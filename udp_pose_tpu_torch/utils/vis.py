"""Debug images (port of ``udp_pose_tpu/utils/vis.py``; parity:
deep_hrnet/lib/utils/vis.py).

Joint grids (:20-51), heatmap grids (:54-116) and ``save_debug_images``
behind the ``DEBUG.*`` switches (:119-142), in numpy and OpenCV as the
JAX package draws them (no torchvision ``make_grid``).  Images come in
as (B, H, W, 3) u8 or float batches: numpy arrays or tensors on any
device.  OpenCV is imported inside the functions that write.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_uint8(images):
    x = _numpy(images)
    if x.dtype != np.uint8:
        x = np.clip(x, 0, 255).astype(np.uint8)
    return x


def _grid(images, nrow=8, padding=2):
    """(B, H, W, C) u8 batch → one grid image (``make_grid``'s role)."""
    x = _to_uint8(images)
    B, H, W, C = x.shape
    ncol = min(nrow, B)
    nrows = math.ceil(B / ncol)
    grid = np.zeros((nrows * (H + padding) + padding,
                     ncol * (W + padding) + padding, C), np.uint8)
    for i in range(B):
        r, c = divmod(i, ncol)
        y0 = r * (H + padding) + padding
        x0 = c * (W + padding) + padding
        grid[y0:y0 + H, x0:x0 + W] = x[i]
    return grid


def save_batch_image_with_joints(batch_image, batch_joints,
                                 batch_joints_vis, file_name, nrow=8):
    """vis.py:20-51: a green dot on each visible joint, in a grid."""
    import cv2
    imgs = _to_uint8(batch_image).copy()
    for i in range(imgs.shape[0]):
        for joint, vis in zip(_numpy(batch_joints[i]),
                              _numpy(batch_joints_vis[i])):
            v = vis[0] if np.ndim(vis) else vis
            if v > 0:
                cv2.circle(imgs[i], (int(joint[0]), int(joint[1])), 2,
                           [0, 255, 0], 2)
    cv2.imwrite(file_name, cv2.cvtColor(_grid(imgs, nrow),
                                        cv2.COLOR_RGB2BGR))


def save_batch_heatmaps(batch_image, batch_heatmaps, file_name,
                        normalize=True):
    """vis.py:54-116: each joint's heatmap in colour over the resized
    image, beside it, one row a sample.  The colour map is applied as
    its 256-entry table (what ``cv2.applyColorMap`` does to u8 maps) to
    all maps at once: a call per map makes the batch take seconds with
    some OpenCV builds."""
    import cv2
    imgs = _to_uint8(batch_image)
    hms = _numpy(batch_heatmaps).astype(np.float32)
    B, J, hh, hw = hms.shape
    if normalize:
        mn = hms.min(axis=(2, 3), keepdims=True)
        mx = hms.max(axis=(2, 3), keepdims=True)
        hms = (hms - mn) / (mx - mn + 1e-9)
    jet = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0]
    small = np.stack([cv2.resize(imgs[b], (hw, hh)) for b in range(B)])
    cm = jet[(hms * 255).astype(np.uint8)]                # (B, J, h, w, 3)
    blend = (cm * 0.7 + small[:, None] * 0.3).astype(np.uint8)
    canvas = np.concatenate([small[:, None], blend], axis=1)
    cv2.imwrite(file_name, canvas.transpose(0, 2, 1, 3, 4).reshape(
        B * hh, (J + 1) * hw, 3))


def save_debug_images(cfg, images, joints, joints_vis, target, output,
                      prefix, pred_joints=None):
    """vis.py:119-142: the images the ``DEBUG.SAVE_*`` switches ask for,
    as ``<prefix>_gt.jpg``, ``_pred.jpg``, ``_hm_gt.jpg`` and
    ``_hm_pred.jpg``.  ``pred_joints``: predicted joints in input-crop
    space (the reference passes ``preds_in_input_space``,
    function.py:219)."""
    if not cfg.DEBUG.DEBUG:
        return
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    if cfg.DEBUG.SAVE_BATCH_IMAGES_GT:
        save_batch_image_with_joints(images, joints, joints_vis,
                                     f"{prefix}_gt.jpg")
    if cfg.DEBUG.SAVE_BATCH_IMAGES_PRED and pred_joints is not None:
        save_batch_image_with_joints(images, pred_joints, joints_vis,
                                     f"{prefix}_pred.jpg")
    if cfg.DEBUG.SAVE_HEATMAPS_GT:
        save_batch_heatmaps(images, target, f"{prefix}_hm_gt.jpg")
    if cfg.DEBUG.SAVE_HEATMAPS_PRED:
        save_batch_heatmaps(images, output, f"{prefix}_hm_pred.jpg")
