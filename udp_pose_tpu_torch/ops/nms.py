"""NMS family (port of ``udp_pose_tpu/ops/nms.py``).

The host half (reference deep_hrnet/lib/nms/nms.py:35-177): greedy
box-IoU NMS, OKS-IoU, OKS-NMS and soft-OKS-NMS in numpy.  COCO
evaluation uses the OKS variants (lib/dataset/coco.py:342-351);
candidate counts there are tiny, so they run on the host.  Box IoU uses
the reference's ``+1`` pixel-area convention (nms.py:52) by default.

The device half, :func:`nms_torch` and :func:`nms_torch_batched`: the
fixed-shape greedy NMS of the detect-then-pose graph (``nms_jax``), one
frame or F frames at a time, with no host synchronisation.
"""

from __future__ import annotations

import numpy as np
import torch

# COCO keypoint sigmas (lib/nms/nms.py:77)
COCO_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89], np.float32) / 10.0


def nms_np(dets, thresh, plus_one=True):
    """Greedy box NMS; dets (N, 5) [x1,y1,x2,y2,score] → kept indices.

    ``plus_one=True`` uses the reference's +1 pixel-area convention
    (lib/nms/nms.py:35-72); ``False`` gives plain IoU (torchvision.ops.nms
    semantics).
    """
    if len(dets) == 0:
        return []
    e = 1.0 if plus_one else 0.0
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1 + e) * (y2 - y1 + e)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(0.0, xx2 - xx1 + e)
                 * np.maximum(0.0, yy2 - yy1 + e))
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep


def oks_iou(g, d, a_g, a_d, sigmas=None, in_vis_thre=None):
    """OKS between one pose ``g`` (3J,) and N poses ``d`` (N, 3J)
    (lib/nms/nms.py:75-94).  The reference's visibility filter is a
    python ``and`` of two index lists, which evaluates to the second: with
    ``in_vis_thre`` set, keypoints are kept where ``vd > thre``."""
    if sigmas is None:
        sigmas = COCO_SIGMAS
    vars_ = (sigmas * 2) ** 2
    xg, yg = g[0::3], g[1::3]
    xd, yd = d[:, 0::3], d[:, 1::3]
    dx = xd - xg[None]
    dy = yd - yg[None]
    e = ((dx ** 2 + dy ** 2) / vars_[None]
         / ((a_g + a_d)[:, None] / 2 + np.spacing(1)) / 2)
    if in_vis_thre is not None:
        vd = d[:, 2::3]
        mask = vd > in_vis_thre
        cnt = mask.sum(axis=1)
        s = np.where(mask, np.exp(-e), 0.0).sum(axis=1)
        return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    return np.exp(-e).mean(axis=1)


def oks_nms(kpts, scores, areas, thresh, sigmas=None, in_vis_thre=None):
    """Greedy OKS-NMS (lib/nms/nms.py:97-124): kpts (N, 3J), scores (N,),
    areas (N,) → kept indices."""
    if len(scores) == 0:
        return []
    order = np.asarray(scores).argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        if rest.size == 0:
            break
        ious = oks_iou(kpts[i], kpts[rest], areas[i], areas[rest],
                       sigmas, in_vis_thre)
        order = rest[ious <= thresh]
    return keep


def soft_oks_nms(kpts, scores, areas, thresh, sigmas=None, in_vis_thre=None,
                 max_dets=20):
    """Soft OKS-NMS with Gaussian rescoring (lib/nms/nms.py:138-177)."""
    if len(scores) == 0:
        return []
    order = np.asarray(scores).argsort()[::-1]
    scores = np.asarray(scores, np.float64)[order]
    keep = []
    while order.size > 0 and len(keep) < max_dets:
        i = order[0]
        rest = order[1:]
        ious = oks_iou(kpts[i], kpts[rest], areas[i], areas[rest],
                       sigmas, in_vis_thre) if rest.size else np.zeros(0)
        scores = scores[1:] * np.exp(-(ious ** 2) / thresh)
        resort = scores.argsort()[::-1]
        order = rest[resort]
        scores = scores[resort]
        keep.append(int(i))
    return keep


def _iou_matrix(boxes, plus_one=True):
    """(..., N, 4) xyxy → (..., N, N) IoU, in ``nms_jax``'s arithmetic."""
    off = 1.0 if plus_one else 0.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + off) * (y2 - y1 + off)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = ((xx2 - xx1 + off).clamp_min(0.0)
             * (yy2 - yy1 + off).clamp_min(0.0))
    return inter / (areas[..., :, None] + areas[..., None, :] - inter)


def nms_torch_batched(boxes, scores, iou_thresh, max_out, plus_one=True):
    """Fixed-shape greedy NMS over F frames at once, on the tensors'
    device.

    boxes (F, N, 4) xyxy, scores (F, N); rows to ignore carry score
    -inf.  Returns (keep_idx (F, max_out) int32 padded with -1, keep_mask
    (F, N) bool).  Each of ``min(max_out, N)`` rounds takes the first
    highest live score (a tie keeps the lower index, as ``nms_jax`` and
    the native ``greedy_nms`` do) and suppresses the rows whose IoU with
    it exceeds ``iou_thresh``.  No ``.item()``, ``nonzero`` or boolean
    indexing: nothing waits for the device."""
    F, n = scores.shape
    iou = _iou_matrix(boxes, plus_one=plus_one)
    rows = torch.arange(n, device=scores.device)
    alive = scores > -torch.inf
    kept = torch.zeros_like(alive)
    neg_inf = torch.full_like(scores, -torch.inf)
    keep_idx = []
    for _ in range(min(max_out, n)):
        cand = torch.where(alive, scores, neg_inf)
        i = cand.argmax(dim=1)                                     # (F,)
        valid = cand.gather(1, i[:, None])[:, 0] > -torch.inf
        hit = rows[None, :] == i[:, None]
        overlap = iou.gather(1, i[:, None, None].expand(F, 1, n))[:, 0] \
            > iou_thresh
        alive = torch.where(valid[:, None], alive & ~overlap & ~hit, alive)
        kept |= hit & valid[:, None]
        # a round that finds nothing leaves nothing for the later ones,
        # so the valid rounds are a prefix and fill slots 0, 1, ...
        keep_idx.append(torch.where(valid, i, -1).to(torch.int32))
    keep_idx += [torch.full((F,), -1, dtype=torch.int32,
                            device=scores.device)] * (max_out - len(keep_idx))
    return torch.stack(keep_idx, dim=1), kept


def nms_torch(boxes, scores, iou_thresh, max_out, plus_one=True):
    """Fixed-shape greedy NMS of one frame (``nms_jax``): boxes (N, 4)
    xyxy, scores (N,) with -inf on padding rows → (keep_idx (max_out,)
    int32 padded with -1, keep_mask (N,) bool).  ``plus_one=False`` gives
    the plain IoU of the YOLO path (boxes.py:153)."""
    keep_idx, kept = nms_torch_batched(boxes[None], scores[None],
                                       iou_thresh, max_out, plus_one)
    return keep_idx[0], kept[0]
