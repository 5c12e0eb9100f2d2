"""Target encoders: joints → training heatmaps (port of
``udp_pose_tpu/ops/targets.py``).

Reference ``JointsDataset.generate_target`` (deep_hrnet/lib/dataset/
JointsDataset.py:291-385) scatters a windowed Gaussian patch per joint in
a Python loop.  The torch encoders are closed-form expressions over a
meshgrid that broadcast over any leading batch dims, so one call encodes
a batch on the device; the numpy twins are what the host data workers
run (:mod:`..data.base`).

All encoders use the UDP feature stride ``(image_size-1)/(heatmap_size-1)``.
The torch encoders divide by a constant as XLA compiles the JAX
package's ``x / c``: a product with the float32 reciprocal of ``c``, so
both give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch


def _grids(heatmap_size_wh, device):
    W, H = heatmap_size_wh
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return px, py


def _recip(c):
    """The float32 reciprocal of float32 ``c``, as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def _inputs(joints, joints_vis, image_size, heatmap_size):
    joints = torch.as_tensor(joints, dtype=torch.float32)
    vis = torch.as_tensor(joints_vis, dtype=torch.float32,
                          device=joints.device)
    if vis.dim() == joints.dim():           # (..., J, K): column 0
        vis = vis[..., 0]
    W, H = heatmap_size
    stride_x = (image_size[0] - 1.0) / (W - 1.0)
    stride_y = (image_size[1] - 1.0) / (H - 1.0)
    return joints, vis, stride_x, stride_y


def gaussian_targets(joints, joints_vis, heatmap_size, image_size, sigma):
    """Windowed unit-peak Gaussian heatmaps (JointsDataset.py:301-348).

    joints (..., J, 2+) image-space xy; joints_vis (..., J) or (..., J, K)
    (column 0 used); heatmap_size/image_size (w, h); sigma in heatmap
    pixels.  Returns (target (..., J, H, W) float32, weight (..., J)).
    The peak is the continuous sub-pixel location (UDP); the support
    window is the ±3σ box around the rounded centre (``int`` truncation),
    and joints whose window misses the map get weight 0.
    """
    joints, vis, stride_x, stride_y = _inputs(joints, joints_vis,
                                              image_size, heatmap_size)
    W, H = heatmap_size
    tmp = float(sigma) * 3.0
    mu_ax = joints[..., 0] * _recip(stride_x)
    mu_ay = joints[..., 1] * _recip(stride_y)
    mu_x = torch.trunc(mu_ax + 0.5)
    mu_y = torch.trunc(mu_ay + 0.5)
    ul_x = torch.trunc(mu_x - tmp)
    ul_y = torch.trunc(mu_y - tmp)
    br_x = torch.trunc(mu_x + tmp + 1.0)
    br_y = torch.trunc(mu_y + tmp + 1.0)

    oob = (ul_x >= W) | (ul_y >= H) | (br_x < 0) | (br_y < 0)
    weight = torch.where(oob, 0.0, vis)

    px, py = _grids(heatmap_size, joints.device)

    def col(v):
        return v[..., None, None]

    d2 = (px - col(mu_ax)) ** 2 + (py - col(mu_ay)) ** 2
    g = torch.exp(-d2 * _recip(2.0 * float(sigma) ** 2))
    window = ((px >= col(ul_x)) & (px < col(br_x))
              & (py >= col(ul_y)) & (py < col(br_y)))
    target = torch.where(window & col(weight > 0.5), g, 0.0)
    return target, weight


def offset_targets(joints, joints_vis, heatmap_size, image_size, kpd):
    """UDP combined heatmap+offset targets (JointsDataset.py:349-381).

    Returns (target (..., 3J, H, W) interleaved [hm, off_x, off_y] per
    joint, weight (..., J)).  Inside the disc of radius ``kpd`` heatmap
    pixels the classification map is 1 and the offsets hold the
    normalised displacement to the continuous joint location.
    """
    joints, vis, stride_x, stride_y = _inputs(joints, joints_vis,
                                              image_size, heatmap_size)
    W, H = heatmap_size
    mu_x = joints[..., 0] * _recip(stride_x)
    mu_y = joints[..., 1] * _recip(stride_y)
    px, py = _grids(heatmap_size, joints.device)
    off_x = (mu_x[..., None, None] - px) * _recip(kpd)
    off_y = (mu_y[..., None, None] - py) * _recip(kpd)
    dis = off_x ** 2 + off_y ** 2
    keep = (dis <= 1.0) & (vis > 0.5)[..., None, None]
    hm = torch.where(keep, 1.0, 0.0)
    ox = torch.where(keep, off_x, 0.0)
    oy = torch.where(keep, off_y, 0.0)
    target = torch.stack([hm, ox, oy], dim=-3)        # (..., J, 3, H, W)
    return target.flatten(-4, -3), vis


def batch_gaussian_targets(joints, joints_vis, heatmap_size, image_size,
                           sigma):
    """:func:`gaussian_targets` over a leading batch dim."""
    return gaussian_targets(joints, joints_vis, heatmap_size, image_size,
                            sigma)


def batch_offset_targets(joints, joints_vis, heatmap_size, image_size, kpd):
    """:func:`offset_targets` over a leading batch dim."""
    return offset_targets(joints, joints_vis, heatmap_size, image_size, kpd)


# ---------------------------------------------------------------------------
# numpy twins: the host data workers' encoders
# ---------------------------------------------------------------------------

def offset_targets_np(joints, joints_vis, heatmap_size, image_size, kpd):
    """Host twin of :func:`offset_targets` (JointsDataset.py:349-381)."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    J = joints.shape[0]
    vis = np.asarray(joints_vis, np.float32)
    if vis.ndim == 2:
        vis = vis[:, 0]
    target = np.zeros((J, 3, H * W), np.float32)
    fx, fy = np.meshgrid(np.arange(W), np.arange(H))
    fx, fy = fx.ravel(), fy.ravel()
    stride = (np.asarray(image_size, np.float64) - 1.0) / (
        np.asarray(heatmap_size, np.float64) - 1.0)
    for j in range(J):
        if vis[j] <= 0.5:
            continue
        xo = (joints[j][0] / stride[0] - fx) / kpd
        yo = (joints[j][1] / stride[1] - fy) / kpd
        keep = (xo ** 2 + yo ** 2) <= 1
        target[j, 0, keep] = 1
        target[j, 1, keep] = xo[keep]
        target[j, 2, keep] = yo[keep]
    return target.reshape(J * 3, H, W), vis.copy()


def gaussian_targets_np(joints, joints_vis, heatmap_size, image_size, sigma):
    """Host twin of :func:`gaussian_targets` (JointsDataset.py:301-348)."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    J = joints.shape[0]
    vis = np.asarray(joints_vis, np.float32)
    if vis.ndim == 2:
        vis = vis[:, 0]
    target = np.zeros((J, H, W), np.float32)
    weight = vis.copy()
    stride = (np.asarray(image_size, np.float64) - 1.0) / (
        np.asarray(heatmap_size, np.float64) - 1.0)
    tmp = sigma * 3
    for j in range(J):
        mu_ax = joints[j][0] / stride[0]
        mu_ay = joints[j][1] / stride[1]
        mu_x = int(mu_ax + 0.5)
        mu_y = int(mu_ay + 0.5)
        ul = [int(mu_x - tmp), int(mu_y - tmp)]
        br = [int(mu_x + tmp + 1), int(mu_y + tmp + 1)]
        if ul[0] >= W or ul[1] >= H or br[0] < 0 or br[1] < 0:
            weight[j] = 0
            continue
        if weight[j] > 0.5:
            xs = np.arange(max(0, ul[0]), min(br[0], W))
            ys = np.arange(max(0, ul[1]), min(br[1], H))
            gx = np.exp(-(xs - mu_ax) ** 2 / (2 * sigma ** 2))
            gy = np.exp(-(ys - mu_ay) ** 2 / (2 * sigma ** 2))
            target[j][np.ix_(ys, xs)] = gy[:, None] * gx[None, :]
    return target, weight


# RSN kernel size → sigma (RSN/dataset/JointsDataset.py:19-25)
RSN_KERNEL_SIGMA = {15: 2.6, 11: 2.0, 9: 1.7, 7: 1.4105, 5: 1.1105}
RSN_DEFAULT_KERNELS = (15, 11, 9, 7, 5)


def rsn_targets_np(joints, valid, heatmap_size, image_size,
                   kernels=RSN_DEFAULT_KERNELS):
    """RSN's multi-kernel 255-amplitude label pyramid
    (RSN/dataset/JointsDataset.py:214-220, :276-291): for each kernel
    size a full-map Gaussian of its sigma a joint (no window), at the
    unbiased stride ``(in-1)/(out-1)``, peak 255; joints with valid < 1
    give all-zero maps.  joints (J, 2+) crop-space xy, valid (J,) or
    (J, 1) → (len(kernels), J, H, W) float32."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    J = joints.shape[0]
    v = np.asarray(valid, np.float32)
    if v.ndim == 2:
        v = v[:, 0]
    fx, fy = np.meshgrid(np.arange(W), np.arange(H))
    out = np.zeros((len(kernels), J, H, W), np.float32)
    for ki, k in enumerate(kernels):
        sigma = RSN_KERNEL_SIGMA[k]
        for j in range(J):
            if v[j] < 1:
                continue
            tx = joints[j][0] * (W - 1.0) / (image_size[0] - 1.0)
            ty = joints[j][1] * (H - 1.0) / (image_size[1] - 1.0)
            d2 = (fx - tx) ** 2 + (fy - ty) ** 2
            out[ki, j] = 255.0 * np.exp(-d2 / (2.0 * sigma ** 2))
    return out
