"""UDP crop geometry (port of ``udp_pose_tpu/ops/affine.py``).

The UDP crop matrix and joint rotation of training (reference deep_hrnet/
lib/dataset/JointsDataset.py:29-73, :226-228), as torch functions and
the numpy twins the host data workers use, and the host-side matrices of
the serving path's crop warp.

Coordinate convention (UDP): the continuous image spans ``size - 1``
pixel intervals.  Matrices map **destination pixel → source pixel**
(the ``WARP_INVERSE_MAP`` convention).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PIXEL_STD = 200.0  # reference: JointsDataset.py:78 (`self.pixel_std = 200`)


def udp_warp_matrix(rot_deg, center, scale, out_size_wh):
    """Destination→source (2, 3) float32 matrix of the UDP crop, i.e.
    reference ``get_warpmatrix(r, c*2.0, image_size-1.0, s)``
    (JointsDataset.py:29-49, called at :226): ``rot_deg`` in degrees,
    ``center`` (2,) source-space crop centre, ``scale`` (2,) box size /
    200, ``out_size_wh`` (w, h) of the crop.  ``src = M @ [x, y, 1]``."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=center.device)
    theta = torch.as_tensor(rot_deg, dtype=torch.float32,
                            device=center.device) * (math.pi / 180.0)
    s200 = scale * PIXEL_STD
    dst_w = float(out_size_wh[0]) - 1.0
    dst_h = float(out_size_wh[1]) - 1.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    sx = s200[0] / dst_w
    sy = s200[1] / dst_h
    row0 = torch.stack([
        cos * sx,
        sin * sy,
        -0.5 * s200[0] * cos - 0.5 * s200[1] * sin + center[0],
    ])
    row1 = torch.stack([
        -sin * sx,
        cos * sy,
        0.5 * s200[0] * sin - 0.5 * s200[1] * cos + center[1],
    ])
    return torch.stack([row0, row1])


def udp_rotate_joints(joints_xy, rot_deg, center, scale, out_size_wh,
                      do_clip=False):
    """Source-space joints (..., 2) → UDP crop space (reference
    ``rotate_points``, JointsDataset.py:51-73, as called at :228).  With
    ``do_clip``, x is clipped to [0, w-1] and y to [0, h-1]."""
    joints_xy = torch.as_tensor(joints_xy, dtype=torch.float32)
    dev = joints_xy.device
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    s200 = torch.as_tensor(scale, dtype=torch.float32, device=dev) \
        * PIXEL_STD
    w, h = float(out_size_wh[0]), float(out_size_wh[1])
    radian = torch.as_tensor(rot_deg, dtype=torch.float32, device=dev) \
        * (math.pi / 180.0)
    sin_n, cos = -torch.sin(radian), torch.cos(radian)
    rel = joints_xy - center
    x = cos * rel[..., 0] + sin_n * rel[..., 1]
    y = -sin_n * rel[..., 0] + cos * rel[..., 1]
    x = (x + s200[0] * 0.5) * ((w - 1.0) / s200[0])
    y = (y + s200[1] * 0.5) * ((h - 1.0) / s200[1])
    if do_clip:
        x = torch.clamp(x, 0.0, w - 1.0)
        y = torch.clamp(y, 0.0, h - 1.0)
    return torch.stack([x, y], dim=-1)


def udp_rotate_joints_np(joints_xy, rot_deg, center, scale, out_size_wh,
                         do_clip=False):
    """Host twin of :func:`udp_rotate_joints`, in float64."""
    joints_xy = np.asarray(joints_xy, np.float64)
    center = np.asarray(center, np.float64)
    s200 = np.asarray(scale, np.float64) * PIXEL_STD
    w, h = float(out_size_wh[0]), float(out_size_wh[1])
    radian = float(rot_deg) / 180.0 * math.pi
    sin_n, cos = -math.sin(radian), math.cos(radian)
    rel = joints_xy - center
    x = cos * rel[..., 0] + sin_n * rel[..., 1]
    y = -sin_n * rel[..., 0] + cos * rel[..., 1]
    x = (x + s200[0] * 0.5) * ((w - 1.0) / s200[0])
    y = (y + s200[1] * 0.5) * ((h - 1.0) / s200[1])
    if do_clip:
        x = np.clip(x, 0.0, w - 1.0)
        y = np.clip(y, 0.0, h - 1.0)
    return np.stack([x, y], axis=-1)


def udp_warp_matrix_np(rot_deg, center, scale, out_size_wh):
    """Host twin of :func:`udp_warp_matrix` (float64 math, float32
    matrix)."""
    theta = float(rot_deg) / 180.0 * math.pi
    s200 = np.asarray(scale, np.float64) * PIXEL_STD
    dst_w = float(out_size_wh[0]) - 1.0
    dst_h = float(out_size_wh[1]) - 1.0
    m = np.zeros((2, 3), np.float32)
    m[0, 0] = math.cos(theta) * s200[0] / dst_w
    m[0, 1] = math.sin(theta) * s200[1] / dst_h
    m[0, 2] = (-0.5 * s200[0] * math.cos(theta)
               - 0.5 * s200[1] * math.sin(theta) + center[0])
    m[1, 0] = -math.sin(theta) * s200[0] / dst_w
    m[1, 1] = math.cos(theta) * s200[1] / dst_h
    m[1, 2] = (0.5 * s200[0] * math.sin(theta)
               - 0.5 * s200[1] * math.cos(theta) + center[1])
    return m


def classic_affine_mats_np(center, scale, out_size_wh):
    """(n, 2, 3) dst→src matrices of the classic 3-point crop affine
    (rot 0, deep_hrnet tools/infer_utils/utils.py:157-177) for boxes that
    arrive aspect-matched from ``xyxy_to_cs``, where the construction is
    isotropic: the y-scale equals the x-scale src_w / dst_w."""
    center = np.asarray(center, np.float32)
    s200 = np.asarray(scale, np.float32) * PIXEL_STD
    dst_w, dst_h = float(out_size_wh[0]), float(out_size_wh[1])
    n = center.shape[0]
    mats = np.zeros((n, 2, 3), np.float32)
    s = s200[:, 0] / dst_w
    mats[:, 0, 0] = s
    mats[:, 1, 1] = s
    mats[:, 0, 2] = center[:, 0] - dst_w * 0.5 * s
    mats[:, 1, 2] = center[:, 1] - dst_h * 0.5 * s
    return mats
