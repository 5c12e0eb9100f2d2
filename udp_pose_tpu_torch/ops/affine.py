"""UDP crop geometry (port of ``udp_pose_tpu/ops/affine.py``).

The UDP crop matrix and joint rotation of training (reference deep_hrnet/
lib/dataset/JointsDataset.py:29-73, :226-228), as torch functions and
the numpy twins the host data workers use, and the matrices and the bilinear
crop warp of the detect-then-pose path, on the device
(:func:`classic_affine_matrix`, :func:`crop_boxes`) and on the host
(:func:`classic_affine_mats_np`).

Coordinate convention (UDP): the continuous image spans ``size - 1``
pixel intervals.  Matrices map **destination pixel → source pixel**
(the ``WARP_INVERSE_MAP`` convention).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PIXEL_STD = 200.0  # reference: JointsDataset.py:78 (`self.pixel_std = 200`)


def udp_warp_matrix(rot_deg, center, scale, out_size_wh, compiled_div=False):
    """Destination→source (2, 3) float32 matrix of the UDP crop, i.e.
    reference ``get_warpmatrix(r, c*2.0, image_size-1.0, s)``
    (JointsDataset.py:29-49, called at :226): ``rot_deg`` in degrees,
    ``center`` (2,) source-space crop centre, ``scale`` (2,) box size /
    200, ``out_size_wh`` (w, h) of the crop.  ``src = M @ [x, y, 1]``.
    Batched over leading dims: ``rot_deg`` (...), ``center`` and
    ``scale`` (..., 2) → (..., 2, 3).  ``compiled_div``: divide by the
    crop size as XLA compiles a division by a constant, a product with
    its float32 reciprocal (the JAX package's jitted graphs; its eager
    calls divide)."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=center.device)
    theta = torch.as_tensor(rot_deg, dtype=torch.float32,
                            device=center.device) * (math.pi / 180.0)
    s200 = scale * PIXEL_STD
    dst_w = float(out_size_wh[0]) - 1.0
    dst_h = float(out_size_wh[1]) - 1.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    sw, sh = s200[..., 0], s200[..., 1]
    if compiled_div:
        sx = sw * float(np.float32(1.0) / np.float32(dst_w))
        sy = sh * float(np.float32(1.0) / np.float32(dst_h))
    else:
        sx = sw / dst_w
        sy = sh / dst_h
    row0 = torch.stack([
        cos * sx,
        sin * sy,
        -0.5 * sw * cos - 0.5 * sh * sin + center[..., 0],
    ], dim=-1)
    row1 = torch.stack([
        -sin * sx,
        cos * sy,
        0.5 * sw * sin - 0.5 * sh * cos + center[..., 1],
    ], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def udp_rotate_joints(joints_xy, rot_deg, center, scale, out_size_wh,
                      do_clip=False):
    """Source-space joints (..., 2) → UDP crop space (reference
    ``rotate_points``, JointsDataset.py:51-73, as called at :228).  With
    ``do_clip``, x is clipped to [0, w-1] and y to [0, h-1].  ``center``
    and ``scale`` (..., 2) and ``rot_deg`` broadcast against the joints'
    leading dims (a batch: (B, 1, 2) and (B, 1) for (B, J, 2) joints)."""
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
    x = (x + s200[..., 0] * 0.5) * ((w - 1.0) / s200[..., 0])
    y = (y + s200[..., 1] * 0.5) * ((h - 1.0) / s200[..., 1])
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


def classic_affine_matrix(center, scale, rot_deg, out_size_wh, inv=False,
                          shift=(0.0, 0.0)):
    """The classic (non-UDP) 3-point affine transform, batched over the
    leading dims of ``center`` and ``scale`` (..., 2).

    Reference ``get_affine_transform`` (deep_hrnet/lib/utils/
    transforms.py:77-109): a crop box of ``scale * 200`` centred at
    ``center`` (moved by ``shift`` × the box), rotated by ``rot_deg``
    degrees, mapped onto ``out_size_wh`` so that the box width spans the
    output width; the y-scale equals the x-scale.  ``inv=False`` gives
    source → destination, ``inv=True`` destination → source.  Solves the
    3×3 system as the JAX package does; returns (..., 2, 3) float32.
    ``rot_deg`` and ``shift`` are numbers, so that nothing is copied from
    the host to the device and nothing waits for the device."""
    center = torch.as_tensor(center, dtype=torch.float32)
    s200 = torch.as_tensor(scale, dtype=torch.float32,
                           device=center.device) * PIXEL_STD
    dst_w, dst_h = float(out_size_wh[0]), float(out_size_wh[1])
    rot = float(rot_deg) * math.pi / 180.0
    sin, cos = math.sin(rot), math.cos(rot)
    src_w = s200[..., 0]
    src0 = center + s200 * torch.stack(
        [torch.full_like(src_w, float(v)) for v in shift], dim=-1)
    src1 = src0 + torch.stack([src_w * 0.5 * sin, -src_w * 0.5 * cos],
                              dim=-1)
    d = src0 - src1
    src2 = src1 + torch.stack([-d[..., 1], d[..., 0]], dim=-1)
    # the destination triangle: (w/2, h/2), (w/2, h/2 - w/2), (0, h/2 - w/2)
    zero = torch.zeros_like(src_w)
    dst = torch.stack([torch.stack([zero + dst_w * 0.5, zero + dst_h * 0.5],
                                   dim=-1),
                       torch.stack([zero + dst_w * 0.5,
                                    zero + (dst_h * 0.5 - dst_w * 0.5)],
                                   dim=-1),
                       torch.stack([zero,
                                    zero + (dst_h * 0.5 - dst_w * 0.5)],
                                   dim=-1)], dim=-2)
    src = torch.stack([src0, src1, src2], dim=-2)              # (..., 3, 2)
    if inv:
        src, dst = dst, src
    src_h = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)
    # A @ [x, y, 1]^T = dst for the (2, 3) A: src_h @ A^T = dst
    sol, _ = torch.linalg.solve_ex(src_h, dst, check_errors=False)
    return sol.transpose(-1, -2)


def apply_affine(points_xy, matrix):
    """Apply a (2, 3) affine matrix to (..., 2) points."""
    points_xy = torch.as_tensor(points_xy, dtype=torch.float32)
    return points_xy @ matrix[:, :2].T + matrix[:, 2]


def _sample_grid(matrices, out_hw):
    """Source coordinates (..., h, w) float32 of each output pixel under
    the (..., 2, 3) destination → source ``matrices``: ``m0·x + m1·y +
    m2`` with ``m0·x + (m1·y)`` rounded once, as the JAX graph's
    contracted multiply-add computes it (a coordinate 1 ulp off moves a
    crop value by up to 255 ulp)."""
    out_h, out_w = out_hw
    dev = matrices.device
    dst_x = torch.arange(out_w, dtype=torch.float64, device=dev)[None, :]
    dst_y = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    m = matrices.float()[..., None, None]

    def row(r):
        ax_by = (m[..., r, 0, :, :].double() * dst_x
                 + (m[..., r, 1, :, :] * dst_y).double()).float()
        return ax_by + m[..., r, 2, :, :]

    return row(0), row(1)


def _bilinear_gather(flat, base, src_x, src_y, H, W):
    """Sample frames at float coords, zero outside: ``flat`` holds the
    frames as (frames·H·W, C) rows, ``base`` (..., 1, 1) each sample's
    first row.  Integer taps are gathered as they are and weighted in
    float32 (four times fewer bytes gathered than a float frame)."""
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = src_x - x0
    fy = src_y - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat[idx.reshape(-1)].reshape(*idx.shape, flat.shape[1])
        return vals.float() * inb[..., None].float()

    w00 = ((1 - fx) * (1 - fy))[..., None]
    w01 = (fx * (1 - fy))[..., None]
    w10 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    return (tap(y0, x0) * w00 + tap(y0, x0 + 1) * w01
            + tap(y0 + 1, x0) * w10 + tap(y0 + 1, x0 + 1) * w11)


def warp_affine(image, matrix, out_hw):
    """Bilinear warp of one (H, W, C) image with a (2, 3) destination →
    source matrix (the ``WARP_INVERSE_MAP`` convention), zero outside the
    image → (out_h, out_w, C) float32."""
    return crop_boxes(image, matrix[None], out_hw)[0]


def warp_affine_batch(images, matrices, out_hw):
    """Bilinear warp of each (H, W, C) image of ``images`` (B, H, W, C)
    with its own (2, 3) destination → source matrix of ``matrices`` (B,
    2, 3) → (B, out_h, out_w, C) float32, zero outside the image: one
    :func:`crop_boxes` call with one box a frame."""
    return crop_boxes(images, matrices[:, None], out_hw)[:, 0]


def crop_boxes(image, matrices, out_hw):
    """Warp many boxes out of frames on the device: an (H, W, C) frame
    with (N, 2, 3) matrices → (N, h, w, C), or (F, H, W, C) frames with
    (F, N, 2, 3) matrices → (F, N, h, w, C); float32, zero outside the
    frame.  ``out_hw`` is (out_h, out_w)."""
    batched = image.dim() == 4
    frames = image if batched else image[None]
    mats = matrices if batched else matrices[None]
    F_, H, W, C = frames.shape
    src_x, src_y = _sample_grid(mats.float(), out_hw)       # (F, N, h, w)
    base = (torch.arange(F_, device=frames.device) * (H * W)).view(
        F_, 1, 1, 1)
    out = _bilinear_gather(frames.reshape(F_ * H * W, C), base, src_x,
                           src_y, H, W)
    return out if batched else out[0]


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
