"""Heatmap → keypoint decoders, batched on the device.

Port of ``udp_pose_tpu/ops/decode.py`` (reference deep_hrnet/lib/core/
inference.py): argmax peaks (:30-58), DARK Taylor refinement (:60-145),
the UDP offset decode (:156-174) and the UDP transform back to source
space (:20-27).  Heatmap layout (B, J, H, W) float32.

The offset decode runs the peak-find + offset gather as the CUDA kernel
of :mod:`.peak_offset` on a CUDA tensor, and as its plain version on a
CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .blur import gaussian_blur
from .peak_offset import udp_offset_decode_fused

PIXEL_STD = 200.0


def get_max_preds(heatmaps):
    """Peak location + value per joint (reference inference.py:30-58).

    heatmaps (B, J, H, W) → preds (B, J, 2) xy float32, maxvals (B, J, 1).
    Ties resolve to the first flattened index; a peak <= 0 gives (0, 0).
    """
    B, J, H, W = heatmaps.shape
    flat = heatmaps.reshape(B, J, H * W)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.amax(flat, dim=2, keepdim=True)
    x = (idx % W).float()
    y = torch.floor(idx.float() / W)
    preds = torch.stack([x, y], dim=-1)
    return preds * (maxvals > 0.0).float(), maxvals


def _gather_at(maps, xi, yi):
    """maps[b, j, yi[b, j], xi[b, j]] → (B, J)."""
    B, J, H, W = maps.shape
    lin = yi * W + xi
    return maps.reshape(B, J, H * W).gather(2, lin[..., None])[..., 0]


def dark_refine(coords, heatmaps):
    """DARK sub-pixel refinement (reference inference.py:60-145): 7×7
    blur, renormalise to the original peak, clip to [0.001, 50], log,
    replicate-pad by 1, then one Newton step ``coords - H^-1 d`` from
    finite differences at the integer peak.  A singular Hessian gives a
    zero shift (reference LinAlgError path :129-132)."""
    maxori = torch.amax(heatmaps, dim=(2, 3), keepdim=True)
    blurred = gaussian_blur(heatmaps, 7)
    bmax = torch.amax(blurred, dim=(2, 3), keepdim=True)
    bmin = torch.amin(blurred, dim=(2, 3), keepdim=True)
    norm = (blurred - bmin) / (bmax - bmin) * maxori
    logm = torch.log(torch.clamp(norm, 0.001, 50.0))
    pad = F.pad(logm, (1, 1, 1, 1), mode="replicate")

    xi = coords[..., 0].long() + 1      # +1: padded-space offset
    yi = coords[..., 1].long() + 1
    I = _gather_at(pad, xi, yi)
    Ix1 = _gather_at(pad, xi + 1, yi)
    Ix1_ = _gather_at(pad, xi - 1, yi)
    Iy1 = _gather_at(pad, xi, yi + 1)
    Iy1_ = _gather_at(pad, xi, yi - 1)
    Ix1y1 = _gather_at(pad, xi + 1, yi + 1)
    Ix1_y1_ = _gather_at(pad, xi - 1, yi - 1)

    dx = 0.5 * (Ix1 - Ix1_)
    dy = 0.5 * (Iy1 - Iy1_)
    dxx = Ix1 - 2.0 * I + Ix1_
    dyy = Iy1 - 2.0 * I + Iy1_
    dxy = 0.5 * (Ix1y1 - Ix1 - Iy1 + 2.0 * I - Ix1_ - Iy1_ + Ix1_y1_)

    det = dxx * dyy - dxy * dxy
    nonsingular = det != 0.0
    inv_det = torch.where(nonsingular,
                          1.0 / torch.where(nonsingular, det, 1.0), 0.0)
    # closed-form 2x2 inverse; shift = H^-1 @ [dx, dy]
    shift_x = inv_det * (dyy * dx - dxy * dy)
    shift_y = inv_det * (-dxy * dx + dxx * dy)
    return coords.float() - torch.stack([shift_x, shift_y], dim=-1)


# UDP combined heatmap+offset decode (reference inference.py:156-174),
# under the JAX package's name: blurs, then the peak + offset kernel
udp_offset_decode = udp_offset_decode_fused


def transform_preds(coords, center, scale, output_size_wh):
    """Heatmap-space coords → source-image space, UDP convention
    (reference inference.py:20-27: scale*200 spans ``output_size - 1``
    heatmap intervals).  coords (..., J, 2); center/scale (..., 2)."""
    s200 = scale.float() * PIXEL_STD
    w = float(output_size_wh[0]) - 1.0
    h = float(output_size_wh[1]) - 1.0
    sx = (s200[..., 0] / w)[..., None]
    sy = (s200[..., 1] / h)[..., None]
    cx = (center[..., 0] - s200[..., 0] * 0.5)[..., None]
    cy = (center[..., 1] - s200[..., 1] * 0.5)[..., None]
    x = coords[..., 0] * sx + cx
    y = coords[..., 1] * sy + cy
    return torch.stack([x, y], dim=-1)


def get_final_preds(heatmaps, center, scale, target_type="gaussian",
                    post_process=True, kpd=4.0):
    """Full decode: peaks → sub-pixel refine → source space (reference
    inference.py:149-186).  heatmaps (B, J, H, W) for 'gaussian',
    (B, 3J, H, W) for 'offset'.  Returns (preds (B, J, 2), maxvals
    (B, J, 1), preds in input-crop space (B, J, 2))."""
    H, W = heatmaps.shape[2], heatmaps.shape[3]
    if target_type == "gaussian":
        coords, maxvals = get_max_preds(heatmaps)
        if post_process:
            coords = dark_refine(coords, heatmaps)
    elif target_type == "offset":
        coords, maxvals = udp_offset_decode(heatmaps, kpd)
    else:
        raise ValueError(f"unknown target_type {target_type!r}")
    in_input = torch.stack([
        coords[..., 0] / (W - 1.0) * (4.0 * W - 1.0),
        coords[..., 1] / (H - 1.0) * (4.0 * H - 1.0),
    ], dim=-1)
    preds = transform_preds(coords, center, scale, (W, H))
    return preds, maxvals, in_input
