"""Alternative decoders (port of ``udp_pose_tpu/ops/alt_decode.py``;
parity: deep_hrnet tools/infer_utils/decode.py).

:func:`simdr_decode`: SimDR's 1-D classification heads (decode.py:7-16),
the per-axis softmax argmax halved (split ratio 2), then the *biased*
transform (÷ output size, no −1).  :func:`shift_decode`: the argmax
moved ±0.25 toward the higher neighbour (decode.py:19-40), the classic
SimpleBaseline quarter offset.  Both batched tensor functions on the
inputs' device; both return int32 source coordinates, as the reference
casts them.  No path of either package calls them.
"""

from __future__ import annotations

import torch


def _biased_transform(coords, center, scale, output_size_wh):
    """decode.py:56-62: a unit is scale·200 over the output size (no
    −1).  coords (B, J, 2), center and scale (B, 2)."""
    dev = coords.device
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    s200 = torch.as_tensor(scale, dtype=torch.float32, device=dev) * 200.0
    sx = (s200[..., 0] / float(output_size_wh[0]))[..., None]
    sy = (s200[..., 1] / float(output_size_wh[1]))[..., None]
    x = coords[..., 0] * sx + (center[..., 0] - s200[..., 0] * 0.5)[..., None]
    y = coords[..., 1] * sy + (center[..., 1] - s200[..., 1] * 0.5)[..., None]
    return torch.stack([x, y], dim=-1)


def simdr_decode(pred_x, pred_y, center, scale, image_size_wh=(192, 256)):
    """pred_x (B, J, W·k), pred_y (B, J, H·k) → int32 source coordinates
    (B, J, 2)."""
    x = torch.softmax(pred_x.float(), dim=2).argmax(2) / 2.0
    y = torch.softmax(pred_y.float(), dim=2).argmax(2) / 2.0
    coords = torch.stack([x, y], dim=-1).float()
    return _biased_transform(coords, center, scale,
                             image_size_wh).to(torch.int32)


def shift_decode(heatmaps, center, scale):
    """(B, J, H, W) heatmaps → int32 source coordinates (B, J, 2) of the
    argmax shifted by ±0.25 toward the higher neighbour where the peak
    lies inside (1 < px < W-1, 1 < py < H-1) and is positive; a map that
    is nowhere positive gives −1 before the transform."""
    B, J, H, W = heatmaps.shape
    flat = heatmaps.float().reshape(B, J, H * W)
    maxvals = flat.amax(dim=2)
    idx = flat.argmax(dim=2)             # the first maximum
    px = idx % W
    py = idx // W
    coords = torch.stack([px, py], -1).float()
    positive = maxvals > 0
    coords = torch.where(positive[..., None], coords, -1.0)

    def at(dx, dy):
        xi = (px + dx).clamp(0, W - 1)
        yi = (py + dy).clamp(0, H - 1)
        return flat.gather(2, (yi * W + xi)[..., None])[..., 0]

    diff_x = at(1, 0) - at(-1, 0)
    diff_y = at(0, 1) - at(0, -1)
    interior = ((px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)
                & positive)
    shift = torch.stack([torch.sign(diff_x), torch.sign(diff_y)], -1) * 0.25
    coords = coords + shift * interior[..., None]
    return _biased_transform(coords, center, scale, (W, H)).to(torch.int32)
