"""RSN decode: blur, then a double argmax with a shift toward the second
peak, batched on the device.

Port of ``udp_pose_tpu/ops/rsn_decode.py`` (parity: RSN/exps/RSN18.coco/
test.py:25-71 ``get_results``): a 10-px zero border, the k×k Gaussian
blur (:func:`.blur.gaussian_blur`), the argmax, then for each configured
shift the next-highest peak (each found peak zeroed) and a move of that
fraction toward it; the score comes from the unblurred map at the
rounded location (``map/255 + 0.5``); grid mapping ``×4 + 2``; the
classic (biased) crop → source transform.  The PRM variant uses shifts
(0.25, 0.125) with the same loop.  Plain torch: the JAX package leaves
this decode to XLA and has no kernel for it.
"""

from __future__ import annotations

import torch

from .blur import gaussian_blur

BORDER = 10


def _argmax2d(maps):
    """(..., H, W) → y, x (int64) of the first maximum."""
    W = maps.shape[-1]
    idx = maps.flatten(-2).argmax(dim=-1)
    return idx // W, idx % W


def _zero_at(maps, y, x):
    """``maps`` with the pixel (y, x) of each map set to 0."""
    W = maps.shape[-1]
    flat = maps.flatten(-2).scatter(-1, (y * W + x)[..., None], 0.0)
    return flat.view(maps.shape)


def rsn_decode(outputs, centers, scales, kernel=11, shifts=(0.25,),
               input_size_hw=(256, 192)):
    """outputs (B, J, H, W) raw 255-scale heatmaps; centers, scales (B, 2)
    → (preds (B, J, 2) in source space, maxvals (B, J, 1)), on the
    outputs' device."""
    outputs = outputs.float()
    B, J, H, W = outputs.shape
    centers = torch.as_tensor(centers, dtype=torch.float32,
                              device=outputs.device)
    scales = torch.as_tensor(scales, dtype=torch.float32,
                             device=outputs.device)
    score_map = outputs / 255.0 + 0.5

    dr = gaussian_blur(torch.nn.functional.pad(outputs, (BORDER,) * 4),
                       kernel)
    y0, x0 = _argmax2d(dr)
    dr = _zero_at(dr, y0, x0)
    x = (x0 - BORDER).float()
    y = (y0 - BORDER).float()
    for s in shifts:
        py, px = _argmax2d(dr)
        dr = _zero_at(dr, py, px)
        dx = (px - BORDER).float() - x
        dy = (py - BORDER).float() - y
        ln = torch.sqrt(dx * dx + dy * dy)
        ok = ln > 1e-3
        ln = torch.clamp(ln, min=1e-12)
        x = x + torch.where(ok, s * dx / ln, 0.0)
        y = y + torch.where(ok, s * dy / ln, 0.0)
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)

    # the score at the rounded location of the unblurred map (test.py:61-62)
    xi = torch.round(x + 1e-9).long()
    yi = torch.round(y + 1e-9).long()
    scores = score_map.flatten(-2).gather(-1, (yi * W + xi)[..., None])

    # grid mapping ×4+2, then the crop → source transform (test.py:60-66)
    in_h, in_w = input_size_hw
    s200 = scales * 200.0
    px_src = ((x * 4.0 + 2.0) / in_w * s200[:, None, 0] + centers[:, None, 0]
              - s200[:, None, 0] * 0.5)
    py_src = ((y * 4.0 + 2.0) / in_h * s200[:, None, 1] + centers[:, None, 1]
              - s200[:, None, 1] * 0.5)
    return torch.stack([px_src, py_src], dim=-1), scores
