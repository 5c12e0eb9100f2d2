"""Fused peak-find + offset gather for the UDP offset decode.

Port of the one TPU kernel of the serving path,
``udp_pose_tpu/ops/pallas/decode_kernels.py`` (``fused_peak_offset``),
as the CUDA kernel ``csrc/peak_offset.cu``.  Its semantics are those of
the default decode, ``udp_pose_tpu/ops/decode.udp_offset_decode``: a map
whose peak is <= 0 is decoded at (0, 0) with the offsets read there.
(The Pallas wrapper gathers the offsets at the unmasked argmax instead;
the port does not follow it.)

On a CUDA tensor :func:`fused_peak_offset` launches the kernel or raises.
Only a CPU tensor takes :func:`fused_peak_offset_reference`, its plain
PyTorch version, which the card's checks also hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .blur import gaussian_blur


def fused_peak_offset_reference(hm, off_x, off_y):
    """Plain version: (N, H, W) float32 maps → (N, 5) float32
    ``[x, y, maxval, ox, oy]``.  ``idx`` is the first flat index holding
    the row max (a NaN counts as the max, as in ``torch.argmax``); where
    ``maxval > 0`` is false, x = y = 0 and the offsets are read at flat
    index 0."""
    N, H, W = hm.shape
    flat = hm.reshape(N, H * W)
    maxval = torch.amax(flat, dim=1)
    peak = maxval > 0.0
    idx = torch.where(peak, torch.argmax(flat, dim=1), 0)
    x = (idx % W).float()
    y = torch.floor(idx.float() / W)
    ox = off_x.reshape(N, H * W).gather(1, idx[:, None])[:, 0]
    oy = off_y.reshape(N, H * W).gather(1, idx[:, None])[:, 0]
    return torch.stack([x, y, maxval, ox, oy], dim=1)


def _check(hm, off_x, off_y):
    for name, t in (("hm", hm), ("off_x", off_x), ("off_y", off_y)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != hm.device:
            raise ValueError(f"{name} is on {t.device}, hm on {hm.device}")
        if t.shape != hm.shape or t.dim() != 3:
            raise ValueError(f"{name} must be (N, H, W) like hm "
                             f"{tuple(hm.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    N, H, W = hm.shape
    if H * W == 0 or H * W >= 1 << 24 or N >= 1 << 31:
        raise ValueError(f"unsupported map shape {tuple(hm.shape)}")


def _launch(hm, off_x, off_y, out):
    lib = _build.load("peak_offset")
    fn = lib.peak_offset_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    N, H, W = hm.shape
    stream = torch.cuda.current_stream(hm.device).cuda_stream
    status = fn(hm.data_ptr(), off_x.data_ptr(), off_y.data_ptr(),
                out.data_ptr(), N, H * W, W, stream)
    if status != 0:
        raise RuntimeError(f"peak_offset_kernel launch failed: "
                           f"cudaError_t {status}")


def fused_peak_offset(hm, off_x, off_y):
    """(N, H, W) contiguous float32 blurred heatmaps and offset maps →
    (N, 5) float32 ``[x, y, maxval, ox, oy]`` (see the plain version for
    the exact semantics).  CUDA tensors go through the kernel; each launch
    adds one to ``fused_peak_offset.launches``."""
    if hm.device.type == "cpu":
        return fused_peak_offset_reference(hm, off_x, off_y)
    if hm.device.type != "cuda":
        raise ValueError(f"unsupported device {hm.device}")
    _check(hm, off_x, off_y)
    out = torch.empty((hm.shape[0], 5), dtype=torch.float32,
                      device=hm.device)
    with torch.cuda.device(hm.device):
        _launch(hm, off_x, off_y, out)
    fused_peak_offset.launches += 1
    return out


fused_peak_offset.launches = 0


def blurred_offset_maps(net_output, kpd):
    """(B, 3J, H, W) interleaved [hm, off_x, off_y] net output → the three
    blurred (B·J, H, W) float32 maps the peak kernel reads: a 15×15 blur
    of the heatmaps, 7×7 of the offsets × ``kpd`` (reference
    inference.py:156-174)."""
    B, C, H, W = net_output.shape
    hm = gaussian_blur(net_output[:, 0::3], 15)
    off_x = gaussian_blur(net_output[:, 1::3] * kpd, 7)
    off_y = gaussian_blur(net_output[:, 2::3] * kpd, 7)
    return tuple(m.reshape(B * (C // 3), H, W).contiguous()
                 for m in (hm, off_x, off_y))


def packed_to_coords(packed):
    """(..., 5) ``[x, y, maxval, ox, oy]`` → coords (..., 2) = peak +
    offset, maxvals (..., 1)."""
    return packed[..., 0:2] + packed[..., 3:5], packed[..., 2:3]


def udp_offset_decode_fused(net_output, kpd):
    """UDP combined heatmap+offset decode: blurs, then the peak kernel.
    Returns coords (B, J, 2) in heatmap space and maxvals (B, J, 1)."""
    B, C = net_output.shape[:2]
    packed = fused_peak_offset(*blurred_offset_maps(net_output, kpd))
    return packed_to_coords(packed.reshape(B, C // 3, 5))
