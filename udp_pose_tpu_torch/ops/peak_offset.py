"""Peak-find + offset decode kernels of the UDP offset decode.

Port of the one TPU kernel of the serving path,
``udp_pose_tpu/ops/pallas/decode_kernels.py`` (``fused_peak_offset``),
as the CUDA source ``csrc/peak_offset.cu``, in two modes:

* :func:`fused_peak_offset`: peak only, the Pallas function's
  counterpart.  Blurred (N, H, W) maps in, (N, 5) out.
* :func:`udp_offset_decode_fused`: the whole UDP offset decode in one
  launch, the main path.  The raw (B, 3J, H, W) net output in, NCHW or
  channels-last; the 15×15 heatmap blur, the peak, and the 7×7 offset
  blurs at the peak pixel only; (B, J, 5) out.

Their semantics are those of the default decode,
``udp_pose_tpu/ops/decode.udp_offset_decode``: a map whose peak is <= 0
is decoded at (0, 0) with the offsets read there.  (The Pallas wrapper
gathers the offsets at the unmasked argmax instead; the port does not
follow it.)

On a CUDA tensor each wrapper launches its kernel or raises.  Only a CPU
tensor takes the plain versions, :func:`fused_peak_offset_reference` and
:func:`udp_offset_decode_reference`, which the card's checks also hold
the kernels against, bit for bit.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .blur import folded_taps, gaussian_blur, separable_blur_reference


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


def udp_offset_decode_reference(net_output, kpd):
    """Plain version of the fused decode: (B, 3J, H, W) interleaved
    [hm, off_x, off_y] → (B, J, 5) ``[x, y, maxval, ox, oy]``, with the
    blurs of :func:`.blur.separable_blur_reference` (15×15 on the
    heatmaps, 7×7 on the offsets × ``kpd``) and the peak semantics of
    :func:`fused_peak_offset_reference`."""
    B, C, H, W = net_output.shape
    maps = (separable_blur_reference(net_output[:, 0::3], 15),
            separable_blur_reference(net_output[:, 1::3] * kpd, 7),
            separable_blur_reference(net_output[:, 2::3] * kpd, 7))
    packed = fused_peak_offset_reference(
        *(m.reshape(B * (C // 3), H, W) for m in maps))
    return packed.reshape(B, C // 3, 5)


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


def _check_net(net):
    """What the fused decode kernel refuses before a launch.  Any
    element strides are taken; H, W >= 8 lets one REFLECT_101 fold reach
    across the 15-tap blur's halo."""
    if net.dtype != torch.float32:
        raise TypeError(f"net_output must be float32, got {net.dtype}")
    if net.dim() != 4 or net.shape[1] % 3:
        raise ValueError(f"net_output must be (B, 3J, H, W), got "
                         f"{tuple(net.shape)}")
    B, C, H, W = net.shape
    if H < 8 or W < 8 or H * W >= 1 << 24 or B * (C // 3) >= 1 << 31:
        raise ValueError(f"unsupported map shape {tuple(net.shape)}: the "
                         f"kernel takes 8 <= H, W and H*W < 2**24")


@lru_cache(maxsize=None)
def _kernel(name, argtypes):
    fn = getattr(_build.load("peak_offset"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _raise_on(status, what):
    if status != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {status}")


@lru_cache(maxsize=None)
def _c_taps(ksize):
    taps = folded_taps(ksize)
    return (ctypes.c_float * len(taps))(*taps.tolist())


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
    N, H, W = hm.shape
    out = torch.empty((N, 5), dtype=torch.float32, device=hm.device)
    if N == 0:
        return out
    with torch.cuda.device(hm.device):
        fn = _kernel("peak_offset_launch",
                     (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3
                     + (ctypes.c_void_p,))
        _raise_on(fn(hm.data_ptr(), off_x.data_ptr(), off_y.data_ptr(),
                     out.data_ptr(), N, H * W, W,
                     torch.cuda.current_stream().cuda_stream),
                  "peak_offset_kernel")
    fused_peak_offset.launches += 1
    return out


fused_peak_offset.launches = 0


def udp_offset_decode_fused(net_output, kpd):
    """(B, 3J, H, W) float32 interleaved [hm, off_x, off_y] net output,
    any strides → (B, J, 5) float32 ``[x, y, maxval, ox, oy]`` (see
    :func:`udp_offset_decode_reference`).  CUDA tensors go through the
    one-launch decode kernel; each launch adds one to
    ``udp_offset_decode_fused.launches``."""
    if net_output.device.type == "cpu":
        return udp_offset_decode_reference(net_output, kpd)
    if net_output.device.type != "cuda":
        raise ValueError(f"unsupported device {net_output.device}")
    _check_net(net_output)
    B, C, H, W = net_output.shape
    out = torch.empty((B, C // 3, 5), dtype=torch.float32,
                      device=net_output.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(net_output.device):
        fn = _kernel("udp_decode_launch",
                     (ctypes.c_void_p,) + (ctypes.c_longlong,) * 4
                     + (ctypes.c_int,) * 4 + (ctypes.c_float,)
                     + (ctypes.c_void_p,) * 4)
        _raise_on(fn(net_output.data_ptr(), *net_output.stride(), B, C // 3,
                     H, W, float(kpd), _c_taps(15), _c_taps(7),
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                  "udp_decode_kernel")
    udp_offset_decode_fused.launches += 1
    return out


udp_offset_decode_fused.launches = 0


def blurred_offset_maps(net_output, kpd):
    """(B, 3J, H, W) interleaved [hm, off_x, off_y] net output → the three
    blurred (B·J, H, W) float32 maps the peak-only kernel reads, by the
    matrix-product blur: 15×15 on the heatmaps, 7×7 on the offsets ×
    ``kpd`` (reference inference.py:156-174).  Off the main path: the
    fused decode blurs inside its kernel."""
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
