"""The int8 (w8a8) depthwise convolution of the PTQ serving mode.

The JAX package computes a grouped conv (``feature_group_count`` = C) as
one XLA conv on int8 operands with an int32 result, the activation
quantise before it and the dequant epilogue after it
(``udp_pose_tpu/models/quantize.py``, ``_quantized_conv`` :188-218).
Every grouped conv of the zoo is depthwise (groups = Cin = Cout): the
mobile nets' k = 3, 5, 7 convs at stride 1 and 2, and RSN's PRM 9×9.

:func:`int8_dwconv` launches ``int8_dwconv_launch`` of
``csrc/int8_dwconv.cu`` on a CUDA tensor (and adds one to
``int8_dwconv.launches``); on a CPU tensor it takes the plain version
:func:`int8_dwconv_reference`.  On the card it launches or raises: nothing
falls back to a float conv or to the plain version.  :func:`_plan` picks,
in Python so that the CPU tests reach it, the load route from the
activation's layout and base alignment (:func:`dw_route`) and the
channels a block (:func:`channel_block`).  :func:`int8_dwconv_tiled`
launches the source's earlier design, which no path runs: the yardstick
that ``chip_smoke.py`` times the port's launch against.  The layer both
take is a :class:`..models.quantize.Int8DepthwiseConv2d`
(``kernel_size``, ``stride``, ``padding``, ``in_channels``, ``inv_s_a``,
``w_taps``, ``w_packed``, ``scale``, ``bias``, ``launch_plans``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .int8_conv import _current_stream, _raise_on, conv_out_hw

KERNELS = (3, 5, 7, 9)      # the kernel's square sizes
STRIDES = (1, 2)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("channels_last", "split", "nchw")   # the launcher's route codes
TILE = 8                    # output rows and columns of a block
CHANNEL_BLOCKS = (32, 16, 8)
PACK_CHANNELS = max(CHANNEL_BLOCKS)  # w_packed's channels: a multiple


def quantize_activation(x, inv_s_a):
    """``clip(round(float32(x) · inv_s_a), −127, 127)`` (round half to
    even), as float32 values."""
    return torch.clamp(torch.round(x.float() * inv_s_a), -127, 127)


def int8_dwconv_accumulators(x, layer):
    """The int32 sums of the depthwise conv of the quantised activation:
    float64 products of the integer values, each sum rounded to the
    integer it is (|acc| ≤ 127² · 81 < 2²⁴, so any summation order gives
    it exactly)."""
    C = layer.in_channels
    kh, kw = layer.kernel_size
    q = quantize_activation(x, layer.inv_s_a)
    w = layer.w_taps.t().reshape(C, 1, kh, kw)
    return torch.round(F.conv2d(q.double(), w.double(), None, layer.stride,
                                layer.padding, 1, C)).to(torch.int32)


def int8_dwconv_reference(x, layer):
    """Plain version of :func:`int8_dwconv`: the accumulators of
    :func:`int8_dwconv_accumulators`, then ``float32(acc) · scale[c]``,
    ``+ bias[c]`` and the cast to ``x``'s dtype, one rounding each, as
    the JAX epilogue; channels-last, as the kernel writes it."""
    y = int8_dwconv_accumulators(x, layer).float() * layer.scale[:, None,
                                                                 None]
    if layer.bias is not None:
        y = y + layer.bias[:, None, None]
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def pack_weights(w_taps, k):
    """The (k·k, C) int8 weight as the kernel reads it: int32 words of
    shape (C rounded up to ``PACK_CHANNELS``, k, ⌈k/4⌉), word ``[c, i,
    m]`` holding taps ``4m … 4m+3`` of row ``i`` of channel ``c``, the
    first in its low byte; zeros past k and past C."""
    C = w_taps.shape[1]
    tw = (k + 3) // 4
    taps = torch.zeros((-(-C // PACK_CHANNELS) * PACK_CHANNELS, k, 4 * tw),
                       dtype=torch.int64, device=w_taps.device)
    taps[:C, :, :k] = w_taps.t().reshape(C, k, k).to(torch.int64) & 0xFF
    words = (taps[..., 0::4] | taps[..., 1::4] << 8 | taps[..., 2::4] << 16
             | taps[..., 3::4] << 24)
    return (words - ((words >> 31) << 32)).to(torch.int32).contiguous()


def _widest(*byte_counts):
    """The widest load, of 16, 8, 4 and 2 bytes, that divides every one
    of ``byte_counts`` (1 if none does)."""
    return next((lb for lb in (16, 8, 4, 2)
                 if all(b % lb == 0 for b in byte_counts)), 1)


def _split_reads_in_storage(x, off):
    """Whether the split route's loads, which start ``off`` elements
    before each channel pair and end one element past the last channel
    when ``off`` is 0, lie in ``x``'s storage."""
    N, C, H, W = x.shape
    sN, _, sH, sW = x.stride()
    elt = x.element_size()
    st = x.untyped_storage()
    lo = x.data_ptr() - off * elt
    last = (N - 1) * sN + (H - 1) * sH + (W - 1) * sW + 2 * C - 1 - off
    return (lo >= st.data_ptr()
            and x.data_ptr() + (last + 1) * elt <= st.data_ptr() + st.nbytes())


def dw_route(x):
    """The kernel's load route for the (N, C, H, W) activation ``x``:
    (route of ``ROUTES``, bytes a load, offset).

    * ``channels_last`` (channel stride 1): the widest load that C, the
      image, row and pixel strides and the base address allow;
    * ``split`` (channel stride 2, the even/odd channel-split views): the
      parent's contiguous words, from ``offset`` (0 or 1) elements before
      each of the view's channels, at least one of its values a load;
    * ``nchw`` (W stride 1): along the rows of each channel plane, the
      widest load that W, the other strides and the base allow.

    Raises ValueError for any other layout."""
    N, C, H, W = x.shape
    sN, sC, sH, sW = x.stride()
    elt = x.element_size()
    ptr = x.data_ptr()

    def steps(*dims):
        return [st * elt for n, st in dims if n > 1]

    if sC == 1 or C == 1:
        lb = _widest(ptr, C * elt, *steps((N, sN), (H, sH), (W, sW)))
        if lb >= elt:
            return "channels_last", lb, 0
    elif sC == 2:
        lb, off = max((_widest(ptr - off * elt, 2 * C * elt,
                               *steps((N, sN), (H, sH), (W, sW))), off)
                      for off in (0, 1))
        if lb >= 2 * elt and _split_reads_in_storage(x, off):
            return "split", lb, off
    elif sW == 1 or W == 1:
        lb = _widest(ptr, W * elt, *steps((N, sN), (C, sC), (H, sH)))
        if lb >= elt:
            return "nchw", lb, 0
    raise ValueError(f"int8_dwconv takes no load route for x "
                     f"{tuple(x.shape)} strides {x.stride()} {x.dtype} at "
                     f"{ptr % 16} bytes past a 16-byte boundary: channel "
                     f"stride 1 or 2 or W stride 1, element-aligned")


def channel_block(C):
    """Channels a block: the widest of ``CHANNEL_BLOCKS`` that pads C by
    at most a quarter (8 pads C = 18 to 24 where 32 would pad it to
    32)."""
    return next((cb for cb in CHANNEL_BLOCKS
                 if 4 * (-(-C // cb) * cb) <= 5 * C), CHANNEL_BLOCKS[-1])


class DwArgs(ctypes.Structure):
    """The launchers' arguments other than the activation and output
    pointers and the stream (``struct DwArgs`` of
    ``csrc/int8_dwconv.cu``, field for field)."""
    _fields_ = ([(n, ctypes.c_longlong) for n in ("sN", "sC", "sH", "sW")]
                + [(n, ctypes.c_void_p) for n in ("w", "scale", "bias")]
                + [(n, ctypes.c_int) for n in (
                    "dtype", "batch", "C", "H", "W", "k", "stride", "pad",
                    "Ho", "Wo", "route", "load_bytes", "offset", "cb")]
                + [("inv", ctypes.c_float)])


class DwPlan(NamedTuple):
    args: DwArgs
    shape: tuple           # the output's (N, C, Ho, Wo)
    route: str
    load_bytes: int
    offset: int
    cb: int                # channels a block

    @property
    def label(self):
        return f"{self.route}/{self.load_bytes}B"


def _plan(x, layer):
    """Check ``x`` and ``layer`` against what the kernel takes, pick the
    load route and the blocks, and pack the launch.  Raises TypeError on a
    dtype or rank and ValueError on a geometry, a layer tensor or a layout
    that the kernel does not take."""
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise TypeError(f"activation must be (N, C, H, W) float32 or "
                        f"bfloat16, got {x.dtype} {tuple(x.shape)}")
    N, C, H, W = x.shape
    (kh, kw), (sh, sw), (ph, pw) = (layer.kernel_size, layer.stride,
                                    layer.padding)
    Ho, Wo = conv_out_hw(H, W, layer.kernel_size, layer.stride,
                         layer.padding)
    w = layer.w_packed
    if (C != layer.in_channels or kh != kw or kh not in KERNELS
            or sh != sw or sh not in STRIDES or ph != pw or Ho < 1 or Wo < 1
            or w.dtype != torch.int32 or not w.is_contiguous()
            or w.device != x.device or w.data_ptr() % 16
            or tuple(w.shape) != (-(-C // PACK_CHANNELS) * PACK_CHANNELS,
                                  kh, (kh + 3) // 4)):
        raise ValueError(f"unsupported int8 depthwise conv: x "
                         f"{tuple(x.shape)}, kernel {layer.kernel_size}, "
                         f"stride {layer.stride}, padding {layer.padding}, "
                         f"packed weight {w.dtype} {tuple(w.shape)} on "
                         f"{w.device}")
    for name, t in (("scale", layer.scale), ("bias", layer.bias)):
        if t is not None and (t.dtype != torch.float32 or t.device !=
                              x.device or not t.is_contiguous()
                              or t.numel() != C):
            raise ValueError(f"{name} must be a contiguous float32 vector "
                             f"of {C} on {x.device}")
    route, lb, off = dw_route(x)
    cb = channel_block(C)
    args = DwArgs(
        *x.stride(), w.data_ptr(), layer.scale.data_ptr(),
        None if layer.bias is None else layer.bias.data_ptr(),
        _DTYPES[x.dtype], N, C, H, W, kh, sh, ph, Ho, Wo,
        ROUTES.index(route), lb, off, cb, float(layer.inv_s_a))
    return DwPlan(args, (N, C, Ho, Wo), route, lb, off, cb)


def launch_plan(x, layer):
    """:func:`_plan` of ``x`` and ``layer``, kept per input layout in
    ``layer.launch_plans`` so that a serving forward pays it once.  The
    key holds what the route depends on: the shape, the strides, the
    dtype, the base address's offset from a 16-byte boundary and, on a
    channel stride of 2, where the view lies in its storage; and the
    addresses of the layer's tensors."""
    plans = layer.launch_plans
    key = (x.shape, x.stride(), x.dtype, x.device, x.data_ptr() % 16,
           (x.storage_offset(), x.untyped_storage().nbytes())
           if x.stride(1) == 2 else None,
           layer.w_packed.data_ptr(), layer.scale.data_ptr(),
           None if layer.bias is None else layer.bias.data_ptr())
    plan = plans.get(key)
    if plan is None:
        plan = _plan(x, layer)
        if len(plans) >= 64:            # many layouts: start again
            plans.clear()
        plans[key] = plan
    return plan


@lru_cache(maxsize=None)
def _launcher(name):
    """The launcher ``name`` of ``csrc/int8_dwconv.cu`` with its C
    signature: (x, out, DwArgs*[, w_taps for the previous design],
    stream)."""
    fn = getattr(_build.load("int8_dwconv"), name)
    fn.argtypes = ((ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(DwArgs))
                   + ((ctypes.c_void_p,) if name == "int8_dwconv_tiled_launch"
                      else ()) + (ctypes.c_void_p,))
    fn.restype = ctypes.c_int
    return fn


def _launch(x, layer, name, *extra):
    if x.device.type != "cuda":
        raise ValueError(f"int8_dwconv needs a CUDA tensor, got {x.device}")
    plan = launch_plan(x, layer)
    out = torch.empty(plan.shape, dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out, False
    with torch.cuda.device(x.device):
        status = _launcher(name)(x.data_ptr(), out.data_ptr(),
                                 ctypes.byref(plan.args), *extra,
                                 _current_stream(x.device))
    _raise_on(status, name)
    return out, True


def int8_dwconv(x, layer):
    """The int8 depthwise conv of ``layer`` on the (N, C, H, W) activation
    ``x`` (float32 or bf16; channels-last, a channel stride of 2 or NCHW
    rows, see :func:`dw_route`) → (N, C, Ho, Wo) of ``x``'s dtype, a
    channels-last tensor: one launch on a CUDA tensor, with the load
    route :func:`_plan` picks (``int8_dwconv.launches``), the plain
    version on a CPU tensor.
    Raises on a device, dtype, shape or layout that the kernel does not
    take."""
    if x.device.type == "cpu":
        return int8_dwconv_reference(x, layer)
    out, launched = _launch(x, layer, "int8_dwconv_launch")
    int8_dwconv.launches += launched
    return out


def int8_dwconv_tiled(x, layer):
    """:func:`int8_dwconv` by the source's earlier design (16-byte loads
    only where C % 8 == 0 on an aligned channels-last view, one value a
    thread otherwise; the weights repacked by every block) on a CUDA
    tensor (``int8_dwconv_tiled.launches``).  It takes the layouts
    :func:`_plan` takes.  No path runs it: it is the yardstick of
    :func:`int8_dwconv`."""
    if x.device.type == "cpu":
        return int8_dwconv_reference(x, layer)
    out, launched = _launch(x, layer, "int8_dwconv_tiled_launch",
                            layer.w_taps.data_ptr())
    int8_dwconv_tiled.launches += launched
    return out


int8_dwconv.launches = 0
int8_dwconv_tiled.launches = 0
