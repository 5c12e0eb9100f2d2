"""The int8 (w8a8) depthwise convolution of the PTQ serving mode.

The JAX package computes a grouped conv (``feature_group_count`` = C) as
one XLA conv on int8 operands with an int32 result, the activation
quantise before it and the dequant epilogue after it
(``udp_pose_tpu/models/quantize.py``, ``_quantized_conv`` :188-218).
Every grouped conv of the zoo is depthwise (groups = Cin = Cout): the
mobile nets' k = 3, 5, 7 convs at stride 1 and 2, and RSN's PRM 9×9.

:func:`int8_dwconv` launches the hand-written kernel of
``csrc/int8_dwconv.cu`` on a CUDA tensor (and adds one to
``int8_dwconv.launches``); on a CPU tensor it takes the plain version
:func:`int8_dwconv_reference`.  On the card it launches or raises: nothing
falls back to a float conv or to the plain version.  The layer it takes
is a :class:`..models.quantize.Int8DepthwiseConv2d` (``kernel_size``,
``stride``, ``padding``, ``in_channels``, ``inv_s_a``, ``w_taps``,
``scale``, ``bias``, ``launch_plans``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from . import _build
from .int8_conv import _current_stream, _raise_on, conv_out_hw

KERNELS = (3, 5, 7, 9)      # the kernel's square sizes
STRIDES = (1, 2)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def dw_loads(x):
    """``"vec"`` where 8 channels of one tap are one aligned 16-byte
    chunk (channel stride 1, C % 8 == 0, the other strides of dims longer
    than 1 multiples of 8 elements, a 16-byte aligned base), else
    ``"scalar"``: the kernel's two routes."""
    N, C, H, W = x.shape
    if (C % 8 == 0 and x.stride(1) == 1 and x.data_ptr() % 16 == 0
            and all(x.stride(d) % 8 == 0 for d in (0, 2, 3)
                    if x.shape[d] > 1)):
        return "vec"
    return "scalar"


class DwArgs(ctypes.Structure):
    """The launcher's arguments other than the activation and output
    pointers and the stream (``struct DwArgs`` of ``csrc/int8_dwconv.cu``,
    field for field)."""
    _fields_ = ([(n, ctypes.c_longlong) for n in ("sN", "sC", "sH", "sW")]
                + [(n, ctypes.c_void_p) for n in ("w", "scale", "bias")]
                + [(n, ctypes.c_int) for n in (
                    "dtype", "batch", "C", "H", "W", "k", "stride", "pad",
                    "Ho", "Wo", "vec")]
                + [("inv", ctypes.c_float)])


def _plan(x, layer):
    """Check ``x`` and ``layer`` against what the kernel takes and pack
    the launch: (DwArgs, output shape (N, C, Ho, Wo))."""
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise TypeError(f"activation must be (N, C, H, W) float32 or "
                        f"bfloat16, got {x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"int8_dwconv needs a CUDA tensor, got {x.device}")
    N, C, H, W = x.shape
    (kh, kw), (sh, sw), (ph, pw) = (layer.kernel_size, layer.stride,
                                    layer.padding)
    Ho, Wo = conv_out_hw(H, W, layer.kernel_size, layer.stride,
                         layer.padding)
    w = layer.w_taps
    if (C != layer.in_channels or kh != kw or kh not in KERNELS
            or sh != sw or sh not in STRIDES or ph != pw or Ho < 1 or Wo < 1
            or w.dtype != torch.int8 or not w.is_contiguous()
            or w.device != x.device or tuple(w.shape) != (kh * kw, C)):
        raise ValueError(f"unsupported int8 depthwise conv: x "
                         f"{tuple(x.shape)}, kernel {layer.kernel_size}, "
                         f"stride {layer.stride}, padding {layer.padding}, "
                         f"weight {w.dtype} {tuple(w.shape)} on {w.device}")
    for name, t in (("scale", layer.scale), ("bias", layer.bias)):
        if t is not None and (t.dtype != torch.float32 or t.device !=
                              x.device or not t.is_contiguous()
                              or t.numel() != C):
            raise ValueError(f"{name} must be a contiguous float32 vector "
                             f"of {C} on {x.device}")
    args = DwArgs(
        *x.stride(), w.data_ptr(), layer.scale.data_ptr(),
        None if layer.bias is None else layer.bias.data_ptr(),
        _DTYPES[x.dtype], N, C, H, W, kh, sh, ph, Ho, Wo,
        int(dw_loads(x) == "vec"), float(layer.inv_s_a))
    return args, (N, C, Ho, Wo)


@lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("int8_dwconv").int8_dwconv_launch
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(DwArgs),
                   ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return fn


def int8_dwconv(x, layer):
    """The int8 depthwise conv of ``layer`` on the (N, C, H, W) activation
    ``x`` (float32 or bf16, any strides) → (N, C, Ho, Wo) of ``x``'s
    dtype, a channels-last tensor: one kernel launch on a CUDA tensor
    (``int8_dwconv.launches``), the plain version on a CPU tensor.
    Raises on a device, dtype or shape that the kernel does not take.

    The checks and packed arguments are kept per input layout in
    ``layer.launch_plans``, keyed with the addresses of the layer's
    tensors, so that a serving forward pays them once."""
    if x.device.type == "cpu":
        return int8_dwconv_reference(x, layer)
    plans = layer.launch_plans
    key = (x.shape, x.stride(), x.dtype, x.device, x.data_ptr() % 16 == 0,
           layer.w_taps.data_ptr(), layer.scale.data_ptr(),
           None if layer.bias is None else layer.bias.data_ptr())
    plan = plans.get(key)
    if plan is None:
        plan = _plan(x, layer)
        if len(plans) >= 64:            # many layouts: start again
            plans.clear()
        plans[key] = plan
    args, shape = plan
    out = torch.empty(shape, dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        status = _launcher()(x.data_ptr(), out.data_ptr(), ctypes.byref(args),
                             _current_stream(x.device))
    _raise_on(status, "int8_dwconv")
    int8_dwconv.launches += 1
    return out


int8_dwconv.launches = 0
