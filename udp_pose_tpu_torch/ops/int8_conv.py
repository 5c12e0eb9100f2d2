"""The int8 (w8a8) convolution of the PTQ serving mode, in three steps.

The JAX package computes it as one XLA conv on int8 operands with an
int32 result, the activation quantise before it and the dequant
epilogue after it fused by XLA (``udp_pose_tpu/models/quantize.py``,
``_quantized_conv`` :188-218).  Stock PyTorch on CUDA has no int8 conv,
so the port lowers it to a GEMM:

* :func:`quant_im2col`: the activation (N, C, H, W), bf16 or float32,
  any strides → int8 patches (rows, K_pad), taps in (kh, kw, cin) order,
  ``clip(round(x * inv_s_a), -127, 127)`` (round half to even);
* :func:`int8_gemm`: patches × the prepared (N_pad, K_pad) int8 weight
  → int32 (``torch._int_mm`` on the card, an exact integer product on
  the CPU);
* :func:`dequant_epilogue`: ``float(acc) * scale[c] + bias[c]`` → the
  output dtype, two roundings as in the JAX package.

:func:`int8_conv2d` composes them.  The (M, Cout) result of the epilogue
is NHWC in memory, so the conv returns it as a channels-last NCHW view.
``_int_mm`` wants more than 16 rows and K and N multiples of 8: the
patches carry zero rows and zero columns up to that, and the weight zero
rows and columns to match (:func:`gemm_rows`, :func:`gemm_pad`).

:func:`quant_im2col` and :func:`dequant_epilogue` are the CUDA kernels of
``csrc/int8_conv.cu`` on a CUDA tensor (each launch adds one to the
wrapper's ``.launches``) and their plain versions on a CPU tensor, which
the card's checks also hold the kernels against, bit for bit.  On the
card a wrapper launches its kernel or raises: nothing falls back to a
float conv or to the plain version.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from . import _build

GEMM_ALIGN = 8         # _int_mm: K and N multiples of 8
GEMM_MIN_ROWS = 17     # _int_mm: more than 16 rows
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gemm_pad(n: int) -> int:
    """``n`` rounded up to the GEMM's multiple (K and N)."""
    return -(-int(n) // GEMM_ALIGN) * GEMM_ALIGN


def gemm_rows(m: int) -> int:
    """Rows of the patch matrix for ``m`` output pixels."""
    return max(int(m), GEMM_MIN_ROWS)


def conv_out_hw(h, w, kernel, stride, padding):
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


# ------------------------------------------------------------ plain versions

def quant_im2col_reference(x, inv_s_a, kernel, stride, padding, k_pad):
    """Plain version of :func:`quant_im2col`."""
    N, C, H, W = x.shape
    (kh, kw), (sh, sw) = kernel, stride
    ph, pw = padding
    Ho, Wo = conv_out_hw(H, W, kernel, stride, padding)
    q = torch.clamp(torch.round(x.float() * inv_s_a), -127, 127)
    q = F.pad(q, (pw, pw, ph, ph))
    cols = F.unfold(q, (kh, kw), stride=(sh, sw))   # (N, C·kh·kw, L)
    cols = cols.view(N, C, kh * kw, Ho * Wo).permute(0, 3, 2, 1)
    M, K = N * Ho * Wo, kh * kw * C
    out = torch.zeros((gemm_rows(M), k_pad), dtype=torch.int8,
                      device=x.device)
    out[:M, :K] = cols.reshape(M, K).to(torch.int8)
    return out


def int8_gemm(a, w_gemm):
    """(rows, K_pad) int8 patches × (N_pad, K_pad) int8 weight →
    (rows, N_pad) int32.  ``torch._int_mm`` on the card, whose second
    operand is the column-major view ``w_gemm.t()``; on the CPU the exact
    product in float64 (|acc| < 2**53 for any K the nets have)."""
    if a.device.type == "cuda":
        return torch._int_mm(a, w_gemm.t())
    return (a.double() @ w_gemm.double().t()).to(torch.int32)


def dequant_epilogue_reference(acc, scale, bias, out_dtype, rows, cols):
    """Plain version of :func:`dequant_epilogue`."""
    y = acc[:rows, :cols].float() * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


# ------------------------------------------------------------- the kernels

@lru_cache(maxsize=None)
def _kernel(name, argtypes):
    fn = getattr(_build.load("int8_conv"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _raise_on(status, what):
    if status != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {status}")


def quant_im2col(x, inv_s_a, kernel, stride, padding, k_pad):
    """(N, C, H, W) float32 or bf16 activation, any strides → (rows,
    k_pad) int8 patches: row ``(n, oh, ow)``, column ``(i·kw + j)·C + c``
    holds ``clip(round(x[n, c, oh·sh − ph + i, ow·sw − pw + j] ·
    inv_s_a), −127, 127)`` (0 outside the image, in rows ≥ N·Ho·Wo and in
    columns ≥ kh·kw·C).  ``inv_s_a``: a float32 value as a Python float.
    CUDA tensors go through the kernel (``quant_im2col.launches``)."""
    if x.device.type == "cpu":
        return quant_im2col_reference(x, inv_s_a, kernel, stride, padding,
                                      k_pad)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise TypeError(f"activation must be (N, C, H, W) float32 or "
                        f"bfloat16, got {x.dtype} {tuple(x.shape)}")
    N, C, H, W = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    Ho, Wo = conv_out_hw(H, W, kernel, stride, padding)
    M = N * Ho * Wo
    if k_pad % GEMM_ALIGN or k_pad < kh * kw * C or Ho < 1 or Wo < 1:
        raise ValueError(f"unsupported im2col: x {tuple(x.shape)}, kernel "
                         f"{kernel}, stride {stride}, padding {padding}, "
                         f"k_pad {k_pad}")
    out = torch.empty((gemm_rows(M), k_pad), dtype=torch.int8,
                      device=x.device)
    with torch.cuda.device(x.device):
        fn = _kernel("quant_im2col_launch",
                     (ctypes.c_void_p, ctypes.c_int)
                     + (ctypes.c_longlong,) * 4 + (ctypes.c_int,) * 12
                     + (ctypes.c_longlong,) * 2
                     + (ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p))
        _raise_on(fn(x.data_ptr(), _DTYPES[x.dtype], *x.stride(), C, H, W,
                     kh, kw, sh, sw, ph, pw, Ho, Wo, k_pad, M, out.shape[0],
                     float(inv_s_a), out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream),
                  "quant_im2col_kernel")
    quant_im2col.launches += 1
    return out


quant_im2col.launches = 0


def dequant_epilogue(acc, scale, bias, out_dtype, rows, cols):
    """(≥ rows, ld) int32 accumulators → (rows, cols) ``out_dtype``:
    ``float(acc) · scale[c]``, then ``+ bias[c]`` (float32 ``scale`` and
    ``bias`` of length ≥ cols; ``bias`` may be None), each rounded to
    float32, then the cast.  CUDA tensors go through the kernel
    (``dequant_epilogue.launches``)."""
    if acc.device.type == "cpu":
        return dequant_epilogue_reference(acc, scale, bias, out_dtype, rows,
                                          cols)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    if (acc.dtype != torch.int32 or acc.dim() != 2 or acc.stride(1) != 1
            or acc.shape[0] < rows or acc.shape[1] < cols):
        raise ValueError(f"accumulators must be a row-major int32 (>= "
                         f"{rows}, >= {cols}) matrix, got {acc.dtype} "
                         f"{tuple(acc.shape)} strides {acc.stride()}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.device !=
                              acc.device or not t.is_contiguous()
                              or t.numel() < cols):
            raise ValueError(f"{name} must be a contiguous float32 vector "
                             f"of >= {cols} on {acc.device}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"unsupported output dtype {out_dtype}")
    out = torch.empty((rows, cols), dtype=out_dtype, device=acc.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(acc.device):
        fn = _kernel("dequant_epilogue_launch",
                     (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p))
        _raise_on(fn(acc.data_ptr(), rows, cols, acc.stride(0),
                     scale.data_ptr(),
                     None if bias is None else bias.data_ptr(),
                     _DTYPES[out_dtype], out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream),
                  "dequant_epilogue_kernel")
    dequant_epilogue.launches += 1
    return out


dequant_epilogue.launches = 0


def int8_conv2d(x, layer):
    """The int8 conv of ``layer`` (a :class:`..models.quantize.Int8Conv2d`:
    ``kernel_size``, ``stride``, ``padding``, ``inv_s_a``, ``k_pad``,
    ``w_gemm``, ``scale``, ``bias``, ``out_channels``) on the (N, C, H,
    W) activation ``x`` → (N, Cout, Ho, Wo) of ``x``'s dtype, a
    channels-last view."""
    N, _, H, W = x.shape
    Ho, Wo = conv_out_hw(H, W, layer.kernel_size, layer.stride,
                         layer.padding)
    a = quant_im2col(x, layer.inv_s_a, layer.kernel_size, layer.stride,
                     layer.padding, layer.k_pad)
    acc = int8_gemm(a, layer.w_gemm)
    del a                              # the patches go before the epilogue
    y = dequant_epilogue(acc, layer.scale, layer.bias, x.dtype,
                         N * Ho * Wo, layer.out_channels)
    return y.view(N, Ho, Wo, layer.out_channels).permute(0, 3, 1, 2)
