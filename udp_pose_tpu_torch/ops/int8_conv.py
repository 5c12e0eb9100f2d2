"""The int8 (w8a8) convolution of the PTQ serving mode.

The JAX package computes it as one XLA conv on int8 operands with an
int32 result, the activation quantise before it and the dequant
epilogue after it fused by XLA (``udp_pose_tpu/models/quantize.py``,
``_quantized_conv`` :188-218).  Stock PyTorch on CUDA has no int8 conv.

:func:`int8_conv2d` is the port's: on a CUDA tensor one launch of
:func:`int8_conv_fused`, the implicit-GEMM kernel of
``csrc/int8_conv.cu`` that quantises the activation as it loads it, runs
the s8 tensor cores and applies the epilogue in registers; on a CPU
tensor its plain version :func:`int8_conv_fused_reference`.  Either
returns the (M, Cout) NHWC result as a channels-last NCHW view.  The
plain version composes the three steps of the GEMM lowering:

* :func:`quant_im2col`: the activation (N, C, H, W), bf16 or float32,
  any strides → int8 patches (rows, K_pad), taps in (kh, kw, cin) order,
  ``clip(round(x * inv_s_a), -127, 127)`` (round half to even);
* :func:`int8_gemm`: patches × the prepared (N_pad, K_pad) int8 weight
  → int32 (``torch._int_mm`` on the card, the exact integer product
  :func:`int8_gemm_reference` on the CPU);
* :func:`dequant_epilogue`: ``float(acc) * scale[c] + bias[c]`` → the
  output dtype, two roundings as in the JAX package.

On the card those three are the slice-5 path (two kernels of the same
source around ``_int_mm``), which no serving path runs any more: the card
checks hold the fused kernel against it bit for bit and time the two.
``_int_mm`` wants more than 16 rows and K and N multiples of 8: the
patches carry zero rows and zero columns up to that, and the weight zero
rows and columns to match (:func:`gemm_rows`, :func:`gemm_pad`).  The
fused kernel reads the weight in K tiles of 32 bytes, so
``Int8Conv2d`` pads K to :func:`k_tile_pad`, which is a multiple of 8 too.

Each kernel wrapper launches its kernel on a CUDA tensor (and adds one to
its ``.launches``) and takes its plain version on a CPU tensor; on the
card it launches or raises: nothing falls back to a float conv or to the
plain version.
"""

from __future__ import annotations

import ctypes
import re
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

GEMM_ALIGN = 8         # _int_mm: K and N multiples of 8
GEMM_MIN_ROWS = 17     # _int_mm: more than 16 rows
GEMM_N_ALIGN = 32      # int8_gemm's weight rows, which cuBLASLt takes
K_TILE = 32            # the fused kernel's K tile (bytes of int8)
# the launcher's ``route``: scalar gather, 16-byte loads, shifted taps
ROUTES = ("gather", "vec", "shift")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gemm_pad(n: int) -> int:
    """``n`` rounded up to the GEMM's multiple (K and N)."""
    return -(-int(n) // GEMM_ALIGN) * GEMM_ALIGN


def k_tile_pad(k: int) -> int:
    """K rounded up to the fused kernel's K tile: the prepared weight's
    K_pad (a multiple of ``GEMM_ALIGN`` as well)."""
    return -(-int(k) // K_TILE) * K_TILE


def _kernel_table():
    """The fused kernel's tilings, (BLOCK_M, BLOCK_N) in the order of its
    launcher's ``tile`` index, and the halo rows its shift kernel holds on
    each side of a block: ``kTilings`` and ``kMaxHalo`` of
    ``csrc/int8_conv.cu``, read from the source (not built), so that the
    tilings are written down once."""
    src = (_build.CSRC_DIR / "int8_conv.cu").read_text()
    table = re.search(r"constexpr Tiling kTilings\[\] = \{(.*?)\};", src,
                      re.S).group(1)
    tiles = tuple((int(bm), int(bn)) for bm, bn, _, _ in re.findall(
        r"\{(\d+), (\d+), (\d+), (\d+)\}", table))
    halo = int(re.search(r"constexpr int kMaxHalo = (\d+);", src).group(1))
    return tiles, halo


FUSED_TILES, MAX_HALO = _kernel_table()


class FusedTiling(NamedTuple):
    tile: int       # index into FUSED_TILES
    block_m: int
    block_n: int
    route: str      # one of ROUTES


def fused_tiling(shape, Cout, kernel, stride, padding, loads, dtype,
                 sms) -> FusedTiling:
    """The fused kernel's tiling and route for a conv of the (N, C, H, W)
    activation ``shape`` to ``Cout`` channels whose layout allows
    ``loads`` (``"dense"``: dense channels-last; ``"vec"``: channel stride
    1 and 16-byte aligned chunks; ``"scalar"``: anything else), on a card
    of ``sms`` streaming multiprocessors.

    The block covers as many output channels as it can (the first tiling
    whose BLOCK_N holds min(Cout, 128)), so that each activation byte is
    loaded and quantised for as few column blocks as possible; 128 output
    columns take 64 rows a block, to keep the accumulators at 64
    registers a thread.  Routes: ``"shift"`` for a stride-1 "same" conv
    of a dense channels-last bf16 activation with C % 32 == 0 whose halo
    fits the extended tile (each pixel quantised once for all taps), in
    blocks of twice the rows where the table has them and two of them an
    SM remain;
    ``"vec"`` where 8 channels of one tap are one 16-byte load (C % 8 ==
    0); else ``"gather"`` (the C = 3 stems, NCHW input)."""
    N, C, H, W = shape
    if C < 1 or Cout < 1:
        raise ValueError(f"unsupported int8 conv: {C} -> {Cout} channels")
    tile = next(i for i, (_, bn) in enumerate(FUSED_TILES)
                if bn >= min(Cout, 128))
    block_m, block_n = FUSED_TILES[tile]
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    Ho, Wo = conv_out_hw(H, W, kernel, stride, padding)
    if (loads == "dense" and dtype == torch.bfloat16 and C % K_TILE == 0
            and (sh, sw) == (1, 1) and kh % 2 and kw % 2
            and (ph, pw) == (kh // 2, kw // 2) and 3 <= kh * kw <= 32
            and ph * W + pw <= MAX_HALO):
        route = "shift"
        tall = (2 * block_m, block_n)
        blocks = -(-N * Ho * Wo // tall[0]) * -(-Cout // block_n)
        if tall in FUSED_TILES and blocks >= 2 * sms:
            tile = FUSED_TILES.index(tall)
    elif loads in ("dense", "vec") and C % 8 == 0:
        route = "vec"
    else:
        route = "gather"
    return FusedTiling(tile, *FUSED_TILES[tile], route)


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


def int8_gemm_reference(a, w_gemm):
    """The exact integer product of :func:`int8_gemm` in float64 on any
    device (|acc| < 2**53 for any K the nets have)."""
    return (a.double() @ w_gemm.double().t()).to(torch.int32)


def int8_gemm(a, w_gemm):
    """(rows, K_pad) int8 patches × (N_pad, K_pad) int8 weight →
    (rows, N_pad) int32.  ``torch._int_mm`` on the card, whose second
    operand is the column-major view ``w_gemm.t()``, with the weight's
    rows padded with zeros to a multiple of ``GEMM_N_ALIGN`` (cuBLASLt
    refuses some row counts, RSN's 104 at 786432 rows among them) and the
    product's first N_pad columns kept, a row-major view; on the CPU
    :func:`int8_gemm_reference`."""
    if a.device.type != "cuda":
        return int8_gemm_reference(a, w_gemm)
    n = w_gemm.shape[0]
    if n % GEMM_N_ALIGN:
        w_gemm = F.pad(w_gemm, (0, 0, 0, -n % GEMM_N_ALIGN))
    return torch._int_mm(a, w_gemm.t())[:, :n]


def dequant_epilogue_reference(acc, scale, bias, out_dtype, rows, cols):
    """Plain version of :func:`dequant_epilogue`."""
    y = acc[:rows, :cols].float() * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def _nhwc_view(y, N, Ho, Wo):
    """(N·Ho·Wo, Cout) rows → the (N, Cout, Ho, Wo) channels-last view."""
    return y.view(N, Ho, Wo, y.shape[-1]).permute(0, 3, 1, 2)


def int8_conv_fused_reference(x, layer):
    """Plain version of :func:`int8_conv_fused`, on either device: the
    three plain steps, with the exact integer product between them."""
    N, _, H, W = x.shape
    Ho, Wo = conv_out_hw(H, W, layer.kernel_size, layer.stride,
                         layer.padding)
    a = quant_im2col_reference(x, layer.inv_s_a, layer.kernel_size,
                               layer.stride, layer.padding, layer.k_pad)
    acc = int8_gemm_reference(a, layer.w_gemm)
    del a
    y = dequant_epilogue_reference(acc, layer.scale, layer.bias, x.dtype,
                                   N * Ho * Wo, layer.out_channels)
    return _nhwc_view(y, N, Ho, Wo)


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


def _loads(x):
    """What the layout of the (N, C, H, W) activation ``x`` lets the
    kernel load (see :func:`fused_tiling`): ``"dense"`` for a dense
    channels-last tensor, ``"vec"`` where 8 channels of one tap are one
    aligned 16-byte load (channel stride 1, the other strides of dims
    longer than 1 multiples of 8 elements, a 16-byte aligned base),
    ``"scalar"`` otherwise."""
    N, C, H, W = x.shape
    if not (x.stride(1) == 1 and x.data_ptr() % 16 == 0
            and all(x.stride(d) % 8 == 0 for d in (0, 2, 3)
                    if x.shape[d] > 1)):
        return "scalar"
    dense = (x.stride(3) == C and x.stride(2) == W * C
             and (N == 1 or x.stride(0) == H * W * C))
    return "dense" if dense else "vec"


class FusedArgs(ctypes.Structure):
    """The fused launcher's arguments other than the activation and output
    pointers and the stream (``struct FusedArgs`` of
    ``csrc/int8_conv.cu``, field for field)."""
    _fields_ = ([(n, ctypes.c_longlong) for n in ("sN", "sC", "sH", "sW")]
                + [(n, ctypes.c_void_p) for n in ("w", "scale", "bias")]
                + [(n, ctypes.c_int) for n in (
                    "dtype", "batch", "C", "H", "W", "kh", "kw", "sh", "sw",
                    "ph", "pw", "Ho", "Wo", "n_pad", "k_pad", "cout")]
                + [("inv", ctypes.c_float), ("tile", ctypes.c_int),
                   ("route", ctypes.c_int)])


def _plan(x, layer):
    """Check ``x`` and ``layer`` against what the kernel takes and pack
    the launch: (FusedArgs, output shape (N, Cout, Ho, Wo))."""
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise TypeError(f"activation must be (N, C, H, W) float32 or "
                        f"bfloat16, got {x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv_fused needs a CUDA tensor, got "
                         f"{x.device}")
    N, C, H, W = x.shape
    (kh, kw), (sh, sw), (ph, pw) = (layer.kernel_size, layer.stride,
                                    layer.padding)
    Ho, Wo = conv_out_hw(H, W, layer.kernel_size, layer.stride,
                         layer.padding)
    Cout, w = layer.out_channels, layer.w_gemm
    if (C != layer.in_channels or Ho < 1 or Wo < 1
            or layer.k_pad % K_TILE or layer.k_pad < kh * kw * C
            or w.dtype != torch.int8 or not w.is_contiguous()
            or w.device != x.device or w.shape[0] < Cout
            or w.shape[1] != layer.k_pad):
        raise ValueError(f"unsupported int8 conv: x {tuple(x.shape)}, "
                         f"kernel {layer.kernel_size}, stride "
                         f"{layer.stride}, padding {layer.padding}, weight "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}, "
                         f"k_pad {layer.k_pad}")
    for name, t in (("scale", layer.scale), ("bias", layer.bias)):
        if t is not None and (t.dtype != torch.float32 or t.device !=
                              x.device or not t.is_contiguous()
                              or t.numel() != Cout):
            raise ValueError(f"{name} must be a contiguous float32 vector "
                             f"of {Cout} on {x.device}")
    t = fused_tiling(x.shape, Cout, layer.kernel_size, layer.stride,
                     layer.padding, _loads(x), x.dtype,
                     torch.cuda.get_device_properties(
                         x.device).multi_processor_count)
    args = FusedArgs(
        *x.stride(), w.data_ptr(), layer.scale.data_ptr(),
        None if layer.bias is None else layer.bias.data_ptr(),
        _DTYPES[x.dtype], N, C, H, W, kh, kw, sh, sw, ph, pw, Ho, Wo,
        w.shape[0], layer.k_pad, Cout, float(layer.inv_s_a), t.tile,
        ROUTES.index(t.route))
    return args, (N, Cout, Ho, Wo)


def _current_stream(device):
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def int8_conv_fused(x, layer, tile=None):
    """The int8 conv of ``layer`` (see :func:`int8_conv2d`) in one launch
    of the fused kernel on a CUDA tensor (``int8_conv_fused.launches``).
    Raises on a device, dtype or shape that the kernel does not take.
    ``tile``: another tiling than :func:`fused_tiling`'s (an index into
    ``FUSED_TILES``), for the card checks that time tilings against each
    other.

    The checks and the packed launch arguments are kept per input layout
    in ``layer.launch_plans`` where the layer has that dict (each
    ``Int8Conv2d``), keyed with the addresses of its weight, scale and
    bias, so that a serving forward pays them once: the host's cost of a
    launch is what paces the small-batch paths."""
    plans = getattr(layer, "launch_plans", None)
    key = (x.shape, x.stride(), x.dtype, x.device, x.data_ptr() % 16 == 0,
           layer.w_gemm.data_ptr(), layer.scale.data_ptr(),
           None if layer.bias is None else layer.bias.data_ptr())
    plan = None if plans is None else plans.get(key)
    if plan is None:
        plan = _plan(x, layer)
        if plans is not None:
            if len(plans) >= 64:        # many layouts: start again
                plans.clear()
            plans[key] = plan
    args, shape = plan
    if tile is not None:
        args = FusedArgs.from_buffer_copy(args)
        args.tile = tile
    out = torch.empty(shape, dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    fn = _kernel("int8_conv_fused_launch", (ctypes.c_void_p,
                                            ctypes.c_void_p,
                                            ctypes.POINTER(FusedArgs),
                                            ctypes.c_void_p))
    if x.device.index == torch.cuda.current_device():
        status = fn(x.data_ptr(), out.data_ptr(), ctypes.byref(args),
                    _current_stream(x.device))
    else:
        with torch.cuda.device(x.device):
            status = fn(x.data_ptr(), out.data_ptr(), ctypes.byref(args),
                        _current_stream(x.device))
    _raise_on(status, "int8_conv_fused")
    int8_conv_fused.launches += 1
    return out


int8_conv_fused.launches = 0


def int8_conv2d(x, layer):
    """The int8 conv of ``layer`` (a :class:`..models.quantize.Int8Conv2d`:
    ``kernel_size``, ``stride``, ``padding``, ``in_channels``,
    ``inv_s_a``, ``k_pad``, ``w_gemm``, ``scale``, ``bias``,
    ``out_channels``) on the (N, C, H, W) activation ``x`` → (N, Cout,
    Ho, Wo) of ``x``'s dtype, a channels-last view: the fused kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return int8_conv_fused_reference(x, layer)
    return int8_conv_fused(x, layer)
