"""The port's int8 conv as the serving path runs it: the plain version of
the fused kernels (``ops/int8_conv.int8_conv_fused_reference``) against
the JAX package's ``_quantized_conv`` bit for bit, the route and tiling at
every int8 site of full-width HRNet-w32, YOLOv5n, ``pose_resnet50``,
``rsn18`` and the five mobile nets, and the CPU route of ``int8_conv2d``.  The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 9a), where
it is held bit for bit against the three-step path and the plain version.
"""

import ctypes
import re
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_quantize import CONV_CASES, _nchw, _one_conv
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.models import quantize as jq
from udp_pose_tpu_torch.models import quantize as tq
from udp_pose_tpu_torch.ops import int8_conv as ic
from udp_pose_tpu_torch.ops import peak_offset as po

REPO = Path(__file__).resolve().parents[1]

# (kernel, stride, padding, cin, cout, (H, W))
FUSED_CASES = [case + ((12, 10),) for case in CONV_CASES] + [
    (3, 2, 1, 3, 64, (12, 10)),     # the w32 stem
    (3, 1, 1, 16, 10, (7, 9)),      # C=16: a K tile of 32 spans two taps
    (1, 1, 0, 24, 40, (5, 6)),      # Cout 40: a partly filled 64-wide block
    (3, 2, 1, 8, 20, (3, 3)),       # M = 2·2·2 = 8 < 17 rows
]


def _case_id(case):
    k, s, p, cin, cout, (h, w) = case
    return f"k{k}s{s}p{p}-{cin}to{cout}-{h}x{w}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", FUSED_CASES, ids=_case_id)
def test_fused_plain_version_equals_jax_quantized_conv(case, bias, dtype):
    """``int8_conv_fused_reference`` (which the card holds the kernel to)
    and the CPU ``Int8Conv2d`` give the JAX ``_quantized_conv`` output bit
    for bit, as a channels-last view in the input's dtype."""
    k, s, p, cin, cout, (h, w) = case
    module, v, conv = _one_conv(k, s, p, cin, cout, bias, seed=cin + cout)
    x = np.random.default_rng(k + cout).normal(0, 1.5, (2, h, w, cin)).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    amax = float(np.abs(x).max()) * 0.7          # some inputs saturate
    want = jq.QuantizedModel(module, {"conv": amax}).apply(v, xj)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    layer = tq.Int8Conv2d(conv, amax)
    assert layer.k_pad % ic.K_TILE == 0 and layer.k_pad >= k * k * cin
    for got in (ic.int8_conv_fused_reference(xt, layer), layer(xt)):
        assert got.dtype == xt.dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                      want)


@pytest.mark.parametrize("inv", [1.0, 0.731, 3.3, 1 / 127])
def test_quantise_by_adding_1_5_times_2_to_the_23(inv):
    """The kernels' quantise (``quantize8`` of ``csrc/int8_conv.cu``):
    clamp ``v · inv`` to ±127, add 1.5·2²³ in float32 and keep the low
    byte of the sum's bits; equal to ``clip(rint(v · inv), -127, 127)``
    (ties to even; NaN → -127 as the kernels' ``fmaxf`` gives), here in
    numpy's float32 arithmetic on ties, extremes and random values."""
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.normal(0, 80, 200_000), np.arange(-300, 301) * 0.5,
        [np.inf, -np.inf, np.nan, 127.5, -127.5, 2.5, -2.5, 1e30, -1e30],
    ]).astype(np.float32)
    prod = (v * np.float32(inv)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        want = np.clip(np.rint(prod), -127, 127)
    want = np.where(np.isnan(prod), -127, want).astype(np.int8)
    q = np.fmin(np.fmax(prod, np.float32(-127)), np.float32(127))
    bits = (q + np.float32(12582912.0)).astype(np.float32).view(np.uint32)
    np.testing.assert_array_equal((bits & 0xff).astype(np.uint8).view(
        np.int8), want)


def test_fused_tiles_are_the_kernels():
    """``FUSED_TILES`` and ``MAX_HALO`` are ``kTilings`` and ``kMaxHalo``
    of the kernel source, and the table is as ``fused_tiling`` takes it:
    its first fit by BLOCK_N lands on a 4-warp tiling, which every route
    takes, and a block with twice its rows, where the table has one, is
    an 8-warp tiling, which only the shift kernel takes."""
    src = (REPO / "udp_pose_tpu_torch/csrc/int8_conv.cu").read_text()
    table = re.search(r"kTilings\[\] = \{(.*?)\};", src, re.S).group(1)
    warps = {(int(bm), int(bn)): int(wm) * int(wn) for bm, bn, wm, wn in
             re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}", table)}
    assert list(warps) == list(ic.FUSED_TILES)
    assert f"constexpr int kMaxHalo = {ic.MAX_HALO};" in src
    for cout in (1, 10, 32, 33, 64, 65, 128, 256):
        t = ic.fused_tiling((1, 8, 9, 9), cout, (1, 1), (1, 1), (0, 0),
                            "vec", torch.float32, 132)
        assert t.route == "vec" and warps[t.block_m, t.block_n] == 4
        assert warps.get((2 * t.block_m, t.block_n), 8) == 8
    assert sum(n == 8 for n in warps.values()) == 2
    # blocks of twice the rows where two of them an SM remain: 240 of
    # them are enough on 114 SMs, not on 132
    assert [ic.fused_tiling((20, 64, 64, 48), 64, (3, 3), (1, 1), (1, 1),
                            "dense", torch.bfloat16, sms, wgmma=False).block_m
            for sms in (132, 114)] == [128, 256]


def test_wgmma_tiles_are_the_kernels():
    """``WGMMA_TILES`` and the engine's constants are ``kWgTilings`` and
    the ``constexpr int`` values of ``csrc/int8_conv_sm90.cu``; every N
    tile a weight is packed at has a block of 128 rows and one of 64, and
    half of it (the plan's split of a 128- or 256-wide chunk) too; 256
    rows only at NT <= 64; the stage steps divide ``kStepAlign``."""
    src = (REPO / "udp_pose_tpu_torch/csrc/int8_conv_sm90.cu").read_text()
    table = re.search(r"kWgTilings\[\] = \{(.*?)\};", src, re.S).group(1)
    tiles = [(int(bm), int(bn)) for bm, bn in
             re.findall(r"\{(\d+), (\d+)\}", table)]
    assert tiles == list(ic.WGMMA_TILES)
    for name, value in ic.WGMMA_CONST.items():
        assert f"constexpr int {name} = {value};" in src
    assert "NT >= 256 ? 2 : 4;" in src
    for nt in (32, 64, 128, 256):
        assert (128, nt) in tiles and (64, nt) in tiles
        assert ic.WGMMA_CONST["kStepAlign"] % ic.wgmma_stage_steps(nt) == 0
        if nt == 256:
            assert (128, nt // 2) in tiles and (64, nt // 2) in tiles
    # 256 rows: two warpgroups of two m64 tiles, A from shared memory
    assert {bn for bm, bn in tiles if bm == 256} == {32, 64}
    assert [ic.wgmma_n_tile(c) for c in (1, 26, 32, 33, 52, 64, 65, 104,
                                         129, 256, 257, 2048)] == [
        32, 32, 32, 64, 64, 64, 128, 128, 256, 256, 256, 256]


def test_wrappers_find_their_launchers():
    """Every launcher the wrappers bind is an ``extern "C"`` function of
    the source it is bound from (a missing one would fail only on the
    card)."""
    csrc = REPO / "udp_pose_tpu_torch/csrc"
    exported = {name: set(re.findall(r'extern "C" int (\w+)\(',
                                     (csrc / f"{name}.cu").read_text()))
                for name in ("int8_conv", "int8_conv_sm90")}
    wrappers = (REPO / "udp_pose_tpu_torch/ops/int8_conv.py").read_text()
    bound = set(re.findall(r'_kernel\("(\w+)"', wrappers))
    assert bound == {"int8_conv_fused_launch", "quant_im2col_launch",
                     "dequant_epilogue_launch", "int8_conv_wgmma_launch"}
    assert bound - {"int8_conv_wgmma_launch"} <= exported["int8_conv"]
    assert exported["int8_conv_sm90"] == {"int8_conv_wgmma_launch"}
    assert re.search(r'_kernel\("int8_conv_wgmma_launch", \w+, '
                     r'"int8_conv_sm90"\)', wrappers)


def test_fused_args_mirror_the_c_struct():
    """``FusedArgs`` has the fields of ``struct FusedArgs`` in both
    sources (``int8_conv.cu``'s launcher and the Hopper engine's), in
    order and of the same C types."""
    for source in ("int8_conv", "int8_conv_sm90"):
        _fused_args_mirror(
            (REPO / f"udp_pose_tpu_torch/csrc/{source}.cu").read_text())


def _fused_args_mirror(src):
    body = re.search(r"struct FusedArgs \{(.*?)\};", src, re.S).group(1)
    ctype = {"long long": ctypes.c_longlong, "const void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if decl:
            kind = next(k for k in ctype if decl.startswith(k + " "))
            fields += [(n.strip(), ctype[kind])
                       for n in decl[len(kind):].split(",")]
    assert ic.FusedArgs._fields_ == fields


NET_YAMLS = {
    "w32": "hrnet_w32_256x192_udp_offset",
    "rsn18": "rsn18_256x192",
    "pose_resnet50": "resnet50_256x192_gaussian",
    "mobilenetv3_small": "mobilenetv3_small_256x192",
    "mobilevit_s": "mobilevit_s_256x192_pixel_shuffle",
    "mobilevitv2_05": "mobilevitv2_05_256x192_pixel_shuffle",
    "shufflenetv2_10x": "shufflenetv2_10x_256x192_pixel_shuffle",
    "shufflenetv2_plus_small": "shufflenetv2_plus_small_256x192",
}


@lru_cache(maxsize=None)
def _sites(net):
    """(conv, input shape, ``_loads`` of its input) of each dense int8
    site, in call order, of a B=1 forward of the full-width net on the
    CPU in float32 (the shapes and layouts are the bf16 net's;
    ``chip_smoke.int8_sites``'s hooks: the sites ``DEFAULT_SKIP`` leaves
    in int8; depthwise sites have their own kernel).  YOLOv5n's float
    model is NCHW; its int8 convs hand on channels-last outputs, so every
    site but the stem sees a dense channels-last input: all are taken as
    "dense", as on the card."""
    from udp_pose_tpu_torch.config import load_config
    from udp_pose_tpu_torch.models import build_detector, build_model
    from udp_pose_tpu_torch.utils.convert import conv_sites
    if net == "yolov5n":
        model = build_detector("yolov5n", device="cpu")
        x = torch.zeros(1, 3, 384, 640)
    else:
        cfg = load_config(str(REPO / f"configs/coco/{NET_YAMLS[net]}.yaml"))
        cfg.TPU.DTYPE = "float32"
        model = build_model(cfg, device="cpu")
        w, h = cfg.MODEL.IMAGE_SIZE
        x = torch.zeros(1, 3, h, w).contiguous(
            memory_format=torch.channels_last)
    sites, seen, hooks = conv_sites(model), [], []
    for name, mod in model.named_modules():
        if (name in sites and not tq._matches(sites[name], tq.DEFAULT_SKIP)
                and not tq.is_depthwise(mod)):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args: seen.append((m, tuple(args[0].shape),
                                             "dense" if net == "yolov5n"
                                             else ic._loads(args[0])))))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


W32_PR6 = {"gather": 1, "vec": 79, "shift": 213}
# the engine walks w32's 64x48 and, at 256 crops, 32x24 3x3 convs; where
# it would not walk, those stay on the shift route
W32_FOLD = {"gather": 1, "vec": 79, "shift": 1, "wgmma": 212, "walks": 132}
W32_128 = {"gather": 1, "vec": 79, "shift": 65, "wgmma": 148, "walks": 68}
W32_FRAME = {"gather": 1, "vec": 79, "shift": 133, "wgmma": 80}


def _case(net, batch, dtype, sms, routes, pr6, id=None):
    return pytest.param(net, batch, dtype, sms, routes, pr6, id=id or
                        f"{net}-{batch}-{str(dtype)[6:]}-{sms}")


BF16 = torch.bfloat16


@pytest.mark.parametrize("net,batch,dtype,sms,routes,pr6", [
    _case("w32", 256, BF16, 132, W32_FOLD, dict(W32_PR6, wide=124),
          "w32-256-dtype0-132-routes0"),
    _case("w32", 128, BF16, 114, W32_128, dict(W32_PR6, wide=68),
          "w32-128-dtype1-114-routes1"),
    _case("w32", 16, BF16, 132, W32_FRAME, dict(W32_PR6, wide=0),
          "w32-16-dtype2-132-routes2"),
    _case("yolov5n", 1, torch.float32, 132, {"gather": 1, "vec": 56},
          {"gather": 1, "vec": 56, "wide": 0},
          "yolov5n-1-dtype3-132-routes3"),
    _case("w32", 32, BF16, 132, W32_FRAME, dict(W32_PR6, wide=4)),
    _case("pose_resnet50", 128, BF16, 132,
          {"gather": 1, "vec": 39, "wgmma": 13, "walks": 3},
          {"gather": 1, "vec": 39, "shift": 13, "wide": 11}),
    _case("rsn18", 256, BF16, 132,
          {"gather": 9, "vec": 30, "wgmma": 72, "walks": 36},
          {"gather": 54, "vec": 57, "wide": 0}),
    _case("mobilenetv3_small", 256, BF16, 132,
          {"gather": 1, "vec": 40},
          {"gather": 1, "vec": 40, "wide": 0}),
    _case("mobilevit_s", 256, BF16, 132,
          {"gather": 20, "vec": 11, "shift": 1},
          {"gather": 20, "vec": 11, "shift": 1, "wide": 1}),
    _case("mobilevitv2_05", 256, BF16, 132,
          {"gather": 14, "vec": 9},
          {"gather": 14, "vec": 9, "wide": 0}),
    _case("shufflenetv2_10x", 256, BF16, 132,
          {"gather": 28, "vec": 10, "wgmma": 3, "walks": 1},
          {"gather": 28, "vec": 10, "shift": 3, "wide": 3}),
    _case("shufflenetv2_plus_small", 256, BF16, 132,
          {"gather": 39, "vec": 33},
          {"gather": 39, "vec": 33, "wide": 0})])
def test_fused_tiling_takes_every_int8_site(net, batch, dtype, sms, routes,
                                            pr6):
    """Every dense int8 site of the nets, as the card runs them (their
    inputs' layouts, bf16 at the fold batch, w32 also at 128 crops on a
    114-SM card and at one frame's 16 crops with the flip, YOLOv5n in
    float32), gets a route and tiling of the kernels and the weights the
    launchers want (K_pad a multiple of 32 and at least K, N_pad at least
    Cout; the packed weight where the conv has the Hopper engine's
    geometry), so that no shape of theirs raises on the card: the
    stride-1 "same" convs larger than 1×1 of dense channels-last bf16
    activations, any C, take the engine ("walks": blocks that walk
    tiles), RSN's C = 26 and 52 3×3 convs among them, but for the shapes
    of ``WGMMA_SLOWER`` and, at NT <= 64, where the older kernel's shift
    route would take them and the engine's blocks would not walk; the
    rest the older kernel; ``pr6``: the routes PR 6's design takes without
    the engine ("wide": its shift route's blocks of twice the rows)."""
    got = dict.fromkeys(routes, 0)
    old = dict.fromkeys(pr6, 0)
    got.setdefault("walks", 0)
    for conv, (_, C, H, W), loads in _sites(net):
        geometry = (conv.out_channels, conv.kernel_size, conv.stride,
                    conv.padding, loads, dtype, sms)
        t = ic.fused_tiling((batch, C, H, W), *geometry)
        p = ic.fused_tiling((batch, C, H, W), *geometry, wgmma=False)
        assert (p.block_m, p.block_n) == ic.FUSED_TILES[p.tile]
        # the narrowest block that holds Cout, up to 128 columns
        assert p.block_n == min(bn for _, bn in ic.FUSED_TILES
                                if bn >= min(conv.out_channels, 128))
        wide = (p.block_m // 2, p.block_n) in ic.FUSED_TILES
        if p.route == "shift":
            assert conv.padding[0] * W + conv.padding[1] <= ic.MAX_HALO \
                and conv.stride == (1, 1) and C % 32 == 0
        else:
            assert not wide
        old[p.route] += 1
        old["wide"] += wide
        layer = tq.Int8Conv2d(conv, 1.0)
        K = C * conv.kernel_size[0] * conv.kernel_size[1]
        assert layer.w_gemm.shape == (ic.gemm_pad(conv.out_channels),
                                      ic.k_tile_pad(K))
        assert layer.k_pad % ic.K_TILE == 0 and layer.k_pad % 8 == 0
        if t.route == "wgmma":
            assert ic.wgmma_takes(C, conv.kernel_size, conv.stride,
                                  conv.padding, loads, dtype)
            assert (t.block_m, t.block_n) == ic.WGMMA_TILES[t.tile]
            plan = ic.wgmma_plan((batch, C, H, W), conv.out_channels,
                                 conv.kernel_size, sms)
            assert plan[:5] == (t.tile, t.block_m, t.block_n, t.ring,
                                t.tiles_per_block)
            assert plan.smem <= ic.WGMMA_CONST["kMaxSmem"]
            pack = ic.wgmma_n_tile(conv.out_channels)
            assert layer.w_packed.numel() == (
                -(-conv.out_channels // pack) * pack * ic.K_TILE
                * ic.wgmma_k_steps(C, conv.kernel_size))
            got["walks"] += t.tiles_per_block > 1
            assert not (p.route == "shift" and t.block_n <= 64
                        and t.tiles_per_block == 1)
        else:
            assert t == p
        got[t.route] += 1
    assert got == dict({"walks": 0}, **routes)
    assert old == pr6
    # an NCHW input (the detector's letterboxed canvas) takes the gather,
    # a channels-last view that is not dense the 16-byte loads, float32
    # the older kernel
    def route(C, loads, dtype=torch.bfloat16):
        return ic.fused_tiling((2, C, 30, 40), 32, (3, 3), (1, 1), (1, 1),
                               loads, dtype, 132).route

    assert route(16, "scalar") == "gather"
    assert route(32, "vec") == "vec"
    assert route(26, "dense") == "wgmma"
    # C % 32 == 0 at NT 32: the shift route, unless the engine's blocks
    # walk tiles (a map of many tiles)
    assert route(32, "dense") == "shift"
    assert ic.fused_tiling((256, 32, 64, 48), 32, (3, 3), (1, 1), (1, 1),
                           "dense", BF16, 132).route == "wgmma"
    assert route(32, "dense", torch.float32) == "vec"
    assert route(26, "dense", torch.float32) == "gather"
    # 1x1 convs and the shapes measured slower stay on PR 6's routes
    assert ic.fused_tiling((2, 64, 30, 40), 256, (1, 1), (1, 1), (0, 0),
                           "dense", BF16, 132).route == "vec"
    for C, Cout, kh, kw, H, W in ic.WGMMA_SLOWER:
        assert ic.fused_tiling((256, C, H, W), Cout, (kh, kw), (1, 1),
                               (kh // 2, kw // 2), "dense", BF16,
                               132).route == "shift"


def test_loads_of_a_layout():
    """``_loads`` tells dense channels-last (any C, dims of size 1 in any
    stride, a 16-byte aligned base) from other channels-last views and
    from NCHW."""
    x = torch.zeros(2, 32, 6, 5)
    assert ic._loads(x) == "scalar"
    cl = x.contiguous(memory_format=torch.channels_last)
    assert ic._loads(cl) == "dense"
    assert ic._loads(cl[:, :, 1:5]) == "vec"
    assert ic._loads(cl[:, 3:]) == "scalar"
    odd = torch.zeros(2, 26, 6, 5).contiguous(
        memory_format=torch.channels_last)
    assert ic._loads(odd) == "dense"
    assert ic._loads(odd[:, :, 1:5]) == "scalar"
    pooled = torch.zeros(4, 40, 1, 1).as_strided((4, 40, 1, 1),
                                                 (40, 1, 1, 1))
    assert ic._loads(pooled) == "dense"
    buf = torch.zeros(2 * 6 * 5 * 32 + 4)
    assert ic._loads(buf[4:].view(2, 6, 5, 32).permute(0, 3, 1, 2)) \
        == "dense"
    assert ic._loads(buf[2:-2].view(2, 6, 5, 32).permute(0, 3, 1, 2)) \
        == "scalar"


def _counters():
    return (ic.int8_conv_fused.launches, ic.quant_im2col.launches,
            ic.dequant_epilogue.launches, po.udp_offset_decode_fused.launches,
            po.fused_peak_offset.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_cpu_route_is_the_plain_version(dtype, channels_last):
    """On the CPU ``int8_conv2d`` and ``Int8Conv2d`` return the plain
    result and launch nothing; the fused wrapper raises on a CPU tensor
    and on a dtype the kernel does not take."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(2, 16, 9, 7, generator=g) * 2).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    conv = torch.nn.Conv2d(16, 24, 3, 2, 1, bias=True)
    layer = tq.Int8Conv2d(conv, 4.0)
    before = _counters()
    want = ic.int8_conv_fused_reference(x, layer)
    for got in (ic.int8_conv2d(x, layer), layer(x)):
        assert torch.equal(got, want)
        assert got.is_contiguous(memory_format=torch.channels_last)
    assert _counters() == before
    with pytest.raises(ValueError, match="CUDA"):
        ic.int8_conv_fused(x, layer)
    with pytest.raises(TypeError):
        ic.int8_conv_fused(x.half(), layer)
    with pytest.raises(TypeError):
        ic.int8_conv_fused(x[0], layer)
    assert _counters() == before
