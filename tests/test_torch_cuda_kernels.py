"""The port's CUDA kernels against their plain versions, bit for bit, on
the card.  Skips without CUDA; imports nothing of JAX, so that it runs on
a host with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from udp_pose_tpu_torch.ops import peak_offset as po

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _same_bits(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _net(rng, B, Jn, H, W):
    net = rng.standard_normal((B, 3 * Jn, H, W)).astype(np.float32)
    net[:, 0::3] += np.float32(3.0) * (rng.random((B, Jn, H, W)) > 0.999)
    net[0, 0] = 0.5                     # constant map: ties everywhere
    net[-1, 3] = -np.abs(net[-1, 3])    # peak <= 0: masked
    net[0, 3, 2, 3] = np.nan            # NaN row
    return torch.from_numpy(net)


@pytest.mark.parametrize("shape", [(3, 17, 64, 48), (2, 17, 96, 72),
                                   (2, 5, 20, 13), (1, 2, 8, 8)])
@pytest.mark.parametrize("channels_last", [False, True])
def test_fused_decode_kernel_equals_plain_version(cuda, shape,
                                                  channels_last):
    net = _net(np.random.default_rng(sum(shape)), *shape).to(cuda)
    if channels_last:
        net = net.contiguous(memory_format=torch.channels_last)
    before = po.udp_offset_decode_fused.launches
    peak_before = po.fused_peak_offset.launches
    got = po.udp_offset_decode_fused(net, 4.0)
    want = po.udp_offset_decode_reference(net, 4.0)
    torch.cuda.synchronize()
    assert po.udp_offset_decode_fused.launches == before + 1
    assert po.fused_peak_offset.launches == peak_before
    assert got.shape == (shape[0], shape[1], 5)
    assert _same_bits(got, want)


def test_peak_only_kernel_equals_plain_version(cuda):
    rng = np.random.default_rng(1)
    hm = torch.from_numpy(rng.standard_normal((70, 64, 48)).astype(
        np.float32)).to(cuda)
    hm[3] = 0.25
    hm[4] = -1.0
    hm[5, 10, 10] = float("nan")
    ox, oy = torch.randn_like(hm), torch.randn_like(hm)
    before = po.fused_peak_offset.launches
    got = po.fused_peak_offset(hm, ox, oy)
    want = po.fused_peak_offset_reference(hm, ox, oy)
    torch.cuda.synchronize()
    assert po.fused_peak_offset.launches == before + 1
    assert _same_bits(got, want)


@pytest.mark.parametrize("batch", [16, 8 * 16])
def test_fused_decode_at_the_detect_then_pose_shapes(cuda, batch):
    """The fused decode as the detect-then-pose engine calls it: the
    ``max_persons`` = 16 crops of one frame, and 8 frames of them in one
    ``infer_frames`` chunk; channels-last as the model hands it over."""
    net = _net(np.random.default_rng(batch), batch, 17, 64, 48).to(cuda)
    net = net.contiguous(memory_format=torch.channels_last)
    before = po.udp_offset_decode_fused.launches
    got = po.udp_offset_decode_fused(net, 4.0)
    want = po.udp_offset_decode_reference(net, 4.0)
    torch.cuda.synchronize()
    assert po.udp_offset_decode_fused.launches == before + 1
    assert _same_bits(got, want)


def test_nms_torch_on_the_card_equals_the_cpu(cuda):
    from udp_pose_tpu_torch.ops.nms import nms_torch, nms_torch_batched
    rng = np.random.default_rng(3)
    F, n = 4, 512
    xy = rng.uniform(0, 600, (F, n, 2)).astype(np.float32)
    wh = rng.uniform(10, 120, (F, n, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1))
    scores = torch.from_numpy(rng.integers(0, 50, (F, n)).astype(
        np.float32) / 50)                                  # many ties
    scores[:, 400:] = -torch.inf
    scores[2] = -torch.inf                                 # an empty frame
    want = nms_torch_batched(boxes, scores, 0.45, 16, plus_one=False)
    got = nms_torch_batched(boxes.to(cuda), scores.to(cuda), 0.45, 16,
                            plus_one=False)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    one = nms_torch(boxes[0].to(cuda), scores[0].to(cuda), 0.45, 16)
    assert torch.equal(one[0].cpu(), nms_torch(boxes[0], scores[0], 0.45,
                                               16)[0])


@pytest.mark.parametrize("case", [
    # (N, C, H, W, kernel, stride, padding, Cout, bias, dtype, channels_last)
    (4, 64, 32, 24, 3, 1, 1, 64, False, torch.bfloat16, True),
    (2, 3, 256, 192, 3, 2, 1, 64, False, torch.bfloat16, True),
    (2, 256, 8, 6, 1, 1, 0, 128, False, torch.bfloat16, True),
    (1, 3, 96, 128, 6, 2, 2, 16, False, torch.float32, False),
    (3, 36, 10, 9, 1, 1, 0, 20, True, torch.float32, True),
    (2, 12, 7, 5, 3, 2, 1, 10, True, torch.bfloat16, False),
    (2, 16, 9, 7, 3, 1, 1, 256, True, torch.bfloat16, True),
    (1, 32, 3, 3, 3, 2, 1, 40, True, torch.float32, True),
    (1, 32, 3, 3, 3, 1, 1, 24, True, torch.bfloat16, True),
    (2, 64, 20, 15, 3, 1, 1, 130, True, torch.bfloat16, True),
    (64, 32, 64, 48, 3, 1, 1, 32, False, torch.bfloat16, True),
    (96, 64, 32, 24, 3, 1, 1, 64, False, torch.bfloat16, True),
    (176, 128, 16, 12, 3, 1, 1, 128, True, torch.bfloat16, True),
])
def test_int8_conv_kernels_equal_plain_versions(cuda, case):
    """quant_im2col and dequant_epilogue on the card against their plain
    versions, bit for bit, ``torch._int_mm`` against the CPU's exact
    integer product, and the fused kernel, which ``Int8Conv2d`` launches
    on the card, against both that three-step card path and its plain
    version: w32 shapes (bf16, channels-last), YOLOv5's 6×6 stem on an
    NCHW image, odd channel counts (scalar epilogue), bias, strided input,
    two column blocks (Cout 256) and fewer than 17 output pixels; the
    shift route's 3×3 stride-1 convs at those edges too (9 pixels, Cout
    130), at 64 crops of w32's 64×48 branch, and in both of its blocks
    of twice the rows (w32's 3×3 convs of 64 and 128 channels at
    batches that have two such blocks an SM), each a launch at the
    tiling that ``fused_tiling`` gives it."""
    from udp_pose_tpu_torch.models.quantize import Int8Conv2d
    from udp_pose_tpu_torch.ops import int8_conv as ic
    N, C, H, W, k, s, p, O, bias, dtype, channels_last = case
    g = torch.Generator().manual_seed(sum(case[:8]))
    x = (torch.randn(N, C, H, W, generator=g) * 3).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    conv = torch.nn.Conv2d(C, O, k, s, p, bias=bias)
    layer = Int8Conv2d(conv, float(x.float().abs().amax()) * 0.8)
    Ho, Wo = ic.conv_out_hw(H, W, layer.kernel_size, layer.stride,
                            layer.padding)
    M = N * Ho * Wo
    args = (layer.inv_s_a, layer.kernel_size, layer.stride, layer.padding,
            layer.k_pad)
    want_a = ic.quant_im2col(x, *args)
    want_acc = ic.int8_gemm(want_a, layer.w_gemm)
    want_y = ic.dequant_epilogue(want_acc, layer.scale, layer.bias, dtype,
                                 M, O)
    want_out = ic.int8_conv_fused_reference(x, layer)
    layer, xc = layer.to(cuda), x.to(cuda)
    counts = (ic.quant_im2col.launches, ic.dequant_epilogue.launches,
              ic.int8_conv_fused.launches)
    a = ic.quant_im2col(xc, *args)
    acc = ic.int8_gemm(a, layer.w_gemm)
    y = ic.dequant_epilogue(acc, layer.scale, layer.bias, dtype, M, O)
    out = layer(xc)
    torch.cuda.synchronize()
    tiling = ic.fused_tiling(
        xc.shape, O, layer.kernel_size, layer.stride, layer.padding,
        ic._loads(xc), dtype,
        torch.cuda.get_device_properties(xc.device).multi_processor_count)
    assert (tiling.route == "shift") == (channels_last and s == 1
                                         and k == 3 and C % 32 == 0
                                         and dtype == torch.bfloat16)
    assert (ic.quant_im2col.launches, ic.dequant_epilogue.launches,
            ic.int8_conv_fused.launches) == (counts[0] + 1, counts[1] + 1,
                                             counts[2] + 1)
    assert torch.equal(a.cpu(), want_a)
    assert torch.equal(acc.cpu(), want_acc)
    assert torch.equal(y.cpu(), want_y)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert out.dtype == dtype
    assert torch.equal(out.permute(0, 2, 3, 1).reshape(M, O), y)
    assert torch.equal(out.cpu(), want_out)
    assert torch.equal(ic.int8_conv_fused_reference(xc, layer).cpu(),
                       want_out)


def test_int_mm_shape_rules(cuda):
    """What ``torch._int_mm`` takes on the card, which the int8 conv pads
    its GEMM to (``ops/int8_conv.gemm_rows``, ``gemm_pad``): more than 16
    rows, K and N multiples of 8, the second operand column-major; any
    row count above 16, odd ones included."""
    from udp_pose_tpu_torch.ops import int8_conv as ic
    assert ic.gemm_rows(16) == 17 and ic.gemm_pad(27) == 32
    g = torch.Generator().manual_seed(5)

    def mm(m, k, n):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        got = torch._int_mm(a.to(cuda), w.to(cuda).t())
        return torch.equal(got.cpu(), ic.int8_gemm(a, w))

    assert all(mm(*s) for s in ((17, 32, 8), (1001, 576, 64), (20, 40, 24)))
    for m, k, n in ((16, 32, 8), (24, 27, 8), (24, 32, 12)):
        with pytest.raises(RuntimeError):
            mm(m, k, n)


DW_CASES = [
    # (N, C, H, W, kernel, stride, bias, dtype, view, route/bytes)
    (4, 16, 128, 96, 3, 2, False, torch.bfloat16, "channels_last",
     "channels_last/16B"),
    (4, 576, 8, 6, 5, 1, False, torch.bfloat16, "channels_last",
     "channels_last/16B"),
    (4, 96, 32, 24, 5, 2, False, torch.float32, "channels_last",
     "channels_last/16B"),
    (3, 18, 17, 13, 3, 1, False, torch.bfloat16, "channels_last",
     "channels_last/4B"),
    (1, 58, 16, 12, 7, 1, True, torch.bfloat16, "channels_last",
     "channels_last/4B"),
    (3, 116, 16, 12, 3, 2, False, torch.bfloat16, "channels_last",
     "channels_last/8B"),
    (3, 58, 16, 12, 3, 2, False, torch.bfloat16, "odd_channels",
     "split/8B"),
    (1, 18, 64, 48, 5, 1, True, torch.bfloat16, "odd_channels", "split/8B"),
    (3, 208, 8, 6, 3, 1, False, torch.bfloat16, "odd_channels",
     "split/16B"),
    (2, 24, 9, 7, 9, 2, True, torch.float32, "even_channels", "split/16B"),
    (2, 36, 64, 48, 5, 2, False, torch.bfloat16, "odd_channels",
     "split/16B"),
    (2, 52, 10, 9, 7, 1, True, torch.float32, "channel_slice",
     "channels_last/4B"),
    (1, 13, 11, 9, 3, 1, False, torch.bfloat16, "channel_slice",
     "channels_last/2B"),
    (2, 104, 12, 9, 7, 2, False, torch.bfloat16, "nchw", "nchw/2B"),
    (3, 384, 16, 12, 3, 1, True, torch.bfloat16, "nchw", "nchw/8B"),
    (1, 256, 8, 6, 5, 2, False, torch.bfloat16, "nchw", "nchw/4B"),
    (2, 40, 32, 24, 9, 1, False, torch.float32, "nchw", "nchw/16B"),
    (2, 32, 16, 12, 9, 1, True, torch.bfloat16, "channels_last",
     "channels_last/16B"),
    (1, 40, 3, 2, 9, 2, True, torch.float32, "channels_last",
     "channels_last/16B"),
    (3, 72, 2, 5, 7, 1, True, torch.bfloat16, "channels_last",
     "channels_last/16B"),
    (2, 72, 19, 21, 3, 1, True, torch.bfloat16, "channels_last",
     "channels_last/16B"),
    (1, 64, 40, 300, 3, 1, False, torch.bfloat16, "channels_last",
     "channels_last/16B"),
    (3, 32, 24, 150, 5, 2, True, torch.float32, "odd_channels",
     "split/16B"),
]


def _dw_case(case, device):
    """A seeded activation of the case's layout on the CPU and on
    ``device`` (the same strides, base offsets and storage), and its
    layer."""
    from udp_pose_tpu_torch.models.quantize import Int8DepthwiseConv2d
    N, C, H, W, k, s, bias, dtype, view = case[:9]
    g = torch.Generator().manual_seed(sum(case[:6]))
    wide = (torch.randn(N, 2 * C, H, W, generator=g) * 3).to(dtype)
    wide = wide.contiguous(memory_format=torch.channels_last)

    def view_of(t):
        return {"channels_last": t[:, :C].contiguous(
                    memory_format=torch.channels_last),
                "odd_channels": t[:, 1::2], "even_channels": t[:, 0::2],
                "channel_slice": t[:, 5:5 + C] if C % 2 else t[:, 7:7 + C],
                "nchw": t[:, :C].contiguous()}[view]

    x, xc = view_of(wide), view_of(wide.to(device))
    assert xc.stride() == x.stride()
    conv = torch.nn.Conv2d(C, C, k, s, (k - 1) // 2, groups=C, bias=bias)
    return x, xc, Int8DepthwiseConv2d(conv,
                                      float(x.float().abs().amax()) * 0.8)


@pytest.mark.parametrize("case", DW_CASES)
def test_int8_dwconv_kernel_equals_plain_version(cuda, case):
    """The launch, which ``Int8DepthwiseConv2d`` makes on the card,
    against its plain version on the card and on the CPU, bit for bit, on
    every load route and width (channels-last 16, 8, 4 and 2 bytes, the
    even/odd channel-split views, NCHW rows), k = 3, 5, 7, 9 and s = 1,
    2, the mobile nets' shapes, RSN's PRM 9×9 with a bias, maps narrower
    and shorter than one 8×8 tile and than a kernel's k rows, rows of
    many tiles, and batches of 1, 2, 3 and 4."""
    from udp_pose_tpu_torch.ops import int8_dwconv as dw
    x, xc, layer = _dw_case(case, cuda)
    want = dw.int8_dwconv_reference(x, layer)
    layer = layer.to(cuda)
    plan = dw.launch_plan(xc, layer)
    assert plan.label == case[9]
    before = (dw.int8_dwconv.launches, dw.int8_dwconv_tiled.launches)
    out = layer(xc)
    torch.cuda.synchronize()
    assert (dw.int8_dwconv.launches,
            dw.int8_dwconv_tiled.launches) == (before[0] + 1, before[1])
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert out.dtype == case[7]
    assert torch.equal(out.cpu(), want)
    assert torch.equal(dw.int8_dwconv_reference(xc, layer).cpu(), want)


def test_int8_dwconv_tiled_yardstick_equals_plain_version(cuda):
    """The previous design, kept as the launch's yardstick, is still bit-equal
    to the plain version (one channel-split shape)."""
    from udp_pose_tpu_torch.ops import int8_dwconv as dw
    x, xc, layer = _dw_case(DW_CASES[6], cuda)
    want = dw.int8_dwconv_reference(x, layer)
    layer = layer.to(cuda)
    before = dw.int8_dwconv_tiled.launches
    out = dw.int8_dwconv_tiled(xc, layer)
    torch.cuda.synchronize()
    assert dw.int8_dwconv_tiled.launches == before + 1
    assert torch.equal(out.cpu(), want)


def test_int8_dwconv_refuses_a_layout_without_a_route(cuda):
    """A channel stride of 3 with no unit W stride has no load route: the
    wrapper raises and launches nothing."""
    from udp_pose_tpu_torch.ops import int8_dwconv as dw
    x, xc, layer = _dw_case(DW_CASES[3], cuda)
    layer = layer.to(cuda)
    wide = torch.zeros(1, 54, 8, 8, device=cuda).contiguous(
        memory_format=torch.channels_last)[:, ::3]
    before = dw.int8_dwconv.launches
    with pytest.raises(ValueError, match="load route"):
        layer(wide)
    assert dw.int8_dwconv.launches == before
