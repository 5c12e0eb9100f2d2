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
