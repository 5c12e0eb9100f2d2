"""The port's peak + offset decode against the JAX package.

On the CPU ``fused_peak_offset`` runs its plain version; the CUDA kernel
itself is held against that plain version on the card by
``chip_smoke.py``.  The port follows ``ops/decode.udp_offset_decode``,
not the Pallas wrapper: where a heatmap's peak is <= 0 the two differ.
"""

import numpy as np
import pytest
import torch

from udp_pose_tpu.ops import decode as jax_decode
from udp_pose_tpu.ops.pallas.decode_kernels import (
    fused_peak_offset as jax_fused_peak_offset, udp_offset_decode_pallas)
from udp_pose_tpu_torch.ops import peak_offset
from udp_pose_tpu_torch.ops.decode import udp_offset_decode
from udp_pose_tpu_torch.ops.peak_offset import (fused_peak_offset,
                                                fused_peak_offset_reference)


def _peaky(rng, N=6, H=64, W=48):
    """The peaky positive maps of tests/test_pallas_kernels.py."""
    maps = rng.uniform(0, 0.1, (N, H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    for i in range(N):
        cy, cx = rng.uniform(4, H - 4), rng.uniform(4, W - 4)
        maps[i] += np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / 8.0
                          ).astype(np.float32)
    return maps


def test_cpu_path_equals_pallas_interpret_on_peaky_maps():
    """Same inputs as tests/test_pallas_kernels.py; every output exact
    (the Pallas select-reduce adds zeros to the one selected offset)."""
    rng = np.random.default_rng(130)
    hm = _peaky(rng)
    ox = rng.normal(size=hm.shape).astype(np.float32)
    oy = rng.normal(size=hm.shape).astype(np.float32)
    gold = np.asarray(jax_fused_peak_offset(hm, ox, oy, interpret=True))
    before = fused_peak_offset.launches
    out = fused_peak_offset(*map(torch.from_numpy, (hm, ox, oy)))
    assert fused_peak_offset.launches == before    # no kernel on the CPU
    assert out.shape == (6, 5) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), gold)


def test_decode_matches_pallas_wrapper_on_peaky_maps():
    rng = np.random.default_rng(131)
    B, J, H, W = 2, 3, 64, 48
    net = rng.uniform(-0.5, 0.5, (B, 3 * J, H, W)).astype(np.float32)
    net[:, 0::3] = _peaky(rng, B * J, H, W).reshape(B, J, H, W)
    gold_c, gold_v = udp_offset_decode_pallas(net, 4.0, interpret=True)
    c, v = udp_offset_decode(torch.from_numpy(net), 4.0)
    np.testing.assert_allclose(v.numpy(), np.asarray(gold_v), rtol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(gold_c),
                               rtol=0, atol=1e-4)


def test_nonpositive_peaks_follow_xla_decode_not_pallas_wrapper():
    """All-negative heatmaps: the peak is masked to (0, 0) and the
    offsets are read there (ops/decode.py:107-111).  The Pallas wrapper
    reads them at the unmasked argmax, so it disagrees."""
    rng = np.random.default_rng(0)
    B, J, H, W = 1, 2, 64, 48
    net = rng.uniform(-1.0, 1.0, (B, 3 * J, H, W)).astype(np.float32)
    net[:, 0::3] = -rng.uniform(0.05, 1.0, (B, J, H, W))
    gold_c, gold_v = jax_decode.udp_offset_decode(net, 4.0)
    pallas_c, _ = udp_offset_decode_pallas(net, 4.0, interpret=True)
    c, v = udp_offset_decode(torch.from_numpy(net), 4.0)
    assert (v.numpy() <= 0).all()
    np.testing.assert_allclose(v.numpy(), np.asarray(gold_v), rtol=1e-6)
    # blurs in another summation order: 1e-5 heatmap px
    np.testing.assert_allclose(c.numpy(), np.asarray(gold_c),
                               rtol=0, atol=1e-5)
    assert np.abs(np.asarray(pallas_c) - np.asarray(gold_c)).max() > 0.1


def test_reference_semantics_ties_nan_inf():
    """Ties go to the lowest flat index; a NaN is the max and masks the
    peak; an all -inf map masks too; offsets are read at index 0 when
    masked."""
    N, H, W = 4, 3, 5
    hm = torch.full((N, H, W), -1.0)
    hm[0, 1, 2] = hm[0, 2, 0] = 7.0            # tie: flat 7 and 10
    hm[1, 0, 4] = 5.0
    hm[1, 2, 3] = float("nan")
    hm[2] = float("-inf")
    hm[3, 2, 4] = 0.0                          # peak exactly 0: masked
    ox = torch.arange(N * H * W, dtype=torch.float32).reshape(N, H, W)
    oy = -ox
    out = fused_peak_offset_reference(hm, ox, oy)
    np.testing.assert_array_equal(out[0].numpy(), [2, 1, 7, 7, -7])
    assert torch.isnan(out[1, 2])
    np.testing.assert_array_equal(out[1, [0, 1, 3, 4]].numpy(),
                                  [0, 0, 15, -15])
    np.testing.assert_array_equal(out[2].numpy(),
                                  [0, 0, -np.inf, 30, -30])
    np.testing.assert_array_equal(out[3].numpy(), [0, 0, 0, 45, -45])


def test_kernel_input_checks():
    """What the CUDA wrapper refuses before a launch."""
    good = torch.zeros(2, 4, 4)
    with pytest.raises(TypeError, match="float32"):
        peak_offset._check(good, good.double(), good)
    with pytest.raises(ValueError, match="contiguous"):
        peak_offset._check(good, good, torch.zeros(2, 4, 4).transpose(1, 2))
    with pytest.raises(ValueError, match=r"\(N, H, W\)"):
        peak_offset._check(good, torch.zeros(2, 4, 5), good)
    with pytest.raises(ValueError, match="device"):
        fused_peak_offset(good.to("meta"), good.to("meta"), good.to("meta"))
