"""The port's fused UDP offset decode and its ordered blur against the JAX
package, on the CPU.

On the CPU ``udp_offset_decode_fused`` runs its plain version,
``udp_offset_decode_reference``; the CUDA kernel is held against that
plain version bit for bit on the card (``chip_smoke.py`` phase 3b and
``tests/test_torch_cuda_kernels.py``).  The plain version's blurs sum tap
by tap in a fixed order, XLA's einsum in another, so the JAX comparisons
hold the integer peaks exactly, maxvals to 1e-6 (absolute) and coords to
1e-4 px.
"""

import numpy as np
import pytest
import torch

from udp_pose_tpu.ops import blur as jax_blur
from udp_pose_tpu.ops import decode as jax_decode
from udp_pose_tpu.ops.pallas.decode_kernels import (
    fused_peak_offset as jax_fused_peak_offset, udp_offset_decode_pallas)
from udp_pose_tpu_torch.ops import peak_offset
from udp_pose_tpu_torch.ops.blur import (blur_matrix_f64, folded_taps,
                                         separable_blur_reference)
from udp_pose_tpu_torch.ops.decode import udp_offset_decode
from udp_pose_tpu_torch.ops.peak_offset import (fused_peak_offset,
                                                packed_to_coords,
                                                udp_offset_decode_fused,
                                                udp_offset_decode_reference)

KPD = 4.0
J = 3


@pytest.mark.parametrize("ksize", [15, 7])
@pytest.mark.parametrize("hw", [(64, 48), (16, 16), (5, 9), (1, 6)])
def test_separable_blur_reference_matches_jax_and_float64(hw, ksize):
    """(5, 9) and (1, 6) reflect more than once across the 15-tap halo."""
    H, W = hw
    x = np.random.default_rng(ksize * 100 + H).standard_normal(
        (2, 3, H, W)).astype(np.float32)
    got = separable_blur_reference(torch.from_numpy(x), ksize).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    want64 = blur_matrix_f64(H, ksize, 0.0) @ x.astype(np.float64) @ \
        blur_matrix_f64(W, ksize, 0.0).T
    np.testing.assert_allclose(got, want64, rtol=0, atol=1e-5)
    gold = np.asarray(jax_blur.gaussian_blur(x, ksize))
    np.testing.assert_allclose(got, gold, rtol=0, atol=1e-5)


def _reflect(i, n):
    if n == 1:
        return 0
    p = 2 * (n - 1)
    i %= p
    return i if i < n else p - i


def test_separable_blur_reference_sums_in_the_kernels_order():
    """Bit for bit a float32 loop in the order the CUDA kernel sums: the
    W pass, then the H pass, ``k0·x[c] + Σ_t k_t·(x[c−t] + x[c+t])`` with
    t upward and every operation rounded on its own."""
    x = np.random.default_rng(3).standard_normal((9, 11)).astype(np.float32)
    k = folded_taps(15)

    def blur_1d(v):
        n = len(v)
        out = np.empty(n, np.float32)
        for c in range(n):
            acc = np.float32(k[0] * v[c])
            for t in range(1, len(k)):
                pair = np.float32(v[_reflect(c - t, n)] + v[_reflect(c + t, n)])
                acc = np.float32(acc + np.float32(k[t] * pair))
            out[c] = acc
        return out

    rows = np.stack([blur_1d(r) for r in x])
    want = np.stack([blur_1d(c) for c in rows.T]).T
    got = separable_blur_reference(torch.from_numpy(x), 15).numpy()
    np.testing.assert_array_equal(got, want)


def _net(rng, B, kind, H=64, W=48):
    """(B, 3J, H, W) net outputs: offsets ~ N(0, 1); heatmaps by kind."""
    net = rng.standard_normal((B, 3 * J, H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    for b in range(B):
        for j in range(J):
            if kind == "peaky":
                cy, cx = rng.uniform(4, H - 4), rng.uniform(4, W - 4)
                hm = rng.uniform(0, 0.1, (H, W)) + np.exp(
                    -((xs - cx) ** 2 + (ys - cy) ** 2) / 8.0)
            elif kind == "negative":
                hm = -rng.uniform(0.05, 1.0, (H, W))
            else:   # two equal impulses: exact ties in either summation
                hm = np.zeros((H, W))
                y0, x0 = rng.integers(8, H - 24), rng.integers(8, W - 24)
                hm[y0, x0] = hm[y0 + 16, x0 + 16] = 2.0
            net[b, 3 * j] = hm
    return net


def _jax_peaks(net):
    """The JAX package's integer peaks (masked) and maxvals."""
    hm = jax_blur.gaussian_blur(net[:, 0::3], 15)
    preds, maxvals = jax_decode.get_max_preds(hm)
    return np.asarray(preds), np.asarray(maxvals)


@pytest.mark.parametrize("kind", ["peaky", "negative", "ties"])
def test_reference_matches_jax_decode(kind):
    net = _net(np.random.default_rng(7), 2, kind)
    packed = udp_offset_decode_reference(torch.from_numpy(net), KPD).numpy()
    assert packed.shape == (2, J, 5) and packed.dtype == np.float32
    preds, maxvals = _jax_peaks(net)
    np.testing.assert_array_equal(packed[..., 0:2], preds)
    np.testing.assert_allclose(packed[..., 2:3], maxvals, rtol=0, atol=1e-6)
    gold_c, gold_v = jax_decode.udp_offset_decode(net, KPD)
    coords, mv = packed_to_coords(torch.from_numpy(packed))
    np.testing.assert_allclose(coords.numpy(), np.asarray(gold_c), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(mv.numpy(), np.asarray(gold_v), rtol=0,
                               atol=1e-6)
    if kind == "negative":
        assert (packed[..., 0:2] == 0).all() and (packed[..., 2] <= 0).all()
    if kind == "ties":      # the lower of the two impulses wins
        assert (packed[..., 1] >= 8).all() and (packed[..., 1] < 64 - 24).all()


def test_reference_matches_pallas_interpret_on_positive_peaks():
    net = _net(np.random.default_rng(8), 2, "peaky")
    hm = jax_blur.gaussian_blur(net[:, 0::3], 15)
    ox = jax_blur.gaussian_blur(net[:, 1::3] * KPD, 7)
    oy = jax_blur.gaussian_blur(net[:, 2::3] * KPD, 7)
    gold = np.asarray(jax_fused_peak_offset(
        *(np.asarray(m).reshape(2 * J, 64, 48) for m in (hm, ox, oy)),
        interpret=True)).reshape(2, J, 5)
    packed = udp_offset_decode_reference(torch.from_numpy(net), KPD).numpy()
    assert (gold[..., 2] > 0).all()
    np.testing.assert_array_equal(packed[..., 0:2], gold[..., 0:2])
    np.testing.assert_allclose(packed[..., 2:], gold[..., 2:], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(packed[..., 2], gold[..., 2], rtol=0,
                               atol=1e-6)
    gold_c, gold_v = udp_offset_decode_pallas(net, KPD, interpret=True)
    coords, mv = udp_offset_decode(torch.from_numpy(net), KPD)
    np.testing.assert_allclose(coords.numpy(), np.asarray(gold_c), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(mv.numpy(), np.asarray(gold_v), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["peaky", "negative", "ties"])
def test_channels_last_gives_the_same_bits(kind):
    net = torch.from_numpy(_net(np.random.default_rng(9), 2, kind))
    net[0, 3, 5, 7] = float("nan")
    cl = net.contiguous(memory_format=torch.channels_last)
    assert cl.stride(1) == 1
    a = udp_offset_decode_fused(net, KPD)
    b = udp_offset_decode_fused(cl, KPD)
    assert torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0))
    assert torch.isnan(a[0, 1, 2]) and a[0, 1, 0] == 0 and a[0, 1, 1] == 0
    for x, y in zip(udp_offset_decode(net, KPD), udp_offset_decode(cl, KPD)):
        assert torch.equal(x.nan_to_num(-7.0), y.nan_to_num(-7.0))


@pytest.mark.parametrize("shape,dtype,error,match", [
    ((2, 9, 16, 16), torch.float64, TypeError, "float32"),
    ((9, 16, 16), torch.float32, ValueError, r"\(B, 3J, H, W\)"),
    ((2, 8, 16, 16), torch.float32, ValueError, r"\(B, 3J, H, W\)"),
    ((2, 9, 7, 16), torch.float32, ValueError, "8 <= H, W"),
    ((2, 9, 16, 7), torch.float32, ValueError, "8 <= H, W"),
    ((1, 3, 4096, 4096), torch.float32, ValueError, "H\\*W < 2\\*\\*24"),
])
def test_check_net_refusals(shape, dtype, error, match):
    """What the fused kernel's wrapper refuses before a launch (meta
    tensors: no memory, shapes only)."""
    with pytest.raises(error, match=match):
        peak_offset._check_net(torch.empty(shape, dtype=dtype,
                                           device="meta"))


def test_non_cpu_non_cuda_device_is_refused():
    net = torch.empty((1, 9, 16, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        udp_offset_decode_fused(net, KPD)


def test_cpu_calls_launch_no_kernel():
    net = torch.from_numpy(_net(np.random.default_rng(10), 1, "peaky"))
    fused0 = udp_offset_decode_fused.launches
    peak0 = fused_peak_offset.launches
    udp_offset_decode(net, KPD)
    udp_offset_decode_fused(net, KPD)
    fused_peak_offset(*peak_offset.blurred_offset_maps(net, KPD))
    assert udp_offset_decode_fused.launches == fused0
    assert fused_peak_offset.launches == peak0
