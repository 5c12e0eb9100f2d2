"""The port's flip, blur and decode ops against the JAX package, on the
same numpy-seeded inputs on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from udp_pose_tpu.core.infer import COCO_FLIP_PAIRS as JAX_COCO_FLIP_PAIRS
from udp_pose_tpu.ops import blur as jax_blur
from udp_pose_tpu.ops import decode as jax_decode
from udp_pose_tpu.ops import flip as jax_flip
from udp_pose_tpu_torch.core.infer import COCO_FLIP_PAIRS
from udp_pose_tpu_torch.ops import blur, decode, flip


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _peaky(rng, B, J, H, W, negative_joints=()):
    """Gaussian bumps on low noise; the listed (b, j) maps go negative."""
    maps = rng.uniform(0, 0.1, (B, J, H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    for b in range(B):
        for j in range(J):
            cy, cx = rng.uniform(2, H - 2), rng.uniform(2, W - 2)
            maps[b, j] += np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / 8.0)
    for b, j in negative_joints:
        maps[b, j] -= 2.0
    return maps


def test_flip_pairs_are_the_jax_packages():
    assert COCO_FLIP_PAIRS == JAX_COCO_FLIP_PAIRS


def test_flip_back_and_flip_back_offset_exact():
    rng = np.random.default_rng(7)
    hm = rng.normal(size=(2, 17, 8, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        flip.flip_back(_t(hm), COCO_FLIP_PAIRS).numpy(),
        np.asarray(jax_flip.flip_back(jnp.asarray(hm), COCO_FLIP_PAIRS)))
    off = rng.normal(size=(2, 51, 8, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        flip.flip_back_offset(_t(off), COCO_FLIP_PAIRS).numpy(),
        np.asarray(jax_flip.flip_back_offset(jnp.asarray(off),
                                             COCO_FLIP_PAIRS)))


@pytest.mark.parametrize("ksize,sigma", [(7, 0.0), (15, 0.0), (11, 2.0)])
def test_gaussian_blur_matches_jax(ksize, sigma):
    rng = np.random.default_rng(ksize)
    maps = rng.normal(size=(2, 3, 64, 48)).astype(np.float32)
    gold = np.asarray(jax_blur.gaussian_blur(jnp.asarray(maps), ksize,
                                             sigma))
    out = blur.gaussian_blur(_t(maps), ksize, sigma)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), gold, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        blur.blur_matrix_f64(64, ksize, sigma).astype(np.float32),
        jax_blur._blur_matrix(64, ksize, sigma))


def _center_scale(rng, B):
    center = rng.uniform(100, 300, (B, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32)
    return center, scale


@pytest.mark.parametrize("target_type", ["offset", "gaussian"])
def test_get_final_preds_matches_jax(target_type):
    """Integer peaks exact, maxvals rtol 1e-6, decoded coords atol 1e-4
    (source-image px; the blurs sum in another order than XLA's)."""
    rng = np.random.default_rng(11)
    B, J, H, W = 2, 4, 64, 48
    negative = ((0, 1), (1, 3))
    hm = _peaky(rng, B, J, H, W, negative)
    if target_type == "offset":
        net = rng.uniform(-0.5, 0.5, (B, 3 * J, H, W)).astype(np.float32)
        net[:, 0::3] = hm
    else:
        net = hm
    center, scale = _center_scale(rng, B)
    gold = jax_decode.get_final_preds(
        jnp.asarray(net), jnp.asarray(center), jnp.asarray(scale),
        target_type=target_type, post_process=True, kpd=4.0)
    out = decode.get_final_preds(_t(net), _t(center), _t(scale),
                                 target_type=target_type, post_process=True,
                                 kpd=4.0)
    peaks = jax_decode.get_max_preds(jnp.asarray(hm))
    np.testing.assert_array_equal(decode.get_max_preds(_t(hm))[0].numpy(),
                                  np.asarray(peaks[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(gold[1]),
                               rtol=1e-6)
    for o, g in ((out[0], gold[0]), (out[2], gold[2])):
        np.testing.assert_allclose(o.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4)


def test_dark_refine_singular_hessian_gives_zero_shift():
    """Far from the only bump the normalised map clips to 0.001, so the
    log map is flat and its Hessian zero: the coordinates stay put, as in
    the JAX decode."""
    hm = np.zeros((1, 1, 13, 13), np.float32)
    hm[0, 0, 0, 0] = 1.0
    coords = np.array([[[6.0, 6.0]]], np.float32)
    out = decode.dark_refine(_t(coords), _t(hm)).numpy()
    gold = np.asarray(jax_decode.dark_refine(jnp.asarray(coords),
                                             jnp.asarray(hm)))
    np.testing.assert_array_equal(out, coords)
    np.testing.assert_array_equal(gold, coords)
