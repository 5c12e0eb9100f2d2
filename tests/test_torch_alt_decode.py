"""The port's alternative decoders (``ops/alt_decode.py``) against the JAX
package's ``simdr_decode`` and ``shift_decode``, on the CPU: the same
numpy-seeded maps, int32 coordinates equal exactly, with peaks on every
border and interior, ties, and maps that are nowhere positive."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from udp_pose_tpu.ops import alt_decode as jax_alt
from udp_pose_tpu_torch.ops import alt_decode


def _boxes(rng, B):
    center = rng.uniform(100, 500, (B, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.5, (B, 2)).astype(np.float32)
    return center, scale


@pytest.mark.parametrize("hw", [(64, 48), (16, 12)])
def test_shift_decode_equals_jax(hw):
    """Random maps, then peaks placed on each border and corner, next to
    the border (px = 1, the interior test's edge), as ties of two
    maxima, with equal neighbours (no shift), and maps that are all
    zero or all negative (−1 before the transform)."""
    H, W = hw
    rng = np.random.default_rng(0)
    B, J = 4, 17
    hm = rng.normal(size=(B, J, H, W)).astype(np.float32)
    spots = [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1), (0, W // 2),
             (H // 2, 0), (H - 1, W // 2), (H // 2, W - 1), (1, 1),
             (2, 2), (H - 2, W - 2), (1, W // 2), (H // 2, 1)]
    for j, (y, x) in enumerate(spots):
        hm[0, j, y, x] = 10.0
    hm[1, 0, 3, 4] = hm[1, 0, 5, 6] = 9.0             # a tie: the first
    hm[1, 1] = 0.0
    hm[1, 1, 5, 5] = 1.0                              # equal neighbours
    hm[2, 0] = 0.0                                    # nowhere positive
    hm[2, 1] = -np.abs(hm[2, 1]) - 0.1
    center, scale = _boxes(rng, B)
    want = np.asarray(jax_alt.shift_decode(jnp.asarray(hm), center, scale))
    got = alt_decode.shift_decode(torch.from_numpy(hm), center, scale)
    assert got.dtype == torch.int32 and got.shape == (B, J, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("image_wh", [(192, 256), (288, 384)])
def test_simdr_decode_equals_jax(image_wh):
    """SimDR heads at split ratio 2, with peaks at both ends of each axis
    and a tie."""
    w, h = image_wh
    rng = np.random.default_rng(1)
    B, J = 3, 17
    px = rng.normal(size=(B, J, 2 * w)).astype(np.float32)
    py = rng.normal(size=(B, J, 2 * h)).astype(np.float32)
    px[0, 0, 0] = py[0, 0, -1] = 8.0
    px[0, 1, -1] = py[0, 1, 0] = 8.0
    px[1, 2, 10] = px[1, 2, 20] = 7.0
    center, scale = _boxes(rng, B)
    want = np.asarray(jax_alt.simdr_decode(jnp.asarray(px), jnp.asarray(py),
                                           center, scale,
                                           image_size_wh=image_wh))
    got = alt_decode.simdr_decode(torch.from_numpy(px), torch.from_numpy(py),
                                  center, scale, image_size_wh=image_wh)
    assert got.dtype == torch.int32 and got.shape == (B, J, 2)
    np.testing.assert_array_equal(got.numpy(), want)
