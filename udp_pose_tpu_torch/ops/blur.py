"""OpenCV-parity Gaussian blur as banded matrix products.

Port of ``udp_pose_tpu/ops/blur.py``: ``cv2.GaussianBlur`` semantics
(small-kernel tables for ``ksize <= 7`` with ``sigma <= 0``,
``BORDER_REFLECT_101``) folded into two dense (H, H) and (W, W) banded
matrices, so the separable blur of (..., H, W) maps is
``B_h @ x @ B_w^T``.  The products run in full float32: TF32 keeps about
three decimal digits, which breaks sub-pixel decode parity with cv2.

:func:`separable_blur_reference` is the same blur summed tap by tap in a
fixed order: the plain version of the fused decode kernel, which sums
in that order too, so that the two agree bit for bit.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch

_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125,
                 0.21875, 0.109375, 0.03125]),
}


def opencv_gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """1-D Gaussian kernel with exact cv2.getGaussianKernel semantics."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return _SMALL_GAUSSIAN_TAB[ksize].astype(np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _reflect101_index(i: int, n: int) -> int:
    """Map an out-of-range index into [0, n) with BORDER_REFLECT_101."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i = i % period
    return i if i < n else period - i


@lru_cache(maxsize=None)
def blur_matrix_f64(n: int, ksize: int, sigma: float) -> np.ndarray:
    """(n, n) float64 matrix B with (B @ v) == 1-D blur of v, border
    folded in.  Read-only: the cache hands the same array to every
    caller."""
    k = opencv_gaussian_kernel1d(ksize, sigma)
    r = ksize // 2
    B = np.zeros((n, n), np.float64)
    for i in range(n):
        for t in range(ksize):
            B[i, _reflect101_index(i + t - r, n)] += k[t]
    B.setflags(write=False)
    return B


@lru_cache(maxsize=None)
def _blur_matrix(n: int, ksize: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    """The float32 banded matrix, kept on ``device`` once made."""
    return torch.from_numpy(
        blur_matrix_f64(n, ksize, sigma).astype(np.float32)).to(device)


@contextlib.contextmanager
def _ieee_fp32_matmul():
    """Full-float32 CUDA matrix products (no TF32) inside the block,
    whatever the process-wide setting, which is restored after.  Only the
    CUDA matmul flag is read and set: restoring the generic
    ``set_float32_matmul_precision("high")`` would also switch the CPU
    backend to TF32, and a later ``allow_tf32 = False`` then leaves the
    two backends mixed, where torch refuses every generic query."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def gaussian_blur(maps, ksize: int, sigma: float = 0.0):
    """cv2.GaussianBlur-parity blur of (..., H, W) maps, in float32."""
    H, W = maps.shape[-2], maps.shape[-1]
    Bh = _blur_matrix(H, ksize, float(sigma), maps.device)
    Bw = _blur_matrix(W, ksize, float(sigma), maps.device)
    with _ieee_fp32_matmul():
        return Bh @ maps.float() @ Bw.T


def folded_taps(ksize: int) -> np.ndarray:
    """The float32 cv2 kernel (sigma from ``ksize``) folded about its
    centre: element t is the tap t away from the centre on either side."""
    k = opencv_gaussian_kernel1d(ksize).astype(np.float32)
    return np.ascontiguousarray(k[ksize // 2::-1])


@lru_cache(maxsize=None)
def _reflect_pairs(n: int, r: int, device: torch.device):
    """For t = 1..r: the REFLECT_101 sources of ``i - t`` and ``i + t``
    for every i in [0, n), as index tensors on ``device``."""
    return tuple(
        tuple(torch.tensor([_reflect101_index(i + s, n) for i in range(n)],
                           device=device) for s in (-t, t))
        for t in range(1, r + 1))


def _blur_axis(x, taps, dim):
    acc = x * taps[0]
    pairs = _reflect_pairs(x.shape[dim], len(taps) - 1, x.device)
    for k, (lo, hi) in zip(taps[1:], pairs):
        acc = acc + (x.index_select(dim, lo) + x.index_select(dim, hi)) * k
    return acc


def separable_blur_reference(maps, ksize: int):
    """cv2.GaussianBlur-parity blur of (..., H, W) maps in float32, for
    any H, W >= 1: the W pass, then the H pass, each output
    ``k[0]·x[c] + Σ_{t=1..r} k[t]·(x[c−t] + x[c+t])`` (``k`` from
    :func:`folded_taps`, t upward, REFLECT_101 borders), every product
    and sum rounded to float32 on its own."""
    taps = [float(k) for k in folded_taps(ksize)]
    return _blur_axis(_blur_axis(maps.float(), taps, -1), taps, -2)
