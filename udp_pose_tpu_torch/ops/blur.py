"""OpenCV-parity Gaussian blur as banded matrix products.

Port of ``udp_pose_tpu/ops/blur.py``: ``cv2.GaussianBlur`` semantics
(small-kernel tables for ``ksize <= 7`` with ``sigma <= 0``,
``BORDER_REFLECT_101``) folded into two dense (H, H) and (W, W) banded
matrices, so the separable blur of (..., H, W) maps is
``B_h @ x @ B_w^T``.  The products run in full float32: TF32 keeps about
three decimal digits, which breaks sub-pixel decode parity with cv2.
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
    """Full-float32 matrix products inside the block, whatever the
    process-wide setting (which is restored after)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def gaussian_blur(maps, ksize: int, sigma: float = 0.0):
    """cv2.GaussianBlur-parity blur of (..., H, W) maps, in float32."""
    H, W = maps.shape[-2], maps.shape[-1]
    Bh = _blur_matrix(H, ksize, float(sigma), maps.device)
    Bw = _blur_matrix(W, ksize, float(sigma), maps.device)
    with _ieee_fp32_matmul():
        return Bh @ maps.float() @ Bw.T
