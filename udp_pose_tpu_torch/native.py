"""ctypes bindings of the native host library (``native/``).

The port's own bindings of ``native/udppose_native.cpp``:
``warp_affine_batch_u8`` (bilinear warp of n crops from one u8 HWC
frame), ``greedy_nms`` (the detector's host NMS), ``resize_bilinear_u8``
(the host letterbox where OpenCV is absent) and ``native_version``.  The
library is not committed: at first use it is compiled from
that source into ``build/native/`` at the repo root (gitignored; the file
name carries a hash of the source).  The source's OpenMP loop over crops
is compiled in where the compiler has an OpenMP runtime, and left out
(one thread, same results) where it has none; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
SOURCE = _REPO / "native" / "udppose_native.cpp"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall")

_lock = threading.Lock()
_lib = None


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libudppose-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    errors = []
    for openmp in (("-fopenmp",), ()):
        proc = subprocess.run([cxx, *CXX_FLAGS, *openmp, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(proc.stderr)
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"building {out} from {SOURCE} failed:\n"
                       + "\n".join(errors))


def load():
    """The loaded library, built on first use (see the module doc)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.warp_affine_batch_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int]
            lib.warp_affine_batch_u8.restype = None
            lib.greedy_nms.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
            lib.greedy_nms.restype = ctypes.c_int
            lib.resize_bilinear_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.resize_bilinear_u8.restype = None
            lib.native_version.argtypes = []
            lib.native_version.restype = ctypes.c_int
            _lib = lib
        return _lib


def warp_affine_batch(img: np.ndarray, matrices: np.ndarray,
                      out_hw) -> np.ndarray:
    """n float32 (oh, ow, C) crops from one uint8 HWC frame; matrices
    (n, 2, 3) map crop (dst) pixels to frame (src) pixels."""
    lib = load()
    oh, ow = int(out_hw[0]), int(out_hw[1])
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"frame must be (H, W, C), got {img.shape}")
    mats = np.ascontiguousarray(matrices, np.float32).reshape(-1, 6)
    n = mats.shape[0]
    H, W, C = img.shape
    out = np.empty((n, oh, ow, C), np.float32)
    lib.warp_affine_batch_u8(img.ctypes.data, H, W, C, mats.ctypes.data, n,
                             out.ctypes.data, oh, ow)
    return out


def native_version() -> int:
    """The source's ABI version (2: the resize entry point exists)."""
    return load().native_version()


def greedy_nms(dets: np.ndarray, thresh: float, plus_one=True):
    """Kept indices of greedy box NMS over (n, 5) ``[x1, y1, x2, y2,
    score]`` rows in float32: a stable sort by descending score (a tie
    keeps the lower index first), then suppression above ``thresh``.
    ``plus_one`` selects the reference's +1 pixel-area convention."""
    lib = load()
    dets = np.ascontiguousarray(dets, np.float32)
    if dets.ndim != 2 or (len(dets) and dets.shape[1] != 5):
        raise ValueError(f"dets must be (n, 5), got {dets.shape}")
    keep = np.empty((len(dets),), np.int32)
    n = lib.greedy_nms(dets.ctypes.data, len(dets), float(thresh),
                       int(bool(plus_one)), keep.ctypes.data)
    return keep[:n].tolist()


def resize_bilinear(img: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear u8 resize of an (H, W, C) frame to ``out_hw`` (half-pixel
    centres, edge clamp, round half up): within 1 of OpenCV's
    ``INTER_LINEAR`` a value."""
    lib = load()
    oh, ow = int(out_hw[0]), int(out_hw[1])
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"frame must be (H, W, C), got {img.shape}")
    H, W, C = img.shape
    out = np.empty((oh, ow, C), np.uint8)
    lib.resize_bilinear_u8(img.ctypes.data, H, W, C, out.ctypes.data, oh, ow)
    return out
