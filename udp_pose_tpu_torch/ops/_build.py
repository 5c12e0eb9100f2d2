"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/torch_kernels/`` at the repo root
(gitignored), then loaded with ``ctypes``.  The library's file name
carries a hash of its source, so an edited kernel rebuilds and a stale
one is never loaded.  Nothing is built when a module is imported: the
CPU tests import every module on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
#: per source name: (seconds, compiler output) of the build this process ran
build_logs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of udp_pose_tpu_torch cannot be built")


def library_path(name: str, src: Path | None = None) -> Path:
    """Where ``src`` (default ``csrc/{name}.cu``) is built, keyed by its
    content."""
    src = CSRC_DIR / f"{name}.cu" if src is None else Path(src)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, src: Path | None = None) -> Path:
    """Compile ``src`` (default ``csrc/{name}.cu``) unless this source's
    library exists.  The compiler writes to a temporary name that is
    renamed into place, so a process that finds the library never finds
    half of it."""
    src = CSRC_DIR / f"{name}.cu" if src is None else Path(src)
    out = library_path(name, src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    build_logs[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
