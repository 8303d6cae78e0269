"""Build and load the package's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` exposes a plain C entry point. At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``velesdb_tpu_torch/_build/`` and loaded with ``ctypes``. The
library's file name carries a hash of the source, so an edited source is
rebuilt and a stale library is never loaded. Nothing is compiled at import
time, and nothing is ever built from outside the package's ``csrc/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["library", "BUILD_SECONDS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}  # name -> nvcc wall time (0.0 = cached)

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build(name: str) -> str:
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(_BUILD, f"lib{name}-{digest}.so")
    if os.path.exists(lib):
        BUILD_SECONDS[name] = 0.0
        return lib
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name))
            _LIBS[name] = lib
        return lib
