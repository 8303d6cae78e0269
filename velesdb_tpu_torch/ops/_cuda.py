"""Build and load the package's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` exposes a plain C entry point. At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``velesdb_tpu_torch/_build/`` and loaded with ``ctypes``. The
library's file name carries a hash of the source and of the ``csrc/``
headers it includes, so an edited source or header is rebuilt and a stale
library is never loaded. Nothing is compiled at import
time, and nothing is ever built from outside the package's ``csrc/``.
:func:`build_all` starts one ``nvcc`` per source at once, so a caller that
needs several kernels pays for the slowest build, not the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["library", "build_all", "BUILD_SECONDS", "BUILD_LOG"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}  # name -> nvcc wall time (0.0 = cached)
BUILD_LOG: dict[str, str] = {}  # name -> nvcc/ptxas stderr (registers, spills)

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: str, seen: list[str]) -> list[str]:
    """``path`` and every header it includes with quotes, depth first, each
    once, resolved beside the including file."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        _sources(os.path.join(os.path.dirname(path), inc.decode()), seen)
    return seen


def _paths(name: str) -> tuple[str, str]:
    """The source and its library's path. The name hashes the source and
    every ``csrc/`` header it includes, so an edited header rebuilds every
    library built from it."""
    src = os.path.join(_CSRC, f"{name}.cu")
    h = hashlib.sha256()
    for path in _sources(src, []):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for one source; None when its library is already built."""
    src, lib = _paths(name)
    if os.path.exists(lib):
        BUILD_SECONDS[name] = 0.0
        return None
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *_NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, src, lib, tmp, time.perf_counter()


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, src, lib, tmp, t0 = job
    _, err = proc.communicate()
    BUILD_LOG[name] = err
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{err}")
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all(names) -> None:
    """Build (and load) every named kernel library, all ``nvcc`` runs at once."""
    with _LOCK:
        jobs = {name: _start(name) for name in names if name not in _LIBS}
        try:
            for name, job in jobs.items():
                _finish(name, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        for name in jobs:
            _LIBS[name] = ctypes.CDLL(_paths(name)[1])


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build_all([name])
    return _LIBS[name]
