"""Native (C++) runtime components with graceful Python fallback.

Copied from ``velesdb_tpu/native``. The host runtime around the device
compute path uses native code where the reference does (its storage/WAL layer is Rust). Components
build lazily with the system compiler into ``_build/`` next to the sources;
when no compiler is available every caller falls back to the pure-Python
implementation transparently.

Current components:

- ``wal_codec`` — batch WAL record framing + validated scan
  (``wal_codec.cpp``); used by ``storage/vector_store.py`` for bulk ingest
  and crash-recovery replay.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["wal_codec"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()


def _build_lib(name: str) -> str | None:
    src = os.path.join(_DIR, f"{name}.cpp")
    build_dir = os.path.join(_DIR, "_build")
    lib = os.path.join(build_dir, f"lib{name}.so")
    try:
        if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
            return lib
        os.makedirs(build_dir, exist_ok=True)
        for cc in ("g++", "c++", "clang++"):
            try:
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", lib],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
                return lib
            except (OSError, subprocess.SubprocessError):
                continue
    except OSError:
        pass
    return None


class _WalCodec:
    """ctypes binding for wal_codec.cpp. ``available`` is False (and every
    method raises) when compilation failed — callers must fall back."""

    def __init__(self):
        self._lib = None
        path = _build_lib("wal_codec")
        if path is None:
            return
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return
        lib.wal_frame_batch.restype = ctypes.c_long
        lib.wal_frame_batch.argtypes = [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_long,
            ctypes.c_long,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        lib.wal_extract.restype = ctypes.c_long
        lib.wal_extract.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_long,
            ctypes.c_long,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.wal_scan.restype = ctypes.c_long
        lib.wal_scan.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_long,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        self._lib = lib

    @property
    def available(self) -> bool:
        return self._lib is not None

    def frame_batch(self, ids: np.ndarray, vecs: np.ndarray) -> bytes:
        """Frame ``[N]`` ids + ``[N, D] f32`` vectors as upsert records."""
        ids = np.ascontiguousarray(ids, np.int64)
        vecs = np.ascontiguousarray(vecs, np.float32)
        n, d = vecs.shape
        if ids.shape != (n,):
            raise ValueError(
                f"frame_batch: ids shape {ids.shape} != ({n},) for {n} vectors"
            )
        out = np.empty(n * (18 + 4 * d), np.uint8)
        written = self._lib.wal_frame_batch(ids, vecs, n, d, out)
        return out[:written].tobytes()

    def extract_bodies(self, data: bytes, n: int, dim: int) -> np.ndarray:
        """Bodies of ``n`` uniform dim-``dim`` upsert records -> [n, dim]."""
        buf = np.frombuffer(data, np.uint8)
        out = np.empty((n, dim), np.float32)
        self._lib.wal_extract(buf, n, dim, out)
        return out

    def scan(self, data: bytes):
        """Validated scan: ``(ids, ops, body_offsets, dims, consumed)``."""
        buf = np.frombuffer(data, np.uint8)
        cap = max(1, len(data) // 18)
        ids = np.empty(cap, np.int64)
        ops = np.empty(cap, np.uint8)
        offs = np.empty(cap, np.int64)
        dims = np.empty(cap, np.uint32)
        consumed = ctypes.c_long(0)
        cnt = self._lib.wal_scan(
            buf, len(data), ids, ops, offs, dims, cap, ctypes.byref(consumed)
        )
        return ids[:cnt], ops[:cnt], offs[:cnt], dims[:cnt], int(consumed.value)


_codec = None


def wal_codec() -> _WalCodec:
    """Lazily built singleton codec (thread-safe)."""
    global _codec
    with _LOCK:
        if _codec is None:
            _codec = _WalCodec()
    return _codec
