"""Peaks of the card and the least work of a search, counted from shapes.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): a roofline share is stated against these,
with the card's power limit printed beside the run.

The work of an exact top-k search depends on the shapes only, never on
which kernel does it, so no rename or replacement of a kernel makes the
count stale.
"""

from __future__ import annotations

__all__ = ["PEAKS", "exact_search_ops", "exact_search_bytes", "exact_search_least_s"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12, "hbm_bytes_per_s": 3.35e12},
}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def exact_search_ops(batch: int, rows: int, dim: int) -> float:
    """Products of the queries with every admitted row: ``2 B N D``."""
    return 2.0 * batch * rows * dim


def exact_search_bytes(batch: int, rows: int, dim: int, k: int) -> float:
    """One byte a coordinate of each admitted row (the int8 shadow), read
    once; the f32 queries read once; ``k`` (f32 score, int64 id) pairs a
    query written once."""
    return float(rows) * dim + 4.0 * batch * dim + 12.0 * batch * k


def exact_search_least_s(batch: int, rows: int, dim: int, k: int, kind: str | None = None):
    """``(seconds, bound)``: the larger of the operations at the int8
    tensor-core rate and the bytes at the HBM rate, and which one it is."""
    peak = PEAKS.get(kind, DEFAULT_PEAK)
    t_ops = exact_search_ops(batch, rows, dim) / peak["int8_ops_per_s"]
    t_bytes = exact_search_bytes(batch, rows, dim, k) / peak["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
