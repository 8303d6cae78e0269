"""Brute-force (exact) device index over a padded slot array.

Counterpart of ``velesdb_tpu/index/brute.py`` for FULL (f32) storage: the
corpus lives as a padded ``[N_pad, D]`` fp32 tensor on the index's device and
every search scores the whole batch against it. Two serve cores, in order:

1. ``int8-assist-pd`` — D < 512 and ``n_pad >= BUCKET_MIN_ROWS``: the
   per-dim int8 coarse scan (CUDA kernel ``csrc/sq8pd_bucket.cu``) keeps
   m = clamp(2k-4, 16, 256) candidates per query, then an exact fp32 rerank.
2. ``streamed-scan`` — everything else: a chunked fp32 matmul with an exact
   per-chunk top-k and merge (``ops/streamed.py``).

Where the reference serves its per-row int8 kernel because ``sq8pd_build``
refused the corpus, this package serves ``streamed-scan`` (the per-row kernel is
still to be ported; ROADMAP.md). There is no fallback between cores at run
time: a failing kernel raises.
"""

from __future__ import annotations

import numpy as np
import torch

from velesdb_tpu_torch.ops.bucket_kernel import (
    BUCKET_MIN_ROWS,
    _pd_invalid_pen,
    pd_chunk,
    sq8pd_build,
    sq8pd_ptile,
    sq8pd_rerank_topk,
)
from velesdb_tpu_torch.ops.distance import DistanceMetric, normalize
from velesdb_tpu_torch.ops.quantization import StorageMode
from velesdb_tpu_torch.ops.streamed import streamed_topk

__all__ = ["BruteForceIndex", "pad_rows", "state_from_jax"]

_METRICS = (DistanceMetric.COSINE, DistanceMetric.EUCLIDEAN, DistanceMetric.DOT_PRODUCT)


def not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to velesdb_tpu_torch yet (see ROADMAP.md)"
    )


def _bucket_safe(n_pad: int, chunk: int, k: int) -> bool:
    """Collision-recall guard: one winner per 128-lane bucket loses
    ~(k-1)/(2*nbuckets) of the true top-k; keep that under ~1%."""
    return n_pad >= BUCKET_MIN_ROWS and (k - 1) <= 0.02 * (n_pad // chunk) * 128


def pad_rows(n: int, minimum: int = 1024) -> int:
    """Padded row count: the next power of two up to 64K rows, then
    power-of-two/16 steps (multiples of 8192, so every kernel chunk divides
    the padded count)."""
    target = max(n, minimum)
    pow2 = 1 << (target - 1).bit_length()
    if pow2 <= 65536:
        return pow2
    step = pow2 // 16
    return ((target + step - 1) // step) * step


def _pd_m(k: int) -> int:
    """Coarse candidates per query for a top-k pd search."""
    return min(max(2 * k - 4, 16), 256)


class BruteForceIndex:
    """Exact search over a device-resident padded corpus (FULL storage)."""

    def __init__(self, dim: int, metric: DistanceMetric,
                 storage_mode: StorageMode = StorageMode.FULL, device="cuda"):
        self.dim = int(dim)
        self.metric = DistanceMetric.parse(metric)
        self.storage_mode = StorageMode.parse(storage_mode)
        if self.storage_mode is not StorageMode.FULL:
            raise not_in_slice(f"storage_mode={self.storage_mode.value!r}")
        if self.metric not in _METRICS:
            raise not_in_slice(f"exact search with metric={self.metric.value!r}")
        self.device = torch.device(device)
        self.n_pad = 0
        self._valid = None  # [N_pad] bool
        self._full = None  # [N_pad, D] f32 (cosine rows pre-normalized)
        self._full_sqnorm = None  # [N_pad] f32
        self._assist_pd = None  # (rows_pd, pen_int, pen_f32, sdim, mid, qu)
        self._pd_chunk = 0
        self._pd_ptile = None  # [N_pad] int32, built with the shadow

    # -- build -------------------------------------------------------------

    def rebuild(self, slots: np.ndarray, valid: np.ndarray) -> None:
        """Upload the host slot array ``[used, D]`` as padded device state,
        with the pd shadow and its ptile when the pd core applies."""
        used = slots.shape[0]
        n_pad = pad_rows(used)
        full = torch.zeros((n_pad, self.dim), dtype=torch.float32, device=self.device)
        full[:used] = torch.from_numpy(np.ascontiguousarray(slots, np.float32)).to(
            self.device
        )
        vmask = torch.zeros(n_pad, dtype=torch.bool, device=self.device)
        vmask[:used] = torch.from_numpy(np.array(valid, dtype=bool)).to(self.device)
        if self.metric is DistanceMetric.COSINE:
            # cosine is normalization-invariant: store rows pre-normalized
            full = normalize(full)
        self._set_state(full, vmask, torch.sum(full * full, dim=1))
        pd = None
        if self.dim < 512 and n_pad >= BUCKET_MIN_ROWS:
            pd = sq8pd_build(full, vmask, self.dim, self.metric)
        self._set_pd(pd)

    def load_state(self, state: dict) -> None:
        """Adopt padded device state, e.g. from :func:`state_from_jax`."""
        self._set_state(state["full"], state["valid"], state["full_sqnorm"])
        self._set_pd(state.get("assist_pd"))

    def _set_state(self, full, valid, sqnorm) -> None:
        self.n_pad = full.shape[0]
        self._full = full
        self._valid = valid
        self._full_sqnorm = sqnorm

    def _set_pd(self, pd) -> None:
        self._assist_pd = pd
        self._pd_chunk = pd_chunk(self.n_pad) if pd is not None else 0
        self._pd_ptile = sq8pd_ptile(pd[1], self._pd_chunk) if pd is not None else None

    # -- search ------------------------------------------------------------

    def _pd_plan(self, k: int) -> int:
        """m for the pd core at this k, or 0 when the streamed scan serves.
        The single source of the dispatch rule for search and serve_engine."""
        if self._assist_pd is None or self.dim >= 512:
            return 0
        m = _pd_m(k)
        if m >= k and _bucket_safe(self.n_pad, self._pd_chunk, m):
            return m
        return 0

    def serve_engine(self, k: int = 10) -> str:
        """Name of the core a ``search(..., k)`` would run right now."""
        return "int8-assist-pd" if self._pd_plan(k) else "streamed-scan"

    def search(self, queries, k: int, mask=None):
        """Masked exact top-k. Returns ``(values [B, k] f32, slot ids [B, k]
        int64)`` on the index's device; empty slots are id -1."""
        q = torch.atleast_2d(
            torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        )
        k_eff = min(k, self.n_pad)
        mask_dev = None
        if mask is not None:
            if not isinstance(mask, torch.Tensor):
                mask = torch.from_numpy(np.asarray(mask, bool))
            mask_dev = _pad_to(mask.to(self.device, torch.bool), self.n_pad)
        m = self._pd_plan(k_eff)
        if m:
            rows_pd, _, _, sdim, _, qu = self._assist_pd
            ptile = self._pd_ptile
            if mask_dev is not None:
                ptile = torch.where(mask_dev, ptile, -64 * _pd_invalid_pen(self.dim))
            return sq8pd_rerank_topk(
                q, rows_pd, ptile, sdim, qu, self._full, k=k_eff, m=m,
                metric=self.metric, chunk=self._pd_chunk, dim=self.dim,
            )
        valid = self._valid if mask_dev is None else self._valid & mask_dev
        return streamed_topk(
            q, self._full, valid=valid, k=k_eff, metric=self.metric,
            corpus_sqnorm=self._full_sqnorm,
        )


def _pad_to(mask: torch.Tensor, n_pad: int) -> torch.Tensor:
    if mask.shape[0] < n_pad:
        mask = torch.cat([mask, mask.new_zeros(n_pad - mask.shape[0])])
    return mask[:n_pad]


def state_from_jax(arrays: dict, device) -> dict:
    """Turn the JAX index's padded arrays into this package's device state.

    ``arrays`` holds numpy copies of the reference ``BruteForceIndex``'s
    ``_full``, ``_valid`` and ``_full_sqnorm`` under ``full``, ``valid`` and
    ``full_sqnorm``, and, when its pd shadow exists, the five arrays plus
    ``qu`` of ``_assist_pd`` under ``rows_pd``, ``pen_int``, ``pen_f32``,
    ``sdim``, ``mid`` and ``qu``. Other keys (``bucket_pen``, the f32 bucket
    kernel's penalty) are accepted and not used. The result feeds
    :meth:`BruteForceIndex.load_state`, so both packages search from
    identical shadows."""

    def put(key, dtype):
        return torch.from_numpy(np.ascontiguousarray(arrays[key], dtype)).to(device)

    state = {
        "full": put("full", np.float32),
        "valid": put("valid", bool),
        "full_sqnorm": put("full_sqnorm", np.float32),
        "assist_pd": None,
    }
    if "rows_pd" in arrays:
        state["assist_pd"] = (
            put("rows_pd", np.int8),
            put("pen_int", np.int32),
            put("pen_f32", np.float32),
            put("sdim", np.float32),
            put("mid", np.float32),
            float(arrays["qu"]),
        )
    return state
