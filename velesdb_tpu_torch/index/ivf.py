"""IVF partitioned ANN index: k-means routing + partition-block scoring.

Counterpart of ``velesdb_tpu/index/ivf.py`` (``kmeans``, partition assembly,
``IvfIndex``, ``ivf_search_impl``):

- **build**: Lloyd k-means on the index's device (batched assignment, one
  matmul per chunk; the reference's ``lax.scan`` over chunks is a Python loop
  and its scatter-adds are ``index_add_``). Rows reorder into uniform padded
  partitions ``[P, L, D]`` f32, or ``[P, L, D_pad/4]`` int32 block-packed
  SQ8 words, in blocks of about 131K rows. Skewed clusters split into several
  partitions that share a routing centroid.
- **search**: one ``[B, P]`` matmul routes each query to its top-``nprobe``
  partitions. Unmasked batches of at most ``MAX_KERNEL_BATCH`` queries over
  blocks of at least ``MIN_BLOCK_BYTES`` score them with kernel #10
  (:func:`~velesdb_tpu_torch.ops.ivf_kernel.ivf_probe_topk`); every other
  search runs :func:`ivf_search_impl`, plain torch (XLA in the reference).
  A failing kernel raises: the reference's kill switch and demotion record
  (``:48``, ``:842-854``) are not carried over.

Every top-k here (routing, spill assignment, the probe merge, the dedup)
sends equal scores to the smallest position, as ``lax.top_k`` does, on every
device: partitions split from one cluster share a centroid, so their routing
scores tie exactly. Sums of squares run in a fixed order
(:func:`_row_sumsq`), so the CPU's and the card's assembly agree bit for bit
on one assignment. On the card ``index_add_`` sums with atomics in no fixed
order: a k-means run there is not bit-reproducible.

The ``.npz`` recipe (``kmeans_cents``, ``kmeans_c``, ``n``, ``metric``,
``version``, ``spill``, ``storage``) is the reference's: a file written by
either package loads in the other.

The graph index's build half (reference ``:1130-1610``) lives here too:
``build_from_centroids`` assembles the graph's SQ8 entry IVF from the
approximate build's router, and ``ivf_self_knn`` is the approximate kNN
graph: each partition scored against its ``nprobe`` nearest partitions in
one batched matmul (the reference's ``lax.scan`` over partitions is a loop
over blocks of partitions here), scattered to rows and merged across passes
on the device; ``nn_descent_round`` refines it.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from velesdb_tpu_torch.index.params import SearchQuality
from velesdb_tpu_torch.ops.bucket_kernel import _row_sumsq, first_topk
from velesdb_tpu_torch.ops.chunked import _best
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.ivf_kernel import ivf_probe_supported, ivf_probe_topk
from velesdb_tpu_torch.ops.quantization import SQ8Vectors, sq8_pack_blocked

__all__ = ["IvfIndex", "kmeans", "ivf_search_impl", "ivf_self_knn", "ivf_state_from_jax",
           "merge_ranked", "nn_descent_round", "sq8_unpack_words"]

_METRICS = (DistanceMetric.COSINE, DistanceMetric.EUCLIDEAN, DistanceMetric.DOT_PRODUCT)

_KM_CHUNK = 65536  # the reference's rows per assignment step (its padding rule)
_SCORE_ELEMS = 1 << 25  # [rows, k] scores per assignment step in the port


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def stage_mark(profile, stage: str, t0: float, device) -> float:
    """Add the seconds since ``t0`` to ``profile[stage]`` (after the device's
    queue drains) when a profile is being kept; returns the new start."""
    if profile is not None:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        profile[stage] = profile.get(stage, 0.0) + time.perf_counter() - t0
    return time.perf_counter()


def _step_rows(k: int) -> int:
    """Rows per assignment step: bounds the ``[rows, k]`` score block."""
    return max(8, _SCORE_ELEMS // max(k, 1))


def _affinity(blk: torch.Tensor, cents: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    return blk @ cents.T - 0.5 * cc[None, :]


def _kmeans_device(x: torch.Tensor, init: torch.Tensor, k: int, iters: int):
    """Lloyd iterations over the padded rows ``x [M, D]`` (the reference
    scans ``[M / chunk, chunk, D]``; each step here scores a bounded block
    and scatter-adds into per-cluster sums and counts). Returns
    ``(centroids [k, D], assign [M])``."""
    step = _step_rows(k)
    cents = init
    ones = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        cc = torch.sum(cents * cents, dim=1)
        sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
        counts = torch.zeros(k, dtype=x.dtype, device=x.device)
        for r0 in range(0, x.shape[0], step):
            blk = x[r0 : r0 + step]
            a = torch.argmax(_affinity(blk, cents, cc), dim=1)
            sums.index_add_(0, a, blk)
            counts.index_add_(0, a, ones[: blk.shape[0]])
        cents = torch.where(counts[:, None] > 0, sums / counts[:, None].clamp_min(1.0), cents)
    return cents, _assign_full(x, cents)


def _pad_rows_like_reference(x: torch.Tensor) -> torch.Tensor:
    """The reference's chunk padding (``:119-129``): ``m`` rows pad to a
    multiple of ``min(65536, round_up(m, 8))`` with copies of row 0, which
    enter the cluster sums (zero rows would pull a centroid to the origin)."""
    m = x.shape[0]
    chunk = min(_KM_CHUNK, _round_up(m, 8))
    m_pad = _round_up(m, chunk)
    if m_pad == m:
        return x
    return torch.cat([x, x[:1].expand(m_pad - m, x.shape[1])])


def kmeans(x, k: int, iters: int = 8, seed: int = 0, train_sample: int | None = 262_144):
    """k-means on the device; returns ``(centroids [k, D], assign [N] int64)``.

    Lloyd runs on a training sample (at least 32 points per centroid), then
    one assignment pass covers the full corpus. The init rows and the sample
    come from ``np.random.default_rng(seed)`` with the reference's calls in
    its order, so both packages start from the same rows. ``x`` is a numpy
    array (run on the CPU) or a tensor (run on its device)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    x = x.float()
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if train_sample is not None:
        train_sample = max(train_sample, 32 * k)
    pick = torch.from_numpy(rng.choice(n, size=k, replace=n < k)).to(x.device)
    init = x[pick]
    if train_sample is not None and n > train_sample:
        sample = torch.from_numpy(rng.choice(n, size=train_sample, replace=False)).to(x.device)
        cents, _ = _kmeans_device(_pad_rows_like_reference(x[sample]), init, k, iters)
        return cents, _assign_full(x, cents)
    cents, assign = _kmeans_device(_pad_rows_like_reference(x), init, k, iters)
    return cents, assign[:n]


def _assign_full(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row (``[N]`` int64, ties to the lowest id)."""
    return _assign_topk(x, cents, s=1)[:, 0]


def _assign_topk(x: torch.Tensor, cents: torch.Tensor, *, s: int) -> torch.Tensor:
    """Top-``s`` nearest centroids per row ``[N, s]`` (spill assignment)."""
    cc = torch.sum(cents * cents, dim=1)
    step = _step_rows(cents.shape[0])
    return torch.cat([first_topk(_affinity(x[r0 : r0 + step], cents, cc), s)[1]
                      for r0 in range(0, x.shape[0], step)])


def _assign_topk_sq8(codes, scale, minv, cents, *, s: int, cosine: bool) -> torch.Tensor:
    """Top-``s`` centroids per SQ8 row, dequantizing block by block (the full
    f32 corpus never materializes)."""
    cc = torch.sum(cents * cents, dim=1)
    step = _step_rows(cents.shape[0])
    out = []
    for r0 in range(0, codes.shape[0], step):
        x = codes[r0 : r0 + step].float() * scale[r0 : r0 + step, None] + minv[r0 : r0 + step, None]
        if cosine:
            x = x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-30)
        out.append(first_topk(_affinity(x, cents, cc), s)[1])
    return torch.cat(out)


#: routing sentinel carried in ``cent_sq`` for PADDED partitions (the
#: bucket-rounding slots past the real count, see :func:`_bucket_n_parts`):
#: euclidean routing subtracts ``0.5*cent_sq`` so pads score -5e29; the
#: other metrics mask ``cent_sq >= _PAD_CENT_SQ/2`` columns to -inf
#: explicitly at every routing site.
_PAD_CENT_SQ = 1e30


def _route_mask(route: torch.Tensor, cent_sq: torch.Tensor) -> torch.Tensor:
    """-inf out padded-partition columns of a ``[B, P]`` routing score."""
    return torch.where(cent_sq[None, :] >= _PAD_CENT_SQ * 0.5, -torch.inf, route)


def _group_map(assign, cents, rows_global, *, c: int, L: int, n_parts: int):
    """Partition gather map (reference ``:191``): sort rows by cluster (a
    stable sort, as ``jnp.argsort``), derive dest -> src. Returns
    ``(route_cents [P, D], cent_sq [P], src [P*L] int64 (-1 = empty), ok,
    part_rows [P, L] int64)``. Partitions past the real total are all-pad
    and carry ``cent_sq = _PAD_CENT_SQ``."""
    dev = assign.device
    n = assign.shape[0]
    order = torch.argsort(assign, stable=True)
    sorted_assign = assign[order]
    counts = torch.bincount(assign, minlength=c)
    splits = torch.clamp_min(-(-counts // L), 1)
    ends = torch.cumsum(splits, 0)
    total = ends[-1]
    base_part = ends - splits
    starts = torch.cumsum(counts, 0) - counts
    pos_within = torch.arange(n, device=dev) - starts[sorted_assign]
    dest = (base_part[sorted_assign] + pos_within // L) * L + pos_within % L
    src = torch.full((n_parts * L,), -1, dtype=torch.int64, device=dev)
    src[dest] = order
    ok = src >= 0
    part_rows = torch.where(ok, rows_global[src.clamp_min(0)], -1).reshape(n_parts, L)
    # routing: partition p belongs to the cluster whose split range covers it
    cluster_of_part = torch.searchsorted(ends, torch.arange(n_parts, device=dev), right=True)
    pad = torch.arange(n_parts, device=dev) >= total
    route_cents = torch.where(pad[:, None], 0.0, cents[cluster_of_part.clamp_max(c - 1)])
    cent_sq = torch.where(pad, _PAD_CENT_SQ, _row_sumsq(route_cents))
    return route_cents, cent_sq, src, ok, part_rows


def _exact_n_parts(assign: torch.Tensor, c: int, L: int) -> int:
    """Actual partition count: every cluster owns ceil(count/L) >= 1
    partitions (one scalar readback at build time)."""
    counts = torch.bincount(assign, minlength=c)
    return int(torch.sum(torch.clamp_min(-(-counts // L), 1)))


def _bucket_n_parts(raw: int) -> int:
    """Round UP to a ~1/16-granularity grid (next multiple of
    ``2^(bit_length-5)``): the fallback of :func:`_padded_n_parts` for
    heavily skewed assignments."""
    if raw <= 128:
        return raw
    step = 1 << max(raw.bit_length() - 5, 3)
    return -(-raw // step) * step


def _padded_n_parts(raw: int, c: int) -> int:
    """Padded partition count (reference ``:250``): whenever the exact count
    fits a 12.5% headroom over the cluster count it depends only on ``c``,
    so same-scale rebuilds keep one shape; heavier skew falls back to the
    bucketed exact count. Pad partitions are all-dead rows; the ``cent_sq``
    sentinel keeps them out of every probe top-k, and ``c_real`` caps
    nprobe. The port runs eagerly and keeps the rule for identical layouts
    in both packages."""
    det = c + max(16, c // 8)
    if raw <= det:
        return det
    return _bucket_n_parts(raw)


#: pad-slot memory budget: the deterministic headroom never allocates more
#: than this many bytes of empty partition slots
_PAD_BYTES_BUDGET = 256 * 1024 * 1024


def _padded_n_parts_capped(raw: int, c: int, n_rows: int, L: int, row_bytes: int = 4) -> int:
    """:func:`_padded_n_parts` with two shape-deterministic caps: the
    physical worst case (splits cannot exceed ``n//L``) and the pad-slot
    memory budget."""
    worst = c + n_rows // max(L, 1) + 1
    max_pad = max(16, _PAD_BYTES_BUDGET // max(L * row_bytes, 1))
    if c // 8 <= max_pad:
        padded = _padded_n_parts(raw, c)
    else:  # budget-tightened headroom: same rule, smaller deterministic pad
        det = c + max(16, max_pad)
        padded = det if raw <= det else _bucket_n_parts(raw)
    return min(padded, max(worst, raw))


def _parts_per_block(L: int, n_parts: int) -> int:
    """Partitions gathered per assembly step: bounds each step's
    intermediates to ~131K rows, so an assembly never holds the whole
    ``[P*L, D]`` payload twice."""
    return min(n_parts, max(1, 131_072 // max(L, 1)))


def _blocks(n_parts: int, L: int):
    """Start partitions of the assembly blocks (the last one overlaps its
    predecessor, as the reference's ``min(i * pb, n_parts - pb)``)."""
    pb = _parts_per_block(L, n_parts)
    return pb, [min(i * pb, n_parts - pb) for i in range(-(-n_parts // pb))]


def _group_partitions(live, assign, cents, rows_global, *, c: int, L: int, n_parts: int):
    """f32 partition assembly (reference ``:308``): gather map, then the
    rows gathered block by block into the preallocated partitions, with
    their squared norms."""
    route_cents, cent_sq, src, ok, part_rows = _group_map(
        assign, cents, rows_global, c=c, L=L, n_parts=n_parts)
    d = live.shape[1]
    safe = src.clamp_min(0)
    parts = torch.zeros((n_parts, L, d), dtype=torch.float32, device=live.device)
    part_sq = torch.zeros((n_parts, L), dtype=torch.float32, device=live.device)
    pb, starts = _blocks(n_parts, L)
    for start in starts:
        sl = slice(start * L, (start + pb) * L)
        blk = torch.where(ok[sl, None], live[safe[sl]].float(), 0.0)
        parts[start : start + pb] = blk.reshape(pb, L, d)
        part_sq[start : start + pb] = _row_sumsq(blk).reshape(pb, L)
    return route_cents, cent_sq, parts, part_rows, part_sq


def sq8_unpack_words(w: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``[..., W] int32`` words -> ``[..., W*4]`` code values 0..255 in dim
    order (integers <= 255 are exact in bf16). Inverse of
    :func:`~velesdb_tpu_torch.ops.quantization.sq8_pack_blocked` up to the
    dim padding (padded dims unpack to code 0)."""
    return torch.cat([((w >> (8 * j)) & 0xFF).to(dtype) for j in range(4)], dim=-1)


def _group_partitions_sq8(codes, scale, minv, assign, cents, rows_global, *, c: int, L: int,
                          n_parts: int):
    """SQ8 partition assembly (reference ``:382``): codes stay one byte a dim,
    stored as block-packed int32 words ``[P, L, D_pad/4]``
    (``sq8_pack_blocked``, the layout of the reference's ``_pack_words_2d``);
    per-slot scale and minv, and the dequantized squared norms."""
    route_cents, cent_sq, src, ok, part_rows = _group_map(
        assign, cents, rows_global, c=c, L=L, n_parts=n_parts)
    safe = src.clamp_min(0)
    w_pad = _round_up(codes.shape[1], 4) // 4
    pscale = torch.where(ok, scale[safe], 0.0).reshape(n_parts, L)
    pminv = torch.where(ok, minv[safe], 0.0).reshape(n_parts, L)
    pwords = torch.zeros((n_parts, L, w_pad), dtype=torch.int32, device=codes.device)
    part_sq = torch.zeros((n_parts, L), dtype=torch.float32, device=codes.device)
    pb, starts = _blocks(n_parts, L)
    for start in starts:
        sl = slice(start * L, (start + pb) * L)
        cd = torch.where(ok[sl, None], codes[safe[sl]], 0)
        deq = cd.float() * pscale.reshape(-1)[sl, None] + pminv.reshape(-1)[sl, None]
        pwords[start : start + pb] = sq8_pack_blocked(cd).reshape(pb, L, w_pad)
        part_sq[start : start + pb] = _row_sumsq(deq).reshape(pb, L)
    return route_cents, cent_sq, pwords, pscale, pminv, part_rows, part_sq


def _sq8_parts(sq: SQ8Vectors, rows: np.ndarray, device):
    """``(codes, scale, minv)`` of the live rows on ``device``: no gather
    when every row is live."""
    codes, scale, minv = (torch.as_tensor(a).to(device) for a in sq)
    scale, minv = scale.float(), minv.float()
    if len(rows) != codes.shape[0]:
        ridx = torch.from_numpy(rows).to(device)
        codes, scale, minv = codes[ridx], scale[ridx], minv[ridx]
    return codes, scale, minv


class IvfIndex:
    """Inverted-file ANN over uniform padded partitions on one device."""

    def __init__(self, dim: int, metric: DistanceMetric, n_clusters: int | None = None,
                 kmeans_iters: int = 8, kmeans_seed: int = 0, spill: int = 1,
                 pack_factor: float = 2.0, device="cuda"):
        self.dim = dim
        self.metric = DistanceMetric.parse(metric)
        if self.metric not in _METRICS:
            raise ValueError(f"IVF does not support metric {self.metric}")
        self.device = torch.device(device)
        self.n_clusters = n_clusters
        self.kmeans_iters = kmeans_iters
        self.kmeans_seed = kmeans_seed
        # spill assignment: each row lands in its ``spill`` nearest
        # partitions (2 = double memory, much higher recall per probe);
        # search dedups duplicates
        self.spill = max(1, int(spill))
        # partition slot budget: L = pack_factor * mean occupancy
        self.pack_factor = float(pack_factor)
        self.n = 0
        self.c = 0  # padded partition count == array leading dim
        self.c_real = 0  # exact live-partition count (nprobe cap basis)
        self.part_len = 0
        self._centroids = None  # [P, D] routing centroids
        self._cent_sq = None  # [P]
        self._parts = None  # [P, L, D] f32, or [P, L, D_pad/4] int32 words (sq8)
        self._part_scale = None  # [P, L] f32 (sq8 storage)
        self._part_minv = None  # [P, L] f32 (sq8 storage)
        self._part_rows = None  # [P, L] int64 original row ids, -1 pad
        self._part_sq = None  # [P, L] squared (dequantized) norms
        self._kmeans_cents = None  # [c, D]: the persistence recipe
        self._kmeans_c = 0
        self._kern = None  # (aux [P, 3, L], flat_rows [P*L]) of the probe kernel
        self._kern_ex = None  # (aux, excluded rows, aux with their slots dead)
        self.storage = "f32"  # 'sq8' when built from SQ8Vectors
        self._dirty = True

    # -- build ----------------------------------------------------------------

    def _mark(self, profile, stage, t0):
        return stage_mark(profile, stage, t0, self.device)

    def _live_f32(self, corpus, rows: np.ndarray):
        """The live rows as f32 on the device (one transfer from the host;
        no gather when every row of a device tensor is live), and the
        k-means input (normalized for cosine)."""
        if isinstance(corpus, torch.Tensor):
            live = corpus
            if len(rows) != corpus.shape[0]:
                live = corpus[torch.from_numpy(rows).to(corpus.device)]
            live = live.to(self.device, torch.float32)
        else:
            live = torch.from_numpy(np.ascontiguousarray(corpus[rows], np.float32)).to(self.device)
        if self.metric is DistanceMetric.COSINE:
            return live, live / torch.linalg.norm(live, dim=1, keepdim=True).clamp_min(1e-30)
        return live, live

    def build(self, corpus, valid: np.ndarray | None = None, profile: dict | None = None) -> None:
        """Build from ``corpus``: a numpy array or tensor ``[N, D]`` (f32 or
        half rows), or :class:`SQ8Vectors` (quantized partitions)."""
        t = time.perf_counter()
        sq8 = isinstance(corpus, SQ8Vectors)
        if not sq8 and not isinstance(corpus, torch.Tensor):
            corpus = np.asarray(corpus, np.float32)
        n = corpus.codes.shape[0] if sq8 else corpus.shape[0]
        if valid is None:
            valid = np.ones(n, bool)
        rows = np.flatnonzero(valid)
        self.n = n
        if len(rows) == 0:
            self._dirty = False
            return
        # ~256 rows per cluster, capped so the routing matmul stays small
        c = self.n_clusters or max(1, min(len(rows) // 256, 8192))
        c = min(c, len(rows))
        self.c = c
        if sq8:
            self.storage = "sq8"
            self._build_sq8(corpus, rows, c, profile=profile)
            self._dirty = False
            return
        self.storage = "f32"
        live, km_input = self._live_f32(corpus, rows)
        t = self._mark(profile, "partition.gather", t)
        cents, assign = kmeans(km_input, c, iters=self.kmeans_iters, seed=self.kmeans_seed)
        t = self._mark(profile, "partition.kmeans", t)
        self._kmeans_cents = cents
        self._kmeans_c = c
        self._assemble_partitions(live, km_input, rows, cents, c, assign, profile=profile)
        self._dirty = False

    def _build_sq8(self, sq: SQ8Vectors, rows: np.ndarray, c: int,
                   profile: dict | None = None) -> None:
        t = time.perf_counter()
        codes, scale, minv = _sq8_parts(sq, rows, self.device)
        n_live = codes.shape[0]
        rng = np.random.default_rng(self.kmeans_seed)
        # >=32 training points per centroid (kmeans() gets train_sample=None)
        take = min(max(262_144, 32 * c), n_live)
        sample = torch.from_numpy(rng.choice(n_live, size=take, replace=False)).to(self.device)
        deq_sample = codes[sample].float() * scale[sample][:, None] + minv[sample][:, None]
        if self.metric is DistanceMetric.COSINE:
            nrm = torch.linalg.norm(deq_sample, dim=1, keepdim=True)
            deq_sample = deq_sample / nrm.clamp_min(1e-30)
        cents, _ = kmeans(deq_sample, c, iters=self.kmeans_iters, seed=self.kmeans_seed,
                          train_sample=None)
        del deq_sample, sample  # before assembly: the sample is not needed there
        self._mark(profile, "partition.kmeans", t)
        self._kmeans_cents = cents
        self._kmeans_c = c
        self._assemble_sq8(codes, scale, minv, rows, cents, c, profile=profile)

    def build_from_centroids(self, sq: SQ8Vectors, valid, cents, profile: dict | None = None
                             ) -> None:
        """Assemble SQ8 partitions against given centroids, with no k-means
        run (reference ``:628``): the graph's entry IVF, seeded from the
        approximate build's router (a k-means clustering of the same
        corpus). Writes the port's partition arrays; the probe kernel's
        ``aux [P, 3, L]`` derives from them (:meth:`_kernel_state`)."""
        n = sq.codes.shape[0]
        rows = np.flatnonzero(np.asarray(valid, bool)[:n])
        self.n = n
        if len(rows) == 0:
            self._dirty = False
            return
        self.storage = "sq8"
        cents = torch.as_tensor(np.asarray(cents, np.float32) if not isinstance(
            cents, torch.Tensor) else cents).to(self.device, torch.float32)
        self._kmeans_cents = cents
        self._kmeans_c = int(cents.shape[0])
        self._assemble_sq8(*_sq8_parts(sq, rows, self.device), rows, cents, self._kmeans_c,
                           profile=profile)
        self._dirty = False

    def _set_parts(self, c: int, n_rows: int, assign, row_bytes: int):
        """Partition length, exact and padded counts from an assignment."""
        L = _round_up(max(int(np.ceil(self.pack_factor * n_rows / c)), 8), 8)
        self.part_len = L
        self.c_real = _exact_n_parts(assign, c, L)
        self.c = _padded_n_parts_capped(self.c_real, c, n_rows, L, row_bytes=row_bytes)
        return L

    def _assemble_sq8(self, codes, scale, minv, rows, cents, c, profile=None) -> None:
        t = time.perf_counter()
        s = min(self.spill, c) if self.spill > 1 else 1
        top = _assign_topk_sq8(codes, scale, minv, cents, s=s,
                               cosine=self.metric is DistanceMetric.COSINE)
        if s > 1:
            codes, scale, minv = codes.repeat(s, 1), scale.repeat(s), minv.repeat(s)
            rows = np.tile(rows, s)
        assign = top.T.reshape(-1)  # spill copy j of every row, then copy j+1
        t = self._mark(profile, "partition.assign", t)
        L = self._set_parts(c, len(rows), assign, max(self.dim, 1))
        t = self._mark(profile, "partition.nparts", t)
        (self._centroids, self._cent_sq, self._parts, self._part_scale, self._part_minv,
         self._part_rows, self._part_sq) = _group_partitions_sq8(
            codes, scale, minv, assign, cents, torch.from_numpy(rows).to(self.device),
            c=c, L=L, n_parts=self.c)
        self._mark(profile, "partition.payload", t)
        self._kern = None

    def _assemble_partitions(self, live, km_input, rows, cents, c, assign=None,
                             profile=None) -> None:
        """Deterministic partition assembly from centroids (shared by build
        and load: the persisted artifact is centroids + meta only)."""
        t = time.perf_counter()
        if self.spill > 1:
            # each row also lands in its next-nearest clusters: one more
            # assignment pass, ``spill`` x the partition memory
            s = min(self.spill, c)
            assign = _assign_topk(km_input, cents, s=s).T.reshape(-1)
            live = live.repeat(s, 1)
            rows = np.tile(rows, s)
        elif assign is None:
            assign = _assign_full(km_input, cents)
        t = self._mark(profile, "partition.assign", t)
        L = self._set_parts(c, len(rows), assign, 4 * max(self.dim, 1))
        t = self._mark(profile, "partition.nparts", t)
        (self._centroids, self._cent_sq, self._parts, self._part_rows,
         self._part_sq) = _group_partitions(
            live, assign, cents, torch.from_numpy(rows).to(self.device), c=c, L=L,
            n_parts=self.c)
        self._mark(profile, "partition.payload", t)
        self._kern = None

    def invalidate(self, _ids=None) -> None:
        self._dirty = True

    @property
    def dirty(self) -> bool:
        return self._dirty

    def nprobe_for(self, ef: int | None, quality=None) -> int:
        """Quality knob: ef budget -> partitions probed. Recall tracks corpus
        coverage ``nprobe * L / N`` (the reference's calibration, ``:781``):
        the balanced profile (ef=128) probes ~3.5% of the rows, other
        profiles scale linearly in ef; spilled builds scale by ``spill``."""
        if quality is not None:
            ef = SearchQuality.parse(quality).ef
        ef = ef or 128
        n_live = max(self.n, 1)
        cov = ef / 3700.0  # ef=128 -> 3.46% coverage
        want = -(-int(cov * n_live * self.spill) // max(self.part_len, 1))
        return int(min(max(want, 2), self.c_real or self.c))

    # -- search ----------------------------------------------------------------

    def search(self, queries, k: int, ef: int | None = None, quality=None,
               nprobe: int | None = None, mask=None, exclude=None):
        """Returns ``(values [B, k] f32, row ids [B, k] int64)`` best-first on
        the index's device.

        ``exclude`` (row ids) leaves those rows out, as a mask that drops
        them would, but an unmasked batch that the probe kernel serves stays
        on the kernel: the rows' slots turn dead (``pen = +inf``) in a copy
        of its state (:meth:`_excluded_state`). The reference folds them into
        the mask, which sends every such search to the plain path."""
        q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=self.device))
        b = q.shape[0]
        nprobe = min(nprobe or self.nprobe_for(ef, quality), self.c_real or self.c)
        itemsize = 1 if self.storage == "sq8" else 4
        kernel = mask is None and ivf_probe_supported(b, self.part_len, self.dim, itemsize)
        exclude = None if exclude is None else np.unique(np.asarray(exclude, np.int64))
        if exclude is not None and len(exclude) and not kernel:
            n = max(self.n, 0 if mask is None else len(mask), int(exclude[-1]) + 1)
            m = np.ones(n, bool)
            if mask is not None:
                m[: len(mask)] = np.asarray(mask, bool)
                m[len(mask):] = False
            m[exclude[exclude >= 0]] = False
            mask = m
        mask_dev = None
        if mask is not None:
            m = np.asarray(mask, bool)
            m = np.pad(m, (0, max(0, self.n - m.shape[0])))
            mask_dev = torch.from_numpy(m).to(self.device)
        # spilled rows can surface from two probed partitions: over-fetch,
        # dedup (duplicates carry bit-identical scores), re-trim
        k_fetch = min(self.spill * k + 8 if self.spill > 1 else k, nprobe * self.part_len)
        if kernel:
            state = self._kernel_state()
            if exclude is not None and len(exclude):
                state = (self._excluded_state(exclude), state[1])
            vals, idx = ivf_probe_topk(q, self._centroids, self._cent_sq, self._parts, *state,
                                       k=k_fetch, nprobe=nprobe, metric=self.metric)
        else:
            parts = ((self._parts, self._part_scale, self._part_minv)
                     if self.storage == "sq8" else self._parts)
            vals, idx = ivf_search_impl(q, self._centroids, self._cent_sq, parts,
                                        self._part_rows, self._part_sq, mask_dev, k=k_fetch,
                                        nprobe=nprobe, metric=self.metric)
        if self.spill > 1:
            vals, idx = _dedup_topk(vals, idx, k=min(k, k_fetch),
                                    higher_is_better=self.metric.higher_is_better)
        return vals, idx

    def _kernel_state(self):
        """Probe-kernel operands ``(aux [P, 3, L], flat_rows [P*L] int64)``:
        cosine's 1/|c| folds into the affine so raw dots are cosine scores;
        euclidean's |c|^2 rides as the additive penalty; dead slots carry
        +inf. Derived once per assembly, cached on the index."""
        if self._kern is None:
            psq = self._part_sq
            zero = torch.zeros_like(psq)
            cosine = self.metric is DistanceMetric.COSINE
            inv = torch.where(psq > 1e-30, torch.rsqrt(psq.clamp_min(1e-30)), 0.0)
            if self.storage == "sq8":
                mul, add = self._part_scale, self._part_minv
                if cosine:
                    mul, add = mul * inv, add * inv
            else:  # f32 rows: dots need no affine restore
                mul = inv if cosine else torch.ones_like(psq)
                add = zero
            pen_base = psq if self.metric is DistanceMetric.EUCLIDEAN else zero
            pen = torch.where(self._part_rows >= 0, pen_base, torch.inf)
            aux = torch.stack([mul, add, pen], dim=1).float().contiguous()
            self._kern = (aux, self._part_rows.reshape(-1))
        return self._kern

    def _excluded_state(self, rows: np.ndarray) -> torch.Tensor:
        """The probe kernel's ``aux`` with the slots of ``rows`` (sorted
        unique row ids) dead, cached for the last such set."""
        aux = self._kernel_state()[0]
        ex = self._kern_ex
        if ex is None or ex[0] is not aux or not np.array_equal(ex[1], rows):
            dead = torch.isin(self._part_rows, torch.from_numpy(rows).to(self.device))
            out = aux.clone()
            out[:, 2, :] = torch.where(dead, torch.inf, aux[:, 2, :])
            self._kern_ex = ex = (aux, rows, out)
        return ex[2]

    # -- persistence -------------------------------------------------------------

    def save(self, path: str, version: int = 0) -> None:
        """Persist the recipe (k-means centroids + meta), not the partition
        layout: ``load`` re-runs the deterministic assembly on the device."""
        if self._parts is None or self._kmeans_cents is None:
            return
        np.savez_compressed(
            path,
            kmeans_cents=self._kmeans_cents.cpu().numpy(),
            kmeans_c=self._kmeans_c,
            n=self.n,
            metric=self.metric.value,
            version=version,
            spill=self.spill,
            storage=self.storage,
        )

    def load(self, path: str, corpus, valid: np.ndarray, version: int = 0) -> bool:
        """Reassemble from a saved recipe over ``corpus`` (as for
        :meth:`build`); False (nothing loaded) when the file is missing or
        stale: another metric, version, storage or row count."""
        if not os.path.exists(path):
            return False
        data = np.load(path)
        if (str(data["metric"]) != self.metric.value or int(data["version"]) != version
                or "kmeans_cents" not in data):
            return False
        sq8 = isinstance(corpus, SQ8Vectors)
        saved_storage = str(data["storage"]) if "storage" in data else "f32"
        if saved_storage != ("sq8" if sq8 else "f32"):
            return False  # storage mode changed: rebuild
        self.n = corpus.codes.shape[0] if sq8 else corpus.shape[0]
        if int(data["n"]) != self.n:
            return False
        self.spill = int(data["spill"]) if "spill" in data else 1
        rows = np.flatnonzero(np.asarray(valid, bool)[: self.n])
        if len(rows) == 0:
            return False
        cents = torch.from_numpy(np.asarray(data["kmeans_cents"], np.float32)).to(self.device)
        self._kmeans_cents = cents
        self._kmeans_c = int(data["kmeans_c"])
        if sq8:
            self.storage = "sq8"
            self._assemble_sq8(*_sq8_parts(corpus, rows, self.device), rows, cents,
                               self._kmeans_c)
        else:
            self.storage = "f32"
            if not isinstance(corpus, torch.Tensor):
                corpus = np.asarray(corpus, np.float32)
            live, km_input = self._live_f32(corpus, rows)
            self._assemble_partitions(live, km_input, rows, cents, self._kmeans_c)
        self._dirty = False
        return True


def _dedup_topk(vals, idx, *, k: int, higher_is_better: bool):
    """Drop duplicate row ids (first occurrence wins) and re-trim to k."""
    eq = (idx[:, :, None] == idx[:, None, :]) & (idx[:, :, None] >= 0)
    dup = torch.any(torch.tril(eq, -1), dim=2)
    keep = ~dup & (idx >= 0)
    worst = -torch.inf if higher_is_better else torch.inf
    v, pos = _best(torch.where(keep, vals, worst), k, higher_is_better)
    i = torch.gather(idx, 1, pos)
    return v, torch.where(v == worst, -1, i)


def ivf_search_impl(q, cents, cent_sq, parts, part_rows, part_sq, mask, *, k: int, nprobe: int,
                    metric):
    """Probing search in plain torch (reference ``:1018``): ``parts`` is
    either ``[P, L, D] f32`` or a ``(words int32, scale, minv)`` triple (SQ8
    storage, scored through the rank-1 affine identity on the unpacked
    codes). A mask prunes the routing to partitions that hold a masked row
    (a partition with none cannot contribute) and knocks masked rows out of
    the scores. Returns ``(vals [B, k], row ids [B, k] int64)`` in the
    metric's native orientation. (The reference's ``exclude_rows`` serves
    its self-kNN builder, which waits for the graph port.)"""
    metric = DistanceMetric.parse(metric)
    quant = isinstance(parts, tuple)
    b, d = q.shape
    if metric is DistanceMetric.COSINE:
        qn = q / torch.linalg.norm(q, dim=1, keepdim=True).clamp_min(1e-30)
    else:
        qn = q
    if quant:
        pwords, pscale, pminv = parts
        qsum = torch.sum(qn, dim=1, keepdim=True)  # [B, 1]
        qb = F.pad(qn, (0, pwords.shape[-1] * 4 - d)).to(torch.bfloat16).float()
    route = qn @ cents.T
    if metric is DistanceMetric.EUCLIDEAN:
        route = route - 0.5 * cent_sq[None, :]
    route = _route_mask(route, cent_sq)  # bucket-padded partitions -> -inf
    if mask is not None:
        # mask-aware probe pruning: a correlated filter concentrates the
        # masked rows in few partitions far from the query; drop partitions
        # with no masked row so the probes re-aim at the kept ones
        pmask = mask[part_rows.clamp_min(0)] & (part_rows >= 0)
        route = torch.where(torch.any(pmask, dim=1)[None, :], route, -torch.inf)
    _, probe = first_topk(route, nprobe)  # [B, nprobe]

    hib = metric.higher_is_better
    worst = -torch.inf if hib else torch.inf
    qq = torch.sum(qn * qn, dim=1, keepdim=True)
    rv = torch.full((b, k), worst, dtype=torch.float32, device=q.device)
    ri = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for p in range(nprobe):
        pid = probe[:, p]  # [B]
        rows = part_rows[pid]  # [B, L]
        if quant:
            blk = sq8_unpack_words(pwords[pid], torch.float32)  # [B, L, D_pad]
            dots = torch.bmm(blk, qb[:, :, None])[:, :, 0] * pscale[pid] + qsum * pminv[pid]
        else:
            dots = torch.bmm(parts[pid], qn[:, :, None])[:, :, 0]
        if metric is DistanceMetric.COSINE:
            s = dots / torch.sqrt(part_sq[pid].clamp_min(1e-30))
        elif metric is DistanceMetric.EUCLIDEAN:
            s = torch.sqrt((qq + part_sq[pid] - 2.0 * dots).clamp_min(0.0))
        else:
            s = dots
        ok = rows >= 0
        if mask is not None:
            ok = ok & mask[rows.clamp_min(0)]
        s = torch.where(ok, s, worst)
        rows = torch.where(ok, rows, -1)
        rv, pos = _best(torch.cat([rv, s], dim=1), k, hib)
        ri = torch.gather(torch.cat([ri, rows], dim=1), 1, pos)
    return rv, ri


def ivf_state_from_jax(arrays: dict, device) -> IvfIndex:
    """A port :class:`IvfIndex` holding a reference ``IvfIndex``'s state, so
    both packages search the same partitions.

    ``arrays`` holds numpy copies of the reference index's arrays under their
    attribute names without the leading underscore (``centroids``,
    ``cent_sq``, ``parts``, ``part_scale`` and ``part_minv`` (SQ8 storage),
    ``part_rows``, ``part_sq``, ``kmeans_cents``), its scalars (``n``, ``c``,
    ``c_real``, ``part_len``, ``spill``, ``storage``) and ``metric``; and,
    optionally, ``aux``: the reference's probe-kernel state ``[P, 8, L]``,
    whose rows 0-2 become the port's ``aux [P, 3, L]`` (else it is derived
    anew on first search)."""

    def put(key, dtype):
        a = arrays.get(key)
        if a is None:
            return None
        return torch.tensor(np.asarray(a, dtype), device=device)

    cents = arrays["centroids"]
    metric = getattr(arrays["metric"], "value", arrays["metric"])  # the name, or an enum of it
    idx = IvfIndex(cents.shape[1], metric, spill=int(arrays["spill"]), device=device)
    for key in ("n", "c", "c_real", "part_len"):
        setattr(idx, key, int(arrays[key]))
    idx.storage = str(arrays["storage"])
    idx._centroids = put("centroids", np.float32)
    idx._cent_sq = put("cent_sq", np.float32)
    idx._parts = put("parts", np.int32 if idx.storage == "sq8" else np.float32)
    idx._part_scale = put("part_scale", np.float32)
    idx._part_minv = put("part_minv", np.float32)
    idx._part_rows = put("part_rows", np.int64)
    idx._part_sq = put("part_sq", np.float32)
    idx._kmeans_cents = put("kmeans_cents", np.float32)
    idx._kmeans_c = 0 if idx._kmeans_cents is None else idx._kmeans_cents.shape[0]
    if arrays.get("aux") is not None:
        aux = torch.tensor(np.asarray(arrays["aux"][:, :3], np.float32), device=device)
        idx._kern = (aux, idx._part_rows.reshape(-1))
    idx._dirty = False
    return idx


# -- the graph index's kNN builders (reference ``:1130-1610``) -------------------


def _probe_parts(cents, cent_sq, *, nprobe: int, metric, chunk: int = 2048) -> torch.Tensor:
    """Top-``nprobe`` nearest partitions of every partition ``[P, nprobe]``,
    in row chunks of the ``[P, P]`` affinity. ``cent_sq`` is the stored
    routing norm (padded partitions carry the sentinel)."""
    out = []
    for r0 in range(0, cents.shape[0], chunk):
        aff = cents[r0 : r0 + chunk] @ cents.T
        if metric is DistanceMetric.EUCLIDEAN:
            aff = aff - 0.5 * cent_sq[None, :]
        out.append(first_topk(_route_mask(aff, cent_sq), min(nprobe, cents.shape[0]))[1])
    return torch.cat(out)


#: scores ``[G, L, nprobe*L]`` per step of the bucketed kNN
_KNN_STEP_ELEMS = 1 << 26


def _knn_select(q, qrows, qsq, cand, crows, csq, *, k: int, metric):
    """Top-``k`` neighbours of ``G`` partitions' rows ``q [G, L, D]`` among
    their candidates ``cand [G, M, D]`` (maximize-oriented scores; the
    query's own row and empty slots excluded): ``(vals, nbr) [G, L, k]``."""
    g, L, _ = q.shape
    dots = torch.bmm(q, cand.transpose(1, 2))  # [G, L, M]
    if metric is DistanceMetric.EUCLIDEAN:
        s = 2.0 * dots - csq[:, None, :]
    elif metric is DistanceMetric.COSINE:
        s = (dots * torch.rsqrt(qsq.clamp_min(1e-30))[:, :, None]
             * torch.rsqrt(csq.clamp_min(1e-30))[:, None, :])
    else:
        s = dots
    ok = (crows[:, None, :] >= 0) & (crows[:, None, :] != qrows[:, :, None])
    s = torch.where(ok, s, -torch.inf)
    v, i = first_topk(s.reshape(g * L, -1), k)
    nbr = torch.gather(crows, 1, i.reshape(g, L * k)).reshape(g, L, k)
    v = v.reshape(g, L, k)
    return v, torch.where(v == -torch.inf, -1, nbr)


def _bucketed_self_knn(parts, part_rows, part_sq, cents, cent_sq, *, k: int, nprobe: int,
                       metric):
    """Partition-bucketed approximate self-kNN (reference ``:1155``): each
    partition's rows scored against its ``nprobe`` nearest partitions' rows,
    so every row is read O(nprobe) times in all. Returns ``(vals, nbr)``
    ``[P, L, k]`` (-1 = none)."""
    P, L, D = parts.shape
    probe = _probe_parts(cents, cent_sq, nprobe=nprobe, metric=metric,
                         chunk=min(2048, _round_up(P, 8)))
    step = max(1, _KNN_STEP_ELEMS // (L * probe.shape[1] * L))
    vals, nbrs = [], []
    for p0 in range(0, P, step):
        pr = probe[p0 : p0 + step]
        g = pr.shape[0]
        v, nb = _knn_select(parts[p0 : p0 + g], part_rows[p0 : p0 + g], part_sq[p0 : p0 + g],
                            parts[pr].reshape(g, -1, D), part_rows[pr].reshape(g, -1),
                            part_sq[pr].reshape(g, -1), k=k, metric=metric)
        vals.append(v)
        nbrs.append(nb)
    return torch.cat(vals), torch.cat(nbrs)


def _sq8_knn_block(parts_w, pscale, pminv, part_rows, part_sq, probe, start: int, *, k: int,
                   nprobe: int, metric, d: int, count: int):
    """The SQ8 bucketed self-kNN of partitions ``[start, start + count)``
    (reference ``:1200``): words unpacked and dequantized per step, padded
    dims masked to 0 to match ``part_sq``."""
    P, L, W = parts_w.shape
    dmask = (torch.arange(4 * W, device=parts_w.device) < d).float()

    def deq(words, sc, mn):
        return (sq8_unpack_words(words, torch.float32) * sc[..., None] + mn[..., None]) * dmask

    step = max(1, _KNN_STEP_ELEMS // (L * nprobe * L))
    vals, nbrs = [], []
    for p0 in range(start, start + count, step):
        p1 = min(p0 + step, start + count)
        pr = probe[p0:p1]
        g = pr.shape[0]
        q = deq(parts_w[p0:p1], pscale[p0:p1], pminv[p0:p1])
        cand = deq(parts_w[pr].reshape(g, -1, W), pscale[pr].reshape(g, -1),
                   pminv[pr].reshape(g, -1))
        v, nb = _knn_select(q, part_rows[p0:p1], part_sq[p0:p1], cand,
                            part_rows[pr].reshape(g, -1), part_sq[pr].reshape(g, -1),
                            k=k, metric=metric)
        vals.append(v)
        nbrs.append(nb)
    return torch.cat(vals), torch.cat(nbrs)


def _bucketed_self_knn_sq8(parts_w, pscale, pminv, part_rows, part_sq, cents, cent_sq, *,
                           k: int, nprobe: int, metric, d: int, block_parts: int = 4096):
    """SQ8 variant of :func:`_bucketed_self_knn` (reference ``:1250``): the
    partitions stay packed words, each step dequantizes only its working
    set; results land on the host block by block. Returns host ``(vals,
    nbr)`` ``[P, L, k]``."""
    P, L, _ = parts_w.shape
    probe = _probe_parts(cents, cent_sq, nprobe=nprobe, metric=metric,
                         chunk=min(2048, _round_up(P, 8)))
    count = min(block_parts, P)
    vals_h = np.empty((P, L, k), np.float32)
    nbr_h = np.empty((P, L, k), np.int64)
    for s0 in range(0, P, count):
        st = min(s0, P - count)  # the tail overlap recomputes identical rows
        v, nb = _sq8_knn_block(parts_w, pscale, pminv, part_rows, part_sq, probe, st, k=k,
                               nprobe=probe.shape[1], metric=metric, d=d, count=count)
        vals_h[st : st + count] = v.cpu().numpy()
        nbr_h[st : st + count] = nb.cpu().numpy()
    return vals_h, nbr_h


#: the approximate kNN build quantizes its partition copy to SQ8 from this
#: many rows, or from this many f32 corpus bytes (reference ``:1290-1297``)
SQ8_BUILD_MIN_ROWS = int(os.environ.get("VELESDB_SQ8_BUILD_MIN_ROWS", 4_000_000))
SQ8_BUILD_MIN_BYTES = int(os.environ.get("VELESDB_SQ8_BUILD_MIN_BYTES", 2 << 30))


def ivf_self_knn(corpus, k: int, metric, valid=None, nprobe: int = 8, qblock: int = 1024,
                 n_clusters: int | None = None, passes: int = 1, return_router: bool = False,
                 sq8: bool | None = None, profile: dict | None = None,
                 return_device: bool = False, device="cuda"):
    """Approximate kNN graph of a corpus against itself, ``[N, k]`` (-1 =
    none; reference ``:1301``): k-means partitions, then each partition
    against its ``nprobe`` nearest partitions. ``corpus`` is a tensor (built
    on its device) or a numpy array (moved to ``device``).

    ``passes`` decorrelated clusterings (k-means seeds 0, 1, ...) are unioned.
    ``return_router`` also returns the first pass's router ``(centroids
    [P, D], part_rows [P, L])`` as host arrays (bucket-padded partitions
    stripped). ``sq8`` (default: from ``SQ8_BUILD_MIN_ROWS`` / ``_BYTES``)
    builds the partitions as SQ8 words and scores dequantized blocks.
    ``return_device`` returns an int64 tensor on the device, else an int32
    numpy array. ``qblock`` is accepted for the reference's signature."""
    del qblock
    metric = DistanceMetric.parse(metric)
    dev = corpus.device if isinstance(corpus, torch.Tensor) else torch.device(device)
    t = time.perf_counter()

    def mark(stage, t0):
        return stage_mark(profile, stage, t0, dev)

    x = corpus if isinstance(corpus, torch.Tensor) else np.asarray(corpus, np.float32)
    n, d_true = x.shape
    if sq8 is None:
        sq8 = n >= SQ8_BUILD_MIN_ROWS or n * d_true * 4 >= SQ8_BUILD_MIN_BYTES
    src = x
    if sq8:
        from velesdb_tpu_torch.ops.quantization import sq8_quantize

        xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(x).to(dev)
        src = sq8_quantize(xt)
    t = mark("knn.quantize", t)
    valid_np = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    router = None
    pass_vals, pass_ids = [], []
    for p in range(max(passes, 1)):
        t = time.perf_counter()
        ivf = IvfIndex(d_true, metric, n_clusters=n_clusters, kmeans_seed=p, device=dev)
        ivf.build(src, valid_np, profile=profile)
        t = mark("knn.partition", t)
        if ivf._parts is None:
            empty = np.full((n, k), -1, np.int32)
            return (empty, None) if return_router else empty
        if p == 0 and return_router:
            router = (ivf._centroids[: ivf.c_real].cpu().numpy(),
                      ivf._part_rows[: ivf.c_real].cpu().numpy().astype(np.int32))
        nprobe_p = int(min(max(nprobe, 1), ivf.c_real or ivf.c))
        k_eff = min(k, max(nprobe_p * ivf.part_len - 1, 1))
        if sq8:
            vals_h, nbr_h = _bucketed_self_knn_sq8(
                ivf._parts, ivf._part_scale, ivf._part_minv, ivf._part_rows, ivf._part_sq,
                ivf._centroids, ivf._cent_sq, k=k_eff, nprobe=nprobe_p, metric=metric, d=d_true)
            t = mark("knn.score", t)
            rows = ivf._part_rows.cpu().numpy().reshape(-1)
            live = rows >= 0
            out_i = np.full((n, k), -1, np.int64)
            out_v = np.full((n, k), -np.inf, np.float32)
            out_i[rows[live], :k_eff] = nbr_h.reshape(-1, k_eff)[live]
            out_v[rows[live], :k_eff] = vals_h.reshape(-1, k_eff)[live]
            pass_ids.append(out_i)
            pass_vals.append(out_v)
            t = mark("knn.readback", t)
        else:
            vals_d, nbr_d = _bucketed_self_knn(ivf._parts, ivf._part_rows, ivf._part_sq,
                                               ivf._centroids, ivf._cent_sq, k=k_eff,
                                               nprobe=nprobe_p, metric=metric)
            sv, si = _scatter_knn(vals_d, nbr_d, ivf._part_rows, n=n, k=k, k_eff=k_eff)
            t = mark("knn.score", t)
            pass_ids.append(si)
            pass_vals.append(sv)
    if sq8:
        out = pass_ids[0] if len(pass_ids) == 1 else merge_ranked(pass_vals, pass_ids, k)
        out[~valid_np] = -1
        mark("knn.merge", t)
        if return_device:
            out = torch.from_numpy(out.astype(np.int64)).to(dev)
        else:
            out = out.astype(np.int32)
        return (out, router) if return_router else out
    out_d = pass_ids[0]
    if len(pass_ids) > 1:
        out_d = _merge_ranked_device(torch.cat(pass_vals, dim=1), torch.cat(pass_ids, dim=1), k=k)
    out_d = torch.where(torch.tensor(valid_np, device=dev)[:, None], out_d, -1)
    mark("knn.merge", t)
    out = out_d if return_device else out_d.cpu().numpy().astype(np.int32)
    return (out, router) if return_router else out


def _scatter_knn(vals_d, nbr_d, part_rows, *, n: int, k: int, k_eff: int):
    """Partition-shaped kNN ``[P, L, k_eff]`` to row-shaped ``[n, k]`` on the
    device, dead slots dropped (reference ``:1455``)."""
    rows = part_rows.reshape(-1)
    live = rows >= 0
    out_v = torch.full((n, k), -torch.inf, dtype=torch.float32, device=vals_d.device)
    out_i = torch.full((n, k), -1, dtype=torch.int64, device=vals_d.device)
    dest = rows[live].long()
    out_v[dest, :k_eff] = vals_d.reshape(-1, k_eff)[live].float()
    out_i[dest, :k_eff] = nbr_d.reshape(-1, k_eff)[live].long()
    return out_v, out_i


def _merge_ranked_device(allv, alli, *, k: int):
    """Device counterpart of :func:`merge_ranked` (reference ``:1471``):
    order by (value descending, id) with two stable sorts, blank adjacent
    repeats, keep the best ``k`` (ties to the smallest position)."""
    o1 = torch.sort(alli, dim=1, stable=True).indices
    o2 = torch.sort(-torch.gather(allv, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)
    sv = torch.gather(allv, 1, order)
    si = torch.gather(alli, 1, order)
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = (si[:, 1:] == si[:, :-1]) & (si[:, 1:] >= 0)
    sv = torch.where(dup | (si < 0), -torch.inf, sv)
    vals, pos = first_topk(sv, k)
    return torch.where(vals == -torch.inf, -1, torch.gather(si, 1, pos))


def merge_ranked(vals_list, ids_list, k: int) -> np.ndarray:
    """Union-merge ranked candidate lists per row (host numpy, reference
    ``:1490``): scores are maximize-oriented and equal for equal (row, id)
    pairs, so a lexsort (value descending, id) makes duplicates adjacent.
    Returns ``[N, k]`` ids (-1 = none)."""
    allv = np.concatenate(vals_list, axis=1)
    alli = np.concatenate(ids_list, axis=1)
    order = np.lexsort((alli, -allv), axis=1)
    sv = np.take_along_axis(allv, order, axis=1)
    si = np.take_along_axis(alli, order, axis=1)
    dup = np.zeros_like(si, bool)
    dup[:, 1:] = (si[:, 1:] == si[:, :-1]) & (si[:, 1:] >= 0)
    sv[dup | (si < 0)] = -np.inf
    keep = np.argsort(-sv, axis=1, kind="stable")[:, :k]
    out = np.take_along_axis(si, keep, axis=1)
    out[np.take_along_axis(sv, keep, axis=1) == -np.inf] = -1
    return out


def _nn_descent_scan(corpus, cnorm, knn, valid, *, k: int, sample: int, block: int, metric,
                     out_k: int):
    """One NN-descent round (reference ``:1512``): per node, rescore its
    neighbours and sampled neighbours of neighbours exactly, first
    occurrence only, keep the best ``out_k``. ``([N, out_k] vals, ids)``."""
    from velesdb_tpu_torch.index.graph_index import _first_occurrence

    n = knn.shape[0]
    vals, ids = [], []
    for base in range(0, n, block):
        q = corpus[base : base + block]
        nb = knn[base : base + block]
        bs = nb.shape[0]
        ids_s = nb[:, :sample]
        nn2 = knn[ids_s.clamp_min(0)][:, :, :sample]
        nn2 = torch.where(ids_s[:, :, None] >= 0, nn2, -1)
        cand = torch.cat([nb, nn2.reshape(bs, -1)], dim=1)
        self_id = torch.arange(base, base + bs, device=cand.device)[:, None]
        ok = (cand >= 0) & (cand != self_id) & valid[cand.clamp_min(0)]
        # first occurrence among the candidates that pass
        big = 1 << 40
        pos = torch.arange(cand.shape[1], device=cand.device)
        ok = ok & _first_occurrence(torch.where(ok, cand, big + pos))
        vecs = corpus[cand.clamp_min(0)]
        dots = torch.bmm(vecs, q[:, :, None])[:, :, 0]
        cc = cnorm[cand.clamp_min(0)]
        if metric is DistanceMetric.EUCLIDEAN:
            s = 2.0 * dots - cc
        elif metric is DistanceMetric.COSINE:
            qs = torch.rsqrt(torch.sum(q * q, dim=1, keepdim=True).clamp_min(1e-30))
            s = dots * qs * torch.rsqrt(cc.clamp_min(1e-30))
        else:
            s = dots
        s = torch.where(ok, s, -torch.inf)
        v, p = first_topk(s, out_k)
        vals.append(v)
        ids.append(torch.where(v == -torch.inf, -1, torch.gather(cand, 1, p)))
    return torch.cat(vals), torch.cat(ids)


def _reverse_knn(knn: np.ndarray, n: int, k: int) -> np.ndarray:
    """First-k reverse edges per node: ``[N, k]`` (-1 padded)."""
    src = np.repeat(np.arange(n, dtype=np.int64), knn.shape[1])
    dst = knn.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    start = np.searchsorted(dst_s, np.arange(n))
    pos = np.arange(len(dst_s)) - start[dst_s]
    keep = pos < k
    out = np.full((n, k), -1, np.int64)
    out[dst_s[keep], pos[keep]] = src_s[keep]
    return out


def nn_descent_round(corpus, knn, metric, valid=None, sample: int = 16, block: int = 512,
                     device="cuda") -> np.ndarray:
    """Refine a kNN graph by one NN-descent round (neighbours of neighbours
    rescored, both edge directions joined; reference ``:1571``). ``knn`` is
    numpy or a tensor; returns ``[N, k]`` numpy int64."""
    metric = DistanceMetric.parse(metric)
    x = corpus if isinstance(corpus, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(corpus, np.float32)).to(device)
    x = x.float()
    knn = knn.cpu().numpy() if isinstance(knn, torch.Tensor) else np.asarray(knn)
    n, k = knn.shape
    sample = min(sample, k)
    both = np.concatenate([knn.astype(np.int64), _reverse_knn(knn.astype(np.int64), n, k)], 1)
    valid_np = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    vals, ids = _nn_descent_scan(
        x, torch.sum(x * x, dim=1), torch.from_numpy(both).to(x.device),
        torch.tensor(valid_np, device=x.device), k=2 * k, sample=sample, block=block,
        metric=metric, out_k=min(2 * k, k + sample * sample))
    out = merge_ranked([vals.cpu().numpy()], [ids.cpu().numpy()], k)
    out[~valid_np] = -1
    return out
