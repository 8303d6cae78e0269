"""Exact streaming top-k kernels: fused distance top-k (#8) and packed
Hamming top-k (#9).

Counterpart of ``velesdb_tpu/ops/pallas_kernels.py``.

``fused_topk`` (``:265``, ``_fused_kernel`` ``:119``) is the public op that
scores f32 queries against an f32, f16 or bf16 corpus and keeps the top-k
(the JAX package's serve path no longer calls it). The TPU kernel carries a
running top-k across its grid; the CUDA kernel ``csrc/fused_topk.cu`` scores
row ranges in parallel on the tensor cores (split-bf16: three bf16 products
of the split query and row), keeps each range's best k behind a running
threshold, and merges them per query in a second pass. Both select on one
int64 key per score (its order-preserving bits above the reversed row), so
ties go to the smallest row as in the reference's ``_merge_topk``. ``k`` is
capped at :data:`MAX_K` (1,024). :func:`fused_topk_ref` is its plain
version (the fixed-order fp32 dot); the kernel is held to it within
:func:`fused_topk_tolerance`.

``hamming_topk`` (``:410``, ``_hamming_topk_entry`` ``:366``): the BINARY serve core at small
N or large k, where one winner per bucket would lose results. The TPU kernel
carries a running top-k across its sequential grid (k max-extraction passes
per chunk). Hopper blocks run in no order, so the hand-written CUDA kernel
``csrc/hamming_topk.cu`` is a different design with the same result: one
block per query builds a histogram of the integer distances, finds the
threshold distance, and collects the rows under it in row order. Ties go to
the smallest row index, the first-occurrence rule of the reference's
``_merge_topk`` (``:98-101``), so ids equal the reference's exactly.
:func:`hamming_topk_ref` is its plain version (a stable sort).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from velesdb_tpu_torch.ops import _cuda
from velesdb_tpu_torch.ops.bucket_kernel import (
    _FLOAT_CODES,
    _IIJ,
    _P,
    _kernel_route,
    _launch,
    _ordered_dot,
    _round_up,
    _score_keys,
    _ulp,
    hamming_distances,
    order_bound,
    ranked_error,
    split_f32_rows,
)
from velesdb_tpu_torch.ops.distance import DistanceMetric, normalize

__all__ = [
    "DEFAULT_CHUNK",
    "FUSED_SCRATCH_BYTES",
    "LAUNCHES",
    "MAX_K",
    "fit_chunk",
    "fused_topk",
    "fused_topk_error",
    "fused_topk_ref",
    "fused_topk_scan",
    "fused_topk_tolerance",
    "hamming_topk",
    "hamming_topk_ref",
]

# Kernel launches, counted where the CUDA kernel is launched and nowhere else.
LAUNCHES = {"fused_topk": 0, "hamming_topk": 0}

DEFAULT_CHUNK = 2048  # the reference's corpus rows per grid step
MAX_K = 1024  # the rows of one pass-one range of csrc/fused_topk.cu
_FUSED_ROWS = 1024
# Pass one's candidate scratch, ``B * ceil(N / 1024) * k`` int64 keys (B*N*k/128
# bytes: 2 GiB at B 256, N 1M, k 1,024), is capped per launch: larger batches
# launch in query slices (multiples of 8) that fit it.
FUSED_SCRATCH_BYTES = 256 << 20
_FUSED_MAX_DPAD = 4096  # the entry's cap: rows and queries stream by 64-dim K block
_METRIC_CODES = {DistanceMetric.DOT_PRODUCT: 0, DistanceMetric.COSINE: 1,
                 DistanceMetric.EUCLIDEAN: 2}


def fit_chunk(b: int, d: int, k: int, itemsize: int = 4, n: int | None = None) -> int:
    """The reference's VMEM-fitted corpus chunk (``:61-77``), kept for API
    parity: the CUDA kernel's row ranges do not depend on it, and no result
    does."""
    b_pad = _round_up(b, 8)
    d_pad = _round_up(d, 128)
    k_pad = _round_up(max(k, 8), 128)
    budget = 16 * 1024 * 1024 - b_pad * d_pad * 4 - 8 * b_pad * k_pad
    denom = 2 * d_pad * itemsize + 4 * b_pad
    fit = max(256, (budget // denom) // 256 * 256)
    if n is not None:
        fit = min(fit, _round_up(n, 256))
    return int(min(fit, DEFAULT_CHUNK))


def _decode_keys(keys: torch.Tensor):
    """``(score f32, column int64)`` back from :func:`_score_keys`, with the
    column -1 where the score is -inf."""
    hi = torch.div(keys, 1 << 32, rounding_mode="floor").to(torch.int32)
    s = torch.where(hi >= 0, hi, hi ^ 0x7FFFFFFF).view(torch.float32)
    col = (1 << 32) - 1 - (keys & 0xFFFFFFFF)
    return s, torch.where(s == -torch.inf, -1, col)


def _check_fused(q, rows, valid, aux, qq, k):
    if rows.dtype not in _FLOAT_CODES or q.dtype != torch.float32:
        raise TypeError(f"expected q float32 and f32/f16/bf16 rows, got {q.dtype}, {rows.dtype}")
    if valid.dtype != torch.bool or aux.dtype != torch.float32 or qq.dtype != torch.float32:
        raise TypeError("valid must be bool, aux and qq float32")
    if q.ndim != 2 or rows.ndim != 2 or q.shape[1] != rows.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, rows {tuple(rows.shape)}")
    n = rows.shape[0]
    if valid.shape != (n,) or aux.shape != (n,) or qq.shape != (q.shape[0],):
        raise ValueError("valid and aux must be [N], qq [B]")
    if q.shape[1] % 8 or q.shape[1] > _FUSED_MAX_DPAD:
        raise ValueError(f"D_pad={q.shape[1]} must be a multiple of 8, <= {_FUSED_MAX_DPAD}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must be in [1, {MAX_K}]")


def _fused_scores(q, rows, valid, aux, qq, metric: DistanceMetric):
    """The plain scores ``[B, N]``: the fixed-order fp32 dot, the metric
    fixup (dot; ``dot * aux``; ``-max((qq + aux) - 2 dot, 0)``), invalid rows
    at -inf."""
    s = _ordered_dot(q, rows)
    if metric is DistanceMetric.COSINE:
        s = s * aux[None, :]
    elif metric is DistanceMetric.EUCLIDEAN:
        s = -((qq[:, None] + aux[None, :]) - 2.0 * s).clamp_min(0.0)
    return torch.where(valid[None, :], s, -torch.inf)


def _top_keys(s, k: int):
    """The best ``k`` of ``s [B, N]`` by score key, ``(vals, ids)`` padded
    with -inf / -1 to ``k`` columns."""
    vals, idx = _decode_keys(torch.topk(_score_keys(s), min(k, s.shape[1]), dim=1).values)
    pad = k - vals.shape[1]
    return F.pad(vals, (0, pad), value=-torch.inf), F.pad(idx, (0, pad), value=-1)


def fused_topk_ref(q, rows, valid, aux, qq, k: int, metric):
    """Plain torch version of #8: the plain scores (:func:`_fused_scores`)
    and the exact top-k of their keys. Returns maximize-oriented ``(vals
    [B, k] f32, ids [B, k] int64)``, -inf / -1 for empties."""
    metric = DistanceMetric.parse(metric)
    return _top_keys(_fused_scores(q, rows, valid, aux, qq, metric), k)


def fused_topk_tolerance(q, rows, valid, aux, qq, k: int, metric):
    """The plain top-k of #8 and the bound its tensor-core kernel is held to:
    ``(vals_ref, ids_ref, s_ref [B, N], tol [B, k], gap [B, k])``, ``tol`` per
    rank, over the plain row ``r`` at that rank, with
    ``A = sum_d |q_d x_d|`` (``x`` the row upcast to f32):

        dot:    3.1 * 2^-16 * A + order_bound(3 D_pad, 2 D_pad) * A
        score:  f * dot's bound + 2 ulp(vals_ref),  f = 1 (dot),
                aux[r] (cosine), 2 (euclidean)

    The split: the kernel splits ``q`` and ``x`` into bf16 pairs (``hi =
    bf16(v)``, ``lo = bf16(v - hi)``: ``|v - hi| <= 2^-8 |v|``, ``|lo| <=
    2^-8 |v|``, ``|v - hi - lo| <= 2^-16 |v|``) and drops the terms of ``q x``
    beyond ``qhi hi + qhi lo + qlo hi``: ``qlo lo``, ``qhi (x - hi - lo)`` and
    ``(q - qhi - qlo) hi`` are each at most ``2^-16 (1 + 2^-8) |q_d x_d|``,
    the rest below ``2^-23``: in all at most ``3.1 * 2^-16 * A``, a bound
    that always holds.

    The order: the kernel sums its ``3 D_pad`` exact products in fp32 in the
    tensor cores' order, the plain version rounds ``D_pad`` products and
    ``D_pad - 1`` partial sums: :func:`~velesdb_tpu_torch.ops.bucket_kernel.
    order_bound` ``(3 D_pad, 2 D_pad)`` bounds the difference. Its worst
    case, ``5 D_pad 2^-24 A``, is ``2.3e-4 A`` at D 768, which also admits a
    kernel that drops both ``lo`` products (its dots stray by about ``1e-4
    A``).

    The gap: this bound also admits a single TF32 pass at D 768 (a CPU
    emulation). The float64-oracle check ``chip_smoke.py`` adds on
    100k-768d rejects one: recall@10 and recall@100 fall to about 0.997
    against its 0.999 bar, though the score error (about 6e-5) stays under
    its 1e-4 (``tests/test_torch_split_tolerance.py::
    test_fused_topk_oracle_check_rejects_a_single_tf32_pass``).

    The cosine factor scales a dot's error by ``aux``, the euclidean ``- 2
    dot`` by 2 (the clamp at 0 shrinks it); the two ulps cover the rounding
    of the fixup. ``gap`` is the plain gap at each rank: the distance from
    the rank's plain score to the nearer of its neighbours (the ``k +
    1``-th plain score below the last)."""
    metric = DistanceMetric.parse(metric)
    s = _fused_scores(q, rows, valid, aux, qq, metric)
    vals, ids = _top_keys(s, k + 1)
    nxt = vals[:, 1:]
    vals, ids = vals[:, :k], ids[:, :k]
    prev = F.pad(vals[:, :-1], (1, 0), value=torch.inf)
    gap = torch.minimum(prev - vals, vals - nxt)
    r = ids.clamp_min(0)
    x = rows.float()[r]  # [B, k, D_pad]
    a = torch.bmm(x.abs(), q.float().abs()[:, :, None])[:, :, 0]
    d_pad = q.shape[1]
    dot_tol = (3.1 * 2.0**-16 + order_bound(3 * d_pad, 2 * d_pad)) * a
    if metric is DistanceMetric.COSINE:
        dot_tol = dot_tol * aux[r]
    elif metric is DistanceMetric.EUCLIDEAN:
        dot_tol = 2.0 * dot_tol
    return vals, ids, s, dot_tol + 2.0 * _ulp(vals), gap


def fused_topk_error(q, rows, valid, aux, qq, k: int, metric, vals, idx, ref=None):
    """``(vals, idx)`` of #8 against the plain top-k within
    :func:`fused_topk_tolerance` (``ref``: its result, when already
    computed), by :func:`~velesdb_tpu_torch.ops.bucket_kernel.ranked_error`:
    each rank's value within its tolerance of the plain value; its id the
    plain id where the plain gap at that rank exceeds twice the tolerance,
    elsewhere a valid row, returned once, whose plain score lies within the
    tolerance; empties where the plain version has them. Returns ``(worst,
    max_tol, max_abs_err)``; the outputs pass when ``worst <= 1``."""
    if ref is None:
        ref = fused_topk_tolerance(q, rows, valid, aux, qq, k, metric)
    vals_ref, ids_ref, s, tol, gap = ref
    n = s.shape[1]
    inside = (idx >= 0) & (idx < n)
    picked = torch.gather(s, 1, idx.clamp(0, n - 1))
    # a row returned twice: equal to another returned row at an earlier rank
    repeat = ((idx[:, :, None] == idx[:, None, :]).tril(-1) & inside[:, :, None]).any(2)
    return ranked_error(vals_ref, ids_ref, tol, gap, vals, idx, picked, inside & ~repeat)

def fused_topk_scan(q, rows, valid, aux, qq, k: int, metric):
    """The top-k of the fused scan (#8): ``q [B, D_pad] f32``, ``rows
    [N, D_pad]`` f32/f16/bf16, ``valid [N] bool``, ``aux [N]`` (cosine
    ``1/|c|``, euclidean ``|c|^2``), ``qq [B] = |q|^2``, ``1 <= k <= MAX_K``.
    CUDA tensors launch ``csrc/fused_topk.cu`` on the queries split once
    (:func:`~velesdb_tpu_torch.ops.bucket_kernel.split_f32_rows`), one launch
    per slice of queries whose candidate scratch fits
    :data:`FUSED_SCRATCH_BYTES` (at least 8 queries a launch), held to
    :func:`fused_topk_ref` within :func:`fused_topk_tolerance`; CPU tensors
    take :func:`fused_topk_ref`."""
    metric = DistanceMetric.parse(metric)
    _check_fused(q, rows, valid, aux, qq, k)
    if _kernel_route(q, rows, valid, aux, qq):
        return fused_topk_ref(q, rows, valid, aux, qq, k, metric)
    (b, d_pad), n = q.shape, rows.shape[0]
    dev = q.device
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int64, device=dev)
    ranges = -(-n // _FUSED_ROWS)
    step = max(8, FUSED_SCRATCH_BYTES // (8 * ranges * k) // 8 * 8)
    cand = torch.empty((min(b, step), ranges, k), dtype=torch.int64, device=dev)
    qhi, qlo = split_f32_rows(q)
    for i in range(0, b, step):
        j = min(b, i + step)
        _launch(LAUNCHES, "fused_topk", "fused_topk", "fused_topk_launch",
                _P * 9 + _IIJ + (ctypes.c_int,) * 2, qhi[i:j], qlo[i:j], rows, valid, aux,
                qq[i:j], vals[i:j], idx[i:j], cand, j - i, n, d_pad, k,
                _FLOAT_CODES[rows.dtype], _METRIC_CODES[metric])
    return vals, idx


def fused_topk(queries, corpus, valid=None, k: int = 10,
               metric: DistanceMetric = DistanceMetric.COSINE, chunk: int = DEFAULT_CHUNK,
               corpus_sqnorm=None):
    """Fused streaming distance + exact top-k (reference ``:265``).

    ``queries [B, D]`` (f32) against ``corpus [N, D]`` (f32, f16 or bf16,
    upcast to f32). Returns ``(values [B, k], ids [B, k] int64)`` best-first
    in the metric's native orientation (cosine/dot similarity, euclidean
    distance), ``-1`` ids for slots no valid row fills. ``k`` is at most
    :data:`MAX_K`; ``chunk`` is accepted for API parity and changes nothing.
    On the card pass one's scratch is ``B * ceil(N / 1024) * k`` int64 keys,
    at most :data:`FUSED_SCRATCH_BYTES` per launch.
    The cosine factor ``1/|c|`` and ``|q|^2`` are computed here once."""
    metric = DistanceMetric.parse(metric)
    if metric not in _METRIC_CODES:
        raise ValueError(f"unsupported metric {metric}")
    c = torch.as_tensor(corpus)
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=c.device))
    n, d = c.shape
    v = (torch.ones(n, dtype=torch.bool, device=c.device) if valid is None
         else torch.as_tensor(valid, device=c.device).bool())
    if metric is DistanceMetric.COSINE:
        q = normalize(q)
    d_pad = _round_up(d, 128)
    q = F.pad(q, (0, d_pad - d))
    if d_pad != d:
        c = F.pad(c, (0, d_pad - d))
    if corpus_sqnorm is None:
        cn = torch.sum(c.float() ** 2, dim=1)
    else:
        cn = torch.as_tensor(corpus_sqnorm, device=c.device).float()
    if metric is DistanceMetric.COSINE:
        aux = torch.where(cn > 1e-30, torch.rsqrt(cn.clamp_min(1e-30)), 0.0)
    else:
        aux = cn
    qq = torch.sum(q * q, dim=1)
    vals, idx = fused_topk_scan(q, c.contiguous(), v.contiguous(), aux.contiguous(), qq, k,
                                metric)
    if metric is DistanceMetric.EUCLIDEAN:
        return torch.where(idx < 0, torch.inf, torch.sqrt((-vals).clamp_min(0.0))), idx
    return torch.where(idx < 0, -torch.inf, vals), idx

_MAX_WORDS = 256  # 32 * 256 + 1 histogram bins a query
_TOPK_TILE = 256  # rows of one walk step of #9's blocks
_TOPK_BLOCKS = 512  # the (chunk, 32-query tile) blocks #9's chunk aims for


def _topk_chunk(b: int, n: int) -> int:
    """Rows per block of #9 (``csrc/hamming_topk.cu``): the largest power of
    two from 8,192 down to 256 that still gives ``_TOPK_BLOCKS`` blocks of
    (chunk, 32 queries), so that even one query's work spreads over the card."""
    tiles = -(-b // 32)
    chunk = 8192
    while chunk > _TOPK_TILE and tiles * -(-n // chunk) < _TOPK_BLOCKS:
        chunk //= 2
    return chunk


def _topk_scratch_ints(b: int, n: int, w: int, chunk: int) -> int:
    """The int32 scratch elements of one #9 launch, as the kernel's source
    lays them out (``hamming_topk_scratch_ints``)."""
    fn = _cuda.library("hamming_topk").hamming_topk_scratch_ints
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    return fn(b, n, w, chunk)


def _check(q, packed, valid, k):
    if q.dtype != torch.int32 or packed.dtype != torch.int32:
        raise TypeError("packed queries and corpus must be int32 words")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if q.ndim != 2 or packed.ndim != 2 or q.shape[1] != packed.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, corpus {tuple(packed.shape)}")
    if valid.shape != (packed.shape[0],):
        raise ValueError(f"valid of shape {tuple(valid.shape)} for N={packed.shape[0]}")
    if q.shape[1] > _MAX_WORDS:
        raise ValueError(f"W={q.shape[1]} words above {_MAX_WORDS}")
    if not 1 <= k <= packed.shape[0]:
        raise ValueError(f"k={k} must be in [1, N={packed.shape[0]}]")


def hamming_topk_ref(q, packed, valid, k: int):
    """Plain torch version: a stable ascending sort of the exact distances
    with invalid rows at +inf. Returns ``(dist [B, k] f32, ids [B, k] int64)``
    with +inf / -1 empties."""
    d = hamming_distances(q, packed).float()
    d = torch.where(valid[None, :], d, torch.inf)
    dist, idx = torch.sort(d, dim=1, stable=True)
    dist, idx = dist[:, :k], idx[:, :k]
    return dist, torch.where(dist == torch.inf, -1, idx)


def hamming_topk(packed_q, packed_corpus, valid=None, k: int = 10):
    """The exact ``k`` smallest Hamming distances per query over the packed
    corpus (``int32`` words from :func:`~velesdb_tpu_torch.ops.quantization.
    binary_quantize`), skipping rows where ``valid`` is False. ``k`` is
    clamped to N. CUDA tensors launch ``csrc/hamming_topk.cu``; CPU tensors
    take :func:`hamming_topk_ref`. On the card the scratch is ``B * k`` int64
    keys and the int32 counters and rows that the kernel's
    ``hamming_topk_scratch_ints`` asks for (``csrc/hamming_topk.cu``'s header
    gives the layout)."""
    n = packed_corpus.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=packed_corpus.device)
    k = min(k, n)
    _check(packed_q, packed_corpus, valid, k)
    if _kernel_route(packed_q, packed_corpus, valid):
        return hamming_topk_ref(packed_q, packed_corpus, valid, k)
    b, w = packed_q.shape
    dev = packed_q.device
    chunk = _topk_chunk(b, n)
    dist = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int64, device=dev)
    keys = torch.empty((b, k), dtype=torch.int64, device=dev)
    n_ints = _topk_scratch_ints(b, n, w, chunk)
    ints = torch.empty(n_ints, dtype=torch.int32, device=dev)
    _launch(LAUNCHES, "hamming_topk", "hamming_topk", "hamming_topk_launch",
            _P * 7 + (ctypes.c_longlong,) + _IIJ + (ctypes.c_int,),
            packed_q, packed_corpus, valid, dist, idx, keys, ints, n_ints, b, n, w, k, chunk)
    return dist, idx
