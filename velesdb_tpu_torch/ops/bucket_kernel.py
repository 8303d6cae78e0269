"""Bucket-select scans on the card: the float, int8, SQ8 and Hamming kernels.

Counterpart of ``velesdb_tpu/ops/bucket_kernel.py``. Every kernel here scores
a query batch against a padded corpus chunk by chunk and keeps ONE winner per
128-lane bucket of each chunk (``_bucket_select``), so the ``[B, N]`` score
matrix never exists in device memory; an exact ``torch.topk`` over the bucket
winners (``_final_select``) finishes the search. Eight hand-written CUDA
kernels in four sources (``csrc/``), each with its plain torch version
beside it. The float scans are four modes of one tensor-core kernel,
``csrc/dense_bucket_tc.cu``:

- #2 (:func:`dense_bucket_gm`): ``dot - cc`` (:func:`bucket_topk_entry`),
  on f16 and bf16 rows (#2b, counter ``dense_bucket_tc``: the ``bucket-f32``
  core of F16/BF16 storage below D 512) and on f32 rows split into bf16
  (hi, lo) pairs in the kernel (counter ``dense_bucket_gm``: FULL storage
  past the assist cores' guard, and the op :func:`bucket_topk`).
- #3 (:func:`hl_bucket_gm`): split-bf16 (hi, lo) rows
  (:func:`bucket_topk_hl`); the FULL ``split-bf16`` core.
- #6 (:func:`sq8_bucket_gm`): block-packed SQ8 words unpacked in the kernel
  (:func:`sq8_bucket_topk`); the ``sq8-bucket`` core.

The plain versions sum each dot over the dims in order, one rounded
multiply and add per term (:func:`_ordered_dot`). The tensor cores add
exact bf16/f16 products in their own order, so each mode is held to its
plain version within a stated tolerance, through the one checker
:func:`ranked_error`: half rows within :func:`half_scan_tolerance`, f32
rows within :func:`f32_scan_tolerance`, #3 within
:func:`split_scan_tolerance`, #6 within :func:`sq8_scan_tolerance`. The int8
and Hamming kernels:

- ``sq8pd_bucket`` (#1, :func:`sq8pd_bucket_gm`): the per-DIMENSION int8
  "enc-select" scan, the FULL-storage core at D < 512 and at least
  ``BUCKET_MIN_ROWS`` padded rows (``:595-808`` of the reference). The corpus
  gets a shadow quantized per dimension with one corpus-calibrated query step
  ``qu``, so every coarse score is an integer,
  ``qu * doti - pen ~ 2 q.x - |x|^2`` (euclidean) or ``2 q.x``, and the scan
  rides one ENCODED int32 tile ``enc = doti * 64 + ptile`` with
  ``ptile = -64 * pen_int + slice_index``: one integer max per bucket yields
  the winner's value AND its row. int32 budget (dim <= 512): |doti| <=
  127*127*dim, valid ``pen_int`` capped at ``_PD_PEN_CAP`` (else
  :func:`sq8pd_build` refuses), knocked-out rows carry ``_pd_invalid_pen``.
  It runs as the int32 epilogue of #7's kernel on the int8 tensor cores
  (``sq8pd_bucket_launch`` in ``csrc/sq8i_bucket.cu``).
- ``sq8i_bucket`` (#7, :func:`sq8i_bucket_gm`): the per-ROW SQ8 scan, int8
  queries against int8 ``code - 128`` rows with the f32 affine epilogue. It
  serves SQ8 storage, and FULL storage where ``sq8pd_build`` refuses.
- ``hamming_mxu_launch`` (#5, :func:`hamming_mxu_gm`): Hamming distance as an
  int8 dot of 0/1 bit rows (the BINARY default while the bit shadow fits),
  an epilogue of #7's kernel. #7, #5 and #1 run on the int8 tensor cores
  (``wgmma`` s8, s32 accumulators): an int8 dot is exact in any order, so
  all three stay bit for bit against their plain versions.
- ``hamming_bucket`` (#4, :func:`hamming_bucket_gm`): Hamming distance over
  the packed words (BINARY past the bit-shadow budget), on the int8 tensor
  cores as well: each word unpacks in registers into 32 int8 K positions of
  the A operand, the query's bits as +-1, so the s32 dot gives
  ``|q| - popc(q ^ c)`` (``csrc/hamming_bucket.cu``), bit for bit against
  :func:`hamming_bucket_ref`.

A wrapper takes its plain version only for CPU tensors; on CUDA tensors it
launches its kernel on the current stream or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch
import torch.nn.functional as F

from velesdb_tpu_torch.ops import _cuda
from velesdb_tpu_torch.ops.distance import DistanceMetric, hamming_distances, normalize
from velesdb_tpu_torch.ops.quantization import sq8_unpack_blocked

__all__ = [
    "BUCKET_MIN_ROWS",
    "HAMMING_CHUNK",
    "LAUNCHES",
    "bucket_chunk",
    "bucket_topk",
    "bucket_topk_entry",
    "dense_bucket_gm",
    "dense_bucket_ref",
    "f32_scan_error",
    "f32_scan_tolerance",
    "half_scan_error",
    "half_scan_tolerance",
    "ranked_error",
    "split3_f32",
    "split_f32_rows",
    "split_scan_error",
    "split_scan_tolerance",
    "bucket_topk_hl",
    "first_topk",
    "hl_bucket_gm",
    "hl_bucket_ref",
    "sq8_bucket_gm",
    "sq8_bucket_ref",
    "sq8_bucket_topk",
    "sq8_scan_error",
    "sq8_scan_tolerance",
    "sq8_int8_rows",
    "sq8i_bucket_gm",
    "sq8i_bucket_ref",
    "sq8i_bucket_topk",
    "sq8i_rerank_topk",
    "hamming_bits_rows",
    "hamming_mxu_gm",
    "hamming_mxu_ref",
    "hamming_mxu_topk",
    "hamming_mxu_rerank_topk",
    "hamming_bucket_gm",
    "hamming_bucket_ref",
    "hamming_bucket_topk",
    "hamming_rerank_topk",
    "sq8pd_build",
    "sq8pd_ptile",
    "sq8pd_bucket_gm",
    "sq8pd_bucket_gm_ref",
    "sq8pd_candidates",
    "sq8pd_topk",
    "sq8pd_rerank_topk",
]

# Below this corpus size one winner per 128-lane bucket loses too much of the
# true top-k to collisions; the streamed scan serves instead.
BUCKET_MIN_ROWS = 131_072

_LANES = 128
_MAX_CHUNK = 8192  # 64 slices of 128 rows: the slice index fits 6 bits
_PD_PEN_CAP = 1 << 21
# The packed Hamming scan's chunk, as the reference hard-codes it
# (``index/brute.py:639``): 16 slices of 128 rows.
HAMMING_CHUNK = 2048

# Kernel launches per wrapper, counted where the CUDA kernel is launched and
# nowhere else (the CPU path of a wrapper does not count).
LAUNCHES = {
    "dense_bucket_gm": 0,
    "dense_bucket_tc": 0,
    "hl_bucket_gm": 0,
    "sq8_bucket_gm": 0,
    "sq8pd_bucket_gm": 0,
    "sq8i_bucket_gm": 0,
    "hamming_mxu_gm": 0,
    "hamming_bucket_gm": 0,
}


def _pd_doti_max(dim: int) -> int:
    return 127 * 127 * dim


def _pd_invalid_pen(dim: int) -> int:
    return 2 * _pd_doti_max(dim) + 2 * _PD_PEN_CAP


def _pd_empty_thresh(dim: int) -> int:
    return -(_pd_doti_max(dim) + _PD_PEN_CAP)


def _div(a: torch.Tensor, v: float) -> torch.Tensor:
    """``a / v`` as a true fp32 division on every device: a Python-scalar
    divisor would take a reciprocal multiply on CUDA, which rounds
    differently from the CPU and from the reference."""
    return a / torch.tensor(v, dtype=torch.float32, device=a.device)


def _row_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Row sums of squares in a fixed order: sequentially within contiguous
    blocks of 32 columns (zero columns pad the width to a multiple of 32
    without changing a sum), then across the blocks. Every step is an
    elementwise fp32 add, so the sums are the same on every device, and at
    D_pad 128 they equal the JAX package's on the CPU (its XLA row reduction
    adds in this order there), so ``pen_int`` rounds the same in both
    packages."""
    x = F.pad(x, (0, (-x.shape[1]) % 32))
    sq = (x * x).reshape(x.shape[0], -1, 32)
    blocks = sq[:, :, 0]
    for i in range(1, 32):
        blocks = blocks + sq[:, :, i]
    total = blocks[:, 0]
    for j in range(1, blocks.shape[1]):
        total = total + blocks[:, j]
    return total


def bucket_chunk(n_pad: int) -> int:
    """Rows per chunk of the int8 scans (#1, #7, #5): the largest allowed,
    ``min(8192, n_pad)``. It divides every padded row count (``pad_rows``
    steps are multiples of 8192 above 64K rows and powers of two below).
    The reference sizes its chunk from a TPU VMEM model; here it is one rule
    shared by dispatch, ``serve_engine`` and the collision guard."""
    return min(_MAX_CHUNK, n_pad)


def sq8pd_build(slots_f32: torch.Tensor, valid: torch.Tensor, dim: int,
                metric: DistanceMetric):
    """Build the per-dim shadow from the padded f32 corpus ``[N_pad, dim]``.

    Returns ``(rows_pd [N_pad, D_pad] int8, pen_int [N_pad] int32,
    pen_f32 [N_pad] f32, sdim [D_pad] f32, mid [D_pad] f32, qu float)`` or
    ``None`` when the int32 encoding budget does not hold (penalty above
    ``_PD_PEN_CAP`` or dim > 512). COSINE expects pre-normalized rows."""
    if dim > 512:
        return None
    metric = DistanceMetric.parse(metric)
    d_pad = -(-dim // _LANES) * _LANES
    x = slots_f32.float()
    if x.shape[1] < d_pad:
        x = F.pad(x, (0, d_pad - x.shape[1]))
    vmask = valid.bool()
    vcol = vmask[:, None]
    big = torch.where(vcol, x, -torch.inf).amax(dim=0)
    small = torch.where(vcol, x, torch.inf).amin(dim=0)
    mid = torch.where(torch.isfinite(big), (big + small) * 0.5, 0.0)
    sdim = torch.where(big > small, _div(big - small, 254.0), 1.0)
    rows_pd = torch.clamp(torch.round((x - mid[None, :]) / sdim[None, :]), -127, 127)
    rows_pd = torch.where(vcol, rows_pd, 0.0).to(torch.int8)
    if metric is DistanceMetric.EUCLIDEAN:
        pen = _row_sumsq(rows_pd.float() * sdim[None, :] + mid[None, :])
    else:
        pen = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    # batch-common query step calibrated on the corpus itself, 1.2x headroom
    # (outliers clip in the coarse pass only; the rerank rescores in f32)
    qmax = torch.where(vcol, torch.abs(2.0 * x * sdim[None, :]), 0.0).amax()
    qu = float(qmax) / 127.0 * 1.2
    if qu <= 0.0:
        return None
    # cap check in FLOAT: an over-cap penalty would overflow the int32 cast
    if float(torch.where(vmask, pen, 0.0).amax()) / qu > _PD_PEN_CAP:
        return None
    pen_int = torch.round(_div(pen, qu)).to(torch.int32)
    pen_int = torch.where(vmask, pen_int, _pd_invalid_pen(dim)).to(torch.int32)
    pen_f32 = torch.where(vmask, pen, torch.inf)
    return rows_pd, pen_int, pen_f32, sdim, mid, qu


def sq8pd_ptile(pen_int: torch.Tensor, chunk: int) -> torch.Tensor:
    """Corpus-static encoded tile: the additive penalty in the high bits, the
    in-chunk slice index in the low 6."""
    n = pen_int.shape[0]
    slice_i = (torch.arange(n, device=pen_int.device) % chunk) // _LANES
    return (pen_int * -64 + slice_i).to(torch.int32)


def _sq8pd_quantize_queries(queries: torch.Tensor, sdim: torch.Tensor, qu: float,
                            d_pad: int):
    """int8 per-dim queries ``[B_pad, D_pad]`` (B padded to a multiple of 8
    with zero rows) and ``B_pad``."""
    b = queries.shape[0]
    b_pad = -(-max(b, 8) // 8) * 8
    q = queries.float()
    if q.shape[1] < d_pad:
        q = F.pad(q, (0, d_pad - q.shape[1]))
    qv = 2.0 * q * sdim[None, :]
    qi = torch.clamp(torch.round(_div(qv, qu)), -127, 127).to(torch.int8)
    return F.pad(qi, (0, 0, 0, b_pad - b)), b_pad


_P = (ctypes.c_void_p,)
_IIJ = (ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int)  # B_pad, N, width, chunk


@functools.cache
def _entry(lib: str, symbol: str, argtypes: tuple):
    """A kernel library's C entry point, built and bound on first use. Every
    entry takes its pointers and sizes, then the stream, and returns the
    launch's CUDA error code."""
    fn = getattr(_cuda.library(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    return fn


_COUNT_LOCK = threading.Lock()


def _launch(launches: dict, counter: str, lib: str, symbol: str, argtypes: tuple,
            *args) -> None:
    """Launch a kernel on the current stream of its first tensor's device,
    raise on a CUDA error, and count the launch under ``launches[counter]``
    (the launching module's ``LAUNCHES``)."""
    dev = args[0].device
    fn = _entry(lib, symbol, argtypes)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{lib} launch failed with CUDA error {rc}")
    with _COUNT_LOCK:  # server threads launch concurrently
        launches[counter] += 1


_PD_MAX_DPAD = 512  # the int32 encoding's budget (sq8pd_build refuses dim > 512)


def _check_gm_args(qi, rows_pd, ptile, chunk: int) -> None:
    if not (qi.device == rows_pd.device == ptile.device):
        raise ValueError("qi, rows_pd and ptile must be on one device")
    if qi.dtype != torch.int8 or rows_pd.dtype != torch.int8:
        raise TypeError("qi and rows_pd must be int8")
    if ptile.dtype != torch.int32:
        raise TypeError("ptile must be int32")
    if qi.ndim != 2 or rows_pd.ndim != 2 or ptile.ndim != 1:
        raise ValueError("expected qi [B, D], rows_pd [N, D], ptile [N]")
    if not (qi.is_contiguous() and rows_pd.is_contiguous() and ptile.is_contiguous()):
        raise ValueError("qi, rows_pd and ptile must be contiguous")
    n, d_pad = rows_pd.shape
    if qi.shape[1] != d_pad or ptile.shape[0] != n:
        raise ValueError(
            f"shape mismatch: qi {tuple(qi.shape)}, rows_pd {tuple(rows_pd.shape)}, "
            f"ptile {tuple(ptile.shape)}"
        )
    if d_pad % 16 or d_pad > _PD_MAX_DPAD:
        raise ValueError(f"D_pad={d_pad} must be a multiple of 16 and <= {_PD_MAX_DPAD}")
    if chunk <= 0 or chunk % _LANES or chunk > _MAX_CHUNK or n % chunk:
        raise ValueError(
            f"chunk={chunk} must be a multiple of 128, <= {_MAX_CHUNK}, "
            f"and divide N={n}"
        )


def sq8pd_bucket_gm_ref(qi: torch.Tensor, rows_pd: torch.Tensor,
                        ptile: torch.Tensor, chunk: int) -> torch.Tensor:
    """Plain torch version of the bucket scan: ``gm [B_pad, N/chunk*128]``."""
    # Exact in fp32: each product is an integer of magnitude <= 127^2, and
    # every partial sum over D_pad <= 512 terms stays below 2^24, where every
    # integer is representable in fp32. TF32 keeps 10 mantissa bits, enough
    # for any int8 input, and still accumulates in fp32.
    doti = (qi.float() @ rows_pd.float().T).to(torch.int32)
    enc = doti * 64 + ptile[None, :]
    b, n = enc.shape
    return enc.reshape(b, n // chunk, chunk // _LANES, _LANES).amax(dim=2).reshape(b, -1)


def sq8pd_bucket_gm(qi: torch.Tensor, rows_pd: torch.Tensor, ptile: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """Encoded bucket maxima ``gm int32 [B_pad, N/chunk*128]``.

    On CUDA tensors this launches the ``PdEnc`` epilogue of
    ``csrc/sq8i_bucket.cu`` on the current stream (or raises); CPU tensors
    take :func:`sq8pd_bucket_gm_ref`."""
    _check_gm_args(qi, rows_pd, ptile, chunk)
    if _kernel_route(qi, rows_pd, ptile):
        return sq8pd_bucket_gm_ref(qi, rows_pd, ptile, chunk)
    b_pad = qi.shape[0]
    n, d_pad = rows_pd.shape
    gm = torch.empty((b_pad, n // chunk * _LANES), dtype=torch.int32, device=qi.device)
    _launch(LAUNCHES, "sq8pd_bucket_gm", "sq8i_bucket", "sq8pd_bucket_launch", _P * 4 + _IIJ,
            qi, rows_pd, ptile, gm, b_pad, n, d_pad, chunk)
    return gm


def sq8pd_candidates(queries, rows_pd, ptile, sdim, qu, *, m, chunk, dim):
    """Coarse top-m candidate ids (−1 empties) and their decoded int values."""
    b = queries.shape[0]
    d_pad = rows_pd.shape[1]
    qi, _ = _sq8pd_quantize_queries(queries, sdim, qu, d_pad)
    gm = sq8pd_bucket_gm(qi, rows_pd, ptile, chunk)[:b]
    # exact selection on the int32 tile (the reference selects on an f32
    # cast with approx_max_k and re-reads the exact enc)
    enc, pos = torch.topk(gm, min(m, gm.shape[1]), dim=1)
    i_dec = enc & 63
    val = (enc - i_dec) // 64  # exact, sign-safe
    idx = (pos // _LANES) * chunk + i_dec.long() * _LANES + (pos % _LANES)
    empty = val < _pd_empty_thresh(dim)
    return torch.where(empty, -1, idx), val


def _exact_rerank_tail(queries, corpus, ci, *, k, metric):
    """Gather the ``ci`` candidates ``[B, m, D]`` from the resident f32 corpus
    and rescore them exactly in fp32 (cosine corpus rows are pre-normalized).

    Euclidean distances are summed from the differences, ``|q - c|^2``. The
    reference expands ``|q|^2 + |c|^2 - 2 q.c``, which cancels in fp32 once
    the norms dwarf the distances: on a corpus offset by 100 per coordinate
    it swaps near neighbours at any m (ROADMAP.md, faults of the reference)."""
    cand = corpus[ci.clamp_min(0)]  # [B, m, D]
    q = queries.float()
    if metric is DistanceMetric.EUCLIDEAN:
        d2 = torch.sum((cand - q[:, None, :]) ** 2, dim=-1)
        d2, order = torch.topk(torch.where(ci < 0, torch.inf, d2), k, dim=1, largest=False)
        return torch.sqrt(d2), torch.gather(ci, 1, order)
    qn = normalize(q) if metric is DistanceMetric.COSINE else q
    dots = torch.bmm(cand, qn[:, :, None])[:, :, 0]  # [B, m]
    exact = torch.where(ci < 0, -torch.inf, dots)
    vals, order = torch.topk(exact, k, dim=1)
    ids = torch.gather(ci, 1, order)
    return vals, torch.where(vals == -torch.inf, -1, ids)


def sq8pd_rerank_topk(queries, rows_pd, ptile, sdim, qu, corpus, *, k, m, metric,
                      chunk, dim):
    """Coarse pd scan for m candidates + exact f32 rerank to the top k.

    COSINE queries are normalized before the coarse pass: ``qu`` is
    calibrated on the pre-normalized corpus, so a raw query of norm >> 1
    would clip at +-127 in every dimension. (The reference quantizes the raw
    query here; ROADMAP.md lists that as a fault of the reference.)"""
    metric = DistanceMetric.parse(metric)
    coarse_q = normalize(queries.float()) if metric is DistanceMetric.COSINE else queries
    ci, _ = sq8pd_candidates(
        coarse_q, rows_pd, ptile, sdim, qu, m=m, chunk=chunk, dim=dim
    )
    return _exact_rerank_tail(queries, corpus, ci, k=k, metric=metric)


def sq8pd_topk(queries, rows_pd, ptile, sdim, mid, qu, *, k, chunk, dim, metric):
    """Coarse-only pd top-k with metric-native values restored (tests)."""
    metric = DistanceMetric.parse(metric)
    q = queries.float()
    idx, val = sq8pd_candidates(q, rows_pd, ptile, sdim, qu, m=k, chunk=chunk, dim=dim)
    empty = idx < 0
    # qu * val + 2 q.mid = 2 q.x - pen  (pen = |x|^2 for euclidean, else 0)
    qmid = 2.0 * (q @ mid[: q.shape[1]])
    score = qu * val.float() + qmid[:, None]
    if metric is DistanceMetric.EUCLIDEAN:
        qq = torch.sum(q * q, dim=1)
        d2 = (qq[:, None] - score).clamp_min(0.0)
        return torch.where(empty, torch.inf, torch.sqrt(d2)), idx
    dots = score * 0.5
    if metric is DistanceMetric.COSINE:
        qn = torch.sqrt(torch.sum(q * q, dim=1).clamp_min(1e-30))
        dots = dots / qn[:, None]
    return torch.where(empty, -torch.inf, dots), idx


# ---------------------------------------------------------------------------
# shared bucket helpers (reference ``:117-149``)
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bucket_select(s: torch.Tensor, chunk: int):
    """One (max, argmax) winner per 128-lane bucket of each chunk of the
    ``[B, N]`` scores: ``(gm [B, N/chunk*128], gi int32 global rows)``. Ties
    go to the smallest slice index, as in the reference (``:127-129``), so a
    bucket of ``-inf`` scores returns its slice-0 row."""
    b, n = s.shape
    t = s.reshape(b, n // chunk, chunk // _LANES, _LANES)
    gm = t.amax(dim=2)
    off = torch.argmax((t == gm[:, :, None, :]).to(torch.uint8), dim=2)
    base = torch.arange(0, n, chunk, device=s.device)[:, None]
    lane = torch.arange(_LANES, device=s.device)[None, :]
    gi = base[None] + off * _LANES + lane[None]
    return gm.reshape(b, -1), gi.reshape(b, -1).to(torch.int32)


def _score_keys(s: torch.Tensor) -> torch.Tensor:
    """One int64 key per score of ``s [B, M]``: the f32's order-preserving
    bits (-0.0 as +0.0) above the reversed column, so keys are unique and a
    larger key is a better score, then a smaller column."""
    key = (s + 0.0).view(torch.int32).to(torch.int64)  # sign-extended bits
    key ^= (key >> 32) & 0x7FFFFFFF  # negative floats: flip the magnitude
    key <<= 32
    key |= (1 << 32) - 1 - torch.arange(s.shape[1], device=s.device)
    return key


def first_topk(s: torch.Tensor, k: int):
    """Top-``k`` over the last axis of ``s [B, M]``, best first, with equal
    scores going to the smallest position (``lax.top_k``'s rule) on every
    device: ``torch.topk`` orders ties one way on the CPU and another on
    CUDA, so the select runs on one unique int64 key per score
    (:func:`_score_keys`). Returns ``(values, int64 positions)``."""
    top = torch.topk(_score_keys(s), k, dim=1).values
    pos = (1 << 32) - 1 - (top & 0xFFFFFFFF)
    return torch.gather(s, 1, pos), pos


def _final_select(gm: torch.Tensor, gi: torch.Tensor, k: int, b: int):
    """Exact top-k over the bucket winners (the reference's PartialReduce is
    ``approx_max_k``, exact ``top_k`` on its CPU path), empties mapped to id
    -1, equal scores to the smallest bucket position (:func:`first_topk`;
    Hamming scores tie often)."""
    vals, pos = first_topk(gm, min(k, gm.shape[1]))
    idx = torch.gather(gi, 1, pos)[:b].long()
    vals = vals[:b]
    return vals, torch.where(vals == -torch.inf, -1, idx)


def _restore_euclidean(vals, idx, qq):
    """Scores were maximize-oriented ``2 q.c - |c|^2``; surface distances."""
    d2 = (qq[:, None] - vals).clamp_min(0.0)
    return torch.where(idx < 0, torch.inf, torch.sqrt(d2)), idx


def _prep_queries(queries: torch.Tensor, metric: DistanceMetric):
    """``(q, |q|^2)``: cosine queries normalized, euclidean ones doubled (the
    scans maximize ``2 q.c - |c|^2``)."""
    q = queries.float()
    qq = torch.sum(q * q, dim=1)
    if metric is DistanceMetric.COSINE:
        q = normalize(q)
    elif metric is DistanceMetric.EUCLIDEAN:
        q = 2.0 * q
    return q, qq


def _int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a [B, D] . b [N, D]^T`` of int8 operands through fp32
    matmuls over blocks of 1,024 dims: every partial sum of a block is an
    integer below 127 * 128 * 1024 < 2^24, so fp32 holds it exactly (TF32
    keeps int8 inputs exact too and still accumulates in fp32)."""
    out = None
    for d0 in range(0, a.shape[1], 1024):
        part = (a[:, d0 : d0 + 1024].float() @ b[:, d0 : d0 + 1024].float().T).to(torch.int32)
        out = part if out is None else out + part
    return out


def _kernel_route(*tensors) -> bool:
    """True when the plain version serves (CPU tensors). Raises on mixed or
    unsupported devices, non-contiguous or misaligned tensors."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all kernel inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel inputs must be 16-byte aligned")
    return False


def _check_rows(q, rows, q_dtype, rows_dtype, chunk: int, vectors: tuple = (),
                queries: tuple = ()) -> None:
    """Shared shape/dtype contract: ``q [B_pad, W]``, ``rows [N, W]``,
    per-row f32/int32 vectors ``[N]``, per-query vectors ``[B_pad]``."""
    if q.dtype != q_dtype or rows.dtype != rows_dtype:
        raise TypeError(f"expected q {q_dtype} and rows {rows_dtype}, got {q.dtype}, {rows.dtype}")
    if q.ndim != 2 or rows.ndim != 2 or q.shape[1] != rows.shape[1] or q.shape[0] < 1:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, rows {tuple(rows.shape)}")
    n = rows.shape[0]
    for v in vectors:
        if v.ndim != 1 or v.shape[0] != n:
            raise ValueError(f"per-row vector of shape {tuple(v.shape)} for N={n}")
    for v in queries:
        if v.ndim != 1 or v.shape[0] != q.shape[0]:
            raise ValueError(f"per-query vector of shape {tuple(v.shape)} for B={q.shape[0]}")
    if chunk <= 0 or chunk % _LANES or chunk > _MAX_CHUNK or n % chunk:
        raise ValueError(
            f"chunk={chunk} must be a multiple of 128, <= {_MAX_CHUNK}, and divide N={n}"
        )


def _gm_gi(b_pad: int, n: int, chunk: int, device):
    nb = n // chunk * _LANES
    return (torch.empty((b_pad, nb), dtype=torch.float32, device=device),
            torch.empty((b_pad, nb), dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# #7: SQ8 per-row int8 scan (reference ``sq8_int8_rows`` :983,
# ``_sq8i_kernel`` :996, ``sq8i_bucket_topk`` :1018, ``sq8i_rerank_topk`` :1088)
# ---------------------------------------------------------------------------


def sq8_int8_rows(codes: torch.Tensor) -> torch.Tensor:
    """Shift ``[N, D] uint8`` SQ8 codes to signed ``[N, D_pad] int8`` rows
    (``code - 128``, D padded to a multiple of 128 with code 128, i.e. 0)."""
    d = codes.shape[1]
    c = F.pad(codes.to(torch.int16), (0, _round_up(d, _LANES) - d), value=128)
    return (c - 128).to(torch.int8)


_SQ8I_MAX_DPAD = 12288  # a 16-query tile (192 KB) and two 16 KB stages of shared memory


def _check_sq8i(qi, rows8, scale, am, pen, sqi, invqs, chunk):
    _check_rows(qi, rows8, torch.int8, torch.int8, chunk, (scale, am, pen), (sqi, invqs))
    if any(v.dtype != torch.float32 for v in (scale, am, pen, sqi, invqs)):
        raise TypeError("scale, am, pen, sqi and invqs must be float32")
    if qi.shape[1] % 16 or qi.shape[1] > _SQ8I_MAX_DPAD:
        raise ValueError(f"D_pad={qi.shape[1]} must be a multiple of 16, <= {_SQ8I_MAX_DPAD}")


def sq8i_bucket_ref(qi, rows8, scale, am, pen, sqi, invqs, chunk: int):
    """Plain torch version of #7: ``s = doti*scale_n + sqi_b*am_n -
    invqs_b*pen_n`` per (query, row), each product and sum rounded to fp32
    in this order, then the bucket select. Returns ``(gm f32, gi int32)``."""
    s = _int8_dot(qi, rows8).float() * scale[None, :] + sqi[:, None] * am[None, :]
    s = s - invqs[:, None] * pen[None, :]
    return _bucket_select(s, chunk)


def sq8i_bucket_gm(qi, rows8, scale, am, pen, sqi, invqs, chunk: int):
    """Bucket winners of the per-row SQ8 scan, ``(gm f32, gi int32)
    [B_pad, N/chunk*128]``. CUDA tensors launch ``csrc/sq8i_bucket.cu``;
    CPU tensors take :func:`sq8i_bucket_ref`."""
    _check_sq8i(qi, rows8, scale, am, pen, sqi, invqs, chunk)
    if _kernel_route(qi, rows8, scale, am, pen, sqi, invqs):
        return sq8i_bucket_ref(qi, rows8, scale, am, pen, sqi, invqs, chunk)
    (b_pad, d_pad), n = qi.shape, rows8.shape[0]
    gm, gi = _gm_gi(b_pad, n, chunk, qi.device)
    _launch(LAUNCHES, "sq8i_bucket_gm", "sq8i_bucket", "sq8i_bucket_launch", _P * 9 + _IIJ,
            qi, rows8, scale, am, pen, sqi, invqs, gm, gi, b_pad, n, d_pad, chunk)
    return gm, gi


def _sq8i_quantize_queries(queries: torch.Tensor, metric: DistanceMetric, d_pad: int):
    """Per-query symmetric int8 quantization (reference ``:1033-1048``):
    ``(qi [B_pad, D_pad] int8, qs [B_pad], sqi [B_pad], invqs [B_pad], qq [B])``
    with B padded to a multiple of 8 (pad rows: qi 0, qs 1)."""
    b = queries.shape[0]
    b_pad = _round_up(max(b, 8), 8)
    q, qq = _prep_queries(queries, metric)
    qs = _div(torch.amax(torch.abs(q), dim=1), 127.0).clamp_min(1e-30)
    qi = torch.round(q / qs[:, None]).to(torch.int8)
    qi = F.pad(qi, (0, d_pad - qi.shape[1], 0, b_pad - b))
    qs = F.pad(qs, (0, b_pad - b), value=1.0)
    invqs = torch.ones_like(qs) / qs
    sqi = qi.float().sum(dim=1)
    return qi, qs, sqi, invqs, qq


def sq8i_bucket_topk(queries, rows8, scale, minv, penalty, *, k, metric, chunk):
    """Bucket-selection top-k over int8 SQ8 rows (reference ``:1018``).
    ``penalty`` is the per-metric additive penalty, ``+inf`` on rows knocked
    out. Returns metric-native ``(vals [B, k], ids [B, k] int64)``."""
    metric = DistanceMetric.parse(metric)
    b = queries.shape[0]
    qi, qs, sqi, invqs, qq = _sq8i_quantize_queries(queries, metric, rows8.shape[1])
    am = 128.0 * scale + minv  # folds the code-128 shift back in
    gm, gi = sq8i_bucket_gm(qi, rows8, scale, am, penalty, sqi, invqs, chunk)
    vals, idx = _final_select(gm, gi, k, b)
    vals = vals * qs[:b, None]  # undo the 1/qs ranking normalization
    if metric is DistanceMetric.EUCLIDEAN:
        return _restore_euclidean(vals, idx, qq)
    return vals, idx


def sq8i_rerank_topk(queries, rows8, scale, minv, penalty, corpus, *, k, m, metric,
                     chunk, shift=None):
    """Coarse per-row int8 scan for ``m`` candidates, then the exact fp32
    rerank from the resident corpus (reference ``:1088``): the FULL-storage
    ``int8-assist`` core where the pd shadow is refused. ``shift [D]``, when
    given, is the point the shadow was centered on (euclidean only): the
    coarse pass scores ``queries - shift`` against it, which ranks rows by
    the same distances."""
    metric = DistanceMetric.parse(metric)
    coarse_q = queries.float() if shift is None else queries.float() - shift[None, :]
    _, ci = sq8i_bucket_topk(coarse_q, rows8, scale, minv, penalty, k=m, metric=metric,
                             chunk=chunk)
    return _exact_rerank_tail(queries, corpus, ci, k=k, metric=metric)


# ---------------------------------------------------------------------------
# #5: bit-plane Hamming as an int8 dot (reference ``_HAM_BIG`` :491,
# ``_hamming_mxu_kernel`` :494, ``hamming_bits_rows`` :507,
# ``hamming_mxu_topk`` :519). popcount(q ^ c) = |q| + |c| - 2 q.c on 0/1 rows.
# ---------------------------------------------------------------------------

_HAM_BIG = 1 << 20  # knockout >> max popcount(D), far from int32 overflow
_HAM_MAX_DPAD = 6144  # a 32-query tile (192 KB) and two 16 KB stages of shared memory


def hamming_bits_rows(slots: torch.Tensor, dim: int) -> torch.Tensor:
    """The bit shadow: unpacked int8 0/1 sign bits ``[N, D_pad]``, D padded
    to a multiple of 128 with zero bits (they cancel in |q| + |c| - 2 q.c)."""
    bits = (slots[:, :dim] >= 0.0).to(torch.int8)
    return F.pad(bits, (0, _round_up(dim, _LANES) - dim))


def _check_mxu(qi, bits, aux, chunk):
    _check_rows(qi, bits, torch.int8, torch.int8, chunk)
    if aux.dtype != torch.int32 or aux.ndim != 1 or aux.shape[0] != bits.shape[0]:
        raise TypeError("aux must be int32 [N]")
    if qi.shape[1] % 16 or qi.shape[1] > _HAM_MAX_DPAD:
        raise ValueError(f"D_pad={qi.shape[1]} must be a multiple of 16, <= {_HAM_MAX_DPAD}")


def hamming_mxu_ref(qi, bits, aux, chunk: int):
    """Plain torch version of #5: ``s = qi . bits_n - aux_n`` in int32
    (``qi = 2 * qbits``), the bucket select, ``gm`` cast to f32 (exact:
    |s| < 2^24)."""
    gm, gi = _bucket_select(_int8_dot(qi, bits) - aux[None, :], chunk)
    return gm.float(), gi


def hamming_mxu_gm(qi, bits, aux, chunk: int):
    """Bucket winners of the bit-plane Hamming scan, ``(gm f32, gi int32)``.
    CUDA tensors launch ``csrc/sq8i_bucket.cu``'s Hamming entry; CPU tensors
    take :func:`hamming_mxu_ref`."""
    _check_mxu(qi, bits, aux, chunk)
    if _kernel_route(qi, bits, aux):
        return hamming_mxu_ref(qi, bits, aux, chunk)
    (b_pad, d_pad), n = qi.shape, bits.shape[0]
    gm, gi = _gm_gi(b_pad, n, chunk, qi.device)
    _launch(LAUNCHES, "hamming_mxu_gm", "sq8i_bucket", "hamming_mxu_launch", _P * 5 + _IIJ,
            qi, bits, aux, gm, gi, b_pad, n, d_pad, chunk)
    return gm, gi


def hamming_mxu_topk(qbits, rows_bits, aux, *, k, chunk):
    """Smallest Hamming distances first: ``qbits [B, D_pad] int8 0/1`` vs the
    bit shadow; ``aux [N_pad] int32 = |c| + _HAM_BIG * knocked_out``. Returns
    ``(dist [B, k] f32, ids [B, k] int64)`` with +inf / -1 empties."""
    b = qbits.shape[0]
    b_pad = _round_up(max(b, 8), 8)
    qi = F.pad(2 * qbits, (0, 0, 0, b_pad - b))
    qsum = qbits.to(torch.int32).sum(dim=1)
    gm, gi = hamming_mxu_gm(qi, rows_bits, aux, chunk)
    vals, idx = _final_select(gm, gi, k, b)
    empty = vals < -(_HAM_BIG // 2)  # int32 scores have no -inf
    dist = torch.where(empty, torch.inf, qsum[:, None].float() - vals)
    return dist, torch.where(empty, -1, idx)


def hamming_mxu_rerank_topk(queries, qbits, rows_bits, aux, corpus, *, k, m, metric, chunk):
    """Bit-plane Hamming coarse scan (#5) for ``m`` candidates, then the exact
    f32 rerank from the resident ``corpus`` (reference ``:576``); cosine
    expects pre-normalized rows. Returns metric-native ``(vals [B, k], ids
    [B, k] int64)``."""
    _, ci = hamming_mxu_topk(qbits, rows_bits, aux, k=m, chunk=chunk)
    return _exact_rerank_tail(queries, corpus, ci, k=k, metric=DistanceMetric.parse(metric))


# ---------------------------------------------------------------------------
# #4: packed Hamming bucket scan (reference ``_hamming_kernel`` :362,
# ``hamming_bucket_topk`` :377). The reference pads W to 128 words (a TPU lane
# artifact); here the scan reads the true W = ceil(D/32) words.
# ---------------------------------------------------------------------------

_HAM_MAX_WORDS = 256


def _check_packed(q, packed, pen, chunk):
    _check_rows(q, packed, torch.int32, torch.int32, chunk, (pen,))
    if pen.dtype != torch.float32:
        raise TypeError("pen must be float32")
    if q.shape[1] > _HAM_MAX_WORDS:
        raise ValueError(f"W={q.shape[1]} words above {_HAM_MAX_WORDS}")


def hamming_bucket_ref(q, packed, pen, chunk: int):
    """Plain torch version of #4: ``s = -popc(q ^ c) - pen_n`` in fp32, the
    bucket select. Returns ``(gm f32, gi int32)``."""
    s = -hamming_distances(q, packed).float() - pen[None, :]
    return _bucket_select(s, chunk)


def hamming_bucket_gm(q, packed, pen, chunk: int):
    """Bucket winners of the packed Hamming scan, ``(gm f32, gi int32)``.
    CUDA tensors launch ``csrc/hamming_bucket.cu`` (the int8 tensor cores on
    the words unpacked in registers); CPU tensors take
    :func:`hamming_bucket_ref`."""
    _check_packed(q, packed, pen, chunk)
    if _kernel_route(q, packed, pen):
        return hamming_bucket_ref(q, packed, pen, chunk)
    (b_pad, w), n = q.shape, packed.shape[0]
    gm, gi = _gm_gi(b_pad, n, chunk, q.device)
    _launch(LAUNCHES, "hamming_bucket_gm", "hamming_bucket", "hamming_bucket_launch", _P * 5 + _IIJ,
            q, packed, pen, gm, gi, b_pad, n, w, chunk)
    return gm, gi


def hamming_bucket_topk(packed_q, packed_corpus, penalty, *, k, chunk=HAMMING_CHUNK):
    """Smallest packed-Hamming distances first; ``penalty [N_pad] f32`` is 0
    on valid rows and +inf on knocked-out ones. Returns ``(dist [B, k] f32,
    ids [B, k] int64)`` with +inf / -1 empties."""
    b = packed_q.shape[0]
    q = F.pad(packed_q, (0, 0, 0, _round_up(max(b, 8), 8) - b))
    gm, gi = hamming_bucket_gm(q, packed_corpus, penalty, chunk)
    vals, idx = _final_select(gm, gi, k, b)
    return torch.where(idx < 0, torch.inf, -vals), idx


def hamming_rerank_topk(queries, packed_q, packed_corpus, penalty, corpus, *, k, m, metric,
                        chunk=HAMMING_CHUNK):
    """Packed-Hamming coarse scan (#4) for ``m`` candidates, then the exact
    f32 rerank from the resident ``corpus`` (reference ``:429``). Cosine
    expects pre-normalized rows: the reference divides each candidate's dot
    by its norm, which is the same there. Returns metric-native ``(vals [B,
    k], ids [B, k] int64)``."""
    _, ci = hamming_bucket_topk(packed_q, packed_corpus, penalty, k=m, chunk=chunk)
    return _exact_rerank_tail(queries, corpus, ci, k=k, metric=DistanceMetric.parse(metric))


# ---------------------------------------------------------------------------
# The float-score bucket scans, #2, #3 and #6: fixed-order fp32 dots
# ---------------------------------------------------------------------------

_FLOAT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_DENSE_MAX_DPAD = 3072  # #2, #2b and #6: the parts of an 8-query tile and two stages
_HL_MAX_DPAD = 1536  # #3, the reference's cap: two 8-query halves and two stages


def _ordered_dot(q: torch.Tensor, rows: torch.Tensor, acc=None) -> torch.Tensor:
    """fp32 ``q [B, W] . rows [N, W]^T`` summed over ``w = 0 .. W-1`` in
    order, one elementwise multiply and one add per term (no FMA, no
    blocking), so every product and partial sum rounds as the CUDA kernels'
    ``__fmul_rn`` / ``__fadd_rn`` do. ``acc [B, N]``, when given, is the sum
    to continue."""
    qf = q.float()
    rt = rows.float().T.contiguous()  # [W, N]: one contiguous row per term
    if acc is None:
        acc = torch.zeros((q.shape[0], rows.shape[0]), dtype=torch.float32, device=q.device)
    for w in range(q.shape[1]):
        acc = acc + qf[:, w, None] * rt[w][None, :]
    return acc


def _check_float_scan(q, rows, chunk, max_dpad, vectors=(), queries=()):
    if rows.dtype not in _FLOAT_CODES:
        raise TypeError(f"rows must be float32, float16 or bfloat16, got {rows.dtype}")
    _check_rows(q, rows, rows.dtype, rows.dtype, chunk, vectors, queries)
    if any(v.dtype != torch.float32 for v in (*vectors, *queries)):
        raise TypeError("per-row and per-query vectors must be float32")
    if q.shape[0] % 8:
        raise ValueError(f"B_pad={q.shape[0]} must be a multiple of 8")
    if q.shape[1] % 8 or q.shape[1] > max_dpad:
        raise ValueError(f"D_pad={q.shape[1]} must be a multiple of 8, <= {max_dpad}")


def dense_bucket_ref(q, rows, cc, chunk: int):
    """Plain torch version of #2: ``s = dot - cc`` with the fixed-order fp32
    dot of the upcast operands, then the bucket select."""
    return _bucket_select(_ordered_dot(q, rows) - cc[None, :], chunk)


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The fp32 spacing above ``|x|``."""
    mag = x.abs()
    return torch.nextafter(mag, torch.full_like(mag, torch.inf)) - mag


def half_scan_tolerance(q, rows, cc, chunk: int):
    """The plain pass of #2 and the bound #2b is held to on half rows:
    ``(gm_ref, gi_ref, s_ref [B_pad, N], tol)``, ``tol`` per bucket winner:

        |gm - gm_ref| <= 2 * D_pad * 2^-24 * A + 2 ulp(gm_ref)

    with ``A = sum_d |q_d * c_d|`` over the plain winner's row. The products
    of two f16 or two bf16 values are exact in fp32, so only the order of the
    sums differs: each order's sum lies within ``(D_pad - 1) * 2^-24 * A`` of
    the exact dot (the first-order bound of any fp32 summation order), hence
    the factor 2; the two ulps cover the rounding of ``dot - cc``."""
    s = _ordered_dot(q, rows) - cc[None, :]
    gm, gi = _bucket_select(s, chunk)
    a = torch.gather(q.float().abs() @ rows.float().abs().T, 1, gi.long())
    tol = 2.0 * q.shape[1] * 2.0**-24 * a + 2.0 * _ulp(gm)
    return gm, gi, s, tol


def ranked_error(ref_v, ref_i, tol, gap, got_v, got_i, picked, legal):
    """The one checker of the tensor-core kernels (#2b, #3, #8): outputs
    ranked by score, against the plain version's, all ``[..., r]``:
    ``ref_v``/``ref_i`` the plain values and ids by rank, ``tol`` each rank's
    tolerance, ``gap`` the plain gap at that rank (the distance to the
    nearest plain score ranked beside it), ``got_v``/``got_i`` the kernel's,
    ``picked`` the plain score of the row the kernel returned, ``legal``
    whether that row may stand at that rank at all.

    A value must lie within ``tol`` of the plain value; where the plain value
    is ``-inf`` (nothing to rank) value and id must equal the plain ones. An
    id must equal the plain id wherever the gap exceeds ``2 tol``; elsewhere
    it must be legal and name a row whose plain score lies within ``tol`` of
    the plain value. Returns ``(worst, max_tol, max_abs_err)``: ``worst`` is
    the largest error relative to the tolerance, and the outputs pass when it
    is at most 1."""
    inf_ref = torch.isinf(ref_v)
    same = got_v == ref_v
    diff = torch.where(same, 0.0, (got_v - ref_v).abs())
    r_v = torch.where(inf_ref, torch.where(same, 0.0, torch.inf), diff / tol)
    near = torch.where(picked == ref_v, 0.0, (picked - ref_v).abs()) / tol
    r_i = torch.where(gap > 2.0 * tol, torch.where(got_i == ref_i, 0.0, torch.inf),
                      torch.where(legal, near, torch.inf))
    r_i = torch.where(inf_ref, torch.where(got_i == ref_i, 0.0, torch.inf), r_i)
    worst = float(torch.maximum(r_v, r_i).max()) if r_v.numel() else 0.0
    fin = ~inf_ref
    max_tol = float(tol[fin].max()) if bool(fin.any()) else 0.0
    max_abs = float(diff[fin].max()) if bool(fin.any()) else 0.0
    return worst, max_tol, max_abs


def _bucket_error(ref, chunk: int, gm, gi):
    """``(gm, gi)`` of a tensor-core bucket scan against its plain pass
    ``ref = (gm_ref, gi_ref, s_ref [B_pad, N], tol)`` by :func:`ranked_error`,
    each bucket a ranking of one: the gap is the plain bucket's best minus its
    second best, and a returned row is legal in its own bucket only."""
    gm_ref, gi_ref, s, tol = ref
    b, n = s.shape
    t = s.reshape(b, n // chunk, chunk // _LANES, _LANES)
    if t.shape[2] > 1:
        top2 = torch.topk(t, 2, dim=2).values
        gap = (top2[:, :, 0] - top2[:, :, 1]).reshape(b, -1)
    else:
        gap = torch.full_like(gm_ref, torch.inf)
    bucket = torch.arange(gm_ref.shape[1], device=gm.device)
    home = (gi.long() % _LANES == bucket % _LANES) & (gi.long() // chunk == bucket // _LANES)
    picked = torch.gather(s, 1, gi.long().clamp(0, n - 1))
    return ranked_error(gm_ref, gi_ref, tol, gap, gm, gi, picked, home)


def half_scan_error(q, rows, cc, chunk: int, gm, gi, ref=None):
    """``(gm, gi)`` of #2b against the plain pass within
    :func:`half_scan_tolerance` (``ref``: its result, when already computed),
    by :func:`ranked_error`. Returns ``(worst, max_tol, max_abs_err)``.

    ``gm`` must lie within ``tol`` of ``gm_ref``; a ``-inf`` bucket must be
    ``-inf``. ``gi`` must equal ``gi_ref`` wherever the plain bucket's best
    beats its second best by more than ``2 tol``; elsewhere it must name a
    row of the same bucket whose plain score lies within ``tol`` of
    ``gm_ref``."""
    return _bucket_error(half_scan_tolerance(q, rows, cc, chunk) if ref is None else ref,
                         chunk, gm, gi)


def f32_scan_tolerance(q, rows, cc, chunk: int):
    """The plain pass of #2 on f32 rows and the bound its tensor-core mode
    (rows split in the kernel) is held to: ``(gm_ref, gi_ref, s_ref [B_pad,
    N], tol)``, ``tol`` per bucket winner, with ``A = sum_d |q_d x_d|`` over
    the plain winner's row:

        |gm - gm_ref| <= (3.1 * 2^-16 + order_bound(3 D_pad, 2 D_pad)) * A
                         + 2 ulp(gm_ref)

    The kernel computes #8's dot (:func:`~velesdb_tpu_torch.ops.
    pallas_kernels.fused_topk_tolerance` derives both terms): the split's
    dropped terms ``qlo lo``, ``qhi (x - hi - lo)`` and ``(q - qhi - qlo)
    hi`` are at most ``3.1 * 2^-16 * A`` in all; its ``3 D_pad`` exact
    products summed in the tensor cores' order lie within
    :func:`order_bound` ``(3 D_pad, 2 D_pad) A`` of the plain version's
    ``D_pad`` rounded products and ``D_pad - 1`` sums. The two ulps cover
    the rounding of ``dot - cc``."""
    s = _ordered_dot(q, rows) - cc[None, :]
    gm, gi = _bucket_select(s, chunk)
    a = torch.gather(q.float().abs() @ rows.float().abs().T, 1, gi.long())
    d_pad = q.shape[1]
    tol = (3.1 * 2.0**-16 + order_bound(3 * d_pad, 2 * d_pad)) * a + 2.0 * _ulp(gm)
    return gm, gi, s, tol


def f32_scan_error(q, rows, cc, chunk: int, gm, gi, ref=None):
    """``(gm, gi)`` of #2 on f32 rows against the plain pass within
    :func:`f32_scan_tolerance` (``ref``: its result, when already computed),
    by the rules of :func:`half_scan_error`. Returns ``(worst, max_tol,
    max_abs_err)``; the outputs pass when ``worst <= 1``."""
    return _bucket_error(f32_scan_tolerance(q, rows, cc, chunk) if ref is None else ref,
                         chunk, gm, gi)


def dense_bucket_gm(q, rows, cc, chunk: int):
    """Bucket winners of the float scan, ``(gm f32, gi int32)
    [B_pad, N/chunk*128]``: ``q [B_pad, D_pad]`` and ``rows [N, D_pad]`` in
    one float dtype (f32, f16 or bf16), ``cc [N]`` f32. CUDA tensors launch
    ``csrc/dense_bucket_tc.cu`` on the tensor cores: f16 and bf16 rows as
    they are (#2b, counter ``dense_bucket_tc``), within
    :func:`half_scan_tolerance`; f32 rows split into bf16 (hi, lo) pairs in
    the kernel against the queries split here once (#2, counter
    ``dense_bucket_gm``), within :func:`f32_scan_tolerance`. CPU tensors
    take :func:`dense_bucket_ref`."""
    _check_float_scan(q, rows, chunk, _DENSE_MAX_DPAD, (cc,))
    if _kernel_route(q, rows, cc):
        return dense_bucket_ref(q, rows, cc, chunk)
    (b_pad, d_pad), n = q.shape, rows.shape[0]
    gm, gi = _gm_gi(b_pad, n, chunk, q.device)
    if rows.dtype == torch.float32:
        qhi, qlo = split_f32_rows(q)
        _launch(LAUNCHES, "dense_bucket_gm", "dense_bucket_tc", "dense_bucket_f32_launch",
                _P * 6 + _IIJ, qhi, qlo, rows, cc, gm, gi, b_pad, n, d_pad, chunk)
    else:
        _launch(LAUNCHES, "dense_bucket_tc", "dense_bucket_tc", "dense_bucket_tc_launch",
                _P * 5 + _IIJ + (ctypes.c_int,), q, rows, cc, gm, gi, b_pad, n, d_pad, chunk,
                _FLOAT_CODES[rows.dtype])
    return gm, gi


def _fold_mask(penalty: torch.Tensor, mask, n: int) -> torch.Tensor:
    """The per-call filter folded into the additive penalty (``+inf`` on rows
    it drops), as the reference folds it (``:219-223``)."""
    pen = penalty.float()
    if mask is None:
        return pen
    m = mask.to(device=pen.device, dtype=torch.bool)
    if m.shape[0] < n:
        m = F.pad(m, (0, n - m.shape[0]))
    return torch.where(m[:n], pen, torch.inf)


def _bucket_call(q, corpus, cc, *, k: int, chunk: int):
    """The #2 sweep and the exact final select (reference ``:166-196``)."""
    gm, gi = dense_bucket_gm(q, corpus, cc, chunk)
    return _final_select(gm, gi, k, q.shape[0])


def bucket_topk_entry(queries, corpus, cnorm_or_penalty, mask=None, *, k: int, metric,
                      chunk: int, prenormalized: bool = True):
    """Bucket-selection top-k over a float corpus (reference ``:202-250``).

    ``cnorm_or_penalty [N]``: euclidean ``|c|^2``, else 0, with ``+inf`` on
    rows knocked out; ``mask [N] bool`` is a per-call filter folded into it.
    ``corpus [N, D']`` may be wider than the queries' D when its extra
    columns are zero: a corpus already ``[N_pad, round_up(D, 8)]`` goes to the
    kernel without a copy. Cosine assumes pre-normalized rows unless
    ``prenormalized=False``. The queries are cast to the corpus dtype when it
    is not f32. Returns metric-native ``(vals [B, k], ids [B, k] int64)``,
    ``-1`` for empties."""
    metric = DistanceMetric.parse(metric)
    b, d = queries.shape
    n, d_c = corpus.shape
    b_pad, d_pad, n_pad = _round_up(b, 8), _round_up(max(d, d_c), 8), _round_up(n, chunk)
    pen = _fold_mask(cnorm_or_penalty, mask, n)
    q, qq = _prep_queries(queries, metric)
    if metric is DistanceMetric.COSINE and not prenormalized:
        corpus = normalize(corpus.float()).to(corpus.dtype)
    q = F.pad(q, (0, d_pad - d, 0, b_pad - b))
    if (n_pad, d_pad) != tuple(corpus.shape):
        corpus = F.pad(corpus, (0, d_pad - d_c, 0, n_pad - n))
    pen = F.pad(pen, (0, n_pad - n), value=torch.inf)
    if corpus.dtype != torch.float32:
        q = q.to(corpus.dtype)
    vals, idx = _bucket_call(q, corpus.contiguous(), pen, k=k, chunk=chunk)
    vals, idx = vals[:b], idx[:b]
    if metric is DistanceMetric.EUCLIDEAN:
        return _restore_euclidean(vals, idx, qq)
    return vals, idx


def bucket_topk(queries, corpus, penalty=None, k: int = 10,
                metric: DistanceMetric = DistanceMetric.COSINE, chunk: int | None = None,
                prenormalized: bool = False):
    """Convenience wrapper of :func:`bucket_topk_entry` (reference ``:832``):
    ``penalty`` None derives it from the corpus (all rows valid); ``chunk``
    None takes :func:`bucket_chunk` of the 128-padded row count."""
    metric = DistanceMetric.parse(metric)
    c = torch.as_tensor(corpus)
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=c.device))
    if chunk is None:
        chunk = bucket_chunk(_round_up(c.shape[0], _LANES))
    if penalty is None:
        if metric is DistanceMetric.EUCLIDEAN:
            penalty = torch.sum(c.float() ** 2, dim=1)
        else:
            penalty = torch.zeros(c.shape[0], dtype=torch.float32, device=c.device)
    pen = torch.as_tensor(penalty, dtype=torch.float32, device=c.device)
    return bucket_topk_entry(q, c, pen, k=k, metric=metric, chunk=chunk,
                             prenormalized=prenormalized)


# -- #3: split-bf16 (reference ``split_f32_rows`` :272, ``bucket_topk_hl`` :296)


def split_f32_rows(corpus: torch.Tensor):
    """``[N, D] f32`` -> ``(hi, lo)`` bf16 pair: ``hi = bf16(x)``,
    ``lo = bf16(x - hi)``, for :func:`bucket_topk_hl`."""
    x = corpus.float()
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def split3_f32(x: torch.Tensor):
    """``[B, D] f32`` -> ``(hi, mid, lo)`` bf16 with ``hi + mid + lo == x``
    exactly: ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi -
    mid)``. Each remainder is exact in fp32, and three 8-bit significands
    cover f32's 24 (bf16 has f32's exponent range; values below 2^-110 may
    lose bits to bf16's subnormals)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _hl_scores(qhi, qlo, hi, lo, cc):
    """#3's plain scores ``[B_pad, N]``: ``a = qhi.hi``, then ``e = qhi.lo``
    continued with ``qlo.hi`` (the reference's ``[qhi|qlo].[lo|hi]`` in its
    concatenated order), each a fixed-order fp32 sum; ``(a + e) - cc``."""
    a = _ordered_dot(qhi, hi)
    e = _ordered_dot(qlo, hi, acc=_ordered_dot(qhi, lo))
    return (a + e) - cc[None, :]


def hl_bucket_ref(qhi, qlo, hi, lo, cc, chunk: int):
    """Plain torch version of #3: the bucket select of :func:`_hl_scores`."""
    return _bucket_select(_hl_scores(qhi, qlo, hi, lo, cc), chunk)


def order_bound(n_kernel: int, n_plain: int) -> float:
    """The share of ``A = sum |terms|`` by which two fp32 sums of the same
    exact terms, the tensor-core kernel's over ``n_kernel`` terms and the
    plain version's with ``n_plain`` roundings, may differ:
    ``8 (2 sqrt(n_kernel) + sqrt(n_plain)) 2^-24``.

    Worst cases (``(n_kernel + n_plain) 2^-24``) grow with the width: at
    D_pad 1,536 they would admit a split kernel that drops both ``lo``
    products. So the bound is probabilistic (Higham and Mary, "A new
    approach to probabilistic rounding error analysis", SIAM J. Sci. Comput.
    41(5), 2019): with rounding errors independent of the sums, a sum with
    ``n`` roundings lies within ``lambda sqrt(n) u A`` of the exact sum with
    probability about ``1 - 2 n exp(-lambda^2 / 2)`` or more, ``1 - 6e-11``
    at ``lambda = 8`` and n = 2,304. ``u = 2^-24`` for the plain version,
    doubled for the kernel, whose accumulator may truncate.
    ``tests/test_torch_split_tolerance.py`` shows the bounds built on it
    reject a kernel without the ``lo`` products; ``chip_smoke.py`` prints
    the H100's worst error as a share of them."""
    return 8.0 * (2.0 * math.sqrt(n_kernel) + math.sqrt(n_plain)) * 2.0**-24


def split_scan_tolerance(qhi, qlo, hi, lo, cc, chunk: int):
    """The plain pass of #3 and the bound its tensor-core kernel is held to:
    ``(gm_ref, gi_ref, s_ref [B_pad, N], tol)``, ``tol`` per bucket winner:

        |gm - gm_ref| <= order_bound(3 D_pad, 3 D_pad) * A + 2 ulp(gm_ref)

    with ``A = sum_d |qhi_d hi_d| + |qhi_d lo_d| + |qlo_d hi_d|`` over the
    plain winner's row. Both sides sum the same ``3 D_pad`` products, each
    exact in fp32 (two bf16 values): the plain version in its fixed order
    (``a`` over ``D_pad`` terms, ``e`` over ``2 D_pad``, then ``a + e``:
    ``3 D_pad`` roundings, each of a partial sum bounded by ``A``), the
    kernel in the tensor cores' (``3 D_pad - 1`` additions):
    :func:`order_bound` bounds the difference; the two ulps cover the
    rounding of ``dot - cc``."""
    s = _hl_scores(qhi, qlo, hi, lo, cc)
    gm, gi = _bucket_select(s, chunk)
    qh, ql, h = qhi.float().abs(), qlo.float().abs(), hi.float().abs()
    mag = qh @ (h + lo.float().abs()).T
    mag += ql @ h.T
    a_w = torch.gather(mag, 1, gi.long())
    n = 3 * qhi.shape[1]
    tol = order_bound(n, n) * a_w + 2.0 * _ulp(gm)
    return gm, gi, s, tol


def split_scan_error(qhi, qlo, hi, lo, cc, chunk: int, gm, gi, ref=None):
    """``(gm, gi)`` of #3 against the plain pass within
    :func:`split_scan_tolerance` (``ref``: its result, when already
    computed), by the rules of :func:`half_scan_error`. Returns ``(worst,
    max_tol, max_abs_err)``; the outputs pass when ``worst <= 1``."""
    if ref is None:
        ref = split_scan_tolerance(qhi, qlo, hi, lo, cc, chunk)
    return _bucket_error(ref, chunk, gm, gi)


def hl_bucket_gm(qhi, qlo, hi, lo, cc, chunk: int):
    """Bucket winners of the split-bf16 scan (#3), ``(gm f32, gi int32)``.
    CUDA tensors launch the split mode of ``csrc/dense_bucket_tc.cu`` (three
    bf16 products per K step on the tensor cores), held to
    :func:`hl_bucket_ref` within :func:`split_scan_tolerance`; CPU tensors
    take :func:`hl_bucket_ref`."""
    _check_float_scan(qhi, hi, chunk, _HL_MAX_DPAD, (cc,))
    if any(t.dtype != torch.bfloat16 for t in (qhi, qlo, hi, lo)):
        raise TypeError("qhi, qlo, hi and lo must be bfloat16")
    if qlo.shape != qhi.shape or lo.shape != hi.shape:
        raise ValueError(f"shape mismatch: qlo {tuple(qlo.shape)}, lo {tuple(lo.shape)}")
    if _kernel_route(qhi, qlo, hi, lo, cc):
        return hl_bucket_ref(qhi, qlo, hi, lo, cc, chunk)
    (b_pad, d_pad), n = qhi.shape, hi.shape[0]
    gm, gi = _gm_gi(b_pad, n, chunk, qhi.device)
    _launch(LAUNCHES, "hl_bucket_gm", "dense_bucket_tc", "hl_bucket_launch", _P * 7 + _IIJ,
            qhi, qlo, hi, lo, cc, gm, gi, b_pad, n, d_pad, chunk)
    return gm, gi


def bucket_topk_hl(queries, hi, lo, cnorm_or_penalty, mask=None, *, k: int, metric,
                   chunk: int):
    """Split-bf16 bucket search: the :func:`bucket_topk_entry` contract at
    near-f32 fidelity. ``hi/lo [N, D_pad]`` bf16 from :func:`split_f32_rows`
    of the (cosine: pre-normalized) corpus, D padded to 128 at build."""
    metric = DistanceMetric.parse(metric)
    b, d = queries.shape
    n, d_pad = hi.shape
    b_pad = _round_up(b, 8)
    pen = _fold_mask(cnorm_or_penalty, mask, n)
    q, qq = _prep_queries(queries, metric)
    q = F.pad(q, (0, d_pad - d, 0, b_pad - b))
    qhi, qlo = split_f32_rows(q)
    gm, gi = hl_bucket_gm(qhi, qlo, hi, lo, pen, chunk)
    vals, idx = _final_select(gm, gi, k, b)
    if metric is DistanceMetric.EUCLIDEAN:
        return _restore_euclidean(vals, idx, qq)
    return vals, idx


# -- #6: staged SQ8 over block-packed words (reference ``_sq8_kernel`` :894,
# ``sq8_bucket_topk`` :923, f32 unpack)


def _check_sq8_words(q, words, scale, minv, pen, qsum, chunk):
    if q.dtype != torch.float32 or words.dtype != torch.int32:
        raise TypeError(f"expected q float32 and words int32, got {q.dtype}, {words.dtype}")
    if words.ndim != 2 or q.ndim != 2 or q.shape[1] != 4 * words.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, words {tuple(words.shape)}")
    # the row contract on the [B_pad, W] word view of the queries' width
    _check_rows(q[:, 0::4], words, torch.float32, torch.int32, chunk, (scale, minv, pen),
                (qsum,))
    if any(v.dtype != torch.float32 for v in (scale, minv, pen, qsum)):
        raise TypeError("scale, minv, pen and qsum must be float32")
    if q.shape[0] % 8 or q.shape[1] > _DENSE_MAX_DPAD:
        raise ValueError(f"B_pad={q.shape[0]} must be a multiple of 8, D_pad={q.shape[1]} "
                         f"<= {_DENSE_MAX_DPAD}")


def sq8_bucket_ref(q, words, scale, minv, pen, qsum, chunk: int):
    """Plain torch version of #6: the codes unpacked to dim order, the
    fixed-order fp32 dot, ``s = (dot*scale + qsum*minv) - pen``, the bucket
    select."""
    dot = _ordered_dot(q, sq8_unpack_blocked(words))
    s = dot * scale[None, :] + qsum[:, None] * minv[None, :]
    return _bucket_select(s - pen[None, :], chunk)


def sq8_scan_tolerance(q, words, scale, minv, pen, qsum, chunk: int):
    """The plain pass of #6 and the bound its tensor-core mode is held to:
    ``(gm_ref, gi_ref, s_ref [B_pad, N], tol)``, ``tol`` per bucket winner
    ``r``, with ``A = sum_d (|qhi_d| + |qmid_d| + |qlo_d|) code_d`` over its
    row (:func:`split3_f32` of ``q``; ``A`` is ``sum_d |q_d| code_d`` to a
    few parts in 2^9):

        dot:    order_bound(3 D_pad, 2 D_pad) * A
        score:  |scale_r| * dot's bound + 2 ulp(P) + 2 ulp(T) + 2 ulp(gm_ref)

    The dot: the queries split exactly into three bf16 parts and the codes
    0..255 are exact in bf16, so the kernel's ``3 D_pad`` products are the
    exact terms of ``q . codes`` and there is no split term; they are summed
    in the tensor cores' order, the plain version rounds ``D_pad`` products
    and ``D_pad - 1`` sums: :func:`order_bound` bounds the difference. The
    score: both sides round ``P = dot * scale``, ``T = P + qsum * minv`` and
    ``T - pen`` in that order; a dot that differs by ``e`` moves ``P`` by at
    most ``|scale| e`` and each rounding by at most one ulp of its result on
    either side (within a factor 2 of the plain result's ulp)."""
    dot = _ordered_dot(q, sq8_unpack_blocked(words))
    p = dot * scale[None, :]
    t = p + qsum[:, None] * minv[None, :]
    s = t - pen[None, :]
    gm, gi = _bucket_select(s, chunk)
    g = gi.long()
    parts = sum(part.float().abs() for part in split3_f32(q))
    a = torch.gather(parts @ sq8_unpack_blocked(words).T, 1, g)
    d_pad = q.shape[1]
    dot_tol = order_bound(3 * d_pad, 2 * d_pad) * a
    ulps = _ulp(torch.gather(p, 1, g)) + _ulp(torch.gather(t, 1, g)) + _ulp(gm)
    tol = scale.abs()[g] * dot_tol + 2.0 * ulps
    return gm, gi, s, tol


def sq8_scan_error(q, words, scale, minv, pen, qsum, chunk: int, gm, gi, ref=None):
    """``(gm, gi)`` of #6 against the plain pass within
    :func:`sq8_scan_tolerance` (``ref``: its result, when already computed),
    by the rules of :func:`half_scan_error`. Returns ``(worst, max_tol,
    max_abs_err)``; the outputs pass when ``worst <= 1``."""
    if ref is None:
        ref = sq8_scan_tolerance(q, words, scale, minv, pen, qsum, chunk)
    return _bucket_error(ref, chunk, gm, gi)


def _sq8_query_parts(q: torch.Tensor, w: int):
    """#6's queries for the kernel: the columns permuted to the words' order
    (``q'[:, 4 v + j] = q[:, j w + v]``: word ``v`` unpacks into K positions
    ``4 v .. 4 v + 3``), padded to a multiple of 8, split into three bf16
    parts (:func:`split3_f32`)."""
    b = q.shape[0]
    qp = q.reshape(b, 4, w).transpose(1, 2).reshape(b, 4 * w)
    return split3_f32(F.pad(qp, (0, _round_up(4 * w, 8) - 4 * w)))


def sq8_bucket_gm(q, words, scale, minv, pen, qsum, chunk: int):
    """Bucket winners of the staged SQ8 scan (#6), ``(gm f32, gi int32)``:
    ``q [B_pad, D_pad] f32``, ``words [N, D_pad/4] int32``. CUDA tensors
    launch the SQ8 mode of ``csrc/dense_bucket_tc.cu`` (the words unpacked
    to bf16 codes in the kernel, the queries permuted and split here once,
    three bf16 products a K step), held to :func:`sq8_bucket_ref` within
    :func:`sq8_scan_tolerance`; CPU tensors take :func:`sq8_bucket_ref`."""
    _check_sq8_words(q, words, scale, minv, pen, qsum, chunk)
    if _kernel_route(q, words, scale, minv, pen, qsum):
        return sq8_bucket_ref(q, words, scale, minv, pen, qsum, chunk)
    b_pad, (n, w) = q.shape[0], words.shape
    gm, gi = _gm_gi(b_pad, n, chunk, q.device)
    qhi, qmid, qlo = _sq8_query_parts(q, w)
    _launch(LAUNCHES, "sq8_bucket_gm", "dense_bucket_tc", "sq8_bucket_tc_launch",
            _P * 10 + (ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int),
            qhi, qmid, qlo, words, scale, minv, pen, qsum, gm, gi, b_pad, n, qhi.shape[1], w,
            chunk)
    return gm, gi


def sq8_bucket_topk(queries, words, scale, minv, penalty, *, k: int, metric, chunk: int):
    """Bucket-selection search over block-packed SQ8 codes (``words [N_pad,
    D_pad/4] int32`` from :func:`~velesdb_tpu_torch.ops.quantization.
    sq8_pack_blocked`); ``penalty``: euclidean dequantized ``|c|^2``, else 0,
    ``+inf`` on rows knocked out. Cosine's ``1/|c|`` is folded into
    ``scale``/``minv``. ``sum(q)`` is summed here once, in one reduction,
    and handed to the scan."""
    metric = DistanceMetric.parse(metric)
    b, d = queries.shape
    d_pad = words.shape[1] * 4
    b_pad = _round_up(max(b, 8), 8)
    q, qq = _prep_queries(queries, metric)
    q = F.pad(q, (0, d_pad - d, 0, b_pad - b))
    qsum = q.sum(dim=1)
    gm, gi = sq8_bucket_gm(q, words, scale, minv, penalty.float(), qsum, chunk)
    vals, idx = _final_select(gm, gi, k, b)
    if metric is DistanceMetric.EUCLIDEAN:
        return _restore_euclidean(vals, idx, qq)
    return vals, idx
