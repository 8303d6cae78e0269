"""Per-dimension int8 "enc-select" coarse scan + exact f32 rerank.

Counterpart of the pd family of ``velesdb_tpu/ops/bucket_kernel.py``
(``:595-808`` and ``_exact_rerank_tail`` ``:1124``), the FULL-storage serve
core at D < 512 and at least ``BUCKET_MIN_ROWS`` padded rows.

The corpus gets a shadow quantized per DIMENSION with one corpus-calibrated
query step ``qu``, so every score of the coarse pass is an integer:

    qu * doti - pen  ~  2 q.x - |x|^2 (euclidean) or 2 q.x (cosine/dot)

with ``doti`` the int8 x int8 dot and ``pen_int = round(pen / qu)``. The
scan rides a single ENCODED int32 tile, ``enc = doti * 64 + ptile`` with
``ptile = -64 * pen_int + slice_index``: the in-chunk slice index lives in
the low 6 bits, so one integer max per 128-lane bucket yields the bucket
winner's value AND its row. That scan is the hand-written CUDA kernel
``csrc/sq8pd_bucket.cu`` (:func:`sq8pd_bucket_gm`); :func:`sq8pd_bucket_gm_ref`
is its plain torch version. A top-m over the bucket winners, then an exact
fp32 rescoring of the m candidates from the resident corpus, gives the top-k.

int32 budget (dim <= 512): |doti| <= 127*127*dim, valid ``pen_int`` capped at
``_PD_PEN_CAP`` (else :func:`sq8pd_build` refuses), knocked-out rows carry
``_pd_invalid_pen(dim)`` so masked scores sit strictly below every valid score
and |enc| < 2^31.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from velesdb_tpu_torch.ops import _cuda
from velesdb_tpu_torch.ops.distance import DistanceMetric, normalize

__all__ = [
    "BUCKET_MIN_ROWS",
    "LAUNCHES",
    "pd_chunk",
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

# Kernel launches per wrapper, counted where the CUDA kernel is launched and
# nowhere else (the CPU path of a wrapper does not count).
LAUNCHES = {"sq8pd_bucket_gm": 0}


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
    blocks of 32 columns, then across the blocks. Every step is an
    elementwise fp32 add, so the sums are the same on every device, and they
    equal the JAX package's on the CPU (its XLA row reduction adds in this
    order), so ``pen_int`` rounds the same in both packages."""
    sq = (x * x).reshape(x.shape[0], -1, 32)
    blocks = sq[:, :, 0]
    for i in range(1, 32):
        blocks = blocks + sq[:, :, i]
    total = blocks[:, 0]
    for j in range(1, blocks.shape[1]):
        total = total + blocks[:, j]
    return total


def pd_chunk(n_pad: int) -> int:
    """Rows per kernel chunk: the largest allowed, ``min(8192, n_pad)``. It
    divides every padded row count (``pad_rows`` steps are multiples of
    8192 above 64K rows and powers of two below)."""
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
    if d_pad % 4 or d_pad > 512:
        raise ValueError(f"D_pad={d_pad} must be a multiple of 4 and <= 512")
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


@functools.cache
def _gm_launch():
    """The kernel library's C entry point, built and bound on first use."""
    fn = _cuda.library("sq8pd_bucket").sq8pd_bucket_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return fn


def sq8pd_bucket_gm(qi: torch.Tensor, rows_pd: torch.Tensor, ptile: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """Encoded bucket maxima ``gm int32 [B_pad, N/chunk*128]``.

    On CUDA tensors this launches ``csrc/sq8pd_bucket.cu`` on the current
    stream (or raises); CPU tensors take :func:`sq8pd_bucket_gm_ref`."""
    _check_gm_args(qi, rows_pd, ptile, chunk)
    if qi.device.type == "cpu":
        return sq8pd_bucket_gm_ref(qi, rows_pd, ptile, chunk)
    if qi.device.type != "cuda":
        raise ValueError(f"unsupported device {qi.device}")
    if rows_pd.data_ptr() % 4 or qi.data_ptr() % 4:
        raise ValueError("qi and rows_pd must be 4-byte aligned")
    launch = _gm_launch()
    b_pad = qi.shape[0]
    n, d_pad = rows_pd.shape
    gm = torch.empty((b_pad, n // chunk * _LANES), dtype=torch.int32, device=qi.device)
    stream = torch.cuda.current_stream(qi.device).cuda_stream
    rc = launch(
        qi.data_ptr(), rows_pd.data_ptr(), ptile.data_ptr(), gm.data_ptr(),
        b_pad, n, d_pad, chunk, stream,
    )
    if rc != 0:
        raise RuntimeError(f"sq8pd_bucket launch failed with CUDA error {rc}")
    LAUNCHES["sq8pd_bucket_gm"] += 1
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
    and rescore them exactly in fp32 (cosine corpus rows are pre-normalized)."""
    cand = corpus[ci.clamp_min(0)]  # [B, m, D]
    q = queries.float()
    qn = normalize(q) if metric is DistanceMetric.COSINE else q
    dots = torch.bmm(cand, qn[:, :, None])[:, :, 0]  # [B, m]
    if metric is DistanceMetric.EUCLIDEAN:
        qq = torch.sum(qn * qn, dim=1, keepdim=True)
        csq = torch.sum(cand * cand, dim=-1)
        exact = torch.where(ci < 0, torch.inf, qq + csq - 2.0 * dots)
        d2, order = torch.topk(exact, k, dim=1, largest=False)
        ids = torch.gather(ci, 1, order)
        return torch.sqrt(d2.clamp_min(0.0)), ids
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
