"""Streamed exact top-k: a chunked matmul, a per-chunk top-k and an exact merge.

Counterpart of ``velesdb_tpu/ops/streamed.py`` (``streamed_topk`` ->
``_streamed_entry``, ``approx=False``; ``sq8_streamed_topk`` ``:205``). The
reference runs this in plain XLA outside any Pallas kernel, so here it is
plain torch: per corpus chunk one fp32 ``matmul`` of the whole query batch,
a metric fixup, ``torch.topk``, and an exact merge into the running
``[B, k]`` result. The ``[B, N]`` score matrix is never materialized beyond
one chunk.

Scoring is maximize-oriented: dot products for DOT/COSINE (queries
normalized for cosine; the corpus norms fold in per chunk), and
``2 q.c - |c|^2`` for EUCLIDEAN. The reference restores distances as
``sqrt(|q|^2 - (2 q.c - |c|^2))``, which cancels in fp32 where a row lies
close to the query (a self match scores ~3e-3 at |q|^2 ~ 30, 0.25 at a
row offset by 100 per coordinate). On f32 rows the port selects in the same
form and then sums each returned row's distance from the differences,
``|q - c|^2``, and orders the ``k`` by it (:func:`_euclidean_by_differences`):
the set of ids is the same, the values are exact to fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from velesdb_tpu_torch.ops.distance import DistanceMetric, normalize
from velesdb_tpu_torch.ops.quantization import SQ8Vectors, sq8_dequantize

__all__ = ["streamed_topk", "sq8_streamed_topk", "STREAM_CHUNK"]

STREAM_CHUNK = 65536  # corpus rows per step ([B, C] f32 scores = 64MB @ B=256)


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target`` and a multiple of 1024,
    or 0 when none exists (then the caller pads the corpus)."""
    best = 0
    c = 1024
    cap = min(n, target)
    while c <= cap:
        if n % c == 0:
            best = c
        c += 1024
    return best


def streamed_topk(
    queries,
    corpus: torch.Tensor,
    valid: torch.Tensor | None = None,
    k: int = 10,
    metric: DistanceMetric = DistanceMetric.COSINE,
    chunk: int = STREAM_CHUNK,
    corpus_sqnorm: torch.Tensor | None = None,
):
    """Exact top-k of ``queries [B, D]`` over ``corpus [N, D]`` (f32, f16 or
    bf16 rows).

    Returns ``(values [B, k] f32, ids [B, k] int64)`` best-first in the
    metric's native orientation, with id ``-1`` (and ``-inf``/``+inf``
    values) for slots that no valid row fills. ``k`` is clamped to ``N``.
    On a half corpus the queries are cast to its dtype, as the reference
    does (``:82-83``), and each chunk is upcast to fp32 for its matmul on
    its own: the products of two half values are exact in fp32 and the sums
    stay fp32, and the whole corpus is never copied.
    """
    metric = DistanceMetric.parse(metric)
    dev = corpus.device
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=dev))
    n = corpus.shape[0]
    k = min(k, n)
    if n % chunk:
        chunk = _pick_chunk(n, chunk) or min(chunk, n)
    v = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid.bool()
    v = F.pad(v[:n], (0, n - min(v.shape[0], n)))

    qq = torch.sum(q * q, dim=1)
    if metric is DistanceMetric.COSINE:
        q = normalize(q)
    if corpus.dtype != torch.float32:
        q = q.to(corpus.dtype).float()
    b = q.shape[0]
    run_v = torch.full((b, k), -torch.inf, device=dev)
    run_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        rows = corpus[c0:c1].float()
        dots = q @ rows.T  # [B, C]
        if corpus_sqnorm is None:
            cc = torch.sum(rows * rows, dim=1)
        else:
            cc = corpus_sqnorm[c0:c1].float()
        if metric is DistanceMetric.DOT_PRODUCT:
            s = dots
        elif metric is DistanceMetric.COSINE:
            inv = torch.where(cc > 1e-30, torch.rsqrt(cc.clamp_min(1e-30)), 0.0)
            s = dots * inv[None, :]
        else:  # EUCLIDEAN: maximize 2 q.c - |c|^2 == |q|^2 - d^2
            s = 2.0 * dots - cc[None, :]
        s = torch.where(v[None, c0:c1], s, -torch.inf)
        cv, ci = torch.topk(s, min(k, c1 - c0), dim=1)
        run_v, pos = torch.topk(torch.cat([run_v, cv], dim=1), k, dim=1)
        run_i = torch.gather(torch.cat([run_i, ci + c0], dim=1), 1, pos)

    if metric is DistanceMetric.EUCLIDEAN and corpus.dtype == torch.float32:
        return _euclidean_by_differences(q, corpus, run_v, run_i)
    return _finish(run_v, run_i, qq, metric)


def _euclidean_by_differences(q, corpus, run_v, run_i):
    """Distances of the selected rows summed from the differences, in query
    slices of about 2^26 gathered elements, then a stable sort of the ``k``
    (ties stay in selection order); empty slots keep +inf and id -1."""
    b, k = run_i.shape
    step = max(1, (1 << 26) // max(k * corpus.shape[1], 1))
    d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    for r0 in range(0, b, step):
        rows = corpus[run_i[r0 : r0 + step].clamp_min(0)].float()  # [b', k, D]
        d[r0 : r0 + step] = torch.sqrt(torch.sum((rows - q[r0 : r0 + step, None, :]) ** 2, dim=-1))
    d = torch.where(run_v == -torch.inf, torch.inf, d)
    d, order = torch.sort(d, dim=1, stable=True)
    return d, torch.where(d == torch.inf, -1, torch.gather(run_i, 1, order))


def _finish(run_v, run_i, qq, metric):
    empty = run_v == -torch.inf
    ids = torch.where(empty, -1, run_i)
    if metric is DistanceMetric.EUCLIDEAN:
        d2 = (qq[:, None] - run_v).clamp_min(0.0)
        return torch.where(empty, torch.inf, torch.sqrt(d2)), ids
    return run_v, ids


def sq8_streamed_topk(queries, sq: SQ8Vectors, cnorm=None, valid=None, k: int = 10,
                      metric: DistanceMetric = DistanceMetric.COSINE,
                      chunk: int = STREAM_CHUNK):
    """Exact top-k over an SQ8 corpus without a dequantized copy: per chunk
    one fp32 matmul on the raw codes plus the rank-1 affine correction
    ``q . deq(c) = scale * (q . codes) + minv * sum(q)``, then the metric
    fixup, ``torch.topk`` and the merge. ``cnorm``: euclidean -> squared
    dequantized norms, cosine -> dequantized norms, dot -> unused. Same
    output contract as :func:`streamed_topk`.

    As in the reference (``:156-171``), the code product takes the
    (normalized) queries rounded to bf16, while ``sum(q)`` comes from the
    unrounded ones. The product stays an fp32 matmul: a bf16 value times a
    code <= 255 is exact in fp32. The reference selects with
    ``approx_max_k``; the port selects exactly (its ``approx=False``)."""
    metric = DistanceMetric.parse(metric)
    codes = sq.codes
    dev = codes.device
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=dev))
    n = codes.shape[0]
    k = min(k, n)
    scale, minv = sq.scale.float(), sq.minv.float()
    if cnorm is None:
        sqn = torch.sum(sq8_dequantize(sq) ** 2, dim=1)
        cnorm = torch.sqrt(sqn) if metric is DistanceMetric.COSINE else sqn
    v = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid.bool()
    qq = torch.sum(q * q, dim=1)
    if metric is DistanceMetric.COSINE:
        q = normalize(q)
    qsum = torch.sum(q, dim=1, keepdim=True)
    qb = q.to(torch.bfloat16).float()
    b = q.shape[0]
    run_v = torch.full((b, k), -torch.inf, device=dev)
    run_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        dots = (qb @ codes[c0:c1].float().T) * scale[None, c0:c1] + qsum * minv[None, c0:c1]
        cc = cnorm[c0:c1].float()
        if metric is DistanceMetric.DOT_PRODUCT:
            s = dots
        elif metric is DistanceMetric.COSINE:
            s = dots * torch.where(cc > 1e-30, 1.0 / cc.clamp_min(1e-30), 0.0)[None, :]
        else:  # EUCLIDEAN: maximize 2 q.c - |c|^2
            s = 2.0 * dots - cc[None, :]
        s = torch.where(v[None, c0:c1], s, -torch.inf)
        cv, ci = torch.topk(s, min(k, c1 - c0), dim=1)
        run_v, pos = torch.topk(torch.cat([run_v, cv], dim=1), k, dim=1)
        run_i = torch.gather(torch.cat([run_i, ci + c0], dim=1), 1, pos)
    return _finish(run_v, run_i, qq, metric)
