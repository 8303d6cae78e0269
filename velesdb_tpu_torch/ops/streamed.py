"""Streamed exact top-k: a chunked matmul, a per-chunk top-k and an exact merge.

Counterpart of ``velesdb_tpu/ops/streamed.py`` (``streamed_topk`` ->
``_streamed_entry``, ``approx=False``). The reference runs this in plain XLA
outside any Pallas kernel, so here it is plain torch: per corpus chunk one
fp32 ``matmul`` of the whole query batch, a metric fixup, ``torch.topk``,
and an exact merge into the running ``[B, k]`` result. The ``[B, N]`` score
matrix is never materialized beyond one chunk.

Scoring is maximize-oriented: dot products for DOT/COSINE (queries
normalized for cosine; the corpus norms fold in per chunk), and
``2 q.c - |c|^2`` for EUCLIDEAN, restored to distances at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from velesdb_tpu_torch.ops.distance import DistanceMetric, normalize

__all__ = ["streamed_topk", "STREAM_CHUNK"]

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
    """Exact top-k of ``queries [B, D]`` over ``corpus [N, D]``.

    Returns ``(values [B, k] f32, ids [B, k] int64)`` best-first in the
    metric's native orientation, with id ``-1`` (and ``-inf``/``+inf``
    values) for slots that no valid row fills. ``k`` is clamped to ``N``.
    """
    metric = DistanceMetric.parse(metric)
    dev = corpus.device
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=dev))
    n = corpus.shape[0]
    k = min(k, n)
    if n % chunk:
        chunk = _pick_chunk(n, chunk) or min(chunk, n)
    n_pad = -(-n // chunk) * chunk
    c = corpus.float()
    if corpus_sqnorm is None:
        cn = torch.sum(c * c, dim=1)
    else:
        cn = corpus_sqnorm.float()
    v = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid.bool()
    if n_pad != n:
        c = F.pad(c, (0, 0, 0, n_pad - n))
        cn = F.pad(cn, (0, n_pad - cn.shape[0]))
    v = F.pad(v[:n_pad], (0, n_pad - min(v.shape[0], n_pad)))

    qq = torch.sum(q * q, dim=1)
    if metric is DistanceMetric.COSINE:
        q = normalize(q)
    b = q.shape[0]
    run_v = torch.full((b, k), -torch.inf, device=dev)
    run_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    kc = min(k, chunk)
    for c0 in range(0, n_pad, chunk):
        dots = q @ c[c0 : c0 + chunk].T  # [B, C]
        cc = cn[c0 : c0 + chunk]
        if metric is DistanceMetric.DOT_PRODUCT:
            s = dots
        elif metric is DistanceMetric.COSINE:
            inv = torch.where(cc > 1e-30, torch.rsqrt(cc.clamp_min(1e-30)), 0.0)
            s = dots * inv[None, :]
        else:  # EUCLIDEAN: maximize 2 q.c - |c|^2 == |q|^2 - d^2
            s = 2.0 * dots - cc[None, :]
        s = torch.where(v[None, c0 : c0 + chunk], s, -torch.inf)
        cv, ci = torch.topk(s, kc, dim=1)
        mv, pos = torch.topk(torch.cat([run_v, cv], dim=1), k, dim=1)
        run_i = torch.gather(torch.cat([run_i, ci + c0], dim=1), 1, pos)
        run_v = mv

    empty = run_v == -torch.inf
    ids = torch.where(empty, -1, run_i)
    if metric is DistanceMetric.EUCLIDEAN:
        d2 = (qq[:, None] - run_v).clamp_min(0.0)
        return torch.where(empty, torch.inf, torch.sqrt(d2)), ids
    return run_v, ids
