"""Chunked exact top-k: score the corpus in blocks with a running top-k.

Counterpart of ``velesdb_tpu/ops/chunked.py``: ``_self_knn_device`` (``:30``),
``self_knn`` (``:84``), ``chunked_topk`` (``:118``) and ``brute_force_topk``
(``:179``), the exact kNN-graph builder of the graph index below 65,536 rows
and the recall oracle of its tests. The reference scans ``lax.scan`` over
padded chunks; here a Python loop runs over the real rows (padded rows are
invalid there, so they never enter a top-k), one fp32 matmul per block; the
scores are ``pairwise_scores``'s, formed in place.

Every select sends equal scores to the smallest position, as ``lax.top_k``
does (:func:`~velesdb_tpu_torch.ops.bucket_kernel.first_topk`): the running
merge puts earlier chunks first, so ties go to the lowest row on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from velesdb_tpu_torch.ops.bucket_kernel import first_topk
from velesdb_tpu_torch.ops.distance import DistanceMetric, normalize

__all__ = ["chunked_topk", "brute_force_topk", "self_knn"]


def _best(s: torch.Tensor, k: int, higher_is_better: bool):
    """:func:`first_topk` in the metric's orientation: the top-``k`` of
    ``s [B, M]``, ties to the smallest position, ``(values, int64
    positions)``."""
    if higher_is_better:
        return first_topk(s, k)
    v, pos = first_topk(-s, k)
    return -v, pos


def _prepare(corpus: torch.Tensor, metric):
    """The corpus side of :func:`_scores`: rows normalized for cosine, and
    their squared norms for euclidean."""
    x = corpus.float()
    if metric is DistanceMetric.COSINE:
        return normalize(x), None
    if metric is DistanceMetric.EUCLIDEAN:
        return x, torch.sum(x * x, dim=-1)
    return x, None


def _scores(q, qq, blk, bcc, metric):
    """``pairwise_scores`` of prepared operands (queries normalized for
    cosine, ``qq`` / ``bcc`` squared norms for euclidean), with the
    euclidean ``sqrt(max(|q|^2 + |c|^2 - 2 q.c, 0))`` formed in place."""
    if metric is DistanceMetric.EUCLIDEAN:
        return torch.addmm(qq + bcc[None, :], q, blk.T, alpha=-2.0).clamp_min_(0.0).sqrt_()
    return q @ blk.T


def _scan(queries, corpus, valid, k, metric, chunk, self_base=None, prepared=None):
    """Running top-``k`` of ``queries [B, D]`` over ``corpus [N, D]`` in
    blocks of ``chunk`` rows; invalid rows (and, with ``self_base``, row
    ``self_base + i`` for query ``i``) score the worst value. ``prepared``
    is :func:`_prepare` of ``corpus``, when the caller holds it."""
    hib = metric.higher_is_better
    worst = -torch.inf if hib else torch.inf
    b, dev = queries.shape[0], queries.device
    x, cc = prepared if prepared is not None else _prepare(corpus, metric)
    q, qq = _prepare(queries, metric)
    if qq is not None:
        qq = qq[:, None]
    run_v = torch.full((b, k), worst, dtype=torch.float32, device=dev)
    run_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    for c0 in range(0, x.shape[0], chunk):
        c1 = min(c0 + chunk, x.shape[0])
        scores = _scores(q, qq, x[c0:c1], None if cc is None else cc[c0:c1], metric)
        ok = valid[None, c0:c1]
        if self_base is not None:
            ok = ok & (torch.arange(c0, c1, device=dev)[None, :] != rows + self_base)
        scores = scores.masked_fill_(~ok, worst)
        vals, idx = _best(scores, min(k, c1 - c0), hib)
        run_v, pos = _best(torch.cat([run_v, vals], dim=1), k, hib)
        run_i = torch.gather(torch.cat([run_i, idx + c0], dim=1), 1, pos)
    return run_v, run_i


def _self_knn_device(corpus, valid, *, k, metric, q_block, chunk):
    """Exact self-kNN graph (self-edges excluded) ``[N, k] int64``, -1 where
    fewer than ``k`` valid rows exist: query blocks of the corpus against the
    whole corpus, a running top-k over chunks."""
    out = []
    prepared = _prepare(corpus, metric)
    for q0 in range(0, corpus.shape[0], q_block):
        vals, idx = _scan(corpus[q0 : q0 + q_block], corpus, valid, k, metric, chunk,
                          self_base=q0, prepared=prepared)
        worst = -torch.inf if metric.higher_is_better else torch.inf
        out.append(torch.where(vals == worst, -1, idx))
    return torch.cat(out)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def self_knn(corpus, k: int, metric: DistanceMetric, valid=None, q_block: int = 1024,
             c_chunk: int = 16384, device="cuda") -> np.ndarray:
    """kNN graph of a corpus against itself: ``[N, k] int32`` (-1 = none).
    ``corpus`` is a tensor (scored on its device) or a numpy array (moved to
    ``device``)."""
    metric = DistanceMetric.parse(metric)
    x = _as_tensor(corpus, device)
    n = x.shape[0]
    v = torch.ones(n, dtype=torch.bool) if valid is None else torch.tensor(
        np.asarray(valid, bool))
    idx = _self_knn_device(x, v.to(x.device), k=k, metric=metric, q_block=q_block,
                           chunk=c_chunk)
    return idx.cpu().numpy().astype(np.int32)


def chunked_topk(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor, k: int,
                 metric: DistanceMetric, chunk: int = 65536,
                 exclude_self_base: int | None = None):
    """Exact top-k of ``queries [B, D]`` against ``corpus [N, D]`` (tensors on
    one device), best first: ``(values [B, k] f32, indices [B, k] int64)`` in
    the metric's native orientation. Rows with ``valid`` False score the
    worst value; with ``exclude_self_base``, query ``i`` also excludes row
    ``exclude_self_base + i``. Where fewer than ``k`` rows qualify, the
    trailing entries carry the worst value (their index is meaningless)."""
    metric = DistanceMetric.parse(metric)
    return _scan(queries.float(), corpus, valid, k, metric, chunk, self_base=exclude_self_base)


def brute_force_topk(queries, corpus, k: int, metric: DistanceMetric, valid=None,
                     q_block: int = 1024, c_chunk: int = 65536, exclude_self: bool = False,
                     return_device: bool = False, device="cuda"):
    """Exact top-k for arbitrary sizes, numpy in and out (tensors on
    ``device`` with ``return_device``): query blocks of ``q_block`` through
    :func:`chunked_topk`. The recall oracle of the graph tests."""
    metric = DistanceMetric.parse(metric)
    q = np.atleast_2d(np.asarray(queries, np.float32))
    x = _as_tensor(corpus, device)
    n = x.shape[0]
    v = torch.ones(n, dtype=torch.bool) if valid is None else torch.tensor(
        np.asarray(valid, bool))
    v = v.to(x.device)
    qt = torch.from_numpy(q).to(x.device)
    outs = [chunked_topk(qt[s : s + q_block], x, v, k, metric, chunk=c_chunk,
                         exclude_self_base=s if exclude_self else None)
            for s in range(0, q.shape[0], q_block)]
    vals = torch.cat([o[0] for o in outs])
    idx = torch.cat([o[1] for o in outs])
    if return_device:
        return vals, idx
    return vals.cpu().numpy(), idx.cpu().numpy()
