"""Exact top-k under L2 and cosine, with a filter mask, in plain PyTorch.

The yardstick of every vector answer: float64 by default, run in blocks of
rows and queries on whatever device holds the data. ``dtype=torch.bfloat16``
gives the control, the same search computed one precision below the
configuration's float32.

Scores follow the program's public orientation: euclidean scores are L2
distances (ascending), cosine scores are similarities (descending).
"""

from __future__ import annotations

import torch

__all__ = ["topk", "scores_of", "normalize"]


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm (zero rows stay zero)."""
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-300 if x.dtype == torch.float64 else 1e-30)


def _prep(queries, corpus, metric, dtype):
    q = queries.to(dtype)
    c = corpus.to(dtype)
    if metric == "cosine":
        q, c = normalize(q), normalize(c)
    elif metric != "euclidean":
        raise ValueError(f"unsupported metric {metric!r}")
    return q, c


def _block_scores(q, c, metric):
    """Higher-is-better scores of a block: -squared distance or similarity,
    computed entirely in ``q``'s dtype."""
    dots = q @ c.T
    if metric == "euclidean":
        return 2.0 * dots - (q * q).sum(1, keepdim=True) - (c * c).sum(1)[None, :]
    return dots


def topk(queries, corpus, metric, k, mask=None, dtype=torch.float64,
         row_block=131072, query_block=2048):
    """``(scores [B, k] float64, rows [B, k] int64)`` of the best ``k`` rows
    of ``corpus`` for each query; rows outside ``mask`` never appear (their
    place is ``-1`` with a NaN score when fewer than ``k`` rows pass)."""
    n = corpus.shape[0]
    vals_out, idx_out = [], []
    for q0 in range(0, queries.shape[0], query_block):
        qb = queries[q0 : q0 + query_block]
        best_v = best_i = None
        for c0 in range(0, n, row_block):
            q, c = _prep(qb, corpus[c0 : c0 + row_block], metric, dtype)
            s = _block_scores(q, c, metric).to(torch.float64)
            if mask is not None:
                s = torch.where(mask[None, c0 : c0 + row_block], s, -torch.inf)
            kk = min(k, s.shape[1])
            v, i = torch.topk(s, kk, dim=1)
            i = i + c0
            if best_v is not None:
                v, pos = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + kk), dim=1)
                i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
            best_v, best_i = v, i
        vals_out.append(best_v)
        idx_out.append(best_i)
    vals, idx = torch.cat(vals_out), torch.cat(idx_out)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), -torch.inf)], 1)
        idx = torch.cat([idx, idx.new_full((idx.shape[0], pad), -1)], 1)
    empty = torch.isinf(vals)
    idx = torch.where(empty, -1, idx)
    return _public(vals, metric, empty), idx


def _public(s, metric, empty):
    if metric == "euclidean":
        s = torch.sqrt((-s).clamp_min(0.0))
    return torch.where(empty, torch.nan, s)


def scores_of(queries, corpus, metric, q_idx, rows, block=262144):
    """float64 public-orientation scores of the pairs ``(queries[q_idx[j]],
    corpus[rows[j]])``: L2 distances from the coordinate differences,
    cosine similarities of the normalized rows."""
    out = []
    for j0 in range(0, q_idx.shape[0], block):
        q = queries[q_idx[j0 : j0 + block]].to(torch.float64)
        c = corpus[rows[j0 : j0 + block]].to(torch.float64)
        if metric == "euclidean":
            out.append(((q - c) ** 2).sum(1).sqrt())
        elif metric == "cosine":
            out.append((normalize(q) * normalize(c)).sum(1))
        else:
            raise ValueError(f"unsupported metric {metric!r}")
    if not out:
        return torch.zeros(0, dtype=torch.float64, device=queries.device)
    return torch.cat(out)
