"""Weighted reciprocal-rank fusion of two ranked lists, in plain PyTorch.

Frozen to the program's semantics: a row at 0-based rank ``r`` of a list of
weight ``w`` adds ``w / (RRF_K + 1 + r)``; a row in both lists adds both;
the fused list is ordered by score descending, ties to the lower row.
Empty places (row ``-1``) add nothing. Every term and sum is taken in
``dtype`` (float64 for the reference, bfloat16 for the control).
"""

from __future__ import annotations

import torch

__all__ = ["RRF_K", "fuse"]

RRF_K = 60.0


def fuse(vec_rows, txt_rows, k, vector_weight=0.5, rrf_k=RRF_K, dtype=torch.float64):
    """``(scores [B, k] float64, rows [B, k] int64)`` of the fused top ``k``
    of each query from the ranked ``vec_rows [B, Fv]`` and ``txt_rows [B,
    Ft]`` (row ``-1`` = empty); short lists pad with 0 / -1."""
    dev = vec_rows.device
    terms = []
    for rows, w in ((vec_rows, vector_weight), (txt_rows, 1.0 - vector_weight)):
        r = torch.arange(rows.shape[1], device=dev, dtype=torch.float64)
        t = (torch.tensor(w, dtype=dtype, device=dev) / (rrf_k + 1.0 + r).to(dtype))
        terms.append(torch.where(rows >= 0, t[None, :].expand(rows.shape), 0))
    cand = torch.cat([vec_rows, txt_rows], 1).long()
    contrib = torch.cat(terms, 1).to(dtype)
    valid = cand >= 0
    same = (cand[:, :, None] == cand[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    # at most one place a list, so a row sums at most two terms
    total = torch.where(same, contrib[:, None, :], torch.zeros((), dtype=dtype, device=dev))
    total = total.to(torch.float64).sum(2).to(dtype).to(torch.float64)
    f = cand.shape[1]
    first = ~(same & torch.tril(torch.ones(f, f, dtype=torch.bool, device=dev), -1)[None]).any(2)
    keep = valid & first
    total = torch.where(keep, total, -1.0)
    # (score descending, row ascending): sort by row, then stably by score
    big = torch.iinfo(torch.int64).max
    by_row = torch.argsort(torch.where(keep, cand, big), dim=1, stable=True)
    s1 = torch.gather(total, 1, by_row)
    by_score = torch.argsort(-s1, dim=1, stable=True)
    order = torch.gather(by_row, 1, by_score)[:, :k]
    vals = torch.gather(total, 1, order)
    rows = torch.where(vals > 0, torch.gather(cand, 1, order), -1)
    vals = vals.clamp_min(0.0)
    if rows.shape[1] < k:
        pad = k - rows.shape[1]
        vals = torch.cat([vals, vals.new_zeros(vals.shape[0], pad)], 1)
        rows = torch.cat([rows, rows.new_full((rows.shape[0], pad), -1)], 1)
    return vals, rows
