"""Weighted RRF fusion of two top lists, on the lists' device.

Counterpart of ``velesdb_tpu/ops/fused_rrf.py``: both branches of a hybrid
query stay where they were computed, and one small program computes

    fused(slot) = w / (rrf_k + rank_vec + 1) + (1 - w) / (rrf_k + rank_txt + 1)

then the top k, so the hybrid batch reads back only ``[B, k]`` pairs.

Duplicates resolve over the concatenated window (F = 2 fetch, 40 at k 10): a
``[B, F, F]`` equality mask sums each slot's contributions, in a fixed
pairwise order so that the card and the CPU round alike, and the
earlier-occurrence mask zeroes the repeats, independent of the corpus size.
The final order is (fused descending, slot ascending), the host fusion's
``(-score, id)`` rule, through one unique int64 key a candidate.
"""

from __future__ import annotations

import torch

__all__ = ["rrf_fuse_topk", "RRF_K"]

RRF_K = 60.0  # reference default (text.rs hybrid_search)


def rrf_fuse_topk(v_vals, v_idx, t_vals, t_idx, w_vec, w_txt=None, rrf_k=None, *, k):
    """Fuse vector and text branch top lists into a weighted-RRF top-k.

    ``v_vals/v_idx [B, Fv]``: vector branch scores and slots in rank order,
    slot ``-1`` or a non-finite score = empty. ``t_vals/t_idx [B, Ft]``: BM25
    branch, slot ``-1`` or score ``<= 0`` = empty. ``w_vec``/``w_txt``: branch
    weights, taken as f32 (``w_txt`` defaults to ``1 - w_vec`` in f32);
    ``rrf_k`` defaults to the reference's 60. Everything is f32, with the
    reference's ``w / (rrf_k + 1 + rank)`` terms. Returns ``(fused [B, k]
    f32, slots [B, k] int64)``, empty slots ``-1``, equal scores to the
    smaller slot. A slot may repeat within a list: every contribution
    counts, added in a fixed order, so both devices give the same bits."""
    dev = v_idx.device
    f32 = torch.float32
    w_vec = torch.as_tensor(w_vec, dtype=f32, device=dev)
    w_txt = (1.0 - w_vec) if w_txt is None else torch.as_tensor(w_txt, dtype=f32, device=dev)
    rk = torch.as_tensor(RRF_K if rrf_k is None else rrf_k, dtype=f32, device=dev) + 1.0
    fv, ft = v_idx.shape[1], t_idx.shape[1]
    rv = w_vec / (rk + torch.arange(fv, dtype=f32, device=dev))[None, :]
    rv = torch.where((v_idx >= 0) & torch.isfinite(v_vals), rv, 0.0)
    rt = w_txt / (rk + torch.arange(ft, dtype=f32, device=dev))[None, :]
    rt = torch.where((t_idx >= 0) & (t_vals > 0.0), rt, 0.0)

    ids = torch.cat([v_idx.long(), t_idx.long()], dim=1)  # [B, F]
    contrib = torch.cat([rv, rt], dim=1)  # [B, F]
    valid = contrib > 0.0
    ids = torch.where(valid, ids, -1)

    # each candidate's total = the contributions at positions holding the
    # same slot, summed in a fixed pairwise tree over positions (a library
    # reduction adds three or more of them in an order that differs between
    # the card and the CPU); only the first occurrence keeps it
    eq = (ids[:, :, None] == ids[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    tot = _tree_sum(torch.where(eq, contrib[:, None, :], 0.0))
    f = ids.shape[1]
    earlier = torch.tril(torch.ones((f, f), dtype=torch.bool, device=dev), diagonal=-1)
    dup = (eq & earlier[None]).any(dim=2)
    fused = torch.where(valid & ~dup, tot, 0.0)

    # (fused descending, slot ascending) as one key: fused >= 0, so its f32
    # bits order as int32; empties carry the largest slot
    sort_ids = torch.where(fused > 0.0, ids, 0x7FFFFFFF)
    key = (fused.view(torch.int32).long() << 32) | (0x7FFFFFFF - sort_ids)
    kk = min(k, f)
    pos = torch.topk(key, kk, dim=1).indices
    vals = torch.gather(fused, 1, pos)
    out = torch.where(vals > 0.0, torch.gather(sort_ids, 1, pos), -1)
    if kk < k:
        vals = torch.cat([vals, vals.new_zeros(vals.shape[0], k - kk)], 1)
        out = torch.cat([out, out.new_full((out.shape[0], k - kk), -1)], 1)
    return vals, out


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension as a fixed binary tree of elementwise
    adds (zero-padded to a power of two): the same bits on every device."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]
