"""Masked batched top-k and merge primitives.

Counterpart of ``velesdb_tpu/ops/topk.py``. Results come best-first in the
metric's native orientation; an empty slot (a masked or missing entry) is
id ``-1`` with value ``-inf`` (similarity) or ``+inf`` (distance).
"""

from __future__ import annotations

import torch

__all__ = ["top_k", "merge_top_k", "mask_scores"]


def mask_scores(scores: torch.Tensor, mask, higher_is_better: bool) -> torch.Tensor:
    """Set masked-out entries (``mask`` False) to the worst possible score."""
    if mask is None:
        return scores
    worst = -torch.inf if higher_is_better else torch.inf
    return torch.where(mask, scores, worst)


def top_k(scores: torch.Tensor, k: int, higher_is_better: bool = True, mask=None):
    """Top-k over the last axis. Returns ``(values, int64 indices)``."""
    scores = mask_scores(scores, mask, higher_is_better)
    vals, idx = torch.topk(scores, k, dim=-1, largest=higher_is_better, sorted=True)
    worst = -torch.inf if higher_is_better else torch.inf
    return vals, torch.where(vals == worst, -1, idx)


def merge_top_k(values: torch.Tensor, indices: torch.Tensor, k: int,
                higher_is_better: bool = True):
    """Merge candidate lists ``[..., S, K']`` (or ``[..., M]``) into one top-k."""
    if values.ndim > 2:
        values = values.reshape(*values.shape[:-2], -1)
        indices = indices.reshape(*indices.shape[:-2], -1)
    vals, pos = top_k(values, k, higher_is_better=higher_is_better)
    ids = torch.gather(indices, -1, pos.clamp_min(0))
    return vals, torch.where(pos < 0, -1, ids)
