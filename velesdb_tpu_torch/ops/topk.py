"""Masked batched top-k and merge primitives.

Counterpart of ``velesdb_tpu/ops/topk.py``. Results come best-first in the
metric's native orientation; an empty slot (a masked or missing entry) is
id ``-1`` with value ``-inf`` (similarity) or ``+inf`` (distance). Scores,
masks and ids may be tensors or host arrays, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from velesdb_tpu_torch.ops.distance import as_tensor

__all__ = ["top_k", "merge_top_k", "mask_scores", "pad_mask", "DENSE_ELEMS"]

# A dense [queries, slots] score matrix and its int64 select keys are built
# for this many elements at a time; a larger batch runs in query slices (the
# BM25 scores at b 256 x 2^20 slots would take 1 GiB, their keys 2 GiB).
DENSE_ELEMS = 1 << 26


def pad_mask(mask, n_pad: int, device):
    """A host or device bool mask as a ``[n_pad]`` bool tensor on ``device``
    (zero-padded or cut), or ``None``."""
    if mask is None:
        return None
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.asarray(mask, bool))
    mask = mask.to(device, torch.bool)[:n_pad]
    if mask.shape[0] < n_pad:
        mask = torch.cat([mask, mask.new_zeros(n_pad - mask.shape[0])])
    return mask


def mask_scores(scores: torch.Tensor, mask, higher_is_better: bool) -> torch.Tensor:
    """Set masked-out entries (``mask`` False) to the worst possible score."""
    scores = as_tensor(scores)
    if mask is None:
        return scores
    worst = -torch.inf if higher_is_better else torch.inf
    return torch.where(as_tensor(mask).to(scores.device, torch.bool), scores, worst)


def top_k(scores: torch.Tensor, k: int, higher_is_better: bool = True, mask=None):
    """Top-k over the last axis. Returns ``(values, int64 indices)``."""
    scores = mask_scores(scores, mask, higher_is_better)
    vals, idx = torch.topk(scores, k, dim=-1, largest=higher_is_better, sorted=True)
    worst = -torch.inf if higher_is_better else torch.inf
    return vals, torch.where(vals == worst, -1, idx)


def merge_top_k(values: torch.Tensor, indices: torch.Tensor, k: int,
                higher_is_better: bool = True):
    """Merge candidate lists ``[..., S, K']`` (or ``[..., M]``) into one top-k."""
    values, indices = as_tensor(values), as_tensor(indices)
    if values.ndim > 2:
        values = values.reshape(*values.shape[:-2], -1)
        indices = indices.reshape(*indices.shape[:-2], -1)
    vals, pos = top_k(values, k, higher_is_better=higher_is_better)
    ids = torch.gather(indices, -1, pos.clamp_min(0))
    return vals, torch.where(pos < 0, -1, ids)
