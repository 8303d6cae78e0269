"""Exact packed-Hamming top-k (kernel #9).

Counterpart of ``hamming_topk`` in ``velesdb_tpu/ops/pallas_kernels.py``
(``:410``, ``_hamming_topk_entry`` ``:366``): the BINARY serve core at small
N or large k, where one winner per bucket would lose results. The TPU kernel
carries a running top-k across its sequential grid (k max-extraction passes
per chunk). Hopper blocks run in no order, so the hand-written CUDA kernel
``csrc/hamming_topk.cu`` is a different design with the same result: one
block per query builds a histogram of the integer distances, finds the
threshold distance, and collects the rows under it in row order. Ties go to
the smallest row index, the first-occurrence rule of the reference's
``_merge_topk`` (``:98-101``), so ids equal the reference's exactly.
:func:`hamming_topk_ref` is its plain version (a stable sort).
"""

from __future__ import annotations

import torch

from velesdb_tpu_torch.ops.bucket_kernel import (
    _IIJ,
    _P,
    _kernel_route,
    _launch,
    hamming_distances,
)

__all__ = ["LAUNCHES", "hamming_topk", "hamming_topk_ref"]

# Kernel launches, counted where the CUDA kernel is launched and nowhere else.
LAUNCHES = {"hamming_topk": 0}

_MAX_WORDS = 256  # 32 * 256 + 1 histogram bins in shared memory


def _check(q, packed, valid, k):
    if q.dtype != torch.int32 or packed.dtype != torch.int32:
        raise TypeError("packed queries and corpus must be int32 words")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if q.ndim != 2 or packed.ndim != 2 or q.shape[1] != packed.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, corpus {tuple(packed.shape)}")
    if valid.shape != (packed.shape[0],):
        raise ValueError(f"valid of shape {tuple(valid.shape)} for N={packed.shape[0]}")
    if q.shape[1] > _MAX_WORDS:
        raise ValueError(f"W={q.shape[1]} words above {_MAX_WORDS}")
    if not 1 <= k <= packed.shape[0]:
        raise ValueError(f"k={k} must be in [1, N={packed.shape[0]}]")


def hamming_topk_ref(q, packed, valid, k: int):
    """Plain torch version: a stable ascending sort of the exact distances
    with invalid rows at +inf. Returns ``(dist [B, k] f32, ids [B, k] int64)``
    with +inf / -1 empties."""
    d = hamming_distances(q, packed).float()
    d = torch.where(valid[None, :], d, torch.inf)
    dist, idx = torch.sort(d, dim=1, stable=True)
    dist, idx = dist[:, :k], idx[:, :k]
    return dist, torch.where(dist == torch.inf, -1, idx)


def hamming_topk(packed_q, packed_corpus, valid=None, k: int = 10):
    """The exact ``k`` smallest Hamming distances per query over the packed
    corpus (``int32`` words from :func:`~velesdb_tpu_torch.ops.quantization.
    binary_quantize`), skipping rows where ``valid`` is False. ``k`` is
    clamped to N. CUDA tensors launch ``csrc/hamming_topk.cu``; CPU tensors
    take :func:`hamming_topk_ref`."""
    n = packed_corpus.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=packed_corpus.device)
    k = min(k, n)
    _check(packed_q, packed_corpus, valid, k)
    if _kernel_route(packed_q, packed_corpus, valid):
        return hamming_topk_ref(packed_q, packed_corpus, valid, k)
    b, w = packed_q.shape
    dev = packed_q.device
    dist = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int64, device=dev)
    scratch = torch.empty((b, k), dtype=torch.int64, device=dev)
    _launch(LAUNCHES, "hamming_topk", "hamming_topk", "hamming_topk_launch", _P * 6 + _IIJ,
            packed_q, packed_corpus, valid, dist, idx, scratch, b, n, w, k)
    return dist, idx
