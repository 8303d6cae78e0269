"""Distance metrics as batched tensor ops.

Counterpart of ``velesdb_tpu/ops/distance.py``: every metric is a batched
``[B, D] x [N, D] -> [B, N]`` score computation built on one matmul, with the
same semantics and sort orders as the reference package:

- ``cosine`` returns cosine *similarity*; ``dot_product`` the inner product;
  ``euclidean`` the L2 distance.
- ``hamming`` counts positions where ``(a > 0.5) != (b > 0.5)``; ``jaccard``
  treats ``v > 0.5`` as set membership, with J(empty, empty) = 1.0.
- cosine/dot/jaccard sort descending, euclidean/hamming ascending
  (:attr:`DistanceMetric.higher_is_better`).
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

__all__ = ["DistanceMetric", "pairwise_scores", "normalize", "binarize", "set_scores"]


class DistanceMetric(str, enum.Enum):
    """The five metrics of the reference (``distance.rs:16``)."""

    COSINE = "cosine"
    EUCLIDEAN = "euclidean"
    DOT_PRODUCT = "dot_product"
    HAMMING = "hamming"
    JACCARD = "jaccard"

    @property
    def higher_is_better(self) -> bool:
        return self in (
            DistanceMetric.COSINE,
            DistanceMetric.DOT_PRODUCT,
            DistanceMetric.JACCARD,
        )

    @property
    def worst_score(self) -> float:
        """Score assigned to masked-out / padded entries."""
        return -math.inf if self.higher_is_better else math.inf

    @classmethod
    def parse(cls, name) -> "DistanceMetric":
        if isinstance(name, cls):
            return name
        key = str(name).strip().lower()
        aliases = {
            "cosine": cls.COSINE,
            "euclidean": cls.EUCLIDEAN,
            "l2": cls.EUCLIDEAN,
            "dot": cls.DOT_PRODUCT,
            "dot_product": cls.DOT_PRODUCT,
            "dotproduct": cls.DOT_PRODUCT,
            "ip": cls.DOT_PRODUCT,
            "hamming": cls.HAMMING,
            "jaccard": cls.JACCARD,
        }
        if key not in aliases:
            raise ValueError(f"unknown distance metric: {name!r}")
        return aliases[key]


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-30) -> torch.Tensor:
    """L2-normalize, mapping zero vectors to zero (not NaN)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    inv = torch.where(sq > eps, torch.rsqrt(sq.clamp_min(eps)), 0.0)
    return x * inv


def pairwise_scores(
    queries: torch.Tensor, corpus: torch.Tensor, metric: DistanceMetric
) -> torch.Tensor:
    """Batched scores ``[B, N]`` between ``queries [B, D]`` and ``corpus [N, D]``
    in the metric's native orientation (fp32 matmuls)."""
    metric = DistanceMetric.parse(metric)
    q = queries.float()
    c = corpus.float()
    if metric is DistanceMetric.DOT_PRODUCT:
        return q @ c.T
    if metric is DistanceMetric.COSINE:
        return normalize(q) @ normalize(c).T
    if metric is DistanceMetric.EUCLIDEAN:
        qq = torch.sum(q * q, dim=-1, keepdim=True)
        cc = torch.sum(c * c, dim=-1)
        d2 = qq + cc[None, :] - 2.0 * (q @ c.T)
        return torch.sqrt(d2.clamp_min(0.0))
    cb = binarize(c)
    return set_scores(q, cb, torch.sum(cb, dim=-1), metric)


def pairwise_scores_np(queries: np.ndarray, corpus: np.ndarray, metric: DistanceMetric,
                       device) -> np.ndarray:
    """:func:`pairwise_scores` of host rows, computed on ``device`` and read
    back once as a ``[B, N]`` f32 array."""
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(device)
    c = torch.from_numpy(np.ascontiguousarray(corpus, np.float32)).to(device)
    return pairwise_scores(q, c, metric).cpu().numpy()


def binarize(x: torch.Tensor) -> torch.Tensor:
    """The 0/1 f32 rows of the set metrics: ``v > 0.5`` is membership."""
    return (x.float() > 0.5).float()


def set_scores(queries: torch.Tensor, cb: torch.Tensor, nb: torch.Tensor,
               metric: DistanceMetric) -> torch.Tensor:
    """Hamming distances or Jaccard similarities ``[B, N]`` of ``queries``
    against binarized rows ``cb [N, D]`` (:func:`binarize`) with their
    counts ``nb [N]``. Every count and product is an integer below 2^24, so
    the f32 values are exact on every device."""
    qa = binarize(queries)
    na = torch.sum(qa, dim=-1, keepdim=True)
    inter = qa @ cb.T
    if metric is DistanceMetric.HAMMING:
        return na + nb[None, :] - 2.0 * inter
    union = na + nb[None, :] - inter
    return torch.where(union > 0.0, inter / union.clamp_min(1.0e-9), 1.0)
