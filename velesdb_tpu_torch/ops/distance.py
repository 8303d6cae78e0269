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

The public functions take tensors or anything numpy reads (arrays, lists),
as the reference's do; a result lies on the input's device, on the CPU for
host input. :func:`host_set_scores` is the numpy form of the set metrics
that the host rerank and the storage gate's oracle use.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

__all__ = [
    "DistanceMetric",
    "SET_METRICS",
    "pairwise_scores",
    "pairwise_hamming_packed",
    "score_one",
    "normalize",
    "binarize",
    "set_scores",
    "host_set_scores",
    "host_bits",
    "host_bit_scores",
    "hamming_distances",
    "as_tensor",
]


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

    def sort_results(self, results):
        """Sort ``[(id, score), ...]`` best-first (``distance.rs:95``)."""
        return sorted(results, key=lambda t: t[1], reverse=self.higher_is_better)

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


# the metrics scored on ``v > 0.5`` set membership
SET_METRICS = (DistanceMetric.HAMMING, DistanceMetric.JACCARD)


def as_tensor(x, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is (cast to ``dtype`` if given),
    host input (numpy, lists) on the CPU. uint32 words, which torch does not
    hold, keep their bits as int32."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        a = np.ascontiguousarray(a)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x if dtype is None else x.to(dtype)


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-30) -> torch.Tensor:
    """L2-normalize, mapping zero vectors to zero (not NaN)."""
    x = as_tensor(x)
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    inv = torch.where(sq > eps, torch.rsqrt(sq.clamp_min(eps)), 0.0)
    return x * inv


def pairwise_scores(
    queries: torch.Tensor, corpus: torch.Tensor, metric: DistanceMetric
) -> torch.Tensor:
    """Batched scores ``[B, N]`` between ``queries [B, D]`` and ``corpus [N, D]``
    in the metric's native orientation (fp32 matmuls)."""
    metric = DistanceMetric.parse(metric)
    q = as_tensor(queries).float()
    c = as_tensor(corpus).float()
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


def pairwise_hamming_packed(queries, corpus) -> torch.Tensor:
    """Exact Hamming distances ``[B, N]`` int32 between packed words
    (``[B, W]`` against ``[N, W]``, int32 or the reference's uint32), by XOR
    and popcount (reference ``pairwise_hamming_packed``)."""
    return hamming_distances(as_tensor(queries, torch.int32), as_tensor(corpus, torch.int32))


def score_one(a, b, metric) -> float:
    """Single-pair score, parity with ``DistanceMetric::calculate``."""
    a = as_tensor(a, torch.float32).reshape(1, -1)
    b = as_tensor(b, torch.float32).reshape(1, -1)
    return float(pairwise_scores(a, b, DistanceMetric.parse(metric))[0, 0])


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of 32-bit values held in int64 ``[0, 2^32)`` (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distances(q: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Exact ``[B, N]`` int32 Hamming distances between packed int32 words,
    in row blocks that keep each int64 intermediate near 2^24 elements."""
    b, w = q.shape
    n = packed.shape[0]
    out = torch.empty((b, n), dtype=torch.int32, device=q.device)
    step = max(1, (1 << 24) // max(b, 1))
    q64 = q.to(torch.int64)
    for r0 in range(0, n, step):
        c = packed[r0 : r0 + step].to(torch.int64)
        acc = torch.zeros((b, c.shape[0]), dtype=torch.int64, device=q.device)
        for i in range(w):
            acc += _popcount32((q64[:, i, None] ^ c[None, :, i]) & 0xFFFFFFFF)
        out[:, r0 : r0 + c.shape[0]] = acc.to(torch.int32)
    return out


def pairwise_scores_np(queries: np.ndarray, corpus: np.ndarray, metric: DistanceMetric,
                       device) -> np.ndarray:
    """:func:`pairwise_scores` of host rows, computed on ``device`` and read
    back once as a ``[B, N]`` f32 array."""
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(device)
    c = torch.from_numpy(np.ascontiguousarray(corpus, np.float32)).to(device)
    return pairwise_scores(q, c, metric).cpu().numpy()


def binarize(x: torch.Tensor) -> torch.Tensor:
    """The 0/1 f32 rows of the set metrics: ``v > 0.5`` is membership."""
    return (as_tensor(x).float() > 0.5).float()


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


def host_set_scores(q: np.ndarray, vecs: np.ndarray, metric: DistanceMetric) -> np.ndarray:
    """Hamming distances or Jaccard similarities ``[B, N]`` f32 of host rows
    ``q [B, D]`` against ``vecs [N, D]``, in numpy: ``v > 0.5`` membership,
    ``|a| + |b| - 2 a.b``, and ``inter / union`` with two empty sets scoring
    1 (reference ``ops/distance.py:130-140``). Counts and products are
    integers below 2^24, so every value equals the reference's f32 one."""
    cb = host_bits(vecs)
    return host_bit_scores(host_bits(q), cb, cb.sum(axis=1, dtype=np.float32), metric)


def host_bits(x: np.ndarray) -> np.ndarray:
    """The 0/1 f32 rows of the set metrics, in numpy (``v > 0.5``)."""
    return (np.atleast_2d(x) > 0.5).astype(np.float32)


def host_bit_scores(qa: np.ndarray, cb: np.ndarray, nb: np.ndarray,
                    metric: DistanceMetric) -> np.ndarray:
    """:func:`host_set_scores` of 0/1 rows ``qa [B, D]`` against 0/1 rows
    ``cb [N, D]`` with their counts ``nb [N]`` (:func:`host_bits`)."""
    inter = qa @ cb.T
    na = qa.sum(axis=1, dtype=np.float32)[:, None]
    if metric is DistanceMetric.HAMMING:
        return na + nb[None, :] - np.float32(2.0) * inter
    union = na + nb[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(union > 0, inter / np.maximum(union, np.float32(1.0e-9)),
                        np.float32(1.0)).astype(np.float32)
