"""Multi-list result fusion: RRF / Average / Maximum / Weighted.

Parity with the reference's ``FusionStrategy::fuse`` (``fusion/strategy.rs:138``)
and the hybrid-search RRF (k=60) of ``collection/search/text.rs:113-221``.
These operate on small ``[(id, score)]`` lists already reduced from device
top-k — tiny host-side math, no device round trip.
"""

from __future__ import annotations

import enum
from collections import defaultdict
from typing import Sequence

__all__ = ["FusionStrategy", "rrf_fuse", "weighted_rrf"]

RRF_K = 60  # reference default (text.rs hybrid_search)


class FusionStrategy(str, enum.Enum):
    """Strategies of ``fusion/strategy.rs``."""

    AVERAGE = "average"
    MAXIMUM = "maximum"
    RRF = "rrf"
    WEIGHTED_AVERAGE = "weighted_average"
    WEIGHTED_MAXIMUM = "weighted_maximum"
    WEIGHTED_HIT = "weighted_hit"

    @classmethod
    def parse(cls, v) -> "FusionStrategy":
        if isinstance(v, cls):
            return v
        key = str(v).strip().lower()
        aliases = {
            "avg": cls.AVERAGE,
            "average": cls.AVERAGE,
            "max": cls.MAXIMUM,
            "maximum": cls.MAXIMUM,
            "rrf": cls.RRF,
            "weighted_average": cls.WEIGHTED_AVERAGE,
            "weighted_avg": cls.WEIGHTED_AVERAGE,
            "weighted_maximum": cls.WEIGHTED_MAXIMUM,
            "weighted_max": cls.WEIGHTED_MAXIMUM,
            "weighted_hit": cls.WEIGHTED_HIT,
        }
        if key not in aliases:
            raise ValueError(f"unknown fusion strategy: {v!r}")
        return aliases[key]

    def fuse(
        self,
        lists: Sequence[Sequence[tuple[int, float]]],
        k: int,
        weights: Sequence[float] | None = None,
        rrf_k: int = RRF_K,
    ) -> list[tuple[int, float]]:
        """Fuse per-source ranked ``(id, score)`` lists into one top-k.

        ``weights`` applies to the WEIGHTED_* strategies (defaults to uniform).
        """
        if weights is None:
            weights = [1.0] * len(lists)
        if len(weights) != len(lists):
            raise ValueError("weights/lists length mismatch")
        if self is FusionStrategy.RRF:
            return rrf_fuse(lists, k, rrf_k=rrf_k)

        acc: dict[int, list[float]] = defaultdict(list)
        wacc: dict[int, list[float]] = defaultdict(list)
        for lst, w in zip(lists, weights):
            seen = set()
            for vid, score in lst:
                if vid in seen:
                    continue
                seen.add(vid)
                acc[vid].append(score)
                wacc[vid].append(w)
        out: list[tuple[int, float]] = []
        for vid, scores in acc.items():
            ws = wacc[vid]
            if self is FusionStrategy.AVERAGE:
                fused = sum(scores) / len(lists)
            elif self is FusionStrategy.MAXIMUM:
                fused = max(scores)
            elif self is FusionStrategy.WEIGHTED_AVERAGE:
                tw = sum(weights)
                fused = sum(s * w for s, w in zip(scores, ws)) / tw if tw else 0.0
            elif self is FusionStrategy.WEIGHTED_MAXIMUM:
                fused = max(s * w for s, w in zip(scores, ws))
            elif self is FusionStrategy.WEIGHTED_HIT:
                # reward multi-source hits: weighted sum of hit indicators
                fused = sum(ws)
            else:  # pragma: no cover
                raise ValueError(self)
            out.append((vid, fused))
        out.sort(key=lambda t: (-t[1], t[0]))
        return out[:k]


def rrf_fuse(
    lists: Sequence[Sequence[tuple[int, float]]], k: int, rrf_k: int = RRF_K
) -> list[tuple[int, float]]:
    """Reciprocal-rank fusion: ``sum 1/(rrf_k + rank)`` per id."""
    acc: dict[int, float] = defaultdict(float)
    for lst in lists:
        seen = set()
        for rank, (vid, _score) in enumerate(lst):
            if vid in seen:
                continue
            seen.add(vid)
            acc[vid] += 1.0 / (rrf_k + rank + 1)
    out = sorted(acc.items(), key=lambda t: (-t[1], t[0]))
    return out[:k]


def weighted_rrf(
    vector_list: Sequence[tuple[int, float]],
    text_list: Sequence[tuple[int, float]],
    k: int,
    vector_weight: float = 0.5,
    rrf_k: int = RRF_K,
) -> list[tuple[int, float]]:
    """Hybrid-search fusion with a vector/text weight split
    (``hybrid_search``, ``search/text.rs:113-221``)."""
    acc: dict[int, float] = defaultdict(float)
    for rank, (vid, _s) in enumerate(vector_list):
        acc[vid] += vector_weight / (rrf_k + rank + 1)
    for rank, (vid, _s) in enumerate(text_list):
        acc[vid] += (1.0 - vector_weight) / (rrf_k + rank + 1)
    out = sorted(acc.items(), key=lambda t: (-t[1], t[0]))
    return out[:k]
