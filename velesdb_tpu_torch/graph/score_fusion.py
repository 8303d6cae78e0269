"""Multi-component score fusion with explainable breakdowns.

Counterpart of ``collection/search/query/score_fusion.rs:46-441`` (779 LoC):
a result's final score decomposes into vector similarity, graph proximity,
path quality, and boosts; per-strategy combination; ``explain()`` renders
the contribution of each component.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ScoreBreakdown", "combine", "COMBINE_STRATEGIES"]


@dataclasses.dataclass
class ScoreBreakdown:
    """Component scores, each already normalized to [0, 1]-ish ranges."""

    vector: float | None = None  # similarity score
    graph: float | None = None  # graph proximity (1/(1+depth))
    path: float | None = None  # path quality (e.g. edge-weight product)
    boosts: dict = dataclasses.field(default_factory=dict)  # name -> additive

    def components(self) -> dict:
        out = {}
        if self.vector is not None:
            out["vector"] = self.vector
        if self.graph is not None:
            out["graph"] = self.graph
        if self.path is not None:
            out["path"] = self.path
        return out

    def combined(self, strategy: str = "weighted", weights: dict | None = None) -> float:
        return combine(self, strategy, weights)

    def explain(self, strategy: str = "weighted", weights: dict | None = None) -> str:
        """Human-readable contribution trace (``score_fusion.rs`` explain)."""
        comps = self.components()
        weights = weights or {}
        parts = [
            f"{name}={value:.4f}(w={weights.get(name, 1.0):g})"
            for name, value in comps.items()
        ]
        parts += [f"boost[{k}]=+{v:.4f}" for k, v in self.boosts.items()]
        total = self.combined(strategy, weights)
        return f"{strategy}: " + " + ".join(parts) + f" => {total:.4f}"


def _weighted(comps: dict, weights: dict) -> float:
    if not comps:
        return 0.0
    tw = sum(weights.get(k, 1.0) for k in comps)
    if tw <= 0:
        return 0.0
    return sum(v * weights.get(k, 1.0) for k, v in comps.items()) / tw


COMBINE_STRATEGIES = {
    "weighted": _weighted,
    "average": lambda comps, _w: (sum(comps.values()) / len(comps)) if comps else 0.0,
    "maximum": lambda comps, _w: max(comps.values(), default=0.0),
    "minimum": lambda comps, _w: min(comps.values(), default=0.0),
    "product": lambda comps, _w: __import__("math").prod(comps.values()) if comps else 0.0,
}


def combine(breakdown: ScoreBreakdown, strategy: str = "weighted",
            weights: dict | None = None) -> float:
    """Combine components per strategy, then apply additive boosts."""
    fn = COMBINE_STRATEGIES.get(strategy)
    if fn is None:
        raise ValueError(
            f"unknown combine strategy {strategy!r}; "
            f"have {sorted(COMBINE_STRATEGIES)}"
        )
    base = fn(breakdown.components(), weights or {})
    return base + sum(breakdown.boosts.values())
