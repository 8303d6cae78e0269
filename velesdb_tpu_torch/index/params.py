"""Quality profiles of a search, and the graph index's parameters.

Counterpart of ``velesdb_tpu/index/params.py`` (``index/mod.rs:7-12``,
``index/hnsw/params.rs``). The profile's ``ef`` sets the IVF engine's probe
count (``IvfIndex.nprobe_for``) and the graph's beam (``GraphParams.beam_for_ef``),
and its ``min_recall`` is the bar that the planner's honesty gate holds an
unpinned ANN engine to and that the storage recall gate of a quantized
collection widens its rerank oversample to clear.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = ["SearchQuality", "GraphParams"]


class SearchQuality(str, enum.Enum):
    FAST = "fast"
    BALANCED = "balanced"
    ACCURATE = "accurate"
    PERFECT = "perfect"  # exact, with the host f32 rerank on any storage

    @property
    def ef(self) -> int:
        return {
            SearchQuality.FAST: 64,
            SearchQuality.BALANCED: 128,
            SearchQuality.ACCURATE: 256,
            SearchQuality.PERFECT: 2048,
        }[self]

    @property
    def min_recall(self) -> float:
        """Recall bar the profile promises."""
        return {
            SearchQuality.FAST: 0.88,
            SearchQuality.BALANCED: 0.95,
            SearchQuality.ACCURATE: 0.97,
            SearchQuality.PERFECT: 1.0,
        }[self]

    @classmethod
    def parse(cls, v) -> "SearchQuality":
        return v if isinstance(v, cls) else cls(str(v).strip().lower())


@dataclasses.dataclass(frozen=True)
class GraphParams:
    """Build and search parameters of the beam-search graph index
    (reference ``params.py:52``; the measurements behind each default are
    the reference's, written beside its fields).

    ``degree`` is the adjacency row width (HNSW's M0), ``knn_k`` the forward
    kNN width before the alpha prune and the reverse-edge fill."""

    degree: int = 32  # adjacency row width
    knn_k: int = 16  # forward kNN edges per node
    alpha: float = 1.2  # VAMANA diversification factor of the prune
    entry_points: int = 16  # per-query beam seeds from the entry stage
    entry_probes: int = 2  # partitions scanned for the beam's entries
    seed_sample: int = 2048  # routing-set size of the dense seed scan
    quantized_traversal: bool = False  # score beam gathers on an SQ8 shadow
    traversal_rerank: bool = True  # False drops the f32 corpus (capacity mode)
    restarts: int = 1  # independent beams per query, merged with dedup
    expand_width: int = 4  # beam candidates expanded per step
    build_nprobe: int = 8  # partitions probed per row in the approximate kNN build
    build_passes: int = 1  # decorrelated IVF clusterings unioned in the build
    refine_rounds: int = 0  # NN-descent rounds on the approximate kNN

    @classmethod
    def auto(cls, dim: int, n: int | None = None) -> "GraphParams":
        """The reference's size ladder (``params.py:100``): larger corpora get
        wider graphs and a wider entry scan; past 100K rows the beam expands
        16 candidates a step."""
        n = n or 0
        nprobe = 8
        entry_probes, entry_points = 2, 16
        if n >= 1_000_000:
            degree, knn_k = 64, 32
            nprobe = 32
            entry_probes = 64 if dim <= 256 else 16
            entry_points = 96
        elif n >= 100_000:
            degree, knn_k = 48, 24
            entry_probes, entry_points = 16, 96
        else:
            degree, knn_k = 32, 16
        if dim >= 1024:
            degree = max(degree, 48)
        ew = 16 if n >= 100_000 else cls.expand_width
        return cls(degree=degree, knn_k=knn_k, build_nprobe=nprobe, build_passes=1,
                   entry_probes=entry_probes, entry_points=entry_points, expand_width=ew)

    def beam_for_ef(self, ef: int, k: int) -> tuple[int, int]:
        """``(beam width, expansions)`` of an ef budget: both ef rounded up to
        a multiple of 8, within [32, 512] and [8, 512]."""
        ef = max(ef, k)
        beam = max(32, min(512, _round8(ef)))
        expansions = max(8, min(512, _round8(ef)))
        return beam, expansions


def _round8(x: int) -> int:
    return ((x + 7) // 8) * 8
