"""Quality profiles of a search.

Counterpart of ``SearchQuality`` in ``velesdb_tpu/index/params.py``
(``index/mod.rs:7-12``). The profile's ``ef`` sets the IVF engine's probe
count (``IvfIndex.nprobe_for``), and its ``min_recall`` is the bar that the
planner's honesty gate holds an unpinned IVF engine to and that the storage
recall gate of a quantized collection widens its rerank oversample to clear.
"""

from __future__ import annotations

import enum

__all__ = ["SearchQuality"]


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
