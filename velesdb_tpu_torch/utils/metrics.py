"""Latency percentiles for the storage layer.

``LatencyStats`` is copied from ``velesdb_tpu/utils/metrics.py``
(``metrics.rs:326-438`` analog); the IR metrics and Prometheus exposition
there are not needed by this slice.
"""

from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["LatencyStats"]


# -- latency stats (metrics.rs:326-438) ------------------------------------------


class LatencyStats:
    """Sliding sample of latencies with percentile computation."""

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._samples: list[float] = []
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0

    def record(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            if len(self._samples) >= self.capacity:
                self._samples[self.count % self.capacity] = seconds
            else:
                self._samples.append(seconds)

    def percentiles(self, qs=(50, 90, 95, 99)) -> dict[str, float]:
        with self._lock:
            if not self._samples:
                return {f"p{q}": 0.0 for q in qs}
            arr = np.asarray(self._samples)
            return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def timer(self):
        return _Timer(self)


class _Timer:
    def __init__(self, stats: LatencyStats):
        self.stats = stats

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stats.record(time.perf_counter() - self.t0)
