"""IR quality metrics + operational metrics with Prometheus exposition.

A copy of ``velesdb_tpu/utils/metrics.py`` (host code; the port imports
nothing of the reference): recall@k / precision@k / MRR / NDCG / MAP /
hit-rate (``metrics.rs:46-324``), latency percentiles (``LatencyStats``,
``metrics.rs:326-438``, which the storage layer records) and
``OperationalMetrics`` with Prometheus text exposition (``metrics.rs:439,537``)
served at the REST server's ``/metrics``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict

import numpy as np

__all__ = [
    "recall_at_k",
    "precision_at_k",
    "mrr",
    "ndcg_at_k",
    "average_precision",
    "mean_average_precision",
    "hit_rate",
    "LatencyStats",
    "OperationalMetrics",
]


# -- IR quality metrics (metrics.rs:46-324) -----------------------------------


def recall_at_k(retrieved, relevant, k: int) -> float:
    """|top-k ∩ relevant| / |relevant|."""
    if not relevant:
        return 0.0
    top = list(retrieved)[:k]
    return len(set(top) & set(relevant)) / len(set(relevant))


def precision_at_k(retrieved, relevant, k: int) -> float:
    if k <= 0:
        return 0.0
    top = list(retrieved)[:k]
    if not top:
        return 0.0
    return len(set(top) & set(relevant)) / k


def mrr(retrieved, relevant) -> float:
    """Reciprocal rank of the first relevant hit."""
    rel = set(relevant)
    for rank, r in enumerate(retrieved, 1):
        if r in rel:
            return 1.0 / rank
    return 0.0


def ndcg_at_k(retrieved, relevant, k: int) -> float:
    """Binary-relevance NDCG@k."""
    rel = set(relevant)
    dcg = sum(
        1.0 / math.log2(rank + 1)
        for rank, r in enumerate(list(retrieved)[:k], 1)
        if r in rel
    )
    ideal = sum(1.0 / math.log2(rank + 1) for rank in range(1, min(len(rel), k) + 1))
    return dcg / ideal if ideal > 0 else 0.0


def average_precision(retrieved, relevant) -> float:
    rel = set(relevant)
    if not rel:
        return 0.0
    hits, total = 0, 0.0
    for rank, r in enumerate(retrieved, 1):
        if r in rel:
            hits += 1
            total += hits / rank
    return total / len(rel)


def mean_average_precision(retrieved_lists, relevant_lists) -> float:
    pairs = list(zip(retrieved_lists, relevant_lists))
    if not pairs:
        return 0.0
    return sum(average_precision(r, g) for r, g in pairs) / len(pairs)


def hit_rate(retrieved_lists, relevant_lists, k: int) -> float:
    pairs = list(zip(retrieved_lists, relevant_lists))
    if not pairs:
        return 0.0
    hits = sum(
        1 for r, g in pairs if set(list(r)[:k]) & set(g)
    )
    return hits / len(pairs)


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


# -- operational metrics + Prometheus (metrics.rs:439,537) --------------------------


class OperationalMetrics:
    """Counters + latency histograms with Prometheus text exposition."""

    def __init__(self, namespace: str = "velesdb"):
        self.namespace = namespace
        self._counters: dict[tuple, float] = defaultdict(float)
        self._latencies: dict[str, LatencyStats] = {}
        self._gauges: dict[tuple, float] = {}
        self._lock = threading.Lock()
        self.started_at = time.time()

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._counters[(name, _label_key(labels))] += value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[(name, _label_key(labels))] = value

    def latency(self, name: str) -> LatencyStats:
        with self._lock:
            if name not in self._latencies:
                self._latencies[name] = LatencyStats()
            return self._latencies[name]

    def prometheus_text(self) -> str:
        ns = self.namespace
        lines = [
            f"# HELP {ns}_uptime_seconds Process uptime",
            f"# TYPE {ns}_uptime_seconds gauge",
            f"{ns}_uptime_seconds {time.time() - self.started_at:.3f}",
        ]
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                metric = f"{ns}_{name}"
                lines.append(f"# TYPE {metric} counter")
                lines.append(f"{metric}{_fmt_labels(labels)} {v:g}")
            for (name, labels), v in sorted(self._gauges.items()):
                metric = f"{ns}_{name}"
                lines.append(f"# TYPE {metric} gauge")
                lines.append(f"{metric}{_fmt_labels(labels)} {v:g}")
            for name, stats in sorted(self._latencies.items()):
                metric = f"{ns}_{name}_seconds"
                lines.append(f"# TYPE {metric} summary")
                for q, val in stats.percentiles().items():
                    lines.append(
                        f'{metric}{{quantile="0.{q[1:]}"}} {val:.6f}'
                    )
                lines.append(f"{metric}_count {stats.count}")
                lines.append(f"{metric}_sum {stats.total:.6f}")
        return "\n".join(lines) + "\n"


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _fmt_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"
