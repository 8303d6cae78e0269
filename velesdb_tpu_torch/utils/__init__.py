"""Utilities: config system, metrics/observability (the exports of
``velesdb_tpu/utils/__init__.py``); tracing, guardrails and the serving
micro-batcher are imported from their modules."""

from velesdb_tpu_torch.utils.config import ConfigError, VelesConfig
from velesdb_tpu_torch.utils.metrics import (
    LatencyStats,
    OperationalMetrics,
    average_precision,
    hit_rate,
    mean_average_precision,
    mrr,
    ndcg_at_k,
    precision_at_k,
    recall_at_k,
)

__all__ = [
    "VelesConfig",
    "ConfigError",
    "LatencyStats",
    "OperationalMetrics",
    "recall_at_k",
    "precision_at_k",
    "mrr",
    "ndcg_at_k",
    "average_precision",
    "mean_average_precision",
    "hit_rate",
]
