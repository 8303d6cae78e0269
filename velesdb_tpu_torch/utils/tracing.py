"""Structured tracing: hierarchical spans with env-filtered levels.

A copy of ``velesdb_tpu/utils/tracing.py``. Counterpart of the reference's ``tracing`` + ``tracing-subscriber`` with
env-filter (``Cargo.toml:46-47``): nested spans carry timing and fields,
emit through stdlib logging, and aggregate per-span-name latency stats that
feed the operational metrics. Enable with ``VELESDB_TRACE=debug`` (or
``info``/``off``) or programmatically via :func:`set_level`.
"""

from __future__ import annotations

import contextvars
import logging
import os
import time
from contextlib import contextmanager

from velesdb_tpu_torch.utils.metrics import LatencyStats

__all__ = ["span", "set_level", "get_logger", "span_stats", "trace_event"]

_logger = logging.getLogger("velesdb")
_LEVELS = {"off": logging.CRITICAL + 10, "error": logging.ERROR,
           "warning": logging.WARNING, "info": logging.INFO,
           "debug": logging.DEBUG}
_current: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "velesdb_span", default=()
)
_stats: dict[str, LatencyStats] = {}


def set_level(level: str) -> None:
    _logger.setLevel(_LEVELS.get(level.lower(), logging.INFO))


set_level(os.environ.get("VELESDB_TRACE", "warning"))


def get_logger() -> logging.Logger:
    return _logger


def span_stats(name: str) -> LatencyStats:
    if name not in _stats:
        _stats[name] = LatencyStats()
    return _stats[name]


@contextmanager
def span(name: str, **fields):
    """Timed hierarchical span; logs enter/exit at DEBUG, records latency."""
    parent = _current.get()
    path = (*parent, name)
    token = _current.set(path)
    full = "/".join(path)
    if _logger.isEnabledFor(logging.DEBUG):
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        _logger.debug("-> %s %s", full, kv)
    t0 = time.perf_counter()
    try:
        yield path
    except Exception as e:
        _logger.error("!! %s failed after %.3fms: %s",
                      full, (time.perf_counter() - t0) * 1e3, e)
        raise
    finally:
        dt = time.perf_counter() - t0
        span_stats(name).record(dt)
        if _logger.isEnabledFor(logging.DEBUG):
            _logger.debug("<- %s %.3fms", full, dt * 1e3)
        _current.reset(token)


def trace_event(message: str, *args, level: str = "info") -> None:
    path = "/".join(_current.get()) or "-"
    _logger.log(_LEVELS.get(level, logging.INFO), "[%s] " + message, path, *args)
