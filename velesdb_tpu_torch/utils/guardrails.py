"""Runtime failure containment: timeouts, rate limiting, circuit breaking.

Counterpart of the reference's ``guardrails.rs:37,279,343``: query timeout,
depth/cardinality limits (those live in ``graph/traverse.py``), a per-client
token-bucket rate limiter, and a circuit breaker that sheds load after
consecutive failures. Used by the REST server; importable by any caller.
A copy of ``velesdb_tpu/utils/guardrails.py``.
"""

from __future__ import annotations

import threading
import time

__all__ = ["RateLimiter", "CircuitBreaker", "Deadline", "GuardrailExceeded"]


class GuardrailExceeded(RuntimeError):
    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class Deadline:
    """Cooperative query timeout: hot loops call ``check()`` between stages."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self.t0 = time.monotonic()

    @property
    def remaining(self) -> float:
        return self.timeout_s - (time.monotonic() - self.t0)

    def check(self, what: str = "query") -> None:
        if self.remaining <= 0:
            raise GuardrailExceeded(f"{what} exceeded {self.timeout_s:.1f}s timeout")


class RateLimiter:
    """Per-key token bucket (``guardrails.rs`` per-client rate limiter)."""

    def __init__(self, rate_per_s: float = 100.0, burst: float | None = None):
        self.rate = rate_per_s
        self.burst = burst if burst is not None else rate_per_s
        self._buckets: dict[str, tuple[float, float]] = {}  # key -> (tokens, ts)
        self._lock = threading.Lock()

    def try_acquire(self, key: str = "global", cost: float = 1.0) -> bool:
        now = time.monotonic()
        with self._lock:
            tokens, ts = self._buckets.get(key, (self.burst, now))
            tokens = min(self.burst, tokens + (now - ts) * self.rate)
            if tokens < cost:
                self._buckets[key] = (tokens, now)
                return False
            self._buckets[key] = (tokens - cost, now)
            return True

    def acquire(self, key: str = "global", cost: float = 1.0) -> None:
        if not self.try_acquire(key, cost):
            retry = cost / self.rate
            raise GuardrailExceeded(
                f"rate limit exceeded for {key!r}", retry_after_s=retry
            )


class CircuitBreaker:
    """Open after N consecutive failures; half-open probe after cooldown."""

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 10.0):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._failures = 0
        self._opened_at: float | None = None
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                return "half-open"
            return "open"

    def allow(self) -> bool:
        return self.state != "open"

    def record(self, success: bool) -> None:
        with self._lock:
            if success:
                self._failures = 0
                self._opened_at = None
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = time.monotonic()

    def guard(self):
        """Context manager: raises when open, records outcome."""
        return _BreakerGuard(self)


class _BreakerGuard:
    def __init__(self, breaker: CircuitBreaker):
        self.breaker = breaker

    def __enter__(self):
        if not self.breaker.allow():
            raise GuardrailExceeded(
                "circuit open: shedding load",
                retry_after_s=self.breaker.cooldown_s,
            )
        return self

    def __exit__(self, exc_type, exc, tb):
        self.breaker.record(exc_type is None)
        return False
