"""Guardrail tests against the port: rate limiter, circuit breaker,
deadline, server 429/503.

``tests/test_guardrails.py`` case for case, by name, on
``velesdb_tpu_torch`` (the server's database on the CPU); every HTTP call
carries a timeout and the server is shut down and closed in teardown.
"""

import threading
import time
import urllib.error
import urllib.request

import pytest

from velesdb_tpu_torch.utils.guardrails import (
    CircuitBreaker,
    Deadline,
    GuardrailExceeded,
    RateLimiter,
)

TIMEOUT = 60


def test_rate_limiter_token_bucket():
    rl = RateLimiter(rate_per_s=1000.0, burst=3)
    assert all(rl.try_acquire("a") for _ in range(3))
    assert not rl.try_acquire("a")  # burst exhausted
    assert rl.try_acquire("b")  # other keys unaffected
    time.sleep(0.01)  # ~10 tokens refill
    assert rl.try_acquire("a")
    with pytest.raises(GuardrailExceeded) as e:
        rl2 = RateLimiter(rate_per_s=0.5, burst=1)
        rl2.acquire("x")
        rl2.acquire("x")
    assert e.value.retry_after_s == pytest.approx(2.0)


def test_circuit_breaker_states():
    cb = CircuitBreaker(failure_threshold=2, cooldown_s=0.05)
    assert cb.state == "closed"
    for _ in range(2):
        with pytest.raises(RuntimeError):
            with cb.guard():
                raise RuntimeError("backend down")
    assert cb.state == "open"
    with pytest.raises(GuardrailExceeded):
        with cb.guard():
            pass
    time.sleep(0.06)
    assert cb.state == "half-open"
    with cb.guard():
        pass  # successful probe closes it
    assert cb.state == "closed"


def test_deadline():
    d = Deadline(0.02)
    d.check()
    time.sleep(0.03)
    with pytest.raises(GuardrailExceeded, match="timeout"):
        d.check()


def test_server_rate_limit_and_breaker(tmp_db_dir):
    from velesdb_tpu_torch.server.app import make_server
    from velesdb_tpu_torch.utils.config import VelesConfig

    cfg = VelesConfig()
    cfg.limits.rate_per_s = 5.0
    httpd = make_server(tmp_db_dir, host="127.0.0.1", port=0, config=cfg, device="cpu")
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        codes = []
        for _ in range(10):
            try:
                with urllib.request.urlopen(base + "/collections", timeout=TIMEOUT) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        assert 429 in codes and 200 in codes
        # health bypasses the limiter
        with urllib.request.urlopen(base + "/health", timeout=TIMEOUT) as r:
            assert r.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.app.db.close()
        serving.join(timeout=TIMEOUT)
