"""One cell on the card, through the harness's own entry, at a short
window; then no module of JAX or of the JAX package may be loaded in this
process. Skips where there is no CUDA device:

    python -m pytest perfbench/tests/test_perfbench_card.py -q
"""

import json
import time

import pytest
import torch

from perfbench import harness

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda")


def test_sift1m_exact_b256_runs_correct_on_the_card(cuda, capsys):
    t0 = time.perf_counter()
    rc = harness.main(["--workload", "sift1m-exact-b256", "--seed", str(2**31 + 321),
                       "--seconds", "2", "--trace", "0"], t0)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    res = json.loads(out[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert res["device"]["memory_peak_bytes"] > 0
    assert set(res["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert harness.forbidden_modules() == []
