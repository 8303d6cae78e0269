"""The comparison that decides ``correct`` fails what it must, on the CPU
at a small size: the control (the plain reference in bfloat16 put in the
program's place), and whole runs whose timed path is broken underneath:
state left unchanged, half of the batch left out, an answer altered where
it is produced. (A cell on one chip has no exchange between chips to
leave out.)"""

import time

import numpy as np
import pytest

from perfbench import control, harness, judge
from perfbench.tests.test_perfbench_harness import ALL_CELLS, small_spec, two_threads  # noqa: F401
from velesdb_tpu_torch.collection import Collection


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_the_control_is_not_correct(cell, two_threads):  # noqa: F811
    spec = small_spec(cell, rows=20_000, queries=256)
    numbers = control.control_numbers(spec, 2**31 + 7, "cpu")
    correct, checks = judge.verdict(numbers, spec.limits)
    assert not correct, checks
    failed = {name for name, _, _, ok in checks if not ok}
    assert failed & {"miss", "score_err", "text_score_err"}, checks


def _stale(orig):
    first = []

    def op(self, *a, **kw):
        out = orig(self, *a, **kw)
        if not first:
            first.append(out)
        return first[0]
    return op


def _half(orig):
    def op(self, *a, **kw):
        out = orig(self, *a, **kw)
        h = len(out) // 2
        return out[:h] + out[:h] + out[2 * h:]
    return op


def _altered(orig):
    def op(self, *a, **kw):
        out = orig(self, *a, **kw)
        hit = out[0][0]
        n = self.vectors.used_slots
        base = 10**9
        hit["id"] = base + (hit["id"] - base + n // 2) % n
        return out
    return op


@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=["stale", "half", "altered"])
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch, tmp_path, two_threads):  # noqa: F811
    spec = small_spec(cell)
    name = spec.traffic["op"]
    monkeypatch.setattr(Collection, name, fault(getattr(Collection, name)))
    run, numbers, dev, _ = harness.run_cell(spec, 2**31 + 5, 0.3, False, time.perf_counter(),
                                            device="cpu", workdir=str(tmp_path),
                                            log=lambda m: None)
    out = harness.result_line(spec, run, numbers, dev, False)
    assert not out["correct"], out["checks"]


def test_the_altered_answer_is_found_by_a_number_that_sees_one_hit():
    spec = small_spec("sift1m-exact-b256")
    assert spec.limits["score_err"] < 1e-3
    hyb = small_spec("hybrid-1m-b256")
    assert hyb.limits["stray"] == 0 and np.isfinite(hyb.limits["text_score_err"])
