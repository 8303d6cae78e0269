"""The port's examples (``velesdb_tpu_torch/examples``) on the CPU, each run as
``python -m velesdb_tpu_torch.examples.<name> --device cpu`` beside the
reference script of ``examples/`` (``JAX_PLATFORMS=cpu``), both in a child
process with the same ``PYTHONHASHSEED`` (the examples embed text with
``hash``). Their result lines must be equal. Timing lines are left out, and
so are the wall-clock stamps of agent memories (``created_at``,
``last_access``); other numbers must agree within 1e-5, which covers a
memory's recency factor (a 7-day half-life: ~1e-6 a second between its
write and its recall). ``sharded_scale`` runs in a gloo world of 2 against
the reference's 8-device CPU mesh; its mesh and closing lines name the
layout and are left out.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from velesdb_tpu_torch.tools.client_phase import result_lines, same_lines

REPO = Path(__file__).resolve().parents[1]
TIMING = re.compile(r"(\d us|qps)$")


def _run(args, cwd, timeout=300, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", PYTHONHASHSEED="7",
                **env)
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=full, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _result_lines(text, skip=()):
    return [ln for ln in result_lines(text)
            if not TIMING.search(ln) and not any(ln.startswith(x) for x in skip)]


@pytest.mark.parametrize("name,args", [
    ("quickstart", []),
    ("agent_memory_demo", []),
    ("graph_rag", []),
    ("ecommerce_demo", ["--iters", "2"]),
])
def test_example_prints_the_reference_results(tmp_path, name, args):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _run([str(REPO / "examples" / f"{name}.py")], tmp_path / "ref")
    got = _run(["-m", f"velesdb_tpu_torch.examples.{name}", "--device", "cpu", *args],
               tmp_path / "port")
    lines, ref = _result_lines(got), _result_lines(want)
    assert len(lines) >= 4
    assert same_lines(lines, ref), (lines, ref)


def test_sharded_scale_in_a_gloo_world_of_two(tmp_path):
    got = _run(["-m", "velesdb_tpu_torch.examples.sharded_scale", "--device", "cpu",
                "--world", "2"], tmp_path, OMP_NUM_THREADS="2")
    assert "mesh: {'dp': 1, 'rows': 2} over 2 ranks (gloo, cpu)" in got
    lines = _result_lines(got, skip=("mesh:", "done"))
    assert lines == ["sharded exact top-1 correct: True", "sharded ANN shapes: (32, 10)",
                     "sharded SQ8 top-1 agreement with f32: 1.00",
                     "dcn-tier top-1 agreement: 1.0"]
    want = _run([str(REPO / "examples" / "sharded_scale.py")], tmp_path)
    assert lines == _result_lines(want, skip=("mesh:", "done"))
