#!/usr/bin/env python3
"""Measure what a finished ``torch.profiler`` session leaves on later calls.

    PYTHONPATH=<checkout> python3 velesdb_tpu_torch/tools/profiler_overhead.py

``chip_smoke.py`` reads each cell's device busy time with ``torch.profiler``
(CPU and CUDA activities) after timing the cell's calls. This script asks
whether the calls made after such a session cost the host more than the
same calls before it. On the ``sift1m-graph`` data (1,000,000 x 128
euclidean, seed 42, ``GraphParams.auto``, the graph built on the card with
no save) it times, in three rounds, each round after one more profiled
session of 8 calls:

- ``GraphIndex.search`` at b 16, ef 128: the median of 30 calls on CUDA
  events (the beam is bound by the host's launches there);
- 2,000 back-to-back ``torch.add`` of two 16-float tensors: host
  microseconds a launch (``time.perf_counter``, the card drained after).

The numbers go to standard output.
"""

from __future__ import annotations

import importlib.util
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

N, D, SEED, CALLS, ADDS = 1_000_000, 128, 42, 30, 2000


def _chip_smoke():
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launch_us(a, b) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ADDS):
        torch.add(a, b)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / ADDS * 1e6


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profiler_overhead: no CUDA device")
    from velesdb_tpu_torch.index.graph_index import GraphIndex
    from velesdb_tpu_torch.index.params import GraphParams

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    x = cs.make_clustered(np.random.default_rng(SEED), N + 10_000, D)
    gi = GraphIndex(D, "euclidean", GraphParams.auto(D, N), device="cuda")
    xt = torch.from_numpy(x[:N]).cuda()
    gi.build(x[:N], np.ones(N, bool), corpus_dev=xt)
    q = x[N:]
    batches = [q[i : i + 16] for i in range(0, 16 * (CALLS + 1), 16)]
    a = torch.ones(16, device="cuda")
    b = torch.ones(16, device="cuda")

    def search(batch):
        return gi.search(batch, 10, ef=128)[1].cpu()

    for rnd in range(3):
        ms = statistics.median(cs.time_calls(torch, search, batches))
        us = statistics.median(_launch_us(a, b) for _ in range(5))
        print(f"after {rnd} profiled sessions: GraphIndex.search b=16 ef=128 median {ms:.4f} ms; "
              f"torch.add {us:.2f} us a launch (host)", flush=True)
        busy, _ = cs.device_profile(torch, search, batches[1:9])
        print(f"  profiled session {rnd + 1}: device busy {busy:.4f} ms a call", flush=True)


if __name__ == "__main__":
    main()
