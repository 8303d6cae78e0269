#!/usr/bin/env python3
"""Time the graph index's approximate kNN build stage on one NVIDIA GPU.

    PYTHONPATH=<checkout> python3 velesdb_tpu_torch/tools/graph_build_timing.py LABEL

Imports ``velesdb_tpu_torch`` from ``PYTHONPATH``, so two checkouts (a
parent and a change) can be measured by the same script, one after the
other on one card; ``make_clustered`` comes from the ``chip_smoke.py``
beside this package. On the ``sift1m-graph`` data (1,000,000 x 128
euclidean, seed 42, as ``chip_smoke.py`` makes it) it runs the kNN stage of
``GraphIndex.build`` at ``GraphParams.auto``'s parameters
(``ivf_self_knn``: knn_k 32, build_nprobe 32, the rows resident on the
card) three times, and prints each run's seconds by stage (``profile``)
and the kNN graph's recall against the exact neighbours of 2,048 rows,
measured on the card in float64.

The numbers go to standard output.
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

N, D, SEED, RUNS, CHECK_ROWS = 1_000_000, 128, 42, 3, 2048


def _make_clustered():
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_clustered


def _exact_knn(x: torch.Tensor, rows: torch.Tensor, k: int) -> np.ndarray:
    """float64 exact self-kNN (self excluded) of ``rows`` over ``x``."""
    q = x[rows].double()
    out = []
    for s in range(0, q.shape[0], 256):
        d = torch.cdist(q[s : s + 256], x.double())
        d[torch.arange(d.shape[0]), rows[s : s + 256]] = torch.inf
        out.append(torch.topk(d, k, dim=1, largest=False).indices.cpu().numpy())
    return np.concatenate(out)


def main(argv: list[str]) -> None:
    label = argv[0] if argv else "tree"
    from velesdb_tpu_torch.index.ivf import ivf_self_knn
    from velesdb_tpu_torch.index.params import GraphParams

    if not torch.cuda.is_available():
        sys.exit("graph_build_timing: no CUDA device")
    p = GraphParams.auto(D, N)
    x = _make_clustered()(np.random.default_rng(SEED), N + 10_000, D)[:N]
    xt = torch.from_numpy(x).cuda()
    valid = np.ones(N, bool)
    rows = torch.from_numpy(
        np.random.default_rng(1).choice(N, CHECK_ROWS, replace=False)).cuda()
    exact = _exact_knn(xt, rows, p.knn_k)
    for run in range(RUNS):
        prof = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        knn, _ = ivf_self_knn(xt, p.knn_k, "euclidean", valid=valid, nprobe=p.build_nprobe,
                              passes=p.build_passes, return_router=True, profile=prof,
                              return_device=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        got = knn[rows].cpu().numpy()
        recall = np.mean([len(set(a[a >= 0]) & set(b)) / len(b) for a, b in zip(got, exact)])
        stages = ", ".join(f"{key} {v:.4f}" for key, v in prof.items())
        print(f"[{label}] knn run {run}: {total:.4f} s ({stages}); kNN recall@{p.knn_k} over "
              f"{CHECK_ROWS} rows {recall:.4f}", flush=True)
        del knn


if __name__ == "__main__":
    main(sys.argv[1:])
