"""Experiment: a hand-written row-gather kernel against indexing + matmul.

    python -m velesdb_tpu_torch.experiments.exp_gather_kernel [--device cpu]
        [--n 1000000 --d 128 --r 8192 --iters 64 --group 16]

Port of ``benchmarks/exp_gather_kernel.py``. The graph beam search's hot step
gathers scattered corpus rows and scores them against its queries; this
measures that step alone, ``q [8, D] . corpus[idx]^T`` for ``R`` random row
ids, three ways:

    baseline   ``q @ corpus[idx].T``: PyTorch's gather and ``torch.mm`` (the
               script's "XLA gather+dot" line; no path of the package calls it)
    row-gather csrc/row_gather.cu (#11): each row copied to shared memory on
               its own, ``--group`` rows in flight, then scored
    row-gather double-buffered: the next group's copies issued before the
               block waits on this one

Data: numpy seed 0: a standard normal corpus ``[N, D]``, 8 queries, and
``--iters`` distinct id sets of ``R`` rows. Each line gives us a step and the
rate of the gathered rows' bytes (best of 3 samples of ``--iters`` steps);
then the script's correctness spot check, each kernel's max |err| against
the baseline. ``main()`` returns the results.

The answer on an NVIDIA H100 80GB HBM3 (700 W; device times from
``velesdb_tpu_torch/tools/int8_tc_timing.py --gather``, PERF.md row #11):
scattered 512-byte rows are not transaction-bound at a few GB/s there. At
R 262,144 the kernel's bulk row copies alone move 2.4 TB/s of gathered rows
(0.68 of the HBM rate), the whole kernel 2.1 TB/s (0.063 ms), the baseline
0.53 TB/s (0.25 ms: the gather writes the rows out and the product reads
them again). At this script's R 8,192 a step is one DRAM round trip and a
launch: 0.0067 ms of device time for the kernel at either depth, 0.016 for
the baseline; the lines below time the host's enqueue as well (~0.02-0.03
ms a call for each).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from velesdb_tpu_torch.experiments import _common
from velesdb_tpu_torch.experiments import kernels as xk

SAMPLES = 3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--r", type=int, default=8192, help="rows gathered per step")
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--group", type=int, default=16, help="row copies in flight")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _common.resolve_device(args.device)
    n, d, r, g = args.n, args.d, args.r, args.group
    if r % g:
        raise ValueError(f"--r {r} must be a multiple of --group {g}, as in the script")

    rng = np.random.default_rng(0)
    corpus = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32)).to(dev)
    idx_all = torch.from_numpy(rng.integers(0, n, size=(args.iters, r), dtype=np.int32)).to(dev)
    batches = [(idx_all[i],) for i in range(args.iters)]
    bytes_per = r * d * 4

    def baseline(ix):
        return q @ corpus[ix.long()].T

    scorers = {
        "baseline": baseline,
        "row-gather": lambda ix: xk.row_gather_scores(q, corpus, ix, group=g, stages=1),
        "row-gather double-buffered": lambda ix: xk.row_gather_scores(q, corpus, ix, group=g,
                                                                      stages=2),
    }
    results = {}
    for name, fn in scorers.items():
        best, samples = _common.time_batches(fn, batches, dev, SAMPLES, roll=lambda _: 0)
        results[name] = {"us_per_step": best * 1e6, "gb_s": bytes_per / best / 1e9,
                         "samples_us": [s * 1e6 for s in samples]}
        print(f"{name + ':':28s} {best * 1e6:10.2f} us/step  {bytes_per / best / 1e9:8.2f} "
              f"GB/s  (G={g}{'x2' if 'double' in name else ''})", flush=True)

    want = baseline(idx_all[0])
    for name in ("row-gather", "row-gather double-buffered"):
        err = float((scorers[name](idx_all[0]) - want).abs().max())
        results[name]["max_abs_err_vs_baseline"] = err
        print(f"max |err| vs baseline ({name}): {err}", flush=True)
    return {"device": _common.device_name(dev), "n": n, "d": d, "r": r, "group": g,
            "iters": args.iters, "results": results}


if __name__ == "__main__":
    main(sys.argv[1:])
