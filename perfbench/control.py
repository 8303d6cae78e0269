"""The control of a cell: the plain reference put in the program's place,
computed one precision below the configuration's float32 (bfloat16), and
judged as the program's answers are. A sound comparison finds it not
correct.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13

Prints one JSON line a seed: each number compared and its limit, and
``correct``. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["control_numbers", "main"]


def control_numbers(spec, seed: int, device: str) -> dict:
    """The numbers compared when the bfloat16 reference answers one pass
    over the cell's query pool."""
    import torch

    from perfbench import data, judge

    ds = data.make_dataset(spec.cfg, seed, device)
    pool = data.make_pool(spec.cfg, spec.traffic, seed, ds, device)
    mask = data.filter_mask(spec.traffic.get("filter"), ds)
    ref = judge.reference(spec.cfg, spec.traffic, ds, pool, mask)
    ctrl = judge.reference(spec.cfg, spec.traffic, ds, pool, mask, dtype=torch.bfloat16)
    answers = judge.control_answers(ds, pool, ctrl, int(spec.traffic["k"]))
    return judge.judge(spec.cfg, spec.traffic, ds, pool, mask, ref, answers)


def main(argv) -> int:
    from perfbench import harness, judge

    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(spec, seed, "cuda")
        correct, checks = judge.verdict(numbers, spec.limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim, _ in checks},
                          "recall": numbers["_recall"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
