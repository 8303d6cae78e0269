"""Run one cell several times, each run a process of its own, and report
each metric's median and spread.

    python3 perfbench/sets.py --workload <cell> --seeds 1,2,3 --seconds 20 \
        [--trace 0|1] [--out results.jsonl] [--host-sample 2]

A spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median. Each
run's result line, exit code, wall time and the end of its standard error
go to ``--out``; a summary line a run, then one a metric, to standard
output.

``--host-sample S`` times a fixed piece of Python work, shaped like the
hydrate, every ``S`` seconds while each run lasts, in this process beside
the run's, and reports its median beside the run: the host's own speed, to
tell it from the program's.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from operator import itemgetter

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values):
    """``(median, spread)`` of a list of numbers (spread ``None`` under 2)."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def _probe_s(n: int = 20_000) -> float:
    """Seconds of a fixed piece of Python work shaped like the hydrate:
    ``n`` small dicts built and read back."""
    t = time.perf_counter()
    hits = [{"id": i, "score": float(i), "payload": None} for i in range(n)]
    sum(map(itemgetter("id"), hits))
    return time.perf_counter() - t


class HostProbe:
    """Times :func:`_probe_s` every ``every`` seconds on a thread of this
    process (not the run's: the run's Python is not slowed) until
    :meth:`stop`, which returns the median and the range in milliseconds."""

    def __init__(self, every: float):
        self.every = every
        self.times: list[float] = []
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._done.wait(self.every):
            self.times.append(_probe_s())

    def stop(self) -> dict | None:
        self._done.set()
        self._thread.join()
        if not self.times:
            return None
        ms = [t * 1e3 for t in self.times]
        return {"probe_ms": statistics.median(ms), "probe_min_ms": min(ms),
                "probe_max_ms": max(ms), "probes": len(ms)}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/sets.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=1300.0)
    ap.add_argument("--host-sample", type=float, default=0.0)
    args = ap.parse_args(argv)
    per_metric: dict[str, list[float]] = {}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds.split(","):
            cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
                   "--seed", seed, "--seconds", args.seconds, "--trace", args.trace]
            sampler = HostProbe(args.host_sample) if args.host_sample > 0 else None
            t0 = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
            wall = time.perf_counter() - t0
            host = sampler.stop() if sampler else None
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
            except json.JSONDecodeError:
                res = None
            rec = {"workload": args.workload, "seed": int(seed), "trace": int(args.trace),
                   "rc": p.returncode, "wall_s": wall, "host": host, "result": res,
                   "stderr_tail": p.stderr[-3000:]}
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            if res is None:
                print(f"seed {seed}: rc {p.returncode} wall {wall:.1f} s, no result\n"
                      f"{p.stderr[-2000:]}", flush=True)
                continue
            vals = {k: v["value"] for k, v in res["metrics"].items()}
            for k, v in vals.items():
                per_metric.setdefault(k, []).append(v)
            checks = {k: v["value"] for k, v in res["checks"].items()}
            print(f"seed {seed}: rc 0 wall {wall:.1f} s correct {res['correct']} "
                  f"metrics {json.dumps(vals)} checks {json.dumps(checks)} "
                  f"peak {res['device']['memory_peak_bytes']} host {json.dumps(host)}", flush=True)
    finally:
        if out:
            out.close()
    for k, vs in per_metric.items():
        med, sp = spread(vs)
        print(f"metric {k}: n {len(vs)} median {med!r} spread {sp!r} values {vs!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
