"""Run one cell of the benchmark once and print its result line.

A cell is found by its name in ``BENCHMARK.json``; its files are found by
name under ``perfbench/``: ``workloads/<cell>.json`` (the configuration and
traffic it joins, and the limit of each number compared),
``configs/<config>.json`` (the deployment: sizes, data model, the
collection's arguments, guarantees), ``traffic/<mix>.json``
(the operation, batch, k, filter, texts), ``data/<model>.py`` (the data
model's generator), ``ops/<op>.py`` (the call the window drives, its
reference and its numbers) and ``metrics/<metric>.py`` (one reader a
metric). Adding a cell, a configuration, a mix, a data model, an operation
or a metric adds files and entries; no file here changes.

A run:

1. makes its rows, ids, payloads and query pool on the card from the seed;
2. builds the collection under ``TMPDIR`` through the public API
   (``Database.create_collection`` with the configuration's
   ``collection`` arguments, then ``Collection.upsert_bulk`` in chunks of
   ``INGEST_CHUNK`` rows);
3. warms up the cell's own call shape (the lazy builds: device state, the
   column store, BM25) and takes ``setup_s``;
4. drives a closed loop of one client for ``--seconds``, timing every call
   and recording every answer;
5. with ``--trace 1``, then times the operation's side calls alone (the
   text branch of a hybrid cell), and last profiles a steady run of
   further calls;
6. reads the peak memory, checks that neither JAX nor the JAX package was
   loaded, frees the program's state, judges every answer of the window
   against the plain reference (:mod:`perfbench.judge`), and prints each
   number compared beside its limit on standard error and the result as
   the last line of standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import perfbench

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "velesdb_tpu")
WARMUP_CALLS = 3  # calls before set-up ends: the lazy builds and the call shape
PROFILE_SECONDS = 1.5  # the traced run's profiled calls (and each side call's timing)
INGEST_CHUNK = 250_000  # rows a call of upsert_bulk

__all__ = ["Spec", "Run", "load_spec", "run_cell", "main", "forbidden_modules", "result_line"]


class SpecError(Exception):
    pass


class Spec:
    """A cell as the files describe it."""

    def __init__(self, name, cell, cfg, traffic, limits, end_to_end, per_layer):
        self.name = name
        self.cell = cell
        self.cfg = cfg
        self.traffic = traffic
        self.limits = limits
        self.end_to_end = end_to_end  # [metric entry]
        self.per_layer = per_layer


def _json(path: Path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing {path.relative_to(ROOT)}") from None


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    wfile = _json(root / "perfbench" / "workloads" / f"{workload}.json")
    for key in ("config", "traffic"):
        if wfile[key] != cell[key]:
            raise SpecError(f"{workload}: {key} {wfile[key]!r} in its workload file, "
                            f"{cell[key]!r} in BENCHMARK.json")
    cfg = _json(root / "perfbench" / "configs" / f"{cell['config']}.json")
    traffic = _json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [
        m for m in bench["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)
    ]
    return Spec(workload, cell, cfg, traffic, wfile["limits"], e2e, per_layer)


def load_reader(name: str):
    try:
        return perfbench.load("metrics", name).read
    except LookupError as e:
        raise SpecError(str(e)) from None


class Run:
    """What a run recorded, as the metric readers see it."""

    def __init__(self, spec: Spec):
        t = spec.traffic
        self.op = t["op"]
        self.batch = int(t["batch"])
        self.k = int(t["k"])
        self.dim = int(spec.cfg["collection"]["dim"])
        self.admitted_rows = int(spec.cfg["rows"])
        self.device_kind = None
        self.setup_s = None
        self.window_s = 0.0
        self.calls_s: list[float] = []
        self.answered = 0
        self.recall = None
        self.profile = None
        self.side_s: dict[str, list[float]] = {}  # each side call's times, traced run


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (compared whole: the port's name only begins with it)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", workdir: str | None = None, log=print):
    """One run of a cell; returns ``(run, numbers, device_info, loaded)``:
    the record the readers see, the numbers compared, the result's
    ``device`` object and the forbidden modules found after the window."""
    import torch

    from perfbench import data, judge, trace as tr
    from velesdb_tpu_torch import Database

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    run = Run(spec)
    cfg, traffic = spec.cfg, spec.traffic
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        run.device_kind = torch.cuda.get_device_name(0)

    ds = data.make_dataset(cfg, seed, device)
    pool = data.make_pool(cfg, traffic, seed, ds, device)
    mask = data.filter_mask(traffic.get("filter"), ds)
    if mask is not None:
        run.admitted_rows = int(mask.sum())
    op = perfbench.load("ops", traffic["op"])

    tmp = tempfile.mkdtemp(prefix="perfbench-", dir=workdir)
    try:
        db = Database(tmp, device=device)
        col = db.create_collection(**cfg["collection"])
        rows_np = ds.rows.cpu().numpy()
        payloads = ds.payloads()
        step = INGEST_CHUNK
        for s in range(0, ds.n, step):
            col.upsert_bulk(ds.ids[s : s + step].tolist(), rows_np[s : s + step],
                            None if payloads is None else payloads[s : s + step])
        del rows_np, payloads
        call = op.make_call(col, spec, pool)
        for i in range(WARMUP_CALLS):
            call(i)
        side = op.side_calls(col, spec, pool, sync) if trace and hasattr(op, "side_calls") else {}
        for side_call in side.values():
            side_call(0)
        sync()
        run.setup_s = time.perf_counter() - t_start
        log(f"[perfbench] {spec.name} seed {seed}: set-up {run.setup_s:.3f} s, "
            f"engine {col.info()['serve_engine']}")

        # the window: a closed loop of one client
        answers = judge.Answers(run.k)
        calls_s = run.calls_s
        t0 = time.perf_counter()
        end = t0 + seconds
        i = 0
        while True:
            a = time.perf_counter()
            idx, res = call(i)
            b = time.perf_counter()
            calls_s.append(b - a)
            answers.add(idx, res)
            i += 1
            if b >= end:
                break
        run.window_s = time.perf_counter() - t0
        run.answered = answers.count
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        log(f"[perfbench] window {run.window_s:.3f} s, {i} calls, {run.answered} queries, "
            f"{run.window_s - sum(calls_s):.3f} s of it the client's bookkeeping")

        if trace:
            # side calls are timed before the profiler runs: a finished
            # profiler session leaves every later launch dearer on the host
            for name, side_call in side.items():
                times = run.side_s[name] = []
                t1 = time.perf_counter()
                j = 0
                while j < 8 or time.perf_counter() - t1 < PROFILE_SECONDS:
                    a = time.perf_counter()
                    side_call(i + j)
                    times.append(time.perf_counter() - a)
                    j += 1
            run.profile = tr.profile_calls(lambda j: call(i + j), min_calls=8,
                                           seconds=PROFILE_SECONDS, sync=sync)
        loaded = forbidden_modules()
        db.close()
        del col, db, call, side
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = judge.reference(cfg, traffic, ds, pool, mask)
    numbers = judge.judge(cfg, traffic, ds, pool, mask, ref, answers)
    run.recall = numbers["_recall"]
    log(f"[perfbench] reference and comparison {time.perf_counter() - t_ref:.3f} s")
    dev_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": run.device_kind or device,
        "count": int(spec.cell["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    if run.profile is not None:
        dev_info["busy_s"] = run.profile.busy_s
        dev_info["window_s"] = run.profile.window_s
    return run, numbers, dev_info, loaded


def result_line(spec: Spec, run: Run, numbers: dict, dev_info: dict, trace: bool) -> dict:
    """The result object: ``correct``, ``attempted``, ``failed``, the
    metrics of the run's kind, ``device``, with ``--trace 1`` the
    ``breakdown``, and last the numbers compared beside their limits."""
    from perfbench import judge

    correct, checks = judge.verdict(numbers, spec.limits)
    wanted = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"])(run)
        if value is None:
            if not trace:
                raise SpecError(f"{spec.name}: end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {
        "correct": bool(correct),
        "attempted": run.answered,
        "failed": int(numbers["malformed"]),
        "metrics": metrics,
        "device": dev_info,
    }
    if trace and run.profile is not None:
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.profile.device_ops],
            "idle_gaps": [[n, s] for n, s in run.profile.idle_gaps],
        }
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit, _ in checks}
    return out


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run in it builds."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "velesdb_tpu_torch").is_dir():
        print("perfbench: the program (velesdb_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    try:
        spec = load_spec(args.workload)
    except SpecError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    _cache_dirs()
    import torch

    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run, numbers, dev_info, loaded = run_cell(
        spec, args.seed, args.seconds, bool(args.trace), t_start,
        log=lambda msg: print(msg, file=sys.stderr, flush=True))
    loaded = sorted(set(loaded) | set(forbidden_modules()))
    if loaded:
        print(f"perfbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    out = result_line(spec, run, numbers, dev_info, bool(args.trace))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
