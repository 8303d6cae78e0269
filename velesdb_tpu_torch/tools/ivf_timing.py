#!/usr/bin/env python3
"""Time the IVF kernel path's host and device costs on one NVIDIA GPU.

    PYTHONPATH=<checkout> python3 velesdb_tpu_torch/tools/ivf_timing.py LABEL [--schedule]

Imports ``velesdb_tpu_torch`` from ``PYTHONPATH``, so two checkouts (a
parent and a change) can be measured by the same script, one after the
other on one card; ``make_clustered`` comes from the ``chip_smoke.py``
beside this package. On ``hard1m-ivf`` (1,000,000 x 128 euclidean, 24 clusters, seed 43,
as ``chip_smoke.py`` builds it) it prints:

- the planner's latency EMA after the pinned runs of ``chip_smoke.py``
  (16 calls of b 16 at ef 256, 64 and 128) beside exact's static cost;
- ``search_batch`` p50 at b 16, ef 128 (host clock, 30 calls), pinned to
  IVF and, as a control that no IVF code runs, pinned to exact;
- ``IvfIndex.search``, ``ivf_probe_topk`` and ``ivf_probe_scores`` at the
  same shape: the host time to enqueue (no synchronization), the host time
  to a synchronized result, and the device time (CUDA events), medians.

``--schedule`` (where the checkout has ``SCHED_RANK_MAX``) also times
``ivf_probe_scores`` at b 64 over a range of nprobe with the schedule ranked
on the card and built by ``probe_runs``, at L 128 / D 32 and L 1,032 /
D 128 (f32, 3,906 partitions), to place ``SCHED_RANK_MAX``.

The numbers go to standard output.
"""

from __future__ import annotations

import importlib.util
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N, D, B, EF, K, CALLS = 1_000_000, 128, 16, 128, 10, 30
DEVICE = "cuda"


def _make_clustered():
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_clustered


def _host_ms(fn, sync: bool, iters: int = 200) -> float:
    """Median host milliseconds of ``fn``, to its return (``sync`` False:
    the enqueue alone) or to the card's end; the card drained between."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _device_ms(fn, iters: int = 50) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _p50_ms(fn, batches) -> float:
    fn(batches[0])
    times = []
    for q in batches:
        t0 = time.perf_counter()
        fn(q)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _schedule_sweep(ik, out: dict) -> None:
    rng = np.random.default_rng(7)
    keep = ik.SCHED_RANK_MAX
    for L, d in ((128, 32), (1032, 128)):
        n_parts = 3906
        rows = torch.from_numpy(rng.standard_normal((n_parts, L, d), dtype=np.float32)).to(DEVICE)
        aux = torch.stack([torch.ones(n_parts, L), torch.zeros(n_parts, L),
                           torch.zeros(n_parts, L)], 1).to(DEVICE).contiguous()
        q = torch.from_numpy(rng.standard_normal((64, d), dtype=np.float32)).to(DEVICE)
        qsum = q.sum(1)
        for nprobe in (17, 68, 136, 256, 512, 1024):
            probe = torch.from_numpy(
                rng.integers(0, n_parts, (64, nprobe)).astype(np.int32)).to(DEVICE)
            row = {}
            for how, limit in (("ranked", 1 << 30), ("probe_runs", 0)):
                ik.SCHED_RANK_MAX = limit
                fn = lambda: ik.ivf_probe_scores(q, qsum, probe, rows, aux)  # noqa: E731
                row[how] = (_device_ms(fn, 20), _host_ms(fn, False, 50))
            ik.SCHED_RANK_MAX = keep
            out[f"schedule L {L} D {d} M {64 * nprobe}"] = row
            print(f"schedule b 64 nprobe {nprobe} (M {64 * nprobe}), L {L}, D {d}: ranked on "
                  f"the card {row['ranked'][0]:.4f} ms device / {row['ranked'][1]:.4f} ms "
                  f"enqueue; probe_runs {row['probe_runs'][0]:.4f} / "
                  f"{row['probe_runs'][1]:.4f} ms", flush=True)
        del rows, aux


def main() -> None:
    label = sys.argv[1]
    if not torch.cuda.is_available():
        sys.exit("ivf_timing: no CUDA device")
    import velesdb_tpu_torch
    import velesdb_tpu_torch.ops.ivf_kernel as ik
    from velesdb_tpu_torch import Database

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"{label}: {Path(velesdb_tpu_torch.__file__).parent}  [{card}]", flush=True)
    out: dict = {"label": label, "card": card}
    data = _make_clustered()(np.random.default_rng(43), N + 256, D, n_clusters=24)
    base, hard_q = data[:N], data[N:]
    batches = [hard_q[i % 16 * 16:(i % 16 + 1) * 16] for i in range(CALLS)]
    with tempfile.TemporaryDirectory() as tmp:
        db = Database(tmp, device=DEVICE)
        col = db.create_collection("hard1m", D, metric="euclidean")
        col.upsert_bulk(range(N), base)
        col.refresh_device()
        col.index_kind = "ivf"
        col._ensure_ivf(profile={})
        for ef in (256, 64, 128):
            for i in range(0, 256, 16):
                col.search_batch(hard_q[i:i + 16], k=K, ef=ef)
        out["ema_ms"] = {str(k): v / 1e6 for k, v in col.planner._ema.items()}
        out["exact_cost_ms"] = col.planner.cost_exact(N, D, B) / 1e6
        out["ivf_search_batch_p50_ms"] = _p50_ms(
            lambda q: col.search_batch(q, k=K, ef=EF), batches)
        ivf = col.ivf
        nprobe = ivf.nprobe_for(EF)
        q16 = torch.from_numpy(hard_q[:16]).to(DEVICE)
        aux, flat = ivf._kernel_state()
        ops = ik.probe_operands(q16, ivf._centroids, ivf._cent_sq, ivf._parts, nprobe=nprobe,
                                metric=ivf.metric)
        calls = {
            "IvfIndex.search": lambda: ivf.search(q16, K, nprobe=nprobe),
            "ivf_probe_topk": lambda: ik.ivf_probe_topk(
                q16, ivf._centroids, ivf._cent_sq, ivf._parts, aux, flat, k=K, nprobe=nprobe,
                metric=ivf.metric),
            "ivf_probe_scores": lambda: ik.ivf_probe_scores(*ops[:3], ivf._parts, aux),
        }
        for name, fn in calls.items():
            out[name] = {"enqueue_ms": _host_ms(fn, False), "synced_ms": _host_ms(fn, True),
                         "device_ms": _device_ms(fn)}
        col.index_kind = "exact"
        out["exact_search_batch_p50_ms"] = _p50_ms(
            lambda q: col.search_batch(q, k=K), batches)
        db.delete_collection("hard1m")
    print(f"{label}: ivf EMA after the pinned runs {out['ema_ms']} ms, exact's static cost "
          f"{out['exact_cost_ms']:.4f} ms; search_batch b 16 p50: ivf ef {EF} "
          f"{out['ivf_search_batch_p50_ms']:.4f} ms, exact {out['exact_search_batch_p50_ms']:.4f}"
          f" ms  [{card}]", flush=True)
    for name in calls:
        r = out[name]
        print(f"{label}: {name} b 16 nprobe {nprobe}: enqueue {r['enqueue_ms']:.4f} ms, to a "
              f"synchronized result {r['synced_ms']:.4f} ms, device {r['device_ms']:.4f} ms  "
              f"[{card}]", flush=True)
    if "--schedule" in sys.argv and hasattr(ik, "SCHED_RANK_MAX"):
        _schedule_sweep(ik, out)


if __name__ == "__main__":
    main()
