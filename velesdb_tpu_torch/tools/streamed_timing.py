#!/usr/bin/env python3
"""Time the exact streamed scan's euclidean paths on one NVIDIA GPU.

    PYTHONPATH=<checkout> python3 velesdb_tpu_torch/tools/streamed_timing.py LABEL \\
        [--data DIR] [--device cuda|cpu] [--ns-rows N] [--graph-rows N]

Imports ``velesdb_tpu_torch`` from ``PYTHONPATH``, so two checkouts (a
parent and a change) are measured by the same script one after the other
on one card; ``make_clustered`` comes from the ``chip_smoke.py`` beside this
package. Two paths of ``chip_smoke.py`` reach ``streamed_topk`` on f32 rows
under the euclidean metric, and it prints both:

- phase 14 (a)'s streamed mode: ``ShardedBruteForce`` in a world of 1 on one
  north-star shard (6,291,456 x 128, ``make_clustered`` seed 42), searched at
  k 300 (past the assist's oversample); p50 of ``search`` at b 16 and 256
  (host clock, results read back) and ``streamed_topk`` alone on the shard's
  arrays (CUDA events);
- phase 10's graph delta: sift1m (1,000,000 x 128, seed 42) as a ``graph``
  collection (``GraphParams.auto``), 1,000 rows upserted after the build
  (``sift_q[1000:2000] + 0.01``); p50 of ``search_batch`` at ef 128, b 16
  and 256, of the device path at b 16, and of the delta's ``streamed_topk``
  alone on its snapshot (CUDA events).

Each part prints a digest of the returned ids in order and of each row's id
set, so two checkouts' answers can be compared. The north-star rows are made
once and kept as ``DIR/ns-<rows>.npy`` (``build/streamed_timing`` by
default), which later runs memory-map. ``--device cpu`` with small row
counts rehearses the script. The numbers go to standard output.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

D, K, STREAM_K, QUERIES, UPSERTS, EF, CALLS = 128, 10, 300, 1_024, 1_000, 128, 30


def _make_clustered():
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_clustered


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _p50_ms(fn, batches) -> float:
    """Median host milliseconds of ``fn(batch)`` (which reads its result
    back) over ``batches``, after one warm-up call."""
    fn(batches[0])
    ts = []
    for b in batches:
        t0 = time.perf_counter()
        fn(b)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _device_ms(fn, dev, iters: int = 20) -> float:
    """Milliseconds a call of ``fn`` on the card (CUDA events over
    ``iters`` calls; the host clock on the CPU)."""
    fn()
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _digest(ids) -> str:
    """Digests of ``ids [B, k]`` in order and of each row's sorted set."""
    ids = np.ascontiguousarray(np.asarray(ids, np.int64))
    return (f"ids {hashlib.sha1(ids.tobytes()).hexdigest()[:12]}, sets "
            f"{hashlib.sha1(np.sort(ids, axis=1).tobytes()).hexdigest()[:12]}")


def _north_star(make_clustered, data_dir: str, rows: int) -> np.ndarray:
    path = os.path.join(data_dir, f"ns-{rows}.npy")
    if not os.path.exists(path):
        os.makedirs(data_dir, exist_ok=True)
        t0 = time.perf_counter()
        x = make_clustered(np.random.default_rng(42), rows + QUERIES, D)
        np.save(path + ".tmp.npy", x)
        os.replace(path + ".tmp.npy", path)
        print(f"north-star rows made and saved: {time.perf_counter() - t0:.2f} s", flush=True)
    return np.load(path, mmap_mode="r")


def sharded_streamed(label, dev, make_clustered, data_dir, rows) -> None:
    import torch.distributed as dist

    from velesdb_tpu_torch.ops.streamed import streamed_topk
    from velesdb_tpu_torch.parallel import ShardedBruteForce
    from velesdb_tpu_torch.parallel.sharded import make_mesh

    data = _north_star(make_clustered, data_dir, rows)
    corpus, held = data[:rows], np.array(data[rows:])
    mesh = make_mesh(device=dev.type)
    t0 = time.perf_counter()
    idx = ShardedBruteForce(mesh, D, "euclidean")
    idx.rebuild(np.asarray(corpus))
    _sync(dev)
    print(f"[{label}] shard {rows:,} x {D}: rebuild {time.perf_counter() - t0:.2f} s", flush=True)
    for b in (16, 256):
        assert not idx._assist_serves(b, STREAM_K), "k 300 should pass the assist guard by"
        batches = [held[i : i + b] for i in range(0, b * 10, b)] if b == 16 else [held[:256]] * 10
        ms = _p50_ms(lambda q: idx.search(q, STREAM_K), batches)
        _, ids = idx.search(held[:b], STREAM_K)
        q = torch.from_numpy(held[:b]).to(dev)
        dev_ms = _device_ms(lambda: streamed_topk(
            q, idx._corpus, valid=idx._valid, k=STREAM_K, metric="euclidean",
            chunk=min(65536, idx.n_local), corpus_sqnorm=idx._cnorm), dev)
        print(f"[{label}] sharded streamed k {STREAM_K} b {b}: search p50 {ms:.4f} ms (host "
              f"clock, 10 calls), streamed_topk alone {dev_ms:.4f} ms ({dev.type}); "
              f"{_digest(ids)}", flush=True)
    del idx
    dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def graph_delta(label, dev, make_clustered, rows) -> None:
    from velesdb_tpu_torch import Database
    from velesdb_tpu_torch.ops.streamed import streamed_topk

    x = make_clustered(np.random.default_rng(42), rows + 10_000, D)
    base, sq = x[:rows], x[rows:]
    tmp = tempfile.mkdtemp(prefix="velesdb_streamed_timing_")
    try:
        db = Database.open(tmp, device=dev.type)
        col = db.create_collection("sift1m_graph", D, metric="euclidean", index_kind="graph")
        col.upsert_bulk(range(rows), base)
        col.refresh_device()
        t0 = time.perf_counter()
        assert col._ensure_ann(force=True), "no graph built"
        _sync(dev)
        print(f"[{label}] graph {rows:,} x {D}: build {time.perf_counter() - t0:.2f} s",
              flush=True)
        new = sq[1000 : 1000 + UPSERTS] + 0.01
        col.upsert_bulk(range(rows, rows + UPSERTS), new)
        found = col.search_batch(new[:64], k=K, ef=EF)
        assert [r[0].id for r in found] == list(range(rows, rows + 64)), "delta rows not found"
        b16 = [sq[i : i + 16] for i in range(0, 16 * (CALLS + 1), 16)]
        ms16 = _p50_ms(lambda b: col.search_batch(b, k=K, ef=EF), b16)
        ms256 = _p50_ms(lambda b: col.search_batch(b, k=K, ef=EF), [sq[:256]] * 11)
        dev16 = _p50_ms(lambda b: col._search_device(b, K, None, ef=EF)[1].cpu(), b16)
        ids = [[h.id for h in r] for r in col.search_batch(sq[:256], k=K, ef=EF)]
        _, dvecs, _, dalive = col._delta_snapshot("graph")
        valid = torch.from_numpy(dalive).to(dev)
        delta_ms = {}
        for b in (16, 256):
            q = torch.from_numpy(sq[:b]).to(dev)
            delta_ms[b] = _device_ms(lambda: streamed_topk(
                q, dvecs, valid=valid, k=min(K, dvecs.shape[0]), metric="euclidean"), dev)
        print(f"[{label}] graph delta ({UPSERTS} rows upserted after the build), ef {EF}: "
              f"search_batch p50 b 16 {ms16:.4f} ms, b 256 {ms256:.4f} ms, device path b 16 "
              f"{dev16:.4f} ms (host clock, {CALLS} / 10 calls); the delta's streamed_topk "
              f"alone b 16 {delta_ms[16]:.4f} ms, b 256 {delta_ms[256]:.4f} ms ({dev.type}); "
              f"b 256 {_digest(ids)}", flush=True)
        db.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("label")
    ap.add_argument("--data", default=str(Path(__file__).resolve().parents[2] / "build"
                                          / "streamed_timing"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ns-rows", type=int, default=6_291_456)
    ap.add_argument("--graph-rows", type=int, default=1_000_000)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("this tool needs an NVIDIA GPU (or --device cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    import velesdb_tpu_torch
    from velesdb_tpu_torch.ops import _cuda

    print(f"[{args.label}] velesdb_tpu_torch from {Path(velesdb_tpu_torch.__file__).parent}",
          flush=True)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _cuda.build_all(("sq8i_bucket", "ivf_probe"))
        print(f"[{args.label}] build sq8i_bucket, ivf_probe {time.perf_counter() - t0:.2f} s",
              flush=True)
    make_clustered = _make_clustered()
    sharded_streamed(args.label, dev, make_clustered, args.data, args.ns_rows)
    graph_delta(args.label, dev, make_clustered, args.graph_rows)


if __name__ == "__main__":
    main()
