#!/usr/bin/env python3
"""Drive the PyTorch port's exact-search path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, in order; any failure exits nonzero:

1. Device: require CUDA, print the card's name and power limit, turn TF32
   off, build the hand-written kernel from ``velesdb_tpu_torch/csrc``.
2. Kernel vs its plain torch version, bit for bit (``torch.equal``): the slice
   shape (B_pad 256, N 1,048,576, D_pad 128, chunk 8192), the same N at B 1
   and B 16 (the kernel's query-tile builds 8 and 16), and ragged shapes
   (B 13 -> 16, D 100 -> 128, N 131,072, 15% masked rows), for the shadows of
   all three metrics.
3. Slice, SIFT-1M class: 1,000,000 x 128 euclidean FULL, clustered data
   (seed 42, 10K held-out queries), payloads ``{"cat": i % 8}``, through
   ``Database`` -> ``Collection.search_batch`` / ``search`` / a filtered
   search / close + reopen. The launch counters are zeroed just before this
   main path and must show the kernel ran on every search; every launch of
   that run is then held against the plain version on its own arguments,
   bit for bit. Recall@10 >= 0.99 and distances to rtol 1e-4 against a
   float64 oracle on the unpadded corpus.
4. Slice, 100K x 768D cosine (streamed scan): recall@10 >= 0.999.
5. Timing with CUDA events: QPS at b=256 and b=16 for both configs (median
   of 30 calls after warm-up), kernel vs plain time and the kernel's share
   of the derived dp4a issue ceiling, peak device memory; then,
   after every timing, the device's busy time per call and the top kernels
   from torch.profiler.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 10
TIMED_CALLS = 30
DEVICE = "cuda"
SIFT_N, SIFT_D, HELD_OUT = 1_000_000, 128, 10_000  # bench.py:9, :561
C768_N, C768_D = 100_000, 768  # bench.py:7
RAGGED_N, RAGGED_B, RAGGED_D = 131_072, 13, 100
CHUNK = 8192
CARD = ""  # "name, power limit" from nvidia-smi, appended to every number


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(f"{msg}  [{CARD}]", flush=True)


def make_clustered(rng, n, d, n_clusters=64):
    """Clustered Gaussians: the reference benchmark's data model (bench.py:41)."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, n)
    return centers[assign] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


def oracle_topk(torch, corpus64, queries, metric, k, mask=None, chunk=131072):
    """float64 exact top-k on the card: ``(scores [B, k], ids [B, k])`` with
    euclidean scores as distances (ascending) and cosine as similarities."""
    q = torch.as_tensor(queries, device=corpus64.device).double()
    if metric == "cosine":
        q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-300)
    qq = (q * q).sum(1, keepdim=True)
    best_v = best_i = None
    for c0 in range(0, corpus64.shape[0], chunk):
        c = corpus64[c0 : c0 + chunk]
        dots = q @ c.T
        if metric == "euclidean":
            s = -(qq + (c * c).sum(1)[None, :] - 2.0 * dots)
        else:
            s = dots
        if mask is not None:
            s = torch.where(mask[None, c0 : c0 + chunk], s, -torch.inf)
        v, i = torch.topk(s, k, dim=1)
        if best_v is None:
            best_v, best_i = v, i + c0
        else:
            best_v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            best_i = torch.gather(torch.cat([best_i, i + c0], 1), 1, pos)
    if metric == "euclidean":
        best_v = torch.sqrt((-best_v).clamp_min(0.0))
    return best_v.cpu().numpy(), best_i.cpu().numpy()


def score_results(results, o_vals, o_ids, rtol):
    """recall@k of hydrated results against the oracle, and the worst
    relative score error on shared ids."""
    hits, worst = 0, 0.0
    for row, ov, oi in zip(results, o_vals, o_ids):
        truth = {int(i): float(v) for i, v in zip(oi, ov)}
        for hit in row:
            if hit.id in truth:
                hits += 1
                ref = truth[hit.id]
                worst = max(worst, abs(hit.score - ref) / max(abs(ref), 1e-12))
    recall = hits / (len(results) * o_ids.shape[1])
    check(worst <= rtol, f"score error {worst:.3e} above rtol {rtol}")
    return recall


def time_calls(torch, fn, batches):
    """Per-call milliseconds of ``fn(batch)`` measured with CUDA events."""
    fn(batches[0])  # warm-up
    torch.cuda.synchronize()
    out = []
    for b in batches[1:]:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(b)
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def time_kernel(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_profile(torch, fn, batches):
    """Device time per call (kernels and copies on the card) from
    torch.profiler, and the three kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            fn(b)
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(per_name.values()) / 1e3 / len(batches)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:3]
    return busy, [(name, us / 1e3 / len(batches)) for name, us in top]


def report_qps(torch, label, search, queries, b):
    """Median per-call time of ``search`` over consecutive query batches;
    returns it with the batches for a later profile."""
    n_calls = min(TIMED_CALLS + 1, queries.shape[0] // b)
    batches = [queries[i * b : (i + 1) * b] for i in range(n_calls)]
    ms = time_calls(torch, search, batches)
    med = statistics.median(ms)
    p99 = float(np.percentile(ms, 99))
    say(
        f"{label} b={b}: {b / med * 1e3:.1f} QPS (median of {len(ms)} calls, "
        f"p50 {med:.4f} ms, p99 {p99:.4f} ms)"
    )
    return med, batches


def report_busy(torch, label, search, batches, med, calls=8):
    busy, top = device_profile(torch, search, batches[1 : 1 + calls])
    if busy <= 0.0:
        print(f"{label}: device busy not measured (no device events)", flush=True)
        return
    say(
        f"{label}: device busy {busy:.4f} ms/call, idle share {1.0 - busy / med:.3f} "
        f"(torch.profiler over {calls} calls, against the unprofiled median)"
    )
    for name, t in top:
        say(f"    {t:.4f} ms/call  {name[:100]}")


def main() -> None:
    global CARD
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "velesdb_tpu_torch")):
        fail("velesdb_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    CARD = smi.strip()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    from velesdb_tpu_torch import Database
    from velesdb_tpu_torch.index.brute import pad_rows
    from velesdb_tpu_torch.ops import _cuda, bucket_kernel as bk

    t0 = time.perf_counter()
    _cuda.library("sq8pd_bucket")
    say(
        f"build sq8pd_bucket: nvcc {_cuda.BUILD_SECONDS['sq8pd_bucket']:.2f} s, "
        f"load {time.perf_counter() - t0:.2f} s"
    )

    rng = np.random.default_rng(42)
    sift_all = make_clustered(rng, SIFT_N + HELD_OUT, SIFT_D)
    sift, sift_q = sift_all[:SIFT_N], sift_all[SIFT_N:]
    sift_pad = pad_rows(SIFT_N)

    # -- 2. kernel vs plain version, bit for bit ------------------------------
    def shadow(x, metric, valid):
        xt = torch.from_numpy(x).to(dev)
        if metric == "cosine":
            xt = xt / xt.norm(dim=1, keepdim=True)
        pd = bk.sq8pd_build(xt, torch.from_numpy(valid).to(dev), x.shape[1], metric)
        check(pd is not None, f"sq8pd_build refused the {metric} shadow")
        return pd

    def gm_case(label, queries, pd, n, chunk, mask=None):
        rows_pd, pen_int, _, sdim, _, qu = pd
        ptile = bk.sq8pd_ptile(pen_int, chunk)
        if mask is not None:
            ptile = torch.where(mask, ptile, -64 * bk._pd_invalid_pen(queries.shape[1]))
        qi, b_pad = bk._sq8pd_quantize_queries(
            torch.from_numpy(queries).to(dev), sdim, qu, rows_pd.shape[1]
        )
        gm = bk.sq8pd_bucket_gm(qi, rows_pd, ptile, chunk)
        torch.cuda.synchronize()
        ref = bk.sq8pd_bucket_gm_ref(qi, rows_pd, ptile, chunk)
        torch.cuda.synchronize()
        check(gm.shape == (b_pad, n // chunk * 128), f"{label}: gm shape {tuple(gm.shape)}")
        err = int((gm.long() - ref.long()).abs().max())
        check(torch.equal(gm, ref), f"{label}: kernel != plain version (max |err| {err})")
        print(f"kernel == plain, bit for bit: {label}", flush=True)
        return qi, rows_pd, ptile, err

    slice_shape = f"B_pad 256, N {sift_pad}, D_pad 128, chunk {CHUNK}"
    sift_pd = shadow(np.pad(sift, ((0, sift_pad - SIFT_N), (0, 0))), "euclidean",
                     np.arange(sift_pad) < SIFT_N)
    # the kernel has one build per query tile (32, 16, 8): the batch sizes of
    # the main path (256, 16, 1) reach all three at the slice's N
    max_err = 0
    for b in (1, 16):
        *_, err = gm_case(
            f"B {b}, N {sift_pad}, D_pad 128, chunk {CHUNK}, euclidean",
            sift_q[:b], sift_pd, sift_pad, CHUNK,
        )
        max_err = max(max_err, err)
    qi, rows_pd, ptile, err = gm_case(
        f"{slice_shape}, euclidean", sift_q[:256], sift_pd, sift_pad, CHUNK,
    )
    max_err = max(max_err, err)
    ragged = make_clustered(np.random.default_rng(7), RAGGED_N + RAGGED_B, RAGGED_D)
    r_valid = np.random.default_rng(8).random(RAGGED_N) >= 0.15
    r_mask = torch.from_numpy(np.random.default_rng(9).random(RAGGED_N) >= 0.15).to(dev)
    for metric in ("euclidean", "cosine", "dot_product"):
        pd = shadow(ragged[:RAGGED_N], metric, r_valid)
        _, _, _, err = gm_case(
            f"B {RAGGED_B}, N {RAGGED_N}, D {RAGGED_D}, chunk {CHUNK}, "
            f"15% invalid + 15% masked, {metric}",
            ragged[RAGGED_N:], pd, RAGGED_N, CHUNK, mask=r_mask,
        )
        max_err = max(max_err, err)

    kernel_ms = time_kernel(torch, lambda: bk.sq8pd_bucket_gm(qi, rows_pd, ptile, CHUNK))
    plain_ms = time_kernel(torch, lambda: bk.sq8pd_bucket_gm_ref(qi, rows_pd, ptile, CHUNK))
    say(
        f"sq8pd_bucket at {slice_shape}: "
        f"kernel {kernel_ms:.4f} ms, plain torch {plain_ms:.4f} ms"
    )
    # Derived, not counted by a profiler: the dp4a issue ceiling, taking 64
    # dp4a per SM per clock (the integer multiply-add rate of compute
    # capability 9.0) at the card's maximum SM clock.
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dp4a = qi.shape[0] * sift_pad * rows_pd.shape[1] / 4
    rate = dp4a / (kernel_ms * 1e-3)
    ceiling = 64 * n_sm * sm_mhz * 1e6
    say(
        f"sq8pd_bucket dp4a rate {rate / 1e12:.4f} T/s = {rate / ceiling:.4f} of the "
        f"derived issue ceiling {ceiling / 1e12:.4f} T/s (64/SM/clock x {n_sm} SMs "
        f"x {sm_mhz:.0f} MHz max SM clock)"
    )
    del sift_pd, qi, rows_pd, ptile
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="velesdb_chip_smoke_")
    try:
        # -- 3. slice: SIFT-1M class through Database / Collection ------------
        t0 = time.perf_counter()
        db = Database.open(tmp, device=DEVICE)
        col = db.create_collection("sift1m", SIFT_D, metric="euclidean")
        col.upsert_bulk(
            range(sift.shape[0]), sift, [{"cat": i % 8} for i in range(sift.shape[0])]
        )
        say(f"sift1m ingest with payloads: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        col.refresh_device()
        torch.cuda.synchronize()
        say(f"sift1m device refresh (upload + pd shadow + ptile): {time.perf_counter() - t0:.2f} s")
        check(col.info()["serve_engine"] == "int8-assist-pd",
              f"serve_engine {col.info()['serve_engine']!r}, expected 'int8-assist-pd'")

        # the main path: launch counters from zero, and every launch's
        # arguments and result kept to be held against the plain version
        main_calls = []
        kernel = bk.sq8pd_bucket_gm

        def recorded(qi, rows_pd, ptile, chunk):
            gm = kernel(qi, rows_pd, ptile, chunk)
            main_calls.append((qi, rows_pd, ptile, chunk, gm))
            return gm

        bk.sq8pd_bucket_gm = recorded
        for key in bk.LAUNCHES:
            bk.LAUNCHES[key] = 0
        seen = 0

        def launched(what):
            nonlocal seen
            now = bk.LAUNCHES["sq8pd_bucket_gm"]
            check(now > seen, f"{what} did not launch the sq8pd_bucket kernel")
            seen = now

        res256 = col.search_batch(sift_q[:256], k=K)
        launched("search_batch b=256")
        res16 = col.search_batch(sift_q[256:272], k=K)
        launched("search_batch b=16")
        one = col.search(sift_q[300], k=K)
        launched("search")
        filt = {"type": "eq", "field": "cat", "value": 3}
        resf = col.search_batch(sift_q[:256], k=K, filter=filt)
        launched("filtered search_batch")
        main_launches = bk.LAUNCHES["sq8pd_bucket_gm"]
        bk.sq8pd_bucket_gm = kernel
        check(len(main_calls) == main_launches,
              f"{len(main_calls)} recorded calls for {main_launches} launches")
        for qi_m, rows_m, ptile_m, chunk_m, gm_m in main_calls:
            ref = bk.sq8pd_bucket_gm_ref(qi_m, rows_m, ptile_m, chunk_m)
            torch.cuda.synchronize()
            err = int((gm_m.long() - ref.long()).abs().max())
            label = (f"main-path launch, B_pad {qi_m.shape[0]}, N {rows_m.shape[0]}, "
                     f"D_pad {rows_m.shape[1]}, chunk {chunk_m}")
            check(torch.equal(gm_m, ref), f"{label}: kernel != plain version (max |err| {err})")
            print(f"kernel == plain, bit for bit: {label}", flush=True)
            max_err = max(max_err, err)
        del main_calls, ref

        corpus64 = torch.from_numpy(sift).to(dev).double()
        o_v, o_i = oracle_topk(torch, corpus64, sift_q[:301], "euclidean", K)
        rec256 = score_results(res256, o_v[:256], o_i[:256], 1e-4)
        rec16 = score_results(res16, o_v[256:272], o_i[256:272], 1e-4)
        rec1 = score_results([one], o_v[300:301], o_i[300:301], 1e-4)
        cat_mask = torch.from_numpy(np.arange(sift.shape[0]) % 8 == 3).to(dev)
        of_v, of_i = oracle_topk(torch, corpus64, sift_q[:256], "euclidean", K, cat_mask)
        recf = score_results(resf, of_v, of_i, 1e-4)
        bad = [h.id for row in resf for h in row if h.id % 8 != 3 or h.payload != {"cat": 3}]
        check(not bad, f"filtered search returned filtered-out ids {bad[:5]}")
        print(
            f"sift1m recall@10 vs float64 oracle: b=256 {rec256:.4f}, b=16 {rec16:.4f}, "
            f"search {rec1:.4f}, filtered b=256 {recf:.4f}",
            flush=True,
        )
        for name, r in (("b=256", rec256), ("b=16", rec16)):
            check(r >= 0.99, f"sift1m recall@10 {name} = {r:.4f} < 0.99")
        # one query and the 1/8-selective filter: sanity floors, not targets
        check(rec1 >= 0.9, f"sift1m single-query recall@10 = {rec1:.4f}")
        check(recf >= 0.9, f"sift1m filtered recall@10 = {recf:.4f}")
        del corpus64
        ids_before = [[h.id for h in row] for row in res256]
        db.close()
        db = Database.open(tmp, device=DEVICE)
        col = db.get_collection("sift1m")
        check(col.count() == sift.shape[0], f"reopened count {col.count()}")
        res_re = col.search_batch(sift_q[:256], k=K)
        ids_after = [[h.id for h in row] for row in res_re]
        check(
            all(set(a) == set(b) for a, b in zip(ids_before, ids_after)),
            "reopened collection returned other ids",
        )
        check(res_re[0][0].payload == {"cat": res_re[0][0].id % 8}, "payload lost on reopen")
        print("sift1m close + reopen: same ids for all 256 queries", flush=True)

        # -- 4. slice: 100K x 768D cosine (streamed scan) ---------------------
        rng = np.random.default_rng(42)
        c768_all = make_clustered(rng, C768_N + HELD_OUT, C768_D)
        c768, c768_q = c768_all[:C768_N], c768_all[C768_N:]
        col768 = db.create_collection("c768", C768_D, metric="cosine")
        col768.upsert_bulk(range(c768.shape[0]), c768)
        r768 = col768.search_batch(c768_q[:256], k=K)
        check(col768.info()["serve_engine"] == "streamed-scan",
              f"serve_engine {col768.info()['serve_engine']!r}, expected 'streamed-scan'")
        c64 = torch.from_numpy(c768).to(dev).double()
        c64 = c64 / c64.norm(dim=1, keepdim=True)
        o_v, o_i = oracle_topk(torch, c64, c768_q[:256], "cosine", K)
        rec768 = score_results(r768, o_v, o_i, 1e-4)
        print(f"100k-768d cosine recall@10 vs float64 oracle: b=256 {rec768:.4f}", flush=True)
        check(rec768 >= 0.999, f"100k-768d recall@10 = {rec768:.4f} < 0.999")
        del c64

        # -- 5. timing (CUDA events), then the profiler last --------------------
        def device_only(b):
            col._search_device(b, K, None)[1].cpu()

        device_path = "sift1m device path (no hydrate)"
        timed = {}
        for label, fn, queries in (
            ("sift1m search_batch", lambda b: col.search_batch(b, k=K), sift_q),
            (device_path, device_only, sift_q),
            ("100k-768d search_batch", lambda b: col768.search_batch(b, k=K), c768_q),
        ):
            for b in (256, 16):
                timed[label, b] = (fn, *report_qps(torch, label, fn, queries, b))
        for b in (256, 16):
            host = 1.0 - timed[device_path, b][1] / timed["sift1m search_batch", b][1]
            say(f"sift1m search_batch b={b}: host hydrate share {host:.3f}")
        for (label, b), (fn, med, batches) in timed.items():
            if label != device_path:
                report_busy(torch, f"{label} b={b}", fn, batches, med)
        db.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    say(f"peak device memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(json.dumps({"kernels": [{
        "name": "sq8pd_bucket",
        "route": "cuda",
        "source": "velesdb_tpu_torch/csrc/sq8pd_bucket.cu",
        "replaces": "velesdb_tpu/ops/bucket_kernel.py:695",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
