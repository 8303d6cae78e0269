#!/usr/bin/env python3
"""Worlds of ranks for the sharded engines (``velesdb_tpu_torch.parallel``),
and ``chip_smoke.py``'s phase 14 (sharded search on the card).

    python3 velesdb_tpu_torch/tools/sharded_phase.py     # from the root of a checkout; one card

:func:`start_world` spawns a ``torch.distributed`` world of N ranks, one
process each (``torch.multiprocessing`` with the spawn method and a
``file://`` rendezvous in a temporary directory), runs a list of jobs on
every rank in order and hands back each rank's results. The jobs are this
module's functions in :data:`JOBS`: a spawned rank imports this module
again, so it imports nothing but the port (no ``jax``). The CPU tests run
their worlds over gloo through it, and phase 14 runs its world of 4 over
gloo on the one card.

Phase 14 (:func:`sharded_phase`), alone through this script or from
``chip_smoke.py``: (a) a world of 1 over NCCL in this process on one
north-star shard (6,291,456 x 128 euclidean FULL, the assist mode, kernel
#7) beside the single-card ``sq8i_rerank_topk`` on the same arrays; (b)
the streamed mode on 100k-768d's shape and the SQ8 mode on sift1m's;
(c) ``ShardedIvfIndex`` and ``ShardedGraphIndex`` (kernel #10 as each
graph's entry scan) at world 1 on sift1m's rows; (d) a world of 4 ranks
over gloo on the one card on (a)'s rows split four ways, each rank reading
its rows from one memory-mapped ``.npy``.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

if __name__ == "__main__":  # run as a script: import this checkout's package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from velesdb_tpu_torch.index.params import GraphParams
from velesdb_tpu_torch.ops.quantization import StorageMode
from velesdb_tpu_torch.parallel import (
    ShardedBruteForce,
    ShardedGraphIndex,
    ShardedIvfIndex,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    segment_for_host,
    shard_rows,
    sharded_ingest_search_step,
    sharded_state_from_jax,
)
from velesdb_tpu_torch.parallel.multihost import dcn_sharded_search, make_global_rows, num_slices
from velesdb_tpu_torch.parallel.sharded import (
    _all_gather,
    _dp_queries,
    _global_result,
    _pack,
    n_row_shards,
    row_shard,
)

# the device of this rank's shards (set in each spawned rank)
DEVICE = ["cpu"]


# -- worlds ---------------------------------------------------------------------


class World:
    """A running world: :meth:`results` waits for it and returns, for each
    job, the list of every rank's result (rank order)."""

    def __init__(self, ctx, tmp: str, world: int, n_jobs: int):
        self.ctx, self.tmp, self.world, self.n_jobs = ctx, tmp, world, n_jobs

    def results(self, timeout: float = 600.0) -> list[list]:
        deadline = time.monotonic() + timeout
        try:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    raise TimeoutError(f"world of {self.world} still running after {timeout} s")
            outs = []
            for r in range(self.world):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    outs.append(pickle.load(f))
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        return [[outs[r][j] for r in range(self.world)] for j in range(self.n_jobs)]


def start_world(world: int, jobs, *, backend: str = "gloo", device: str = "cpu",
                threads: int = 2) -> World:
    """Spawn ``world`` ranks that each run ``jobs`` (``[(name, kwargs)]``,
    names of :data:`JOBS`) in order on ``device`` (``torch.set_num_threads(
    threads)`` each), and return at once."""
    tmp = tempfile.mkdtemp(prefix="velesdb_world_")
    with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
        pickle.dump(list(jobs), f)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(world, tmp, backend, device, threads), nprocs=world, join=False,
        daemon=True, start_method="spawn")
    return World(ctx, tmp, world, len(jobs))


def run_world(world: int, jobs, **kw) -> list[list]:
    return start_world(world, jobs, **kw).results()


def run_worlds(jobs: dict, meanwhile, timeout: float = 900.0):
    """``jobs`` (world size -> job list) one world at a time, the largest
    first, while ``meanwhile()`` runs here; each rank on one thread (the
    CPU tests share their machine). Returns ``({world: results}, the value
    of meanwhile())``."""
    order = sorted(jobs, reverse=True)
    first = start_world(order[0], jobs[order[0]], threads=1)
    extra = meanwhile()
    out = {order[0]: first.results(timeout)}
    for w in order[1:]:
        out[w] = start_world(w, jobs[w], threads=1).results(timeout)
    return out, extra


def _rank_main(rank: int, world: int, tmp: str, backend: str, device: str, threads: int):
    torch.set_num_threads(threads)
    DEVICE[0] = device
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        with open(os.path.join(tmp, "jobs.pkl"), "rb") as f:
            jobs = pickle.load(f)
        out = [JOBS[name](**kw) for name, kw in jobs]
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".part", path)
    finally:
        dist.destroy_process_group()


# -- jobs (each rank runs the same job; results are numpy) -------------------------


def _shard_info(mesh) -> dict:
    return {"shard": row_shard(mesh), "shards": n_row_shards(mesh), "coords": mesh.coords}


def job_brute(*, dp, dim, metric, corpus, queries, k, storage_mode="full", valid=None,
              mask=None, chunk=65536, serves=()):
    """``ShardedBruteForce`` rebuilt on ``corpus`` and searched (and, with a
    mask, searched again under it); ``serves``: the ``(b_pad, k)`` pairs to
    ask the assist guard about."""
    mesh = make_mesh(dp=dp, device=DEVICE[0])
    idx = ShardedBruteForce(mesh, dim, metric, storage_mode=storage_mode)
    idx.rebuild(corpus, valid)
    out = {"search": idx.search(queries, k, chunk=chunk), "n_local": idx.n_local,
           "n_pad": idx.n_pad, "assist": idx._assist is not None,
           "serves": [idx._assist_serves(b, kk) for b, kk in serves], **_shard_info(mesh)}
    if mask is not None:
        out["masked"] = idx.search(queries, k, mask=mask, chunk=chunk)
    if idx._assist is not None:  # this shard's shadow, for the layout checks
        out["shadow"] = tuple(t.cpu().numpy() for t in idx._assist)
    elif storage_mode == "sq8":
        out["shadow"] = tuple(t.cpu().numpy() for t in (idx._codes, idx._scale, idx._minv,
                                                        idx._cnorm))
    return out


def job_shard_rows(*, dp, array, pad_value=0):
    mesh = make_mesh(dp=dp, device=DEVICE[0])
    return {"local": shard_rows(mesh, array, pad_value).cpu().numpy(), **_shard_info(mesh)}


def job_ingest(*, dp, dim, metric, n, steps, queries, k):
    """``sharded_ingest_search_step`` over zero shards: ``steps`` is
    ``[(rows, write_pos)]``; returns every step's search and the shard's
    validity after the last."""
    mesh = make_mesh(dp=dp, device=DEVICE[0])
    step = sharded_ingest_search_step(mesh, dim, metric)
    corpus = shard_rows(mesh, np.zeros((n, dim), np.float32))
    valid = shard_rows(mesh, np.zeros(n, bool))
    ptr = corpus.data_ptr()
    found = []
    for rows, pos in steps:
        corpus, valid, vals, ids = step(corpus, valid, rows, np.array([pos], np.int32),
                                        queries, k=k)
        found.append((vals, ids))
    return {"found": found, "valid": valid.cpu().numpy(), "in_place": corpus.data_ptr() == ptr,
            **_shard_info(mesh)}


def _mesh(dp, hybrid, slices):
    """A ``(dp, rows)`` mesh, or with ``hybrid`` a ``(dcn, dp, rows)`` one
    over ``slices`` (default: the hosts)."""
    if hybrid:
        return make_hybrid_mesh(dp=dp, device=DEVICE[0], slices=slices)
    return make_mesh(dp=dp, device=DEVICE[0])


def job_ivf(*, dp, dim, metric, corpus, queries, k, n_clusters=None, nprobes=(None,),
            hybrid=False, slices=None):
    mesh = _mesh(dp, hybrid, slices)
    idx = ShardedIvfIndex(mesh, dim, metric, n_clusters=n_clusters)
    idx.build(corpus)
    found = [idx.search(queries, k, nprobe=p) for p in nprobes]
    return {"found": found, "c_local": idx.c_local, "part_len": idx.part_len,
            "n_shards": idx.n_shards, **_shard_info(mesh)}


def job_graph(*, dp, dim, metric, corpus, queries, k, params=None, ef=128,
              entry_modes=(None,), hybrid=False, slices=None):
    mesh = _mesh(dp, hybrid, slices)
    idx = ShardedGraphIndex(mesh, dim, metric,
                            params=None if params is None else GraphParams(**params))
    idx.build(corpus)
    found = [idx.search(queries, k, ef=ef, entry_mode=m) for m in entry_modes]
    return {"found": found, "entry": idx._entry is not None,
            "entry_kern": idx._entry_kern is not None, "n_shards": idx.n_shards,
            **_shard_info(mesh)}


def job_carried(*, dp, arrays, queries, k, searches=({},)):
    """A reference engine's state (``parallel.carried.reference_arrays``)
    as this rank's shard, then ``search(queries, k, **kw)`` for each ``kw``
    of ``searches``."""
    mesh = make_mesh(dp=dp, device=DEVICE[0])
    eng = sharded_state_from_jax(arrays, row_shard(mesh), n_row_shards(mesh), mesh.device)
    eng.mesh = mesh
    return {"found": [eng.search(queries, k, **kw) for kw in searches], **_shard_info(mesh)}


def job_dcn(*, dp, corpus, queries, k, metric, slices=None):
    """``dcn_sharded_search`` over ``make_global_rows`` shards of a hybrid
    mesh (``slices`` hosts; default: the hosts the ranks run on)."""
    mesh = make_hybrid_mesh(dp=dp, device=DEVICE[0], slices=slices)
    n = corpus.shape[0]
    sqn = np.sum(corpus * corpus, axis=1).astype(np.float32)
    c = make_global_rows(mesh, lambda s, e: corpus[s:e], n, row_shape=(corpus.shape[1],))
    v = make_global_rows(mesh, lambda s, e: np.ones(e - s, bool), n, dtype=bool)
    cn = make_global_rows(mesh, lambda s, e: sqn[s:e], n)
    return {"search": dcn_sharded_search(mesh, queries, c, v, cn, k=k, metric=metric),
            "shape": dict(mesh.shape), **_shard_info(mesh)}


def job_helpers(*, dp):
    """The multi-host helpers inside a world started by the caller."""
    adopted = init_distributed()
    mesh = make_hybrid_mesh(dp=dp, device=DEVICE[0])
    return {"adopted": adopted, "slices": num_slices(), "shape": dict(mesh.shape),
            "segment": segment_for_host(103), **_shard_info(mesh)}


JOBS = {
    "brute": job_brute,
    "shard_rows": job_shard_rows,
    "ingest": job_ingest,
    "ivf": job_ivf,
    "graph": job_graph,
    "carried": job_carried,
    "dcn": job_dcn,
    "helpers": job_helpers,
}


# -- phase 14 on the card ------------------------------------------------------

# the reference's north-star shard: 50M rows over 8 chips (tests/test_sharded.py:268)
NS_ROWS, NS_D = 6_291_456, 128
NS_QUERIES = 1024  # held-out rows after the corpus
TIMED = 40  # host-clock calls a p50 (30 calls would make p99 a maximum)
WORLD_TIMED = 20  # a rank of the world of 4 shares the card: its times are printed only
STREAM_K = 300  # past the assist's oversample (m <= 256): the streamed mode serves
IVF_EF = 128
LIBS = ("sq8i_bucket", "ivf_probe")


def _chip_smoke():
    """``chip_smoke.py`` of this checkout, loaded by path (its helpers:
    checks, oracle, launch records, data)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _hold_calls(calls, plain) -> int:
    """Each recorded launch against the plain version on its own arguments,
    bit for bit (raises otherwise); returns how many were held."""
    for args, kwargs, out in calls:
        ref = plain(*args, **kwargs)
        for g, r in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            if g.shape != r.shape or g.dtype != r.dtype or not bool((g == r).all()):
                raise AssertionError(f"{plain.__name__}: a launch differs from the plain version")
    return len(calls)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _p50_ms(fn, calls: int) -> float:
    """Median host-clock milliseconds of ``fn()`` (which reads its result
    back, so the card is done), after three warm-up calls."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def _stages(seconds: dict) -> str:
    """A graph build's top-level stages (knn, prune, assemble, upload)."""
    return ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items() if "." not in k)


def _same_up_to_ties(got, want) -> bool:
    """Equal values and ids, but for the order of ids whose values tie
    exactly: the merge breaks a tie to the lower shard, where one shard's
    select had it by its score before the distance's square root."""
    (gv, gi), (wv, wi) = got, want
    if not np.array_equal(gv, wv):
        return False
    for v, a, b in zip(wv, gi, wi):
        for val in np.unique(v):
            at = v == val
            if set(a[at].tolist()) != set(b[at].tolist()):
                return False
    return True


def _recall(ids, oracle) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / oracle.shape[1]
                          for a, b in zip(ids, oracle)]))


def job_card_world(*, path, queries, k, stream_k, timed):
    """Phase 14 (d), on each rank of a gloo world sharing one card: the
    rank's rows of the memory-mapped ``.npy`` as an assist shard and a graph
    shard; every #7 and #10 launch held against its plain version here."""
    from velesdb_tpu_torch.ops import bucket_kernel as bk
    from velesdb_tpu_torch.ops import ivf_kernel as ik

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(device=DEVICE[0])
    corpus = np.load(path, mmap_mode="r")
    out = {"shard": row_shard(mesh), "backend": mesh.backend, "device": str(mesh.device)}
    t0 = time.perf_counter()
    idx = ShardedBruteForce(mesh, corpus.shape[1], "euclidean")
    idx.rebuild(corpus)
    _sync(mesh.device)
    out["rebuild_s"], out["n_local"] = time.perf_counter() - t0, idx.n_local
    if idx._assist is None or not idx._assist_serves(256, k):
        raise AssertionError("the world of 4's shards do not serve the assist mode")
    before = bk.LAUNCHES["sq8i_bucket_gm"]
    with _chip_smoke().Recorder([(bk, "sq8i_bucket_gm")]) as rec:
        out["assist256"] = idx.search(queries[:256], k)
        out["assist16"] = [idx.search(queries[i : i + 16], k) for i in range(0, 256, 16)]
    out["sq8i_launches"] = bk.LAUNCHES["sq8i_bucket_gm"] - before
    out["sq8i_held"] = _hold_calls(rec.take("sq8i_bucket_gm"), bk.sq8i_bucket_ref)
    out["assist_p50"] = {b: _p50_ms(lambda b=b: idx.search(queries[:b], k), timed)
                         for b in (256, 16)}
    out["streamed"] = idx.search(queries[:16], stream_k)
    del idx
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = ShardedGraphIndex(mesh, corpus.shape[1], "euclidean")
    g.build(corpus)
    _sync(mesh.device)
    out["graph_build_s"], out["graph_stages"] = time.perf_counter() - t0, g.build_seconds
    before = ik.LAUNCHES["ivf_probe"]
    with _chip_smoke().Recorder([(ik, "ivf_probe_scores")]) as rec:
        out["graph16"] = [g.search(queries[i : i + 16], k, ef=IVF_EF) for i in range(0, 256, 16)]
    out["probe_launches"] = ik.LAUNCHES["ivf_probe"] - before
    out["probe_held"] = _hold_calls(rec.take("ivf_probe_scores"), ik.ivf_probe_ref)
    out["graph_p50"] = _p50_ms(lambda: g.search(queries[:16], k, ef=IVF_EF), timed)
    return out


JOBS["card_world"] = job_card_world


def sharded_phase(cs, counters, launches, errs, device: str = "cuda", north_star=None,
                  sift=None):
    """Phase 14: (a), (b) and (c) of the module docstring, then (d) started,
    with ``cs`` the ``chip_smoke`` module (its checks, oracle, launch records
    and data). ``north_star`` is (a)'s ``make_clustered`` rows and held-out
    queries if the caller made them (``chip_smoke.py`` makes them while
    ``nvcc`` builds), ``sift`` sift1m's ``(rows, queries)``; else both are
    made here. ``launches`` / ``errs`` gain #7's (``sq8i_bucket``) and #10's
    (``ivf_probe``) main-path launches. ``device="cpu"`` rehearses the phase
    through the plain versions (with smaller module sizes).

    Returns ``finish()``, which waits for (d), the world of 4, checks it and
    adds its launches: the caller may run host-bound work meanwhile
    (``chip_smoke.py``: phase 3's ingest), none that it times on the card."""
    from velesdb_tpu_torch.ops import bucket_kernel as bk
    from velesdb_tpu_torch.ops import ivf_kernel as ik
    from velesdb_tpu_torch.ops.distance import DistanceMetric
    from velesdb_tpu_torch.ops.quantization import SQ8Vectors
    from velesdb_tpu_torch.ops.streamed import sq8_streamed_topk, streamed_topk

    check, say, K = cs.check, cs.say, cs.K
    mesh = make_mesh(device=device)
    dev = mesh.device
    t_phase = time.perf_counter()

    # -- (a) a world of 1 over NCCL on one north-star shard ------------------------
    t0 = time.perf_counter()
    data = north_star
    if data is None:
        data = cs.make_clustered(np.random.default_rng(42), NS_ROWS + NS_QUERIES, NS_D)
    corpus, held = data[:NS_ROWS], data[NS_ROWS:]
    say(f"sharded (a) data: {NS_ROWS:,} x {NS_D} make_clustered (seed 42): "
        f"{time.perf_counter() - t0:.2f} s here" + (" (made while nvcc built)"
                                                    if north_star is not None else ""))
    want = "nccl" if dev.type == "cuda" else "gloo"
    check(dist.get_world_size() == 1 and dist.get_backend() == want,
          f"make_mesh(): world {dist.get_world_size()} over {dist.get_backend()}, "
          f"expected a world of 1 over {want}")
    t0 = time.perf_counter()
    idx = ShardedBruteForce(mesh, NS_D, "euclidean")
    idx.rebuild(corpus)
    _sync(dev)
    say(f"sharded (a) world of 1, {mesh}: rebuild {time.perf_counter() - t0:.2f} s "
        f"(n_local {idx.n_local:,}; f32 rows {idx._corpus.numel() * 4 / 1e9:.2f} GB, int8 "
        f"shadow {idx._assist[0].numel() / 1e9:.2f} GB)")
    check(idx._assist is not None and idx._assist_serves(256, K) and idx._assist_serves(16, K),
          "sharded (a): the north-star shard does not serve the assist mode")
    c64 = torch.from_numpy(corpus).to(dev).double()
    o_v, o_i = cs.oracle_topk(torch, c64, held[:256], "euclidean", K)
    del c64
    torch.cuda.empty_cache()
    with cs.MainPath(counters, bk, "sq8i_bucket_gm", "sq8i_bucket_gm") as run:
        v256, i256 = idx.search(held[:256], K)
        run.launched("sharded assist b=256")
        found16 = []
        for i in range(0, 256, 16):
            found16.append(idx.search(held[i : i + 16], K))
            run.launched(f"sharded assist b=16 (queries {i}-{i + 15})")
    n_launch = run.launches()
    launches["sq8i_bucket"] += n_launch
    desc = (lambda qi, rows, *rest: f"sq8i_bucket B_pad {qi.shape[0]}, N {rows.shape[0]}, "
            f"D_pad {rows.shape[1]}, chunk {rest[-1]} (sharded assist)")
    errs["sq8i_bucket"] = max(errs["sq8i_bucket"], run.hold_all(bk.sq8i_bucket_ref, desc))
    say(f"sharded (a): {n_launch} launches of #7 on the main path, each equal to its plain "
        f"version bit for bit")
    rows8, scale2, minv2, pen = idx._assist

    def single(q):
        v, i = bk.sq8i_rerank_topk(torch.from_numpy(q).to(dev), rows8, scale2, minv2, pen,
                                   idx._corpus, k=K, m=16, metric="euclidean",
                                   chunk=idx._assist_chunk_for())
        return v.cpu().numpy(), i.cpu().numpy()

    for (sv, si), (v, i), what in ((single(held[:256]), (v256, i256), "b=256"),
                                   (single(held[:16]), found16[0], "b=16")):
        check(np.array_equal(si, i) and np.array_equal(sv, v),
              f"sharded (a) {what}: ids or values differ from the single-card sq8i_rerank_topk")
    r256 = _recall(i256, o_i)
    r16 = _recall(np.concatenate([f[1] for f in found16]), o_i)
    print(f"sharded (a) recall@10 vs float64 oracle: b=256 {r256:.4f}, b=16 over 256 queries "
          f"{r16:.4f}; ids and values equal the single-card sq8i_rerank_topk  [{cs.CARD}]",
          flush=True)
    check(min(r256, r16) >= 0.99, f"sharded (a) recall@10 {r256:.4f} / {r16:.4f} < 0.99")
    for b in (256, 16):
        ms_s = _p50_ms(lambda b=b: idx.search(held[:b], K), TIMED)
        ms_1 = _p50_ms(lambda b=b: single(held[:b]), TIMED)
        say(f"sharded (a) b={b}: sharded search p50 {ms_s:.4f} ms, single-card sq8i_rerank_topk "
            f"p50 {ms_1:.4f} ms ({TIMED} calls each, host clock, results read back): the "
            f"distributed layer {ms_s - ms_1:+.4f} ms")
        # the layer in parts, on one search's partials left on the card
        lv, li = bk.sq8i_rerank_topk(_dp_queries(mesh, held[:b], b), rows8, scale2, minv2, pen,
                                     idx._corpus, k=K, m=16, metric="euclidean",
                                     chunk=idx._assist_chunk_for())
        parts = {
            "merge, dp gather and read back": lambda: _global_result(mesh, lv, li, K, False, b),
            "one all_gather and read back": lambda: _all_gather(
                mesh, ("rows",), _pack(lv, li)).cpu(),
            "read back alone": lambda: (lv.cpu(), li.cpu()),
            "the queries' pad, slice and copy": lambda: _dp_queries(mesh, held[:b], b).cpu(),
        }
        say(f"sharded (a) b={b}, the layer's parts, p50 over {TIMED} calls: " + ", ".join(
            f"{what} {_p50_ms(fn, TIMED):.4f} ms" for what, fn in parts.items()))
    qi, _, sqi, invqs, _ = bk._sq8i_quantize_queries(torch.from_numpy(held[:256]).to(dev),
                                                     DistanceMetric.EUCLIDEAN, 128)
    am = 128.0 * scale2 + minv2
    ms = cs.time_kernel(torch, lambda: bk.sq8i_bucket_gm(qi, rows8, scale2, am, pen, sqi, invqs,
                                                         idx._assist_chunk_for()))
    n = idx.n_local
    least, by = cs.bound(cs.int8_ops_ms(256, n, 128, 6),
                         256 * 128 + n * 128 + 12 * n + 8 * 256 + 8 * 256 * n // 8192 * 128)
    say(f"sharded (a) #7 at B_pad 256, N {n:,}, D_pad 128: {ms:.4f} ms, bound {least:.4f} ms "
        f"({by}; {least / ms:.4f} of it)")
    check(not idx._assist_serves(16, STREAM_K), "k 300 should pass the assist guard by")
    world1_streamed = idx.search(held[:16], STREAM_K)
    say(f"sharded (a) streamed mode at k {STREAM_K}, b=16 (past the assist's oversample): "
        f"p50 {_p50_ms(lambda: idx.search(held[:16], STREAM_K), 10):.4f} ms over 10 calls")
    del idx, rows8, scale2, minv2, pen, am, qi
    torch.cuda.empty_cache()

    # -- (b) the streamed and SQ8 modes -------------------------------------------------
    c768 = cs.make_clustered(np.random.default_rng(42), cs.C768_N + NS_QUERIES, cs.C768_D)
    c768, q768 = c768[: cs.C768_N], c768[cs.C768_N :]
    st = ShardedBruteForce(mesh, cs.C768_D, "cosine")
    st.rebuild(c768)
    check(st._assist is None, "sharded (b): D 768 built an assist shadow")
    for b in (256, 16):
        v, i = st.search(q768[:b], K)
        sv, si = streamed_topk(torch.from_numpy(q768[:b]).to(dev), st._corpus, valid=st._valid,
                               k=K, metric="cosine", chunk=65536, corpus_sqnorm=st._cnorm)
        check(np.array_equal(si.cpu().numpy(), i) and np.array_equal(sv.cpu().numpy(), v),
              f"sharded (b) streamed b={b}: differs from the single-card streamed_topk")
    o768 = cs.oracle_topk(torch, cs.unit64(torch, c768, dev), q768[:256], "cosine", K)[1]
    say(f"sharded (b) streamed, {cs.C768_N:,} x {cs.C768_D} cosine: ids and values equal the "
        f"single-card streamed_topk at b=256 and 16; recall@10 b=256 "
        f"{_recall(st.search(q768[:256], K)[1], o768):.4f}; p50 b=256 "
        f"{_p50_ms(lambda: st.search(q768[:256], K), 10):.4f} ms, b=16 "
        f"{_p50_ms(lambda: st.search(q768[:16], K), 10):.4f} ms (10 calls)")
    del st, c768
    if sift is None:
        sift = cs.make_clustered(np.random.default_rng(42), cs.SIFT_N + cs.HELD_OUT, cs.SIFT_D)
        sift = sift[: cs.SIFT_N], sift[cs.SIFT_N :]
    sift, sift_q = sift
    sq = ShardedBruteForce(mesh, cs.SIFT_D, "euclidean", storage_mode=StorageMode.SQ8)
    sq.rebuild(sift)
    for b in (256, 16):
        v, i = sq.search(sift_q[:b], K)
        sv, si = sq8_streamed_topk(torch.from_numpy(sift_q[:b]).to(dev),
                                   SQ8Vectors(sq._codes, sq._scale, sq._minv), cnorm=sq._cnorm,
                                   valid=sq._valid, k=K, metric="euclidean", chunk=65536)
        check(np.array_equal(si.cpu().numpy(), i) and np.array_equal(sv.cpu().numpy(), v),
              f"sharded (b) SQ8 b={b}: differs from the single-card sq8_streamed_topk")
    s64 = torch.from_numpy(sift).to(dev).double()
    so_i = cs.oracle_topk(torch, s64, sift_q[:256], "euclidean", K)[1]
    del s64
    say(f"sharded (b) SQ8, {cs.SIFT_N:,} x {cs.SIFT_D} euclidean: ids and values equal the "
        f"single-card sq8_streamed_topk at b=256 and 16; recall@10 of the codes b=256 "
        f"{_recall(sq.search(sift_q[:256], K)[1], so_i):.4f} (no rerank); p50 b=256 "
        f"{_p50_ms(lambda: sq.search(sift_q[:256], K), 10):.4f} ms (10 calls)")
    del sq
    torch.cuda.empty_cache()

    # -- (c) ShardedIvfIndex and ShardedGraphIndex at world 1 on sift1m's rows ------------
    t0 = time.perf_counter()
    iv = ShardedIvfIndex(mesh, cs.SIFT_D, "euclidean")
    iv.build(sift)
    _sync(dev)
    build_ivf = time.perf_counter() - t0
    # the reference's sharded rule probes ceil(ef * 8 / L) partitions (TPU
    # shards of few rows); the single-card IvfIndex probes ef/3700 of the rows
    ref_probes = max(2, min(-(-IVF_EF * 8 // iv.part_len), iv.c_local))
    cov_probes = min(max(-(-int(IVF_EF / 3700.0 * cs.SIFT_N) // iv.part_len), 2), iv.c_local)
    rec = {}
    for p in (ref_probes, cov_probes):
        ids = np.concatenate([iv.search(sift_q[i : i + 16], K, nprobe=p)[1]
                              for i in range(0, 256, 16)])
        rec[p] = _recall(ids, so_i)
    say(f"sharded (c) ShardedIvfIndex build {build_ivf:.2f} s ({iv.c_local} partitions of "
        f"{iv.part_len}); recall@10 b=16 over 256 queries: the reference's ef {IVF_EF} rule "
        f"(nprobe {ref_probes}) {rec[ref_probes]:.4f}, the single-card coverage rule at ef "
        f"{IVF_EF} (nprobe {cov_probes}) {rec[cov_probes]:.4f}; p50 b=16 "
        f"{_p50_ms(lambda: iv.search(sift_q[:16], K, nprobe=cov_probes), 10):.4f} ms")
    check(rec[cov_probes] >= 0.95, f"sharded (c) IVF recall@10 {rec[cov_probes]:.4f} < 0.95")
    del iv
    t0 = time.perf_counter()
    g = ShardedGraphIndex(mesh, cs.SIFT_D, "euclidean")
    g.build(sift)
    _sync(dev)
    say(f"sharded (c) ShardedGraphIndex build {time.perf_counter() - t0:.2f} s (not saved): "
        f"{_stages(g.build_seconds)}")
    check(g._entry_kern is not None, "sharded (c): the graph has no entry IVF")
    with cs.MainPath(counters, ik, "ivf_probe_scores", "ivf_probe") as run:
        ids = []
        for i in range(0, 256, 16):
            ids.append(g.search(sift_q[i : i + 16], K, ef=IVF_EF)[1])
            run.launched(f"sharded graph b=16 (queries {i}-{i + 15})")
    n_probe = run.launches()
    launches["ivf_probe"] += n_probe
    errs["ivf_probe"] = max(errs["ivf_probe"], run.hold_all(
        ik.ivf_probe_ref, lambda q, qsum, probe, rows, aux: (
            f"ivf_probe sq8 B {q.shape[0]}, nprobe {probe.shape[1]}, L {rows.shape[1]} "
            f"(sharded graph entry)")))
    rg = _recall(np.concatenate(ids), so_i)
    say(f"sharded (c) graph: {n_probe} launches of #10, each equal to its plain version bit for "
        f"bit; recall@10 b=16 ef {IVF_EF} over 256 queries {rg:.4f}; p50 b=16 "
        f"{_p50_ms(lambda: g.search(sift_q[:16], K, ef=IVF_EF), 10):.4f} ms")
    check(rg >= 0.95, f"sharded (c) graph recall@10 {rg:.4f} < 0.95")
    del g, sift
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # -- (d) a world of 4 ranks over gloo on this one card -------------------------
    if dev.type == "cuda":
        say(f"sharded (d) this process holds {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
            f"({torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved) beside the world of 4")
    tmp = tempfile.mkdtemp(prefix="velesdb_sharded_")
    t0 = time.perf_counter()
    path = os.path.join(tmp, "corpus.npy")
    np.save(path, corpus)
    del data, corpus
    say(f"sharded (d) wrote the {NS_ROWS:,}-row .npy: {time.perf_counter() - t0:.2f} s")
    t_world = time.perf_counter()
    world = start_world(4, [("card_world", dict(path=path, queries=held[:256], k=K,
                                                stream_k=STREAM_K, timed=WORLD_TIMED))],
                        backend="gloo", device=device)
    seconds = time.perf_counter() - t_phase
    say(f"phase 14 sharded: {seconds:.1f} s, its world of 4 started")

    def finish() -> None:
        t_wait = time.perf_counter()
        try:
            per_rank = world.results()[0]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        wall = time.perf_counter() - t_world
        r0 = per_rank[0]
        check(sorted(r["shard"] for r in per_rank) == [0, 1, 2, 3] and r0["backend"] == "gloo",
              "sharded (d): the world of 4 is not four gloo shards")
        for r in per_rank[1:]:
            for key in ("assist256", "streamed"):
                check(np.array_equal(r[key][1], r0[key][1]),
                      f"sharded (d): ranks disagree on {key}")
        check(_same_up_to_ties(r0["streamed"], world1_streamed),
              f"sharded (d): the streamed mode's ids (k {STREAM_K}, b=16) differ from world 1's")
        a256 = _recall(r0["assist256"][1], o_i)
        a16 = _recall(np.concatenate([f[1] for f in r0["assist16"]]), o_i)
        g16 = _recall(np.concatenate([f[1] for f in r0["graph16"]]), o_i)
        sq8i_n = sum(r["sq8i_launches"] for r in per_rank)
        probe_n = sum(r["probe_launches"] for r in per_rank)
        check(all(r["sq8i_held"] == r["sq8i_launches"] > 0
                  and r["probe_held"] == r["probe_launches"] > 0 for r in per_rank),
              "sharded (d): a rank launched no kernel, or held fewer")
        launches["sq8i_bucket"] += sq8i_n
        launches["ivf_probe"] += probe_n
        print(f"sharded (d) world of 4 over gloo on one card ({wall:.1f} s with the spawn): "
              f"recall@10 assist b=256 {a256:.4f}, b=16 {a16:.4f}, graph b=16 ef {IVF_EF} "
              f"{g16:.4f}; the streamed mode's ids (k {STREAM_K}) equal world 1's; {sq8i_n} #7 "
              f"and {probe_n} #10 launches over the ranks, each equal to its plain version bit "
              f"for bit  [{cs.CARD}]", flush=True)
        for r in per_rank:
            print(f"sharded (d) rank shard {r['shard']}: rebuild {r['rebuild_s']:.2f} s, graph "
                  f"build {r['graph_build_s']:.2f} s ({_stages(r['graph_stages'])}), p50 assist "
                  f"b=256 {r['assist_p50'][256]:.4f} / b=16 {r['assist_p50'][16]:.4f} ms, graph "
                  f"b=16 {r['graph_p50']:.4f} ms (four ranks share the card: no claim)",
                  flush=True)
        check(min(a256, a16) >= 0.99,
              f"sharded (d) assist recall@10 {a256:.4f} / {a16:.4f} < 0.99")
        check(g16 >= 0.95, f"sharded (d) graph recall@10 {g16:.4f} < 0.95")
        say(f"phase 14 sharded: (d) waited {time.perf_counter() - t_wait:.1f} s after "
            f"the phase's {seconds:.1f} s")

    return finish


def main() -> None:
    import subprocess

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("this tool needs an NVIDIA GPU")
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(cs.CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from velesdb_tpu_torch.ops import _cuda, bucket_kernel as bk, ivf_kernel as ik

    t0 = time.perf_counter()
    _cuda.build_all(LIBS)
    cs.say(f"build {', '.join(LIBS)} {time.perf_counter() - t0:.2f} s")
    launches, errs = {"sq8i_bucket": 0, "ivf_probe": 0}, {"sq8i_bucket": 0.0, "ivf_probe": 0.0}
    sharded_phase(cs, (bk.LAUNCHES, ik.LAUNCHES), launches, errs)()
    print(f"#7 launches {launches['sq8i_bucket']}, #10 launches {launches['ivf_probe']}, each "
          f"equal to its plain version", flush=True)


if __name__ == "__main__":
    main()
