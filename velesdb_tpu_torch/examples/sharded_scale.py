"""Multi-device scale-out: the 50M x 768D configuration on the port.

The port's copy of ``examples/sharded_scale.py``. The BASELINE.json
north-star config, 50M x 768D sharded over the devices of a world with a
gathered top-k merge, maps onto ``velesdb_tpu_torch.parallel`` like this:

- memory: 50M x 768 x 4B = 153.6GB of f32 vectors, over 8 cards of 80GB
  19.2GB a card in f32 (or bf16 / SQ8 for less); per-shard rows = 6.25M.
- world: one rank per card (``torch.distributed``, NCCL on the card, gloo on
  the CPU); ``make_mesh()`` -> (dp=1, rows=world): every rank owns a
  contiguous row shard, queries replicate over ``dp``.
- search: each rank scans only ITS rows, then the tiny [B, k] partials are
  all-gathered and selected again. Per-rank work is 1/world of the corpus.
- ANN at that scale: ``ShardedGraphIndex`` builds an independent graph per
  shard; or per-shard IVF for the small-batch regime.

The steps are the reference's at its laptop scale (80,000 x 768): exact
search, graph ANN on 16,000 rows, SQ8, and the multi-host search over a
``(dcn, dp, rows)`` mesh. Run: ``python -m
velesdb_tpu_torch.examples.sharded_scale`` (a world of 1 on the card;
``--world N`` spawns N ranks on ``localhost``; ``--device cpu`` runs them
over gloo on the CPU). A caller that has started a process group already
runs :func:`run` in each of its ranks.
"""

from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist

from velesdb_tpu_torch.examples import device_args
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.parallel import ShardedBruteForce, ShardedGraphIndex, make_mesh
from velesdb_tpu_torch.parallel.multihost import (
    dcn_sharded_search,
    make_global_rows,
    make_hybrid_mesh,
)

N, D, B, K = 80_000, 768, 32, 10  # scale N to 50_000_000 over 8 cards


def run(device: str = "cuda") -> dict:
    """The example's steps in this rank of the world (started here as a
    world of 1 if none is); rank 0 prints. Returns the results."""
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    picks = rng.integers(0, N, B)
    queries = corpus[picks] + 0.01 * rng.standard_normal((B, D)).astype(np.float32)
    mesh = make_mesh(device=device)  # (dp=1, rows=world)
    world = dist.get_world_size()
    say = print if dist.get_rank() == 0 else (lambda *a, **kw: None)
    say(f"mesh: {mesh.shape} over {world} ranks ({mesh.backend}, {mesh.device.type})")

    exact = ShardedBruteForce(mesh, D, DistanceMetric.COSINE)
    exact.rebuild(corpus)
    vals, rows = exact.search(queries, K)
    say("sharded exact top-1 correct:", (rows[:, 0] == np.sort(rows[:, 0])).size == B)

    ann = ShardedGraphIndex(mesh, D, DistanceMetric.COSINE)
    ann.build(corpus[:16_000])  # ANN demo on a slice (build is the slow part)
    avals, arows = ann.search(queries, K, ef=128)
    say("sharded ANN shapes:", arows.shape)

    # SQ8 shard mode: the capacity answer for the 50M north star, a quarter
    # of the f32 bytes a card
    sq8 = ShardedBruteForce(mesh, D, DistanceMetric.COSINE, storage_mode="sq8")
    sq8.rebuild(corpus)
    qvals, qrows = sq8.search(queries, K)
    agree = float(np.mean(qrows[:, 0] == rows[:, 0]))
    say(f"sharded SQ8 top-1 agreement with f32: {agree:.2f}")

    # the multi-host tier: the same search over a (dcn, dp, rows) hybrid
    # mesh; on one host dcn=1, across hosts the gather spans them unchanged
    hmesh = make_hybrid_mesh(dp=1, device=device)
    n_pad = -(-N // world) * world
    sqn = np.sum(corpus * corpus, axis=1).astype(np.float32)
    pad = lambda a: np.pad(a, [(0, n_pad - N)] + [(0, 0)] * (a.ndim - 1))  # noqa: E731
    cg = make_global_rows(hmesh, lambda s, e: pad(corpus)[s:e], n_pad, row_shape=(D,))
    vg = make_global_rows(hmesh, lambda s, e: (np.arange(s, e) < N), n_pad, dtype=bool)
    ng = make_global_rows(hmesh, lambda s, e: pad(sqn)[s:e], n_pad)
    dvals, drows = dcn_sharded_search(hmesh, queries, cg, vg, ng, k=K,
                                      metric=DistanceMetric.COSINE)
    dcn_agree = float(np.mean(np.asarray(drows)[:, 0] == rows[:, 0]))
    say("dcn-tier top-1 agreement:", dcn_agree)
    say("done: the same code over a world of 8 cards (or of several hosts) serves the 50M "
        "corpus")
    return {"picks": picks, "rows": rows, "vals": vals, "ann_rows": arows, "sq8_rows": qrows,
            "sq8_agree": agree, "dcn_rows": drows, "dcn_agree": dcn_agree}


def _rank(rank: int, world: int, device: str, addr: str) -> None:
    """One spawned rank: join the world, run the steps, leave."""
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=addr,
                            rank=rank, world_size=world)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        run(device)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict | None:
    """Run the steps in a world of ``--world`` ranks. A world of 1 runs in
    this process (in the caller's process group when one is started, else
    in one it starts and ends) and returns :func:`run`'s results; a larger
    world is spawned on ``localhost`` and returns None."""
    args = device_args(__doc__.splitlines()[0], argv,
                       world=(int, 1, "ranks of the world (1: this process)"))
    if args.world == 1:
        started = not dist.is_initialized()
        try:
            return run(args.device)
        finally:
            if started and dist.is_initialized():
                dist.destroy_process_group()
    import importlib

    import torch.multiprocessing as mp

    with socket.socket() as s:  # a free port for the TCP rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # by its module's name, so the spawned ranks import it (not __main__)
    entry = importlib.import_module("velesdb_tpu_torch.examples.sharded_scale")._rank
    mp.spawn(entry, args=(args.world, args.device, f"tcp://localhost:{port}"),
             nprocs=args.world, join=True)
    return None


if __name__ == "__main__":
    main()
