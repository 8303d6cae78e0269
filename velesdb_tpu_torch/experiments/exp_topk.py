"""Experiment: top-k selection strategies at 1M x 128D, b 256.

    python -m velesdb_tpu_torch.experiments.exp_topk [--device cpu]
        [--variants scan_exact,scan_approx,bucket,bucket_approx,bucket_bf16,pallas]
        [--n 1000000 --d 128 --b 256 --k 10 --chunk 65536 --pchunk 2048
         --iters 16 --samples 3]

Port of the variants of ``benchmarks/exp_topk.py`` that reach a Pallas kernel,
and its ground truth:

    scan_exact   fp32 ``torch.mm`` over row chunks of ``--chunk``, ``torch.topk``
                 per chunk, merged (the ground truth's method)
    scan_approx  the same (the port selects exactly everywhere)
    bucket       #2 (csrc/dense_bucket.cu) on the doubled queries: one winner
                 of ``2 q.c - |c|^2`` per 128-lane bucket of each ``--pchunk``
                 rows, then the top k of the winners
    bucket_approx  the same (exact selection)
    bucket_bf16  #2b (csrc/dense_bucket_tc.cu, tensor cores) on bf16(2q) and
                 the corpus in bf16, ``|c|^2`` from the f32 rows
    pallas       the fused top-k op (#8, csrc/fused_topk.cu)

The script's other variants (floor, bf16, bf16_approx, bf16_floor, the lean
family, int8, sq8_streamed) run on XLA alone and are not ported yet.

Data: the script draws its corpus and queries with ``jax.random`` on the
device; the port draws the same distribution with numpy from the same seeds
(corpus seed 0, recall probe seed 99, timing batches seeds 1000 + s): 64
Gaussian centers, N rows padded to a multiple of lcm(chunk, pchunk) with
``|c|^2 = +inf`` on the pad. Each variant's line gives ms a batch, QPS and
recall@k of the 256 probe queries against the exact scan; the last line is
the results as JSON. ``main()`` returns them; a failing variant raises.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from velesdb_tpu_torch.experiments import _common
from velesdb_tpu_torch.ops import bucket_kernel as bk
from velesdb_tpu_torch.ops import pallas_kernels as pk

PORTED = ("scan_exact", "scan_approx", "bucket", "bucket_approx", "bucket_bf16", "pallas")
XLA_ONLY = ("floor", "bf16", "bf16_approx", "bf16_floor", "lean", "lean_bf16", "lean_dots",
            "lean_dots_bf16", "int8", "sq8_streamed")


def gen_corpus(seed: int, n: int, d: int) -> np.ndarray:
    """The script's ``_gen_corpus`` distribution: 64 centers at 2x a standard
    normal, rows at 0.7 around them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    return centers[rng.integers(0, 64, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


def make_scan(k: int, chunk: int):
    """fp32 ``2 q.c - |c|^2`` over row chunks, ``torch.topk`` per chunk and a
    running merge: ``(vals [B, k], ids [B, k])``."""

    def fn(q, corpus, cnorm):
        best_v = best_i = None
        for c0 in range(0, corpus.shape[0], chunk):
            s = 2.0 * (q @ corpus[c0 : c0 + chunk].T) - cnorm[None, c0 : c0 + chunk]
            v, i = torch.topk(s, k, dim=1)
            if best_v is None:
                best_v, best_i = v, i + c0
            else:
                best_v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
                best_i = torch.gather(torch.cat([best_i, i + c0], 1), 1, pos)
        return best_v, best_i

    return fn


def make_bucket(k: int, chunk: int):
    """``make_bucket``: the bucket scan on the doubled queries, cast to the
    corpus dtype (2 bf16(q) = bf16(2q) exactly), then the exact top k of the
    bucket winners, ties to the smallest position."""

    def fn(q, corpus, cnorm):
        b, d = q.shape
        q2 = F.pad(2.0 * q, (0, 0, 0, (-b) % 8)).to(corpus.dtype)
        gm, gi = bk.dense_bucket_gm(q2, corpus, cnorm, chunk)
        v, pos = bk.first_topk(gm[:b], k)
        return v, torch.gather(gi[:b], 1, pos).long()

    return fn


def make_pallas(k: int, n: int):
    def fn(q, corpus, cnorm):
        valid = torch.arange(corpus.shape[0], device=corpus.device) < n
        return pk.fused_topk(q, corpus, valid, k=k, metric="euclidean", corpus_sqnorm=cnorm)

    return fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--pchunk", type=int, default=2048)  # the bucket kernels' chunk
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--variants", type=str, default="scan_approx,bucket")
    ap.add_argument("--skip-recall", action="store_true")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _common.resolve_device(args.device)
    n, d, b, k = args.n, args.d, args.b, args.k
    names = args.variants.split(",")
    for name in names:
        if name in XLA_ONLY:
            raise SystemExit(f"variant {name} runs on XLA alone in the JAX script and is not "
                             f"ported (ROADMAP.md); ported: {', '.join(PORTED)}")
        if name not in PORTED:
            raise SystemExit(f"unknown variant {name}")

    print(f"device={_common.device_name(dev)} n={n} d={d} b={b} k={k}", flush=True)
    unit = math.lcm(args.chunk, args.pchunk)
    n_pad = -(-n // unit) * unit
    corpus = torch.from_numpy(gen_corpus(0, n, d)).to(dev)
    cnorm = F.pad(torch.sum(corpus * corpus, dim=1), (0, n_pad - n), value=torch.inf)
    corpus = F.pad(corpus, (0, 0, 0, n_pad - n))
    print(f"corpus generated with numpy, seed 0 (n_pad={n_pad})", flush=True)

    probe = torch.from_numpy(gen_corpus(99, 256, d)).to(dev)
    gt_idx = None
    if not args.skip_recall:
        gt_idx = make_scan(k, args.chunk)(probe, corpus, cnorm)[1].cpu().numpy()
        print("ground truth done", flush=True)

    variants = {}
    for name in names:
        if name.startswith("scan"):
            variants[name] = make_scan(k, args.chunk)
        elif name.startswith("bucket"):
            variants[name] = make_bucket(k, args.pchunk)
        else:
            variants[name] = make_pallas(k, n)

    corpus_bf16 = None
    results = {}
    for name, fn in variants.items():
        corp = corpus
        if "bf16" in name:
            if corpus_bf16 is None:
                corpus_bf16 = corpus.to(torch.bfloat16)
            corp = corpus_bf16
        rec = float("nan")
        if gt_idx is not None:
            rec = _common.recall(fn(probe, corp, cnorm)[1], gt_idx)
        samples = []
        for s in range(args.samples):
            qs = torch.from_numpy(gen_corpus(1000 + s, args.iters * b, d)).to(dev)
            batches = [(qs[i * b : (i + 1) * b], corp, cnorm) for i in range(args.iters)]
            samples.append(_common.time_batches(fn, batches, dev, 1, roll=lambda _: 0)[0])
        best = min(samples)
        results[name] = {"ms_per_batch": best * 1e3, "qps": b / best, "recall": rec,
                         "samples_ms": [t * 1e3 for t in samples],
                         **({"selection": "exact"} if name.endswith("approx") else {})}
        print(f"{name}: {results[name]}", flush=True)
    out = {"device": _common.device_name(dev), "n": n, "d": d, "b": b, "k": k,
           "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
