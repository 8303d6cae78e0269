"""Experiment: the packed popcount Hamming scan (#4) against the 1 byte/bit
shadow (#5) and its enc-select form (#1 on bit rows).

    python -m velesdb_tpu_torch.experiments.exp_hamming_mxu [--device cpu]
    (knobs: EXP_N, EXP_D, EXP_B in the environment)

Port of ``benchmarks/exp_hamming_mxu.py``. popcount(q ^ c) = |q| + |c| - 2 q.c
on 0/1 bit vectors, so with the corpus stored as unpacked int8 0/1 rows one
int8 dot replaces the XOR + popcount loop. Engines:

    h0    hamming_bucket_topk: #4 on the packed words (chunk 2,048)
    hm    hamming_mxu_topk: #5 on the bit rows, chunk 2,048; hm8 at 8,192
    hme2  the enc-select form: #1's scan (doti * 64 + ptile, one int32 max per
          bucket, no index output) on the bit rows, ptile = -64 * (|c| +
          2^20 * knocked out) + slice, chunk 2,048; hme8 at 8,192
    h0r   hamming_rerank_topk: #4 for M 80 candidates, then the exact f32
          cosine rerank
    hmr   hamming_mxu_rerank_topk: #5 for M 80, the same rerank
    hmer  hme8 for M 80, the same rerank

Data: numpy seed 7, N 1,200,000 unit rows x D 100 (padded to 1,204,224 rows
and 128 dims), B 256 queries near stored rows. The raw Hamming engines have
no recall line (nan); the reranked ones give recall@10 against a float64
cosine oracle. Two agreement lines hold #5's and the enc-select's distances
against #4's. The port selects exactly, where the script's enc-select used
``approx_max_k``. ``main()`` returns the results; a failing engine raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from velesdb_tpu_torch.experiments import _common
from velesdb_tpu_torch.ops import bucket_kernel as bk
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.quantization import binary_quantize

K = 10
M = 80
ITERS = 64
SAMPLES = 3
_LANES = 128
_BIG = 1 << 20
COSINE = DistanceMetric.COSINE


def hamming_enc_topk(qbits, rows_bits, ptile, *, k, chunk):
    """The script's ``hamming_enc_topk``: ``ptile [N_pad] int32 = -64 * (|c| +
    _BIG * knocked_out) + slice``; the exact int32 select and the decode."""
    b = qbits.shape[0]
    b_pad = -(-max(b, 8) // 8) * 8
    qi = F.pad(2 * qbits, (0, 0, 0, b_pad - b))
    qsum = qbits.to(torch.int32).sum(dim=1)
    val, idx = _common.enc_topk(bk.sq8pd_bucket_gm(qi, rows_bits, ptile, chunk)[:b], k, chunk)
    empty = val < -(_BIG // 2)
    dist = torch.where(empty, torch.inf, qsum[:, None].float() - val.float())
    return dist, torch.where(empty, -1, idx)


def make_data(n: int, d: int, b: int):
    rng = np.random.default_rng(7)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[rng.integers(0, n, b)] + rng.standard_normal((b, d)).astype(np.float32) * 0.25
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return corpus, queries, rng


def _agreement(d0, i0, dx, ix) -> tuple[float, float]:
    err = float((d0 - dx).abs().max())
    a, c = i0.cpu().numpy(), ix.cpu().numpy()
    overlap = float(np.mean([len(set(x.tolist()) & set(y.tolist())) / K for x, y in zip(a, c)]))
    return err, overlap


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _common.resolve_device(args.device)
    n = int(os.environ.get("EXP_N", 1_200_000))
    d = int(os.environ.get("EXP_D", 100))
    b = int(os.environ.get("EXP_B", 256))

    corpus, queries, rng = make_data(n, d, b)
    n_pad = -(-n // 8192) * 8192
    d_pad = -(-d // 128) * 128
    cj = torch.from_numpy(corpus).to(dev)
    packed = F.pad(binary_quantize(cj), (0, 0, 0, n_pad - n))
    bits = F.pad((cj >= 0.0).to(torch.int8), (0, d_pad - d, 0, n_pad - n))
    csum = bits.to(torch.int32).sum(dim=1)
    valid = torch.arange(n_pad, device=dev) < n
    aux = torch.where(valid, csum, csum + _BIG).to(torch.int32)
    pos = torch.arange(n_pad, device=dev)
    pt2048 = (aux * -64 + (pos % 2048) // _LANES).to(torch.int32)
    pt8192 = (aux * -64 + (pos % 8192) // _LANES).to(torch.int32)
    pen = torch.where(valid, 0.0, torch.inf)
    cf = F.pad(cj, (0, 0, 0, n_pad - n))  # f32 rows for the rerank, unpadded D
    print(f"[hm] state up: bits {tuple(bits.shape)} packed {tuple(packed.shape)}", flush=True)

    qt = torch.from_numpy(queries).to(dev)
    qbits = F.pad((qt >= 0.0).to(torch.int8), (0, d_pad - d))
    pq = binary_quantize(qt)
    gt = _common.host_topk(corpus, queries, K, "dot")

    qv = (np.resize(queries, (ITERS * b, d))
          + rng.standard_normal((ITERS * b, d)).astype(np.float32) * 0.05)
    qv_t = torch.from_numpy(qv).to(dev)
    lead_f = qv_t.reshape(ITERS, b, d)
    lead_pq = binary_quantize(qv_t).reshape(ITERS, b, -1)
    lead_qb = F.pad((qv_t >= 0.0).to(torch.int8), (0, d_pad - d)).reshape(ITERS, b, d_pad)

    # label -> (fn, the per-iteration inputs, the probe inputs, kind)
    engines = {
        "h0": (lambda pq_: bk.hamming_bucket_topk(pq_, packed, pen, k=K, chunk=2048),
               (lead_pq,), (pq,), "ham"),
        "hm": (lambda qb: bk.hamming_mxu_topk(qb, bits, aux, k=K, chunk=2048),
               (lead_qb,), (qbits,), "ham"),
        "hm8": (lambda qb: bk.hamming_mxu_topk(qb, bits, aux, k=K, chunk=8192),
                (lead_qb,), (qbits,), "ham"),
        "hme2": (lambda qb: hamming_enc_topk(qb, bits, pt2048, k=K, chunk=2048),
                 (lead_qb,), (qbits,), "ham"),
        "hme8": (lambda qb: hamming_enc_topk(qb, bits, pt8192, k=K, chunk=8192),
                 (lead_qb,), (qbits,), "ham"),
        "h0r": (lambda qf, pq_: bk.hamming_rerank_topk(qf, pq_, packed, pen, cf, k=K, m=M,
                                                        metric=COSINE, chunk=2048),
                (lead_f, lead_pq), (qt, pq), "cos"),
        "hmr": (lambda qf, qb: bk.hamming_mxu_rerank_topk(qf, qb, bits, aux, cf, k=K, m=M,
                                                           metric=COSINE, chunk=2048),
                (lead_f, lead_qb), (qt, qbits), "cos"),
        "hmer": (lambda qf, qb: bk._exact_rerank_tail(
                     qf, cf, hamming_enc_topk(qb, bits, pt8192, k=M, chunk=8192)[1], k=K,
                     metric=COSINE),
                 (lead_f, lead_qb), (qt, qbits), "cos"),
    }

    d0, i0 = bk.hamming_bucket_topk(pq, packed, pen, k=K, chunk=2048)
    dm, im = bk.hamming_mxu_topk(qbits, bits, aux, k=K, chunk=2048)
    de, ie = hamming_enc_topk(qbits, bits, pt8192, k=K, chunk=8192)
    agree = {"hm": _agreement(d0, i0, dm, im), "hme": _agreement(d0, i0, de, ie)}
    print(f"[hm] coarse distance agreement: max|d0-dm| = {agree['hm'][0]:.1f} "
          f"(id overlap {agree['hm'][1]:.4f})", flush=True)
    print(f"[hm] enc-select agreement: max|d0-de| = {agree['hme'][0]:.1f} "
          f"(id overlap {agree['hme'][1]:.4f})", flush=True)

    results = {}
    for label, (fn, leads, probe, kind) in engines.items():
        _, idx = fn(*probe)
        r_host = _common.recall(idx, gt) if kind == "cos" else float("nan")
        batches = [tuple(x[i] for x in leads) for i in range(ITERS)]
        best, samples = _common.time_batches(fn, batches, dev, SAMPLES)
        results[label] = {"ms_per_batch": best * 1e3, "qps": b / best, "recall": r_host,
                          "samples_ms": [s * 1e3 for s in samples]}
        print(f"[hm] {label:4s} N={n:,} D={d} b={b}: {b / best:,.0f} QPS ({best * 1e3:.4f} "
              f"ms/batch) recall_host={r_host:.4f} "
              f"samples={[f'{s * 1e3:.4f}' for s in samples]}", flush=True)
    return {"device": _common.device_name(dev), "n": n, "d": d, "b": b, "k": K, "m": M,
            "iters": ITERS, "samples": SAMPLES, "results": results,
            "agreement": {key: {"max_abs_dist": e, "id_overlap": o}
                          for key, (e, o) in agree.items()}}


if __name__ == "__main__":
    main(sys.argv[1:])
