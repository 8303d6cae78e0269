"""Experiment: what the per-row SQ8 int8 scan (#7) spends its time on.

    python -m velesdb_tpu_torch.experiments.exp_sq8i_v2 [--device cpu]
    (knobs: EXP_N, EXP_D, EXP_B in the environment)

Port of ``benchmarks/exp_sq8i_v2.py``. Every engine returns the same
``(vals, ids)`` contract at k 10 (euclidean distances):

    v0     sq8i_bucket_topk: #7 as the serve path runs it
    v1     #7 on the rows of one packed aux tile [8, N] (scale / am / pen)
    v2     the rank-1 corrections summed first: s = doti*scale + (sqi*am -
           iq*pen) (csrc/sq8i_bucket.cu, epilogue v2)
    v2h    v2 with the epilogue and the bucket select in bf16
    v3     the raw int32 dots, no affine: a lower bound of the scan's cost,
           wrong for euclidean by design
    a16    sq8i_rerank_topk at m 16 (#7 coarse + exact f32 rerank)
    a16v2  the v2 coarse pass at m 16, then the same rerank
    v5     the per-dimension int8 shadow and #1's enc-select scan, built here
           with this script's own calibration (qu from the queries, 1.1x)
    a16v5, a32v5  the v5 coarse pass at m 16 / 32, then the rerank

Data: numpy seed 42, 64 Gaussian centers, N 1,000,000 x D 128 (padded to a
power of two rows and a multiple of 128 dims), B 256. Each line gives ms a
batch and QPS (best of SAMPLES samples of ITERS distinct batches), recall@10
against a float64 host oracle on the unpadded corpus, and the share of
non-finite returned values. The port selects exactly everywhere, so v5's
final select is an exact ``torch.topk`` where the script used
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
from velesdb_tpu_torch.experiments import kernels as xk
from velesdb_tpu_torch.ops import bucket_kernel as bk
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.quantization import sq8_quantize

K = 10
ITERS = 64
SAMPLES = 3
_LANES = 128
EUCLID = DistanceMetric.EUCLIDEAN


def _finish(gm, gi, k, b, qs, qq):
    vals, idx = bk._final_select(gm, gi, k, b)
    return bk._restore_euclidean(vals * qs[:b, None], idx, qq)


def make_call(variant: str, aux: torch.Tensor):
    """The script's ``make_call``: queries doubled and quantized per query
    (its ``_common_prep``, which is ``sq8i_bucket_topk``'s euclidean
    quantizer); ``aux [8, N]`` f32 holds scale / am / pen in rows 0-2. ``v1``
    is #7 on those rows; ``v2`` / ``v2h`` hand the tile and ``qaux [B_pad,
    8]`` (column 1 sqi, column 2 -1/qs) to the epilogue kernel, ``v2h`` in
    bf16."""
    aux_k = aux.to(torch.bfloat16) if variant == "v2h" else aux

    def call(queries, rows8, *, k, chunk):
        b = queries.shape[0]
        qi, qs, sqi, invqs, qq = bk._sq8i_quantize_queries(queries, EUCLID, rows8.shape[1])
        if variant == "v1":
            gm, gi = bk.sq8i_bucket_gm(qi, rows8, aux[0], aux[1], aux[2], sqi, invqs, chunk)
        else:
            qaux = torch.zeros((qi.shape[0], 8), dtype=torch.float32, device=qi.device)
            qaux[:, 1], qaux[:, 2] = sqi, -invqs
            gm, gi = xk.sq8i_v2_bucket_gm(qi, rows8, aux_k, qaux.to(aux_k.dtype), chunk, variant)
        return _finish(gm, gi, k, b, qs, qq)

    return call


def call_v3(queries, rows8, *, k, chunk):
    b = queries.shape[0]
    qi, qs, _, _, qq = bk._sq8i_quantize_queries(queries, EUCLID, rows8.shape[1])
    gm, gi = xk.sq8i_v2_bucket_gm(qi, rows8, None, None, chunk, "v3")
    return _finish(gm, gi, k, b, qs, qq)


def make_call_v5(qu: float, sdim: torch.Tensor, mid: torch.Tensor):
    """The script's ``make_call_v5``: per-dimension int8 queries at the
    batch-common step ``qu``, #1's enc-select scan, the exact int32 select and
    the decode (``val < -2^23`` is empty)."""

    def call_v5(queries, rows_pd, ptile, *, k, chunk):
        b = queries.shape[0]
        b_pad = -(-max(b, 8) // 8) * 8
        qv = 2.0 * queries * sdim[None, :]
        qi = torch.clamp(torch.round(bk._div(qv, qu)), -127, 127).to(torch.int8)
        qi = F.pad(qi, (0, 0, 0, b_pad - b))
        qq = torch.sum(queries * queries, dim=1)
        qmid = 2.0 * (queries @ mid)
        val, idx = _common.enc_topk(bk.sq8pd_bucket_gm(qi, rows_pd, ptile, chunk)[:b], k, chunk)
        empty = val < -(1 << 23)
        score = qu * val.float() + qmid[:, None]
        d2 = (qq[:, None] - score).clamp_min(0.0)
        return torch.where(empty, torch.inf, torch.sqrt(d2)), torch.where(empty, -1, idx)

    return call_v5


def make_data(n: int, d: int, b: int):
    """The script's data: numpy seed 42, 64 centers; returns the generator
    for the timing batches' noise as well."""
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    corpus = centers[rng.integers(0, 64, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7
    queries = centers[rng.integers(0, 64, b)] + rng.standard_normal((b, d)).astype(np.float32) * 0.7
    return corpus, queries, rng


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _common.resolve_device(args.device)
    n = int(os.environ.get("EXP_N", 1_000_000))
    d = int(os.environ.get("EXP_D", 128))
    b = int(os.environ.get("EXP_B", 256))

    corpus, queries, rng = make_data(n, d, b)
    n_pad = 1 << (n - 1).bit_length()
    d_pad = -(-d // 128) * 128
    cf = F.pad(torch.from_numpy(corpus).to(dev), (0, d_pad - d, 0, n_pad - n))
    valid = torch.arange(n_pad, device=dev) < n
    sq = sq8_quantize(cf)
    rows8 = bk.sq8_int8_rows(sq.codes)
    deq = sq.codes.float() * sq.scale[:, None] + sq.minv[:, None]
    pen8 = torch.where(valid, torch.sum(deq * deq, dim=1), torch.inf)
    del deq
    scale8, minv8 = sq.scale.float(), sq.minv.float()
    aux = torch.zeros((8, n_pad), dtype=torch.float32, device=dev)
    aux[0], aux[1], aux[2] = scale8, 128.0 * scale8 + minv8, pen8
    gt = _common.host_topk(corpus, queries, K, "euclidean")

    chunk = bk.bucket_chunk(n_pad)
    qp = F.pad(torch.from_numpy(queries).to(dev), (0, d_pad - d))

    # the per-dimension shadow of v5, as the script builds it
    vcol = valid[:, None]
    big = torch.where(vcol, cf, -torch.inf).amax(dim=0)
    small = torch.where(vcol, cf, torch.inf).amin(dim=0)
    mid = torch.where(torch.isfinite(big), (big + small) * 0.5, 0.0)
    sdim = torch.where(big > small, bk._div(big - small, 254.0), 1.0)
    rows_pd = torch.clamp(torch.round((cf - mid[None, :]) / sdim[None, :]), -127, 127)
    rows_pd = torch.where(vcol, rows_pd, 0.0).to(torch.int8)
    deq_pd = rows_pd.float() * sdim[None, :] + mid[None, :]
    pen_pd = torch.sum(deq_pd * deq_pd, dim=1)
    del deq_pd
    qu = float(torch.abs(2.0 * qp * sdim[None, :]).amax()) / 127.0 * 1.1
    pen_int = torch.where(valid, torch.round(bk._div(pen_pd, qu)).to(torch.int32), 1 << 24)
    slice_i = (torch.arange(n_pad, device=dev) % chunk) // _LANES
    ptile = (pen_int * -64 + slice_i).to(torch.int32)
    print(f"[v2] v5 state up: qu={qu:.6g} max_pen_int="
          f"{int(torch.where(valid, pen_int, 0).amax())}", flush=True)

    call_v1, call_v2, call_v2h = (make_call(v, aux) for v in ("v1", "v2", "v2h"))
    call_v5 = make_call_v5(qu, sdim, mid)

    def rerank(ci):
        return lambda q: bk._exact_rerank_tail(q, cf, ci(q), k=K, metric=EUCLID)

    engines = {
        "v0": lambda q: bk.sq8i_bucket_topk(q, rows8, scale8, minv8, pen8, k=K, metric=EUCLID,
                                            chunk=chunk),
        "v1": lambda q: call_v1(q, rows8, k=K, chunk=chunk),
        "v2": lambda q: call_v2(q, rows8, k=K, chunk=chunk),
        "v2h": lambda q: call_v2h(q, rows8, k=K, chunk=chunk),
        "v3": lambda q: call_v3(q, rows8, k=K, chunk=chunk),
        "a16": lambda q: bk.sq8i_rerank_topk(q, rows8, scale8, minv8, pen8, cf, k=K, m=16,
                                             metric=EUCLID, chunk=chunk),
        "a16v2": rerank(lambda q: call_v2(q, rows8, k=16, chunk=chunk)[1]),
        "v5": lambda q: call_v5(q, rows_pd, ptile, k=K, chunk=chunk),
        "a16v5": rerank(lambda q: call_v5(q, rows_pd, ptile, k=16, chunk=chunk)[1]),
        "a32v5": rerank(lambda q: call_v5(q, rows_pd, ptile, k=32, chunk=chunk)[1]),
    }

    big_q = np.resize(qp.cpu().numpy(), (ITERS * b, d_pad))
    big_q = big_q + rng.standard_normal(big_q.shape).astype(np.float32) * 0.01
    qs_all = torch.from_numpy(big_q.reshape(ITERS, b, d_pad)).to(dev)
    batches = [(qs_all[i],) for i in range(ITERS)]

    results = {}
    for label, fn in engines.items():
        v, idx = fn(qp)
        r_host = _common.recall(idx, gt)
        found = idx >= 0
        nan_frac = float((~torch.isfinite(v[found])).float().mean()) if bool(found.any()) else 0.0
        best, samples = _common.time_batches(fn, batches, dev, SAMPLES)
        results[label] = {"ms_per_batch": best * 1e3, "qps": b / best, "recall": r_host,
                          "nan": nan_frac, "samples_ms": [s * 1e3 for s in samples]}
        print(f"[v2] {label:6s} N={n:,} D={d} b={b}: {b / best:,.0f} QPS ({best * 1e3:.4f} "
              f"ms/batch) recall_host={r_host:.4f} nan={nan_frac:.3f} "
              f"samples={[f'{s * 1e3:.4f}' for s in samples]}", flush=True)
    return {"device": _common.device_name(dev), "n": n, "d": d, "b": b, "k": K,
            "iters": ITERS, "samples": SAMPLES, "results": results}


if __name__ == "__main__":
    main(sys.argv[1:])
