"""``Collection.search_batch``: a batch of vector queries, top ``k``, under
the traffic's ``filter`` and with its search ``params`` (``ef``,
``quality``), if any.

Adds the number ``score_err``: the largest relative gap between a returned
score and the float64 score of the id returned (the exact rerank and the
slot-to-id map, hit by hit).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.judge import Reference
from perfbench.reference import exact as ref_exact


def make_call(col, spec, pool):
    t = spec.traffic
    b, k, filt, params = int(t["batch"]), int(t["k"]), t.get("filter"), t.get("params", {})
    queries = pool.vectors.cpu().numpy()

    def call(i):
        idx = pool.batch(i, b)
        return idx, col.search_batch(queries[idx], k, filter=filt, **params)
    return call


def reference(cfg, traffic, ds, pool, mask, dtype=torch.float64) -> Reference:
    dev = ds.rows.device
    mask_dev = None if mask is None else torch.from_numpy(mask).to(dev)
    vals, rows = ref_exact.topk(pool.vectors, ds.rows, cfg["collection"]["metric"],
                                int(traffic["k"]), mask_dev, dtype=dtype)
    return Reference(rows=rows.cpu().numpy(), scores=vals.cpu().numpy())


def numbers(cfg, traffic, ds, pool, ref, hits) -> dict:
    q_i, r_i = np.nonzero(hits.known)
    dev = ds.rows.device
    exact = ref_exact.scores_of(
        pool.vectors, ds.rows, cfg["collection"]["metric"],
        torch.from_numpy(hits.qidx[q_i]).to(dev), torch.from_numpy(hits.rows[q_i, r_i]).to(dev),
    ).cpu().numpy()
    got = hits.scores[q_i, r_i]
    err = np.abs(got - exact) / np.maximum(np.abs(exact), 1e-12)
    return {"score_err": float(np.nan_to_num(err, nan=np.inf).max()) if err.size else 0.0}
