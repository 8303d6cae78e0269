"""``Collection.hybrid_search_batch``: a batch of vector queries, each with
its text, fused by weighted RRF (``vector_weight``), top ``k``, under the
traffic's ``filter``. The reference fuses each branch's top ``fetch``.

Adds the numbers:

- ``text_score_err``: the largest relative gap between the fused score of
  a hit that only the text branch can hold (in the reference's BM25 top
  ``fetch``, outside its vector top ``VEC_DEPTH``) and the reference's
  ``(1 - w) / (61 + rank)`` for it;
- ``stray``: hits that neither branch can hold (outside the reference's
  BM25 top ``fetch`` and its vector top ``VEC_DEPTH``).

The traced run also times the text branch alone (``side_s["text"]``).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.judge import Reference, in_lists
from perfbench.reference import bm25 as ref_bm25
from perfbench.reference import exact as ref_exact
from perfbench.reference import rrf as ref_rrf

VEC_DEPTH = 64  # vector ranks within which a hybrid hit may come from the vector branch


def make_call(col, spec, pool):
    t = spec.traffic
    b, k, filt, w = int(t["batch"]), int(t["k"]), t.get("filter"), float(t["vector_weight"])
    queries, texts = pool.vectors.cpu().numpy(), pool.texts

    def call(i):
        idx = pool.batch(i, b)
        return idx, col.hybrid_search_batch(queries[idx], [texts[j] for j in idx], k,
                                            vector_weight=w, filter=filt)
    return call


def side_calls(col, spec, pool, sync):
    """``text``: ``text_search_batch`` alone at the cell's batch, texts,
    fetch depth and filter, each call ending in a synchronise."""
    t = spec.traffic
    b, fetch, filt, texts = int(t["batch"]), int(t["fetch"]), t.get("filter"), pool.texts

    def call(i):
        idx = pool.batch(i, b)
        out = col.text_search_batch([texts[j] for j in idx], fetch, filter=filt)
        sync()
        return out
    return {"text": call}


def _text_lists(texts, pool_texts, mask, fetch, dtype=torch.float64):
    """BM25 top ``fetch`` rows of each pool query (one scoring a distinct
    text), ranked on their scores rounded to ``dtype``."""
    index = ref_bm25.Bm25(texts)
    per_text = {}
    for t in sorted(set(pool_texts)):
        s = index.scores(t)
        if dtype != torch.float64:
            s = torch.from_numpy(s).to(dtype).to(torch.float64).numpy()
        per_text[t] = ref_bm25.ranked(s, fetch, mask)[1]
    return np.stack([per_text[t] for t in pool_texts])


def reference(cfg, traffic, ds, pool, mask, dtype=torch.float64) -> Reference:
    k, fetch, w = int(traffic["k"]), int(traffic["fetch"]), float(traffic["vector_weight"])
    dev = ds.rows.device
    mask_dev = None if mask is None else torch.from_numpy(mask).to(dev)
    _, vrows = ref_exact.topk(pool.vectors, ds.rows, cfg["collection"]["metric"],
                              max(VEC_DEPTH, fetch), mask_dev, dtype=dtype)
    trows = _text_lists(ds.fields["text"], pool.texts, mask, fetch, dtype)
    fvals, frows = ref_rrf.fuse(vrows[:, :fetch], torch.from_numpy(trows).to(dev), k, w,
                                dtype=dtype)
    return Reference(rows=frows.cpu().numpy(), scores=fvals.cpu().numpy(),
                     vec_rows=vrows.cpu().numpy(), txt_rows=trows, weight=w)


def numbers(cfg, traffic, ds, pool, ref, hits) -> dict:
    in_txt, t_rank = in_lists(hits.rows, ref.txt_rows[hits.qidx])
    in_vec, _ = in_lists(hits.rows, ref.vec_rows[hits.qidx])
    pure = hits.known & in_txt & ~in_vec
    expect = (1.0 - ref.weight) / (ref_rrf.RRF_K + 1.0 + t_rank[pure])
    err = np.abs(hits.scores[pure] - expect) / expect
    return {"text_score_err": float(np.nan_to_num(err, nan=np.inf).max()) if err.size else 0.0,
            "stray": int((hits.known & ~in_txt & ~in_vec).sum())}
