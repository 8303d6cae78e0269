"""``chip_smoke.py``'s phase 15: the client layer on the card.

The port's adapters (``velesdb_tpu_torch.integrations``) and examples
(``velesdb_tpu_torch.examples``) driven through the entry points a user
calls, each run held to the direct calls it wraps:

- :func:`rag_phase` (15a, ``rag-1m-128d``): a LangChain / LlamaIndex RAG
  store over phase 11's 1,000,000 x 128 cosine directory, run at the end of
  phase 11 (after phase 13) on the same directory. Every ``similarity_search``
  and ``query`` runs #1 (``int8-assist-pd``).
- :func:`graphrag_phase` (15b, ``graphrag-kg-262k``): ``VelesGraphRetriever``
  over hybrid-sq8-262k's collection and phase 12's 1,234,877 ``also_bought``
  edges, inside phase 12. Its seeds run #7 and the host rerank.
- :func:`examples_phase` (15c): the five examples in process at their own
  sizes.

Each takes the loaded ``chip_smoke`` module as ``cs`` (its checks, launch
records and helpers) and returns its seconds. Every kernel launch is held
against the plain version bit for bit (:func:`hold_stacked`).
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import shutil
import tempfile
import time

import numpy as np


class TableEmbedding:
    """A text -> vector table with the LangChain ``Embeddings`` surface (no
    model, no download): each query and document text names its row."""

    def __init__(self, table: dict):
        self.table = table

    def embed_query(self, text: str) -> np.ndarray:
        return self.table[text]

    def embed_documents(self, texts) -> np.ndarray:
        return np.stack([self.table[t] for t in texts])


def numpy_mmr(query, cand, k: int, lam: float) -> list[int]:
    """Maximal marginal relevance over ``cand [m, D]`` in numpy: the rule
    the adapters state, ``lam * cos(q, c) - (1 - lam) * max cos(c, chosen)``."""
    cn = cand / np.maximum(np.linalg.norm(cand, axis=1, keepdims=True), 1e-30)
    qn = query / max(np.linalg.norm(query), 1e-30)
    rel = cn @ qn
    chosen: list[int] = []
    while len(chosen) < min(k, len(cand)):
        div = (cn @ cn[chosen].T).max(axis=1) if chosen else np.zeros(len(cand))
        score = lam * rel - (1 - lam) * div
        score[chosen] = -np.inf
        chosen.append(int(np.argmax(score)))
    return chosen


def hold_stacked(cs, torch, run, plain, per_query, label, group=32) -> int:
    """Every launch ``run`` recorded against the plain version, bit for bit.
    Launches that share their other arguments (the same row tensors) are
    stacked along the batch: the plain versions of #1 and #7 compute each
    query row on its own in exact integer products and elementwise fp32, so
    a stacked call gives each launch's rows as its own call would.
    ``per_query`` names the positions of the per-query arguments. Returns
    the launches held."""
    cs.check(len(run.calls) == run.launches(),
             f"{label}: {len(run.calls)} recorded calls for {run.launches()} launches")
    groups: dict[tuple, list] = {}
    for args, kwargs, out in run.calls:
        cs.check(not kwargs, f"{label}: a launch with keyword arguments")
        key = tuple(None if i in per_query else (id(a) if torch.is_tensor(a) else a)
                    for i, a in enumerate(args))
        groups.setdefault(key, []).append((args, out if isinstance(out, tuple) else (out,)))
    held = 0
    for items in groups.values():
        for s in range(0, len(items), group):
            part = items[s : s + group]
            args = list(part[0][0])
            for i in per_query:
                args[i] = torch.cat([a[i] for a, _ in part])
            ref = plain(*args)
            ref = ref if isinstance(ref, tuple) else (ref,)
            row = 0
            for a, out in part:
                b = a[per_query[0]].shape[0]
                for o, r in zip(out, ref):
                    cs.check(o.dtype == r.dtype and o.shape == r[row : row + b].shape
                             and torch.equal(o, r[row : row + b]),
                             f"{label}: a launch differs from its plain version")
                row += b
            held += len(part)
    run.calls.clear()
    return held


def interleaved_p50_p99(fns, calls) -> list[tuple[float, float]]:
    """Host-clock ``(p50, p99)`` milliseconds of each ``fn(i)`` (each reads
    its result back) for ``i`` in ``calls``, the functions called in turn
    for each ``i``."""
    ms = [[] for _ in fns]
    for i in calls:
        for j, fn in enumerate(fns):
            t0 = time.perf_counter()
            fn(i)
            ms[j].append((time.perf_counter() - t0) * 1e3)
    return [(float(np.percentile(m, 50)), float(np.percentile(m, 99))) for m in ms]


def _rows(pairs):
    return [(d.page_content, float(s)) for d, s in pairs]


def _hits(hits):
    return [((h.payload or {}).get("text", ""), float(h.score)) for h in hits]


def rag_phase(cs, torch, counters, launches, tmp, qv, o_ids) -> float:
    """15a, ``rag-1m-128d``: phase 11's directory (1,000,000 x 128 cosine
    FULL, after phase 13) opened as a LangChain ``VelesDBVectorStore`` and a
    LlamaIndex ``VelesDBLlamaStore`` on their default device; the queries
    are ``qv[SERVE_Q0:]``, whose float64 oracle top-10 ids are ``o_ids``.
    Host-clock numbers come first; the phase takes no profile."""
    from velesdb_tpu_torch.integrations.langchain_velesdb import VelesDBVectorStore, _stable_id
    from velesdb_tpu_torch.integrations.llamaindex_velesdb import VelesDBLlamaStore
    from velesdb_tpu_torch.ops import bucket_kernel as bk

    t_phase = time.perf_counter()
    name, cname, k = "rag-1m-128d", "hybrid-1m-128d", cs.K
    n_q, n_new, n_side = len(o_ids), 10_000, 64
    Q = qv[cs.SERVE_Q0 : cs.SERVE_Q0 + n_q]
    # the write path's documents: the recipe under a new seed
    new_vecs, new_pay, _, _ = cs.hybrid_data(n_new, cs.HYB_D, 1, seed=19)
    new_texts = [f"{p['text']} (new {j})" for j, p in enumerate(new_pay)]
    new_meta = [{"price": p["price"], "new": j} for j, p in enumerate(new_pay)]
    table = {f"query {i}": Q[i] for i in range(n_q)}
    table.update(zip(new_texts, new_vecs))
    emb = TableEmbedding(table)

    t0 = time.perf_counter()
    store = VelesDBVectorStore(emb, path=tmp, collection_name=cname, metric="cosine")
    col = store._collection(cs.HYB_D)
    t_open = time.perf_counter() - t0
    cs.check(col.device.type == "cuda" and col.count() == cs.HYB_N,
             f"{name}: the store opened {col.count()} rows on {col.device}")
    with cs.MainPath(counters, bk, "sq8pd_bucket_gm", "sq8pd_bucket_gm") as run:
        t0 = time.perf_counter()
        store.similarity_search("query 0", k=k)
        t_first = time.perf_counter() - t0
        run.launched(f"{name} first similarity_search")
        cs.check(col._brute.serve_engine(k) == "int8-assist-pd", f"{name}: serve_engine")
        cs.say(f"{name}: VelesDBVectorStore opens the directory ({cs.HYB_N:,} rows) on "
               f"{col.device} in {t_open:.2f} s, first similarity_search (device refresh, "
               f"pd shadow) {t_first:.2f} s")

        # -- host-clock numbers, before anything else of the phase --------------
        t0 = time.perf_counter()
        llama = VelesDBLlamaStore(path=tmp, collection_name=cname)
        llama.query(Q[0], similarity_top_k=k)
        t_llama = time.perf_counter() - t0
        # each adapter against the direct search on its own collection, the
        # four calls of a query in turn, so that a drift of the host clock
        # reaches all four alike
        (lc50, lc99), (d50, d99), (li50, li99), (e50, _) = interleaved_p50_p99((
            lambda i: store.similarity_search(f"query {i}", k=k),
            lambda i: col.search(Q[i], k=k),
            lambda i: llama.query(Q[i], similarity_top_k=k),
            lambda i: llama._coll.search(Q[i], k=k)), range(1, 201))
        run.launched(f"{name} timed calls")
        cs.say(f"{name} k={k}, one query a call over 200 calls in turn: LangChain "
               f"similarity_search p50 {lc50:.3f} ms, p99 {lc99:.3f}, its direct "
               f"Collection.search p50 {d50:.3f} ms, p99 {d99:.3f} (the adapter layer "
               f"{lc50 - d50:.3f} ms); LlamaIndex query p50 {li50:.3f} ms, p99 {li99:.3f}, its "
               f"direct search p50 {e50:.3f} ms (the adapter layer {li50 - e50:.3f} ms); the "
               f"LlamaIndex store's open and first query {t_llama:.2f} s")

        # -- answers equal the direct calls; recall against the oracle -----------
        swaps = {"langchain": 0, "llamaindex": 0}
        got_ids = []
        for i in range(n_q):
            lc = store.similarity_search_with_score(f"query {i}", k=k)
            direct = col.search(Q[i], k=k)
            li = llama.query(Q[i], similarity_top_k=k)
            agree = cs.tie_agree(_rows(lc), _hits(direct))
            cs.check(agree is not None and len(lc) == k,
                     f"{name}: similarity_search_with_score differs from search (query {i})")
            swaps["langchain"] += agree
            agree = cs.tie_agree(list(zip((int(x) for x in li.ids), li.similarities)),
                                 cs.pairs(direct))
            cs.check(agree is not None, f"{name}: LlamaIndex query differs from search ({i})")
            swaps["llamaindex"] += agree
            got_ids.append([int(x) for x in li.ids])
        run.launched(f"{name} similarity_search / query / search")
        recall = float(np.mean([len(set(g) & set(o.tolist())) / k for g, o in zip(got_ids,
                                                                                   o_ids)]))
        print(f"{name}: {n_q} queries through similarity_search_with_score and the LlamaIndex "
              f"query equal the direct search (texts / ids in order, scores within 1e-6; "
              f"near-tie swaps {swaps}); recall@10 vs the float64 oracle {recall:.4f}",
              flush=True)
        cs.check(recall >= 0.95, f"{name}: recall@10 {recall:.4f} < 0.95")

        # -- the filter ----------------------------------------------------------
        t0 = time.perf_counter()
        store.similarity_search("query 0", k=k, filter=cs.HYB_FILTER)
        t_cols = time.perf_counter() - t0
        for i in range(n_side):
            lc = store.similarity_search_with_score(f"query {i}", k=k, filter=cs.HYB_FILTER)
            want = col.search_batch([Q[i]], k, filter=cs.HYB_FILTER)[0]
            li = llama.query(Q[i], similarity_top_k=k, filters=cs.HYB_FILTER)
            cs.check(cs.tie_agree(_rows(lc), _hits(want)) is not None
                     and cs.tie_agree(list(zip((int(x) for x in li.ids), li.similarities)),
                                      cs.pairs(want)) is not None,
                     f"{name}: a filtered answer differs from search_batch with the filter")
            cs.check(all(h.payload["price"] < 50 for h in want)
                     and all(p["price"] < 50 for p in li.payloads),
                     f"{name}: the filter let a row through")
        run.launched(f"{name} filtered similarity_search / query")
        print(f"{name}: {n_side} filtered similarity_search_with_score and query calls "
              f"(price < 50) equal search_batch with the filter, no row at 50 or more",
              flush=True)

        # -- MMR ---------------------------------------------------------------
        for i in range(n_side):
            got = store.max_marginal_relevance_search(f"query {i}", k=4, fetch_k=20)
            hits = col.search(Q[i], 20)
            cand = np.stack([col.vectors.retrieve(h.id) for h in hits])
            want = [hits[j].payload["text"] for j in numpy_mmr(Q[i], cand, 4, 0.5)]
            cs.check([d.page_content for d in got] == want,
                     f"{name}: max_marginal_relevance_search differs from the numpy MMR ({i})")
        run.launched(f"{name} max_marginal_relevance_search")
        print(f"{name}: {n_side} max_marginal_relevance_search (k 4, fetch 20) = a numpy MMR "
              f"over the direct search's 20 rows", flush=True)
        llama.db.close()

        # -- the write path: add, find, delete -----------------------------------
        t0 = time.perf_counter()
        lc_ids = store.add_texts(new_texts, new_meta, ids=[f"new-{j}" for j in range(n_new)])
        t_add = time.perf_counter() - t0
        t0 = time.perf_counter()
        first = store.similarity_search_with_score(new_texts[0], k=1)
        t_refresh = time.perf_counter() - t0
        cs.check(col.count() == cs.HYB_N + n_new
                 and col._brute.serve_engine(k) == "int8-assist-pd",
                 f"{name}: {col.count()} rows after add_texts, "
                 f"{col._brute.serve_engine(k)!r}")
        found = [first[0][0].metadata.get("new") == 0]
        found += [store.similarity_search(new_texts[j], k=1)[0].metadata.get("new") == j
                  for j in range(1, 256)]
        run.launched(f"{name} similarity_search after add_texts")
        cs.check(all(found), f"{name}: {found.count(False)} of 256 added documents not found")
        new_ids = {_stable_id(s) for s in lc_ids}
        t0 = time.perf_counter()
        cs.check(store.delete(lc_ids) is True, f"{name}: delete returned False")
        t_del = time.perf_counter() - t0
        cs.check(col.count() == cs.HYB_N, f"{name}: {col.count()} rows after delete")
        after = [store.similarity_search(new_texts[j], k=k) for j in range(256)]
        after_b = col.search_batch(new_vecs[:1024], k)
        run.launched(f"{name} searches after delete")
        cs.check(not any("new" in d.metadata for row in after for d in row)
                 and not new_ids & {h.id for row in after_b for h in row},
                 f"{name}: a deleted document was returned")
        cs.say(f"{name}: add_texts of {n_new:,} documents {t_add:.2f} s; the first search "
               f"after it {t_refresh:.2f} s (the exact engine has no delta: the upsert marks "
               f"the device state dirty and this search rebuilds it and the pd shadow); 256 "
               f"found at top 1; delete of {n_new:,} {t_del:.2f} s, then none of them "
               f"returned (256 similarity_search, a search_batch of 1,024); the first "
               f"filtered search (column build) {t_cols:.2f} s")
    n = hold_stacked(cs, torch, run, bk.sq8pd_bucket_gm_ref, (0,), f"{name} #1")
    launches["sq8pd_bucket"] += n
    print(f"{name}: {n} #1 launches, each equal to its plain version bit for bit", flush=True)
    store.db.close()
    seconds = time.perf_counter() - t_phase
    cs.say(f"phase 15a {name}: {seconds:.1f} s")
    return seconds


def graphrag_phase(cs, torch, counters, launches, colsq, qsq, indptr, dst) -> float:
    """15b, ``graphrag-kg-262k``: ``VelesGraphRetriever(seed_k=3,
    expand_k=10, max_depth=2, rel_types=["also_bought"])`` over
    hybrid-sq8-262k's collection with phase 12's edges (CSR ``indptr`` /
    ``dst`` on the host) for 256 held-out queries. Each answer must equal a
    host recomputation: the direct ``search`` seeds, ``host_bfs`` from each,
    and the retriever's ranking rule."""
    from velesdb_tpu_torch.integrations.langchain_velesdb_graph import VelesGraphRetriever
    from velesdb_tpu_torch.ops import bucket_kernel as bk

    t_phase = time.perf_counter()
    name, n_q, seed_k, expand_k, depth = "graphrag-kg-262k", 256, 3, 10, 2
    Q = qsq[4096 : 4096 + n_q]
    emb = TableEmbedding({f"question {i}": Q[i] for i in range(n_q)})
    retr = VelesGraphRetriever(colsq, emb, seed_k=seed_k, expand_k=expand_k,
                               max_depth=depth, rel_types=["also_bought"])
    ms, docs = [], []
    with cs.MainPath(counters, bk, "sq8i_bucket_gm", "sq8i_bucket_gm") as run:
        for i in range(n_q):
            t0 = time.perf_counter()
            docs.append(retr.invoke(f"question {i}"))
            ms.append((time.perf_counter() - t0) * 1e3)
        run.launched(f"{name} retriever seeds")
        seeds = [colsq.search(Q[i], k=seed_k) for i in range(n_q)]
        run.launched(f"{name} direct seeds")
    n = hold_stacked(cs, torch, run, bk.sq8i_bucket_ref, (0, 5, 6), f"{name} #7")
    launches["sq8i_bucket"] += n
    d50, _ = cs.p50_p99(lambda i: colsq.search(Q[i], k=seed_k), range(n_q))
    expanded = 0
    for i in range(n_q):
        # the host's ranking: seeds by score at depth 0; each node reached
        # from a seed (host BFS over the same edges) belongs to the first
        # seed that reaches it, at that seed's score x 0.5^depth
        want = [(s.id, float(s.score), 0) for s in seeds[i]]
        seen = {s.id for s in seeds[i]}
        for sid, score, _ in list(want):
            for node, d in sorted(cs.host_bfs(indptr, dst, sid, depth), key=lambda t: t[1]):
                if d and node not in seen:
                    seen.add(node)
                    want.append((node, score * 0.5 ** d, d))
        want.sort(key=lambda t: (t[2], -t[1]))
        got = [(d.metadata["id"], d.metadata["score"], d.metadata["hop_depth"]) for d in docs[i]]
        cs.check(len(got) == min(expand_k, len(want)) and len({g[0] for g in got}) == len(got),
                 f"{name}: {len(got)} documents for query {i}, host {len(want)}")
        for p, (vid, score, d) in enumerate(got):
            # ids equal up to order inside a run of equal (depth, score):
            # the run's order is the traversal's, not a rule of the ranking
            tie = {w[0] for w in want if w[2] == want[p][2] and abs(w[1] - want[p][1]) <= 1e-6}
            cs.check(d == want[p][2] and abs(score - want[p][1]) <= 1e-6 and vid in tie,
                     f"{name}: query {i} document {p} {(vid, score, d)} differs from the "
                     f"host's {want[p]}")
        cs.check(all(d.page_content == colsq.get(d.metadata["id"])[1]["text"] for d in docs[i]),
                 f"{name}: a document's text is not its row's")
        expanded += sum(g[2] > 0 for g in got)
    print(f"{name}: {n_q} retrievals (seed_k {seed_k}, expand_k {expand_k}, depth {depth}, "
          f"also_bought) equal the host recomputation (the direct search's seeds, host_bfs, "
          f"the ranking rule; ids, hop_depth, scores within 1e-6); {expanded} expanded "
          f"documents; {n} #7 launches, each equal to its plain version bit for bit",
          flush=True)
    cs.say(f"{name}: VelesGraphRetriever.invoke p50 {np.percentile(ms, 50):.3f} ms, p99 "
           f"{np.percentile(ms, 99):.3f} over {n_q} queries (host clock); the direct seed "
           f"search p50 {d50:.3f} ms")
    seconds = time.perf_counter() - t_phase
    cs.say(f"phase 15b {name}: {seconds:.1f} s")
    return seconds


STAMP = re.compile(r"'(created_at|last_access)': [-0-9.e+]+")
NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+e[-+]?\d+")


def result_lines(text: str) -> list[str]:
    """An example's printed lines without its wall-clock stamps."""
    return [STAMP.sub(r"'\1': <time>", ln.rstrip()) for ln in text.splitlines() if ln.strip()]


def same_lines(got, want, tol=1e-5) -> bool:
    """Equal lines, numbers with a decimal point within ``tol`` (relative
    above 1): a memory's recency factor moves ~1e-6 a second."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if NUMBER.sub("#", g) != NUMBER.sub("#", w):
            return False
        if any(abs(float(a) - float(b)) > tol * max(1.0, abs(float(b)))
               for a, b in zip(NUMBER.findall(g), NUMBER.findall(w))):
            return False
    return True


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def examples_phase(cs, torch, counters, launches, errs) -> float:
    """15c: the five examples in process on the card at their own sizes.
    ``ecommerce_demo`` (5,000 products, 1,000 users) with
    ``tests/test_ecommerce_demo.py``'s assertions on q1-q4;
    ``quickstart``, ``agent_memory_demo`` and ``graph_rag`` printing the
    result lines of the same example on the CPU; ``sharded_scale`` at
    80,000 x 768 in a world of 1 over NCCL. These collections are below
    131,072 rows, so they run the streamed scan: a check, not a cell."""
    from velesdb_tpu_torch.examples import (
        agent_memory_demo,
        ecommerce_demo,
        graph_rag,
        quickstart,
        sharded_scale,
    )
    from velesdb_tpu_torch.ops import ivf_kernel as ik

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="velesdb_chip_examples_")
    try:
        # -- ecommerce_demo ------------------------------------------------------
        t0 = time.perf_counter()
        shop, text = _printed(ecommerce_demo.main, ["--path", os.path.join(tmp, "shop"),
                                                    "--iters", "3"])
        db, col, vectors = shop["db"], shop["shop"], shop["vectors"]
        cs.check(col.device.type == "cuda" and col.count() == 5000 and shop["n_edges"] > 500,
                 f"ecommerce_demo: {col.count()} products on {col.device}")
        cs.check(set(col.get(0)[1]) == {"name", "category", "subcategory", "brand", "price",
                                        "rating", "review_count", "in_stock", "stock_quantity",
                                        "release_year", "discount_pct"},
                 "ecommerce_demo: the products lack the reference's 11 fields")
        rng = np.random.default_rng(0)
        q = vectors[123] + 0.02 * rng.standard_normal(128).astype(np.float32)
        hits = ecommerce_demo.q1_vector(col, q)
        sub = col.get(123)[1]["subcategory"]
        cs.check(hits[0].id == 123
                 and sum(col.get(h.id)[1]["subcategory"] == sub for h in hits) >= 7,
                 "ecommerce_demo q1: the anchor's shelf is not the top 10")
        rows = ecommerce_demo.q2_vector_filtered(db, vectors[42] + 0.02 * rng.standard_normal(
            128).astype(np.float32))
        cs.check(rows and all(col.get(r["id"])[1]["in_stock"] is True
                              and col.get(r["id"])[1]["price"] < 500 for r in rows)
                 and [r["sim"] for r in rows] == sorted((r["sim"] for r in rows), reverse=True),
                 "ecommerce_demo q2: a filter or the order does not hold")
        anchor = next(p for p in range(5000) if col.neighbors(p, "out", "bought_together"))
        rows = ecommerce_demo.q3_graph(col, anchor)
        cs.check(rows and {r["id"] for r in rows}
                 <= set(col.neighbors(anchor, "out", "bought_together")),
                 "ecommerce_demo q3: a row is not bought together with the anchor")
        q = vectors[anchor] + 0.02 * rng.standard_normal(128).astype(np.float32)
        out = ecommerce_demo.q4_combined(db, col, q, anchor, k=10, price_cap=1000.0)
        cs.check(out and all(col.get(r["id"])[1]["in_stock"] and col.get(r["id"])[1]["rating"]
                             >= 4.0 and col.get(r["id"])[1]["price"] < 1000 for r in out)
                 and [r["score"] for r in out] == sorted((r["score"] for r in out),
                                                         reverse=True),
                 "ecommerce_demo q4: a business rule or the order does not hold")
        db.close()
        print("ecommerce_demo on the card: " + " | ".join(
            ln.strip() for ln in text.splitlines() if ln.strip()), flush=True)
        cs.say(f"ecommerce_demo (5,000 products, 1,000 users, {shop['n_edges']:,} edges): "
               f"tests/test_ecommerce_demo.py's checks on q1-q4 hold, "
               f"{time.perf_counter() - t0:.2f} s (its own timing loops cut to 3 calls)")

        # -- quickstart, agent_memory_demo, graph_rag: the card = the CPU -------
        for mod in (quickstart, agent_memory_demo, graph_rag):
            lines = {}
            t0 = time.perf_counter()
            for device in ("cuda", "cpu"):
                path = os.path.join(tmp, f"{mod.__name__.rsplit('.', 1)[1]}_{device}")
                _, text = _printed(mod.main, ["--device", device, "--path", path])
                lines[device] = result_lines(text)
            name = mod.__name__.rsplit(".", 1)[1]
            cs.check(len(lines["cuda"]) >= 4 and same_lines(lines["cuda"], lines["cpu"]),
                     f"{name}: the card's lines differ from the CPU's:\n{lines}")
            print(f"{name} on the card = on the CPU ({len(lines['cuda'])} lines): "
                  + " | ".join(lines["cuda"]), flush=True)
            cs.say(f"{name}: {time.perf_counter() - t0:.2f} s for both runs")

        # -- sharded_scale in a world of 1 over NCCL ----------------------------
        t0 = time.perf_counter()
        with cs.MainPath(counters, ik, "ivf_probe_scores", "ivf_probe") as run:
            res, text = _printed(sharded_scale.main, ["--world", "1"])
        n10 = run.launches()
        launches["ivf_probe"] += n10
        errs["ivf_probe"] = max(errs["ivf_probe"], run.hold_all(
            ik.ivf_probe_ref, lambda q, *a: f"ivf_probe B {q.shape[0]} (sharded_scale)"))
        cs.check(np.array_equal(res["rows"][:, 0], res["picks"])
                 and res["ann_rows"].shape == (32, 10)
                 and res["sq8_agree"] == 1.0 and res["dcn_agree"] == 1.0,
                 f"sharded_scale: results {text}")
        print("sharded_scale on the card: " + " | ".join(
            ln.strip() for ln in text.splitlines() if ln.strip()), flush=True)
        cs.say(f"sharded_scale (80,000 x 768, world of 1 over NCCL): exact top-1 = the query's "
               f"source row for all 32, SQ8 and multi-host top-1 agreement 1.0, {n10} #10 "
               f"launches, {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    cs.say(f"phase 15c examples: {seconds:.1f} s")
    return seconds
