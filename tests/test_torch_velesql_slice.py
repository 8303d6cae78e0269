"""VelesQL and the knowledge graph, the port against the JAX package.

One seeded dataset (clustered vectors, text / price / category / maker
payloads, two collections, typed edges) goes into a ``velesdb_tpu.Database``
and into a ``velesdb_tpu_torch.Database(device="cpu")``; the same VelesQL
strings, MATCH queries and traversals then run on both. Rows must agree:
equal ids, payloads and aggregates, scores (and every other float) within
1e-5 relative. EXPLAIN plans render to the same text.

At 131,072 x 32 cosine the port's NEAR serves ``int8-assist-pd`` (#1's plain
version on the CPU) where the reference's ``Database`` scans exactly: there
the VelesQL rows equal ``Collection.search``'s, and their recall@10 against a
float64 oracle is no lower than the reference's pd core on the same query.
"""

import numpy as np
import pytest

import velesdb_tpu
import velesdb_tpu_torch
import velesdb_tpu_torch.index.brute as tbrute

RTOL = 1e-5  # relative tolerance of every score and float aggregate
N, D, CLUSTERS = 3000, 16, 8
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon"]


def _dataset():
    rng = np.random.default_rng(14)
    centers = rng.standard_normal((CLUSTERS, D)) * 2.0
    assign = rng.integers(0, CLUSTERS, N)
    vecs = (centers[assign] + 0.6 * rng.standard_normal((N, D))).astype(np.float32)
    payloads = [{"text": f"{WORDS[assign[i] % 5]} {WORDS[(i // 3) % 5]} item",
                 "price": float(i % 100), "category": f"c{assign[i]}", "maker": int(i % 7)}
                for i in range(N)]
    members = [np.flatnonzero(assign == c) for c in range(CLUSTERS)]
    src = rng.integers(0, N, 6000)
    near = rng.random(6000) < 0.8
    dst = np.where(near, [rng.choice(members[assign[s]]) for s in src], rng.integers(0, N, 6000))
    labels = ["also_bought" if i % 3 else "similar" for i in range(6000)]
    queries = (centers[rng.integers(0, CLUSTERS, 4)]
               + 0.6 * rng.standard_normal((4, D))).astype(np.float32)
    return vecs, payloads, (src, dst, labels), queries


def _load(db, vecs, payloads, edges):
    items = db.create_collection("items", dim=D, metric="cosine")
    items.upsert_bulk(range(N), vecs, payloads)
    makers = db.create_collection("makers", dim=4)
    makers.upsert_bulk(range(100, 107), np.eye(7, 4, dtype=np.float32),
                       [{"mid": m, "country": "fr" if m % 2 else "de"} for m in range(7)])
    for s, t, lab in zip(*edges):
        items.add_edge(int(s), int(t), lab, {"w": float((s + t) % 5)})
    return db


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    vecs, payloads, edges, queries = _dataset()
    root = tmp_path_factory.mktemp("slice")
    ref = _load(velesdb_tpu.Database.open(str(root / "ref")), vecs, payloads, edges)
    port = _load(velesdb_tpu_torch.Database.open(str(root / "port"), device="cpu"),
                 vecs, payloads, edges)
    yield ref, port, queries
    ref.close()
    port.close()


def _same(got, want, where="rows"):
    """Structural equality, floats within :data:`RTOL`."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, got, want)
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), (where, got, want)
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=where)
    else:
        assert got == want, (where, got, want)


QUERIES = {
    "near": ("SELECT * FROM items WHERE vector NEAR $v LIMIT 10", {}),
    "near_filter": ("SELECT * FROM items WHERE vector NEAR $v AND price < 50 LIMIT 10", {}),
    "near_match": ("SELECT * FROM items WHERE vector NEAR $v AND text MATCH 'alpha' "
                   "AND price < 80 LIMIT 10", {}),
    "near_fused": ("SELECT * FROM items WHERE vector NEAR_FUSED [$v, $w] "
                   "USING FUSION rrf(k = 60) LIMIT 10", {}),
    "near_fused_avg": ("SELECT id, price FROM items WHERE vector NEAR_FUSED [$v, $w] "
                       "USING FUSION average LIMIT 8", {}),
    "match": ("SELECT * FROM items WHERE text MATCH 'beta gamma' LIMIT 10", {}),
    "group_having": ("SELECT category, COUNT(*) AS n, AVG(price) AS p, MAX(price) AS hi "
                     "FROM items WHERE price < 80 GROUP BY category HAVING COUNT(*) > 5 "
                     "ORDER BY n DESC", {}),
    "order_similarity": ("SELECT * FROM items WHERE price < 3 "
                         "ORDER BY similarity(vector, $v) DESC LIMIT 10", {}),
    "similarity_threshold": ("SELECT id FROM items WHERE vector NEAR $v AND "
                             "similarity(vector, $v) > 0.8 LIMIT 20", {}),
    "join": ("SELECT i.price AS p, m.country AS c FROM items AS i JOIN makers AS m "
             "ON i.maker = m.mid WHERE i.price < 2", {}),
    "in_subquery": ("SELECT id FROM items WHERE maker IN "
                    "(SELECT mid FROM makers WHERE country = 'fr') AND price = 7", {}),
    "union": ("SELECT id FROM items WHERE price < 1 UNION "
              "SELECT id FROM items WHERE price > 98", {}),
    "near_or_meta": ("SELECT id FROM items WHERE vector NEAR $v OR price = 3 LIMIT 40", {}),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_velesql_matches_reference(both, name):
    ref, port, queries = both
    text, extra = QUERIES[name]
    for qi in range(len(queries)):
        params = {"v": queries[qi], "w": queries[(qi + 1) % len(queries)], **extra}
        want = ref.query(text, params)
        got = port.query(text, params)
        assert want, name
        _same(got, want, f"{name}[{qi}]")


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_explain_matches_reference(both, name):
    ref, port, _ = both
    text = QUERIES[name][0]
    assert port.explain_query(text).render() == ref.explain_query(text).render()
    assert port.explain_query(text).to_dict() == ref.explain_query(text).to_dict()


MATCHES = [
    "MATCH (a {category: 'c1'})-[:also_bought]->(b) RETURN a, b.price AS p "
    "ORDER BY p DESC LIMIT 20",
    "MATCH (a)-[r:also_bought*1..2]->(b) WHERE a.price < 2 AND similarity(b, $v) > 0.5 "
    "RETURN a.price AS ap, b, similarity(b, $v) AS s ORDER BY s DESC LIMIT 10",
    "MATCH (a)<-[:similar]-(b) WHERE b.category IN ('c2', 'c3') AND a.price > 97 "
    "RETURN a, b, b.text AS t LIMIT 50",
]


@pytest.mark.parametrize("i", range(len(MATCHES)))
def test_match_matches_reference(both, i):
    ref, port, queries = both
    params = {"v": queries[0]}
    want = ref.match_query("items", MATCHES[i], params)
    got = port.match_query("items", MATCHES[i], params)
    assert want
    _same(got, want, f"match[{i}]")


def test_traverse_matches_reference(both):
    ref, port, _ = both
    r, p = ref.get_collection("items"), port.get_collection("items")
    for start in (0, 17, 1234, 2999):
        for direction in ("out", "in"):
            want = r.traverse(start, max_depth=3, direction=direction)
            assert p.traverse(start, max_depth=3, direction=direction) == want
        assert (p.traverse(start, max_depth=2, label="similar")
                == r.traverse(start, max_depth=2, label="similar"))
        assert p.get_edges(start, "both") == r.get_edges(start, "both")
        assert p.degree(start, "both") == r.degree(start, "both")


def test_near_on_pd_core_matches_search(tmp_path, monkeypatch):
    """131,072 x 32 cosine: the port's NEAR goes through ``int8-assist-pd``
    (#1's plain version here) and returns ``Collection.search``'s rows.

    The pd core is approximate. On the CPU the reference's ``Database``
    serves an exact scan, so its recall is 1.0 wherever the pd rule drops a
    true neighbour; the recall@10 of the port's rows against a float64 oracle
    is held instead to the reference's own pd core (``sq8pd_rerank_topk`` in
    interpret mode, k 10, m 16, on the same rows and normalized query): no
    lower on any query."""
    import jax.numpy as jnp

    import velesdb_tpu.ops.bucket_kernel as jbk
    from velesdb_tpu.index.brute import BruteForceIndex as JIndex
    from velesdb_tpu.ops import DistanceMetric as JMetric
    from velesdb_tpu.ops import StorageMode as JMode

    rng = np.random.default_rng(21)
    n, d = 131_072, 32
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    vecs = centers[rng.integers(0, 64, n)] + 0.7 * rng.standard_normal((n, d)).astype(np.float32)
    db = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu")
    col = db.create_collection("big", d)
    col.upsert_bulk(range(n), vecs, [{"price": float(i % 100)} for i in range(n)])
    col.refresh_device()
    assert col._brute._plan(10) == ("int8-assist-pd", 16)
    calls = []
    fn = tbrute.sq8pd_rerank_topk
    monkeypatch.setattr(tbrute, "sq8pd_rerank_topk",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    j = JIndex(d, JMetric.COSINE, JMode.FULL)
    j.rebuild(vecs, np.ones(n, bool))
    rows_pd, pen_int, _, sdim, _, qu = jbk.sq8pd_build(j._full, j._valid, d, JMetric.COSINE)
    ptile = jbk.sq8pd_ptile(pen_int, col._brute._chunk)
    unit = vecs.astype(np.float64)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    q = vecs[[5, 777, 50_000, 131_000]] + 0.05 * rng.standard_normal((4, d)).astype(np.float32)
    for qi in range(4):
        got = db.query("SELECT * FROM big WHERE vector NEAR $v LIMIT 10", {"v": q[qi]})
        assert calls, "the NEAR query did not run #1's core"
        calls.clear()
        direct = col.search(q[qi], k=10)
        assert [r["id"] for r in got] == [h.id for h in direct]
        assert [r["score"] for r in got] == [h.score for h in direct]
        assert [r["payload"] for r in got] == [h.payload for h in direct]
        qn = q[qi] / np.linalg.norm(q[qi])
        _, ref_ids = jbk.sq8pd_rerank_topk(
            jnp.asarray(qn[None]), rows_pd, ptile, sdim, qu, j._full, k=10, m=16,
            metric=JMetric.COSINE, chunk=col._brute._chunk, dim=d, interpret=True)
        truth = set(np.argsort(-(unit @ qn.astype(np.float64)))[:10].tolist())
        recall = len(truth & {r["id"] for r in got}) / 10
        ref_recall = len(truth & set(np.array(ref_ids)[0].tolist())) / 10
        assert recall >= ref_recall, (qi, recall, ref_recall)
    db.close()
