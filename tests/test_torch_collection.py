"""The slice as a whole on the CPU: ``Database`` -> ``Collection`` -> exact
search in the port, against the JAX package on the same data and directories.

Results agree id for id except at exact score ties, with scores to rtol 1e-5
(fp32 on both sides, different summation order). The on-disk format is
shared: a directory written by either package opens in the other.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import velesdb_tpu
import velesdb_tpu_torch

RTOL = 1e-5
N, DIM = 2000, 24
CAT3 = {"type": "eq", "field": "cat", "value": 3}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    queries = rng.standard_normal((8, DIM)).astype(np.float32)
    payloads = [{"cat": i % 4, "title": f"doc {i}"} for i in range(N)]
    return vecs, queries, payloads


def _same(port_rows, ref_rows):
    assert len(port_rows) == len(ref_rows)
    for got, want in zip(port_rows, ref_rows):
        gs, ws = [h.score for h in got], [h.score for h in want]
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=RTOL)
        for g, w, score in zip(got, want, ws):
            # a different id at a rank is only allowed where scores tie
            assert g.id == w.id or abs(g.score - score) <= RTOL * abs(score) + RTOL
        for h in got:
            assert h.payload == {"cat": h.id % 4, "title": f"doc {h.id}"}


def _fill(db, metric, data):
    vecs, _, payloads = data
    col = db.create_collection("docs", DIM, metric=metric)
    col.upsert_bulk(range(N), vecs, payloads)
    col.upsert(N + 7, vecs[0] * 0.5, {"cat": (N + 7) % 4, "title": f"doc {N + 7}"})
    return col


def _searches(col, queries):
    out = [col.search_batch(queries, k=10), [col.search(queries[0], k=5)]]
    filtered = col.search_batch(queries, k=10, filter=CAT3)
    assert all(h.payload["cat"] == 3 for row in filtered for h in row)
    return out + [filtered]


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product"])
def test_slice_matches_reference(tmp_path, data, metric):
    _, queries, _ = data
    ref_db = velesdb_tpu.Database.open(str(tmp_path / "ref"))
    db = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu")
    ref, col = _fill(ref_db, metric, data), _fill(db, metric, data)
    for a, b in zip(_searches(col, queries), _searches(ref, queries)):
        _same(a, b)
    assert col.info()["serve_engine"] == "streamed-scan"
    for vid in (0, 11, 500, N + 7):
        assert col.delete(vid) == ref.delete(vid) is True
    assert col.count() == ref.count() == N - 3
    assert col.get(11) is None and col.get(12)[1] == ref.get(12)[1]
    got = col.search_batch(queries, k=10)
    _same(got, ref.search_batch(queries, k=10))
    assert not {0, 11, 500, N + 7} & {h.id for row in got for h in row}
    db.close()
    ref_db.close()
    ref = velesdb_tpu.Database.open(str(tmp_path / "ref")).get_collection("docs")
    col = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu").get_collection(
        "docs"
    )
    for a, b in zip(_searches(col, queries), _searches(ref, queries)):
        _same(a, b)


def test_port_opens_reference_directory_and_back(tmp_path, data):
    vecs, queries, _ = data
    path = str(tmp_path / "shared")
    with velesdb_tpu.Database.open(path) as ref_db:
        _fill(ref_db, "euclidean", data)
        ref_db.get_collection("docs").delete(42)
        want = ref_db.get_collection("docs").search_batch(queries, k=10, filter=CAT3)
    with velesdb_tpu_torch.Database.open(path, device="cpu") as db:
        assert db.list_collections() == ["docs"]
        col = db.get_collection("docs")
        assert col.count() == N
        np.testing.assert_array_equal(col.get(5)[0], vecs[5])
        _same(col.search_batch(queries, k=10, filter=CAT3), want)
        col.upsert(N + 100, vecs[3], {"cat": (N + 100) % 4, "title": f"doc {N + 100}"})
    with velesdb_tpu.Database.open(path) as ref_db:
        back = ref_db.get_collection("docs")
        assert back.count() == N + 1
        np.testing.assert_array_equal(back.get(N + 100)[0], vecs[3])


def test_port_never_imports_jax(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(
        f"""
        import sys
        class Blocked:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "lark", "velesdb_tpu"):
                    raise ImportError(f"{{name}} is blocked")
        sys.meta_path.insert(0, Blocked())
        import numpy as np
        sys.path.insert(0, {repo!r})
        import velesdb_tpu_torch
        db = velesdb_tpu_torch.Database.open({str(tmp_path)!r}, device="cpu")
        col = db.create_collection("c", 8, metric="euclidean")
        col.upsert_bulk(range(100), np.eye(100, 8, dtype=np.float32))
        assert col.search(np.eye(1, 8, dtype=np.float32)[0], k=1)[0].id == 0
        x = np.random.default_rng(0).standard_normal((5000, 16)).astype(np.float32)
        for mode in ("sq8", "binary"):
            q = db.create_collection(mode, 16, storage_mode=mode)
            q.upsert_bulk(range(5000), x)
            assert q.search(x[7], k=3)[0].id == 7
            assert q.info()["storage_recall"] is not None
        import velesdb_tpu_torch.ops.pallas_kernels, velesdb_tpu_torch.index.params
        import velesdb_tpu_torch.index.ivf, velesdb_tpu_torch.ops.ivf_kernel
        import velesdb_tpu_torch.velesql.planner
        import velesdb_tpu_torch.experiments, velesdb_tpu_torch.experiments.kernels
        import velesdb_tpu_torch.experiments._common
        import velesdb_tpu_torch.experiments.exp_sq8i_v2, velesdb_tpu_torch.experiments.exp_topk
        import velesdb_tpu_torch.experiments.exp_hamming_mxu
        import velesdb_tpu_torch.experiments.exp_gather_kernel
        x = np.random.default_rng(1).standard_normal((3000, 16)).astype(np.float32)
        v = db.create_collection("v", 16, metric="euclidean")
        v.upsert_bulk(range(3000), x)
        v.index_kind = "ivf"
        assert v.search(x[9], k=3)[0].id == 9 and not v.ivf.dirty
        import velesdb_tpu_torch.index.graph_index, velesdb_tpu_torch.ops.chunked
        from velesdb_tpu_torch.index.ivf import ivf_self_knn, nn_descent_round
        v.index_kind = "graph"
        assert v.search(x[9], k=3, ef=64)[0].id == 9 and not v.ann.dirty
        g = velesdb_tpu_torch.index.graph_index.GraphIndex(
            16, "euclidean", velesdb_tpu_torch.index.params.GraphParams(entry_probes=8),
            device="cpu")
        g.EXACT_KNN_MAX_ROWS = 1000
        y = np.random.default_rng(2).standard_normal((5000, 16)).astype(np.float32)
        g.build(y, np.ones(5000, bool))
        assert g._entry_ivf is not None and g.search(y[5:6], 1)[1].item() == 5
        knn = ivf_self_knn(x, 4, "euclidean", device="cpu")
        assert nn_descent_round(x, knn, "euclidean", device="cpu").shape == (3000, 4)
        import velesdb_tpu_torch.text, velesdb_tpu_torch.fusion, velesdb_tpu_torch.cache
        import velesdb_tpu_torch.ops.fused_rrf
        t = db.create_collection("t", 16, metric="cosine")
        t.upsert_bulk(range(3000), x, [{{"text": "alpha" if i % 2 else "beta gamma",
                                        "price": float(i % 100)}} for i in range(3000)])
        assert t.text_search("gamma", k=3)[0].id % 2 == 0
        assert t.hybrid_search(x[8], "beta", k=3)[0].id == 8 and t.like_mask("%alph%").any()
        assert t.multi_query_search([x[4], x[6]], k=2, strategy="average")
        t.enable_result_cache()
        assert t.search(x[3], k=1) == t.search(x[3], k=1) and t.cache_stats()["hits"] == 1
        t.delete(5)
        assert t.vacuum()["reclaimed_slots"] == 1
        h = db.create_collection("h", 16, metric="hamming")
        h.upsert_bulk(range(3000), x)
        assert h.search(x[11], k=1)[0].id == 11
        import velesdb_tpu_torch.velesql, velesdb_tpu_torch.graph
        rows = db.query("SELECT * FROM t WHERE vector NEAR $v AND price < 50 LIMIT 3",
                        {{"v": x[8]}})
        assert rows[0]["id"] == 8 and all(r["payload"]["price"] < 50 for r in rows)
        t.add_edge(8, 9, "rel")
        assert db.match_query("t", "MATCH (a)-[:rel]->(b) RETURN b")[0]["b"]["id"] == 9
        db.close()
        import json, threading, urllib.request
        import velesdb_tpu_torch.server.app, velesdb_tpu_torch.server.__main__
        import velesdb_tpu_torch.cli, velesdb_tpu_torch.aio, velesdb_tpu_torch.agent
        import velesdb_tpu_torch.migrate, velesdb_tpu_torch.utils.batcher
        import velesdb_tpu_torch.utils.guardrails, velesdb_tpu_torch.utils.tracing
        httpd = velesdb_tpu_torch.server.app.make_server({str(tmp_path)!r}, host="127.0.0.1",
                                                         port=0, device="cpu")
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{{httpd.server_address[1]}}/collections/c/search",
                data=json.dumps({{"vector": np.eye(1, 8)[0].tolist(), "k": 1}}).encode(),
                method="POST", headers={{"Content-Type": "application/json"}})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert json.loads(resp.read())["results"][0]["id"] == 0
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.app.db.close()
        import velesdb_tpu_torch.parallel, velesdb_tpu_torch.parallel.multihost
        import velesdb_tpu_torch.tools.sharded_phase
        mesh = velesdb_tpu_torch.parallel.make_mesh(device="cpu")
        s = velesdb_tpu_torch.parallel.ShardedBruteForce(mesh, 16, "euclidean")
        s.rebuild(x)
        assert s.search(x[9:10], 3)[1][0, 0] == 9
        import velesdb_tpu_torch.integrations, velesdb_tpu_torch.integrations.graph_toolkit
        from velesdb_tpu_torch.integrations.langchain_velesdb import VelesDBVectorStore
        from velesdb_tpu_torch.integrations.llamaindex_velesdb import VelesDBLlamaStore
        from velesdb_tpu_torch.integrations.langchain_velesdb_graph import (
            VelesChatMemory, VelesGraphRetriever, VelesSemanticMemory)
        import velesdb_tpu_torch.examples, velesdb_tpu_torch.examples.quickstart
        import velesdb_tpu_torch.examples.agent_memory_demo
        import velesdb_tpu_torch.examples.ecommerce_demo, velesdb_tpu_torch.examples.graph_rag
        import velesdb_tpu_torch.examples.sharded_scale
        table = {{f"t{{i}}": row for i, row in enumerate(x[:50])}}
        lc = VelesDBVectorStore(table.get, path={str(tmp_path / "lc")!r}, device="cpu")
        lc.add_texts(list(table))
        assert lc.similarity_search("t7", k=1)[0].page_content == "t7"
        li = VelesDBLlamaStore(path={str(tmp_path / "li")!r}, device="cpu")
        li.add([{{"node_id": "a", "embedding": x[0]}}, {{"node_id": "b", "embedding": x[1]}}])
        assert li.query(x[1], similarity_top_k=1).ids == ["b"]
        gdb = velesdb_tpu_torch.Database.open({str(tmp_path / "g")!r}, device="cpu")
        g = gdb.create_collection("g", 16)
        g.upsert_bulk(range(50), x[:50])
        g.add_edge(8, 9, "rel")
        got = VelesGraphRetriever(g, lambda s: x[8], seed_k=1).invoke("q")
        assert [(d.metadata["id"], d.metadata["hop_depth"]) for d in got] == [(8, 0), (9, 1)]
        VelesChatMemory(path={str(tmp_path / "cm")!r}, dimension=8, device="cpu")
        VelesSemanticMemory(path={str(tmp_path / "sm")!r}, dimension=8, device="cpu")
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        assert "lark" not in sys.modules
        assert not [m for m in sys.modules if m.split(".")[0] == "velesdb_tpu"]
        print("no-jax-ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    assert "no-jax-ok" in out.stdout


def test_default_device_is_cuda(tmp_path):
    db = velesdb_tpu_torch.Database(str(tmp_path))
    assert db.device == "cuda"
    col = db.create_collection("c", 4)
    assert col.device.type == "cuda"  # never switched to the CPU on its own


@pytest.mark.parametrize(
    "action",
    [
        "index_graph",
        "index_ivf",
        "add_edge",
        "velesql",
    ],
)
def test_unported_surfaces_raise(tmp_path, action):
    """VelesQL and the knowledge graph were the last ``Database`` and
    ``Collection`` surfaces that raised ``NotImplementedError``; each of them
    serves now, the match on an empty edge store returning no rows."""
    db = velesdb_tpu_torch.Database.open(str(tmp_path), device="cpu")
    col = db.create_collection("c", 4)
    col.upsert(1, np.ones(4, np.float32))
    calls = {
        "index_graph": (lambda: db.match_query("c", "MATCH (a)-[:R]->(b) RETURN b"), []),
        "index_ivf": (lambda: col.ensure_graph() is col.graph, True),
        "add_edge": (lambda: col.add_edge(1, 1, "self"), 0),
        "velesql": (lambda: db.query("SELECT * FROM c LIMIT 1"), [{"id": 1, "payload": None}]),
    }
    call, want = calls[action]
    assert call() == want
    assert not os.path.exists(os.path.join(str(tmp_path), "q", "config.json"))


# -- slice 2: quantized storage ---------------------------------------------

QN, QDIM = 6000, 32


def _clustered(rng, n, d):
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    return centers[rng.integers(0, 64, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


@pytest.fixture(scope="module")
def qdata():
    x = _clustered(np.random.default_rng(1), QN + 32, QDIM)
    return x[:QN], x[QN:]


def _oracle(x, q, metric, keep=None):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "euclidean":
        s = -((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    elif metric == "cosine":
        s = (q64 / np.linalg.norm(q64, axis=1, keepdims=True)) @ (
            x64 / np.linalg.norm(x64, axis=1, keepdims=True)).T
    else:
        s = q64 @ x64.T
    if keep is not None:
        s = np.where(keep[None, :], s, -np.inf)
    return np.argsort(-s, axis=1)[:, :10]


def _recall(rows, truth):
    return np.mean([len({h.id for h in r} & set(t.tolist())) / 10 for r, t in zip(rows, truth)])


@pytest.mark.parametrize("mode", ["sq8", "binary"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product"])
def test_quantized_collection_matches_reference(tmp_path, qdata, mode, metric):
    """Auto-rerank behind the storage gate, filters and reopen, through both
    packages on the same data: the port's recall@10 against a float64 oracle
    is no lower than the reference's less 0.01, and the gate settles on the
    same oversample."""
    x, q = qdata
    payloads = [{"cat": i % 4} for i in range(QN)]
    ref = velesdb_tpu.Database.open(str(tmp_path / "ref")).create_collection(
        "c", QDIM, metric=metric, storage_mode=mode)
    db = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu")
    col = db.create_collection("c", QDIM, metric=metric, storage_mode=mode)
    for c in (ref, col):
        c.upsert_bulk(range(QN), x, payloads)
    truth = _oracle(x, q, metric)
    got, want = col.search_batch(q, k=10), ref.search_batch(q, k=10)
    assert _recall(got, truth) >= _recall(want, truth) - 0.01
    assert col._rerank_oversample == ref._rerank_oversample
    assert col.info()["storage_recall"] == pytest.approx(ref._storage_recall[1], abs=0.01)
    assert col.info()["storage_mode"] == mode
    cat3 = np.arange(QN) % 4 == 3
    filtered = col.search_batch(q, k=10, filter=CAT3)
    assert all(h.payload == {"cat": 3} for row in filtered for h in row)
    assert _recall(filtered, _oracle(x, q, metric, cat3)) >= _recall(
        ref.search_batch(q, k=10, filter=CAT3), _oracle(x, q, metric, cat3)) - 0.01
    raw = col.search_batch(q, k=10, _raw=True)  # the coarse pass alone
    assert all(len(row) == 10 for row in raw)
    db.close()
    col = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu").get_collection("c")
    assert col.storage_mode.value == mode and col.count() == QN
    again = col.search_batch(q, k=10)
    assert [[h.id for h in r] for r in again] == [[h.id for h in r] for r in got]


def test_search_with_rerank_and_perfect_quality(tmp_path, qdata):
    """``search_with_rerank`` returns host f32 scores best-first; FULL storage
    with ``quality="perfect"`` takes the same host rerank."""
    x, q = qdata
    db = velesdb_tpu_torch.Database.open(str(tmp_path), device="cpu")
    col = db.create_collection("s", QDIM, metric="euclidean", storage_mode="sq8")
    col.upsert_bulk(range(QN), x)
    one = col.search_with_rerank(q[0], k=5, oversample=8)
    want = np.linalg.norm(x - q[0], axis=1)
    assert [h.id for h in one] == np.argsort(want)[:5].tolist()
    np.testing.assert_allclose([h.score for h in one], np.sort(want)[:5], rtol=1e-5)
    assert len(col.search_batch_with_rerank(q[:4], k=5)) == 4
    full = db.create_collection("f", QDIM, metric="cosine")
    full.upsert_bulk(range(QN), x)
    perfect = full.search_batch(q, k=10, quality="perfect")
    assert _recall(perfect, _oracle(x, q, "cosine")) == 1.0
    assert full.info()["storage_recall"] is None  # no gate on FULL storage


def test_storage_gate_widens_the_oversample(tmp_path):
    """Sign sketches of 8-dim data are weak: the gate doubles the oversample
    until the probe clears the bar or the 32x cap, as the reference does."""
    x = _clustered(np.random.default_rng(2), 5000, 8)
    db = velesdb_tpu_torch.Database.open(str(tmp_path), device="cpu")
    col = db.create_collection("b", 8, metric="euclidean", storage_mode="binary")
    col.upsert_bulk(range(5000), x)
    col.search(x[0], k=10)
    r = col.info()["storage_recall"]
    assert col._rerank_oversample > 4.0
    assert r >= 0.95 or col._rerank_oversample == 32.0
    gate_at = col._storage_gate_used
    col.upsert(6000, x[1])  # under 10% drift: no new probe
    col.search(x[0], k=10)
    assert col._storage_gate_used == gate_at
