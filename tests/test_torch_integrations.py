"""The port's client adapters (``velesdb_tpu_torch.integrations``) on the CPU.

First ``tests/test_integrations.py``'s ten cases by name, run against the
port's adapters with ``device="cpu"`` and the same ``FakeEmbedder``. Then
parity: the same texts through the reference's adapters (``integrations/``,
JAX on the CPU) and the port's must give the same LangChain documents and
scores (within 1e-6), MMR selections, LlamaIndex ids, graph-retriever
documents and memory variables; one case at 131,072 x 32, where the port
serves #1's plain version; and directories written by either package's
adapter read back through the other's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import velesdb_tpu_torch.index.brute as tbrute
from velesdb_tpu_torch import Database
from velesdb_tpu_torch.integrations.langchain_velesdb import VelesDBVectorStore, _stable_id
from velesdb_tpu_torch.integrations.llamaindex_velesdb import VelesDBLlamaStore
from velesdb_tpu_torch.tools.client_phase import TableEmbedding

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CPU = "cpu"
TOL = 1e-6


class FakeEmbedder:
    """Deterministic embedding: hash words into a small dense space."""

    def __init__(self, dim=32):
        self.dim = dim

    def _embed(self, text):
        rng = np.random.default_rng(abs(hash(text)) % (2**32))
        return rng.standard_normal(self.dim).astype(np.float32).tolist()

    def embed_documents(self, texts):
        return [self._embed(t) for t in texts]

    def embed_query(self, text):
        return self._embed(text)


# -- tests/test_integrations.py's cases, against the port ---------------------


def test_langchain_store_roundtrip(tmp_db_dir):
    store = VelesDBVectorStore(FakeEmbedder(), path=tmp_db_dir, device=CPU)
    ids = store.add_texts(
        ["the fox jumps", "coffee is hot", "tea is warm"],
        metadatas=[{"k": 1}, {"k": 2}, {"k": 3}],
    )
    assert len(ids) == 3
    docs = store.similarity_search("coffee is hot", k=1)
    assert docs[0].page_content == "coffee is hot"
    assert docs[0].metadata == {"k": 2}
    pairs = store.similarity_search_with_score("the fox jumps", k=2)
    assert pairs[0][0].page_content == "the fox jumps"
    assert pairs[0][1] == pytest.approx(1.0, abs=1e-5)
    assert store.delete([ids[1]])
    docs = store.similarity_search("coffee is hot", k=3)
    assert all(d.page_content != "coffee is hot" for d in docs)


def test_langchain_mmr_diversifies(tmp_db_dir):
    store = VelesDBVectorStore(FakeEmbedder(), path=tmp_db_dir, device=CPU)
    # two near-duplicates + one distinct
    store.add_texts(["alpha doc", "alpha doc", "omega doc"])
    out = store.max_marginal_relevance_search(
        "alpha doc", k=2, fetch_k=3, lambda_mult=0.3
    )
    contents = [d.page_content for d in out]
    assert "alpha doc" in contents and "omega doc" in contents


def test_langchain_from_texts(tmp_db_dir):
    store = VelesDBVectorStore.from_texts(
        ["a", "b"], FakeEmbedder(), path=tmp_db_dir, device=CPU
    )
    assert len(store.similarity_search("a", k=2)) == 2


def test_llamaindex_store(tmp_db_dir):
    store = VelesDBLlamaStore(path=tmp_db_dir, device=CPU)
    emb = FakeEmbedder()
    nodes = [
        {"node_id": f"n{i}", "embedding": emb._embed(f"text {i}"),
         "text": f"text {i}", "metadata": {"i": i}}
        for i in range(5)
    ]
    ids = store.add(nodes)
    assert ids == [f"n{i}" for i in range(5)]
    res = store.query(emb._embed("text 3"), similarity_top_k=2)
    assert res.ids[0] == "n3" and res.similarities[0] == pytest.approx(1.0, abs=1e-5)
    store.delete("n3")
    res = store.query(emb._embed("text 3"), similarity_top_k=5)
    assert "n3" not in res.ids


def test_graph_retriever_seed_and_expand(tmp_db_dir):
    from velesdb_tpu_torch.integrations.langchain_velesdb_graph import VelesGraphRetriever

    rng = np.random.default_rng(0)
    db = Database(tmp_db_dir, device=CPU)
    docs = db.create_collection("docs", dim=8)
    emb = {t: rng.standard_normal(8).astype(np.float32)
           for t in ["alpha", "beta", "gamma", "delta"]}
    for i, t in enumerate(emb):
        docs.upsert(i, emb[t], {"text": t})
    docs.add_edge(0, 1, "REF")
    docs.add_edge(1, 2, "REF")
    retr = VelesGraphRetriever(
        docs, embedding=lambda t: emb[t], seed_k=1, expand_k=4, max_depth=2,
        rel_types=["REF"],
    )
    got = retr.get_relevant_documents("alpha")
    contents = [d.page_content for d in got]
    assert contents[0] == "alpha"
    assert "beta" in contents and "gamma" in contents  # 1- and 2-hop
    assert "delta" not in contents  # disconnected
    assert got[1].metadata["hop_depth"] >= 1
    # low_latency skips expansion
    fast = VelesGraphRetriever(
        docs, embedding=lambda t: emb[t], seed_k=1, low_latency=True
    )
    assert len(fast.get_relevant_documents("alpha")) == 1


def test_chat_and_semantic_memory(tmp_path):
    from velesdb_tpu_torch.integrations.langchain_velesdb_graph import (
        VelesChatMemory,
        VelesSemanticMemory,
    )

    rng = np.random.default_rng(1)
    mem = VelesChatMemory(path=str(tmp_path / "a"), dimension=8, device=CPU)
    mem.save_context({"input": "hello"}, {"output": "hi there"})
    mem.save_context({"input": "more"}, {"output": "sure"})
    hist = mem.load_memory_variables({})["history"]
    assert hist.index("Human: hello") < hist.index("AI: sure")
    mem.clear()
    assert mem.load_memory_variables({})["history"] == ""

    emb = {"alpha": rng.standard_normal(8).astype(np.float32)}
    sem = VelesSemanticMemory(
        path=str(tmp_path / "b"),
        embedding=lambda t: emb.get(t, rng.standard_normal(8).astype(np.float32)),
        dimension=8,
        k=2,
        device=CPU,
    )
    sem.remember("alpha", importance=0.9)
    assert "alpha" in sem.load_memory_variables({"q": "alpha"})["facts"]


def test_semantic_chunker_boundaries():
    from velesdb_tpu_torch.integrations.graph_toolkit import SemanticChunker

    text = ("Para one sentence a. Sentence b about things.\n\n"
            "Para two starts here and continues with more words. "
            "It has another sentence that makes it long enough to split.")
    chunks = SemanticChunker(chunk_size=80, chunk_overlap=20).chunk(text)
    assert len(chunks) >= 2
    assert all(c.text for c in chunks)
    # overlap: consecutive chunks share text
    joined = "".join(c.text for c in chunks)
    assert "Para two" in joined and len(joined) >= len(text) - 10


def test_heuristic_extractor():
    from velesdb_tpu_torch.integrations.graph_toolkit import HeuristicExtractor

    ents, rels = HeuristicExtractor().extract(
        "Ada Lovelace works at Analytical Engines. "
        "Charles Babbage founded Analytical Engines."
    )
    names = {e.name for e in ents}
    assert "Ada Lovelace" in names and "Analytical Engines" in names
    typed = {(r.source, r.relation_type, r.target) for r in rels}
    assert ("Ada Lovelace", "WORKS_AT", "Analytical Engines") in typed
    assert ("Charles Babbage", "FOUNDED", "Analytical Engines") in typed


def test_llm_extractor_contract():
    import json

    from velesdb_tpu_torch.integrations.graph_toolkit import LLMExtractor

    def fake_llm(prompt):
        return "sure! " + json.dumps({
            "entities": [{"name": "Mars", "type": "Planet"}],
            "relations": [{"source": "Mars", "target": "Sun",
                           "type": "ORBITS"}],
        })

    ents, rels = LLMExtractor(fake_llm).extract("whatever")
    assert ents[0].entity_type == "Planet"
    assert rels[0].relation_type == "ORBITS"
    assert LLMExtractor(lambda p: "garbage").extract("x") == ([], [])


def test_graph_loader_end_to_end(tmp_db_dir):
    from velesdb_tpu_torch.integrations.graph_toolkit import GraphLoader, SemanticChunker

    db = Database(tmp_db_dir, device=CPU)
    coll = db.create_collection("kg", dim=16)
    loader = GraphLoader(coll)
    stats = loader.load_document(
        "Marie Curie works at Sorbonne University. "
        "Pierre Curie married to Marie Curie.",
        chunker=SemanticChunker(chunk_size=200, chunk_overlap=40),
    )
    assert stats["entities"] >= 3 and stats["relations"] >= 2
    assert stats["chunks"] >= 1
    # idempotent entity ids: re-loading does not duplicate nodes
    loader2 = GraphLoader(coll)
    loader2.load_document("Marie Curie works at Sorbonne University.")
    rows = coll.execute_match(
        "MATCH (a)-[:WORKS_AT]->(b) RETURN a.name AS a, b.name AS b"
    )
    assert ("Marie Curie", "Sorbonne University") in {
        (r["a"], r["b"]) for r in rows
    }
    # the loaded graph is traversable by the RAG retriever via MENTIONS
    chunk_id = stats["chunk_ids"][0]
    got = coll.get(chunk_id)
    assert got is not None and got[1]["kind"] == "chunk"
    nbrs = coll.neighbors(chunk_id, "out", "MENTIONS")
    assert len(nbrs) >= 1
    db.close()


# -- parity with the reference's adapters --------------------------------------

TEXTS = [f"{a} {b} {c}" for a in ("red", "green", "blue", "black") for b in
         ("fox", "coffee", "tea", "river", "stone") for c in ("jumps", "is hot", "flows",
                                                              "sleeps")]
METAS = [{"k": i % 5, "tag": "even" if i % 2 == 0 else "odd"} for i in range(len(TEXTS))]
QUERIES = ["red fox jumps", "blue tea flows", "a query of its own", "black stone sleeps"]


def _docs(pairs):
    return [(d.page_content, d.metadata, s) for d, s in pairs]


def _same_docs(got, want, scale=None):
    """LangChain ``(document, score)`` lists: the same documents in order,
    scores within 1e-6 (times ``scale[i]``, the magnitude of the sums behind
    the i-th score, where it is given)."""
    assert [g[:2] for g in _docs(got)] == [w[:2] for w in _docs(want)]
    scale = scale or [1.0] * len(got)
    assert all(abs(g[1] - w[1]) <= TOL * c for g, w, c in zip(got, want, scale))


@pytest.fixture
def both_stores(tmp_path):
    from integrations.langchain_velesdb import VelesDBVectorStore as RefStore

    emb = FakeEmbedder(24)
    ref = RefStore(emb, path=str(tmp_path / "ref"))
    port = VelesDBVectorStore(emb, path=str(tmp_path / "port"), device=CPU)
    ids = [f"id-{i}" for i in range(len(TEXTS))]
    assert ref.add_texts(TEXTS, METAS, ids=ids) == port.add_texts(TEXTS, METAS, ids=ids)
    return ref, port


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_langchain_documents_and_scores_equal_reference(tmp_path, metric):
    """Cosine scores within 1e-6. The f32 sums behind a dot score are as
    large as ``|q| |c|``, and a euclidean score is the root of ``|q|^2 +
    |c|^2 - 2 q.c``, summed in another order by each package: dot scores are
    held within 1e-6 of ``max(1, |q| |c|)``, euclidean ones squared within
    1e-6 of ``|q|^2 + |c|^2`` (the root of a cancelled sum near 0 differs
    by up to ~3e-3 between the two)."""
    from integrations.langchain_velesdb import VelesDBVectorStore as RefStore

    emb = FakeEmbedder(24)
    ref = RefStore(emb, path=str(tmp_path / "ref"), metric=metric)
    port = VelesDBVectorStore(emb, path=str(tmp_path / "port"), metric=metric, device=CPU)
    ref.add_texts(TEXTS, METAS, ids=[str(i) for i in range(len(TEXTS))])
    port.add_texts(TEXTS, METAS, ids=[str(i) for i in range(len(TEXTS))])
    norm = {t: float(np.linalg.norm(emb._embed(t))) for t in TEXTS + QUERIES}
    for q in QUERIES + TEXTS[::7]:
        for k in (1, 4, 10):
            got = port.similarity_search_with_score(q, k=k)
            want = ref.similarity_search_with_score(q, k=k)
            sums = [norm[q] * norm[d.page_content] for d, _ in want]
            if metric == "euclidean":
                got = [(d, s * s) for d, s in got]
                want = [(d, s * s) for d, s in want]
                sums = [norm[q] ** 2 + norm[d.page_content] ** 2 for d, _ in want]
            _same_docs(got, want, None if metric == "cosine" else [max(1.0, c) for c in sums])
    assert [d.page_content for d in port.similarity_search(QUERIES[0], k=5)] == [
        d.page_content for d in ref.similarity_search(QUERIES[0], k=5)]


def test_langchain_filter_delete_and_mmr_equal_reference(both_stores):
    ref, port = both_stores
    filters = [{"type": "eq", "field": "metadata.tag", "value": "odd"},
               {"type": "lt", "field": "metadata.k", "value": 2}]
    for q in QUERIES:
        for f in filters:
            got = port.similarity_search_with_score(q, k=6, filter=f)
            _same_docs(got, ref.similarity_search_with_score(q, k=6, filter=f))
            assert got and all(f["field"] != "metadata.tag" or d.metadata["tag"] == "odd"
                               for d, _ in got)
        for k, fetch, lam in ((4, 20, 0.5), (3, 8, 0.2), (6, 40, 0.9)):
            assert port.max_marginal_relevance_search(q, k=k, fetch_k=fetch, lambda_mult=lam) \
                == ref.max_marginal_relevance_search(q, k=k, fetch_k=fetch, lambda_mult=lam)
    gone = [f"id-{i}" for i in range(0, len(TEXTS), 3)]
    assert port.delete(gone) == ref.delete(gone) is True
    for q in QUERIES + TEXTS[:6]:
        got = port.similarity_search_with_score(q, k=8)
        _same_docs(got, ref.similarity_search_with_score(q, k=8))
        assert not {d.page_content for d, _ in got} & {TEXTS[i] for i in range(0, len(TEXTS), 3)}


def test_llamaindex_ids_equal_reference(tmp_path):
    from integrations.llamaindex_velesdb import VelesDBLlamaStore as RefLlama

    emb = FakeEmbedder(16)
    nodes = [{"node_id": f"n{i}", "embedding": emb._embed(t), "text": t,
              "metadata": {"i": i, "odd": i % 2 == 1}} for i, t in enumerate(TEXTS)]
    ref = RefLlama(path=str(tmp_path / "ref"), dim=16)
    port = VelesDBLlamaStore(path=str(tmp_path / "port"), dim=16, device=CPU)
    assert port.add(nodes) == ref.add(nodes)
    for q in QUERIES:
        for filters in (None, {"type": "eq", "field": "metadata.odd", "value": True}):
            got = port.query(emb._embed(q), similarity_top_k=7, filters=filters)
            want = ref.query(emb._embed(q), similarity_top_k=7, filters=filters)
            assert got.ids == want.ids and got.payloads == want.payloads
            assert np.allclose(got.similarities, want.similarities, rtol=0, atol=TOL)
    port.delete("n3")
    ref.delete("n3")
    got = port.query(emb._embed(TEXTS[3]), similarity_top_k=5)
    assert got.ids == ref.query(emb._embed(TEXTS[3]), similarity_top_k=5).ids
    assert "n3" not in got.ids


def _graph_pair(tmp_path, n=300, d=16, edges=900, seed=5):
    """The same collection and typed edges in both packages."""
    from velesdb_tpu import Database as RefDatabase

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    src, dst = rng.integers(0, n, edges), rng.integers(0, n, edges)
    lab = rng.choice(["cites", "likes"], edges)
    cols = []
    for db in (RefDatabase(str(tmp_path / "ref")), Database(str(tmp_path / "port"), device=CPU)):
        col = db.create_collection("g", d)
        col.upsert_bulk(range(n), x, [{"text": f"doc {i}", "n": i} for i in range(n)])
        for s, t, lb in zip(src.tolist(), dst.tolist(), lab.tolist()):
            col.add_edge(s, t, lb)
        cols.append(col)
    return x, cols


@pytest.mark.parametrize("kw", [
    {"seed_k": 3, "expand_k": 10, "max_depth": 2, "rel_types": ["cites"]},
    {"seed_k": 5, "expand_k": 25, "max_depth": 3},
    {"seed_k": 2, "expand_k": 8, "max_depth": 1, "rel_types": ["cites", "likes"],
     "direction": "in"},
    {"seed_k": 4, "expand_k": 6, "score_threshold": 0.3},
])
def test_graph_retriever_documents_equal_reference(tmp_path, kw):
    from integrations.langchain_velesdb_graph import VelesGraphRetriever as RefRetriever
    from velesdb_tpu_torch.integrations.langchain_velesdb_graph import VelesGraphRetriever

    x, (rcol, pcol) = _graph_pair(tmp_path)
    rng = np.random.default_rng(9)
    queries = {f"q{i}": x[i * 7] + 0.3 * rng.standard_normal(16).astype(np.float32)
               for i in range(12)}
    ref = RefRetriever(rcol, embedding=queries.get, **kw)
    port = VelesGraphRetriever(pcol, embedding=queries.get, **kw)
    for q in queries:
        want = ref.get_relevant_documents(q)
        got = port.invoke(q)
        assert [d.page_content for d in got] == [d.page_content for d in want]
        assert [(d.metadata["id"], d.metadata["hop_depth"], d.metadata["n"]) for d in got] == \
            [(d.metadata["id"], d.metadata["hop_depth"], d.metadata["n"]) for d in want]
        assert all(abs(g.metadata["score"] - w.metadata["score"]) <= TOL
                   for g, w in zip(got, want))


def test_chat_and_semantic_memory_variables_equal_reference(tmp_path):
    from integrations.langchain_velesdb_graph import VelesChatMemory as RefChat
    from integrations.langchain_velesdb_graph import VelesSemanticMemory as RefFacts
    from velesdb_tpu_torch.integrations.langchain_velesdb_graph import (
        VelesChatMemory,
        VelesSemanticMemory,
    )

    emb = FakeEmbedder(12)
    chats = (RefChat(path=str(tmp_path / "rc"), embedding=emb, dimension=12, window=6),
             VelesChatMemory(path=str(tmp_path / "pc"), embedding=emb, dimension=12, window=6,
                             device=CPU))
    facts = (RefFacts(path=str(tmp_path / "rf"), embedding=emb, dimension=12, k=3),
             VelesSemanticMemory(path=str(tmp_path / "pf"), embedding=emb, dimension=12, k=3,
                                 device=CPU))
    turns = [("hello", "hi there"), ("what is velesdb", "a vector database"),
             ("and the graph", "typed edges"), ("bye", "see you")]
    for human, ai in turns:
        for m in chats:
            m.save_context({"input": human}, {"output": ai})
    assert chats[0].memory_variables == chats[1].memory_variables == ["history"]
    assert chats[1].load_memory_variables({}) == chats[0].load_memory_variables({})
    for i, t in enumerate(TEXTS[:20]):
        for m in facts:
            m.remember(t, importance=0.1 + 0.04 * i, source="test")
    for m in facts:
        m.save_context({"q": "green coffee flows"}, {"a": "black river sleeps"})
    for q in QUERIES + TEXTS[:5]:
        assert facts[1].load_memory_variables({"q": q}) == facts[0].load_memory_variables({"q": q})
    for pair in (chats, facts):
        for m in pair:
            m.clear()
        assert pair[1].load_memory_variables({"q": "x"}) == \
            pair[0].load_memory_variables({"q": "x"})


def test_langchain_store_at_the_pd_core_size(tmp_path, monkeypatch):
    """131,072 x 32 cosine: the port's store serves ``int8-assist-pd`` (#1's
    plain version on the CPU), its documents equal the port's direct
    ``Collection.search``, and they match the reference adapter's (an exact
    scan on the CPU): the same top 1, recall@10 >= 0.99 over the queries,
    the shared documents' scores within 1e-6."""
    from integrations.langchain_velesdb import VelesDBVectorStore as RefStore

    rng = np.random.default_rng(21)
    n, d = 131_072, 32
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 64, n)] + 0.7 * rng.standard_normal((n, d)).astype(np.float32)
    pick = rng.integers(0, n, 24)
    q = x[pick] + 0.05 * rng.standard_normal((24, d)).astype(np.float32)
    texts = [f"doc {i}" for i in range(n)]
    emb = TableEmbedding({**dict(zip(texts, x)), **{f"query {i}": r for i, r in enumerate(q)}})
    port = VelesDBVectorStore(emb, path=str(tmp_path / "port"), device=CPU)
    ref = RefStore(emb, path=str(tmp_path / "ref"))
    ids = [str(i) for i in range(n)]
    port.add_texts(texts, ids=ids)
    ref.add_texts(texts, ids=ids)
    col = port._coll
    col.refresh_device()
    assert col._brute._plan(10) == ("int8-assist-pd", 16)
    calls = []
    fn = tbrute.sq8pd_rerank_topk
    monkeypatch.setattr(tbrute, "sq8pd_rerank_topk",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    recall = []
    for i in range(len(q)):
        got = port.similarity_search_with_score(f"query {i}", k=10)
        assert calls, "the store's search did not run #1's core"
        calls.clear()
        direct = col.search(q[i], k=10)
        assert [(d.page_content, s) for d, s in got] == [
            (h.payload["text"], h.score) for h in direct]
        want = dict((d.page_content, s) for d, s in ref.similarity_search_with_score(
            f"query {i}", k=10))
        assert got[0][0].page_content == f"doc {pick[i]}" == next(iter(want))
        shared = [(t, s) for t, s in ((d.page_content, s) for d, s in got) if t in want]
        assert all(abs(s - want[t]) <= TOL for t, s in shared)
        recall.append(len(shared) / 10)
    assert np.mean(recall) >= 0.99


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directory_reads_back_through_the_other_package(tmp_path, writer):
    """A directory written by one package's LangChain and LlamaIndex
    adapters, closed, then opened through the other's: the same documents,
    ids and scores, and deletes by the writer's string ids."""
    from integrations.langchain_velesdb import VelesDBVectorStore as RefStore
    from integrations.llamaindex_velesdb import VelesDBLlamaStore as RefLlama

    emb = FakeEmbedder(20)
    path = str(tmp_path / "shared")
    mk_lc = {"reference": lambda: RefStore(emb, path=path, collection_name="lc"),
             "port": lambda: VelesDBVectorStore(emb, path=path, collection_name="lc",
                                                device=CPU)}
    mk_li = {"reference": lambda: RefLlama(path=path, collection_name="li", dim=20),
             "port": lambda: VelesDBLlamaStore(path=path, collection_name="li", dim=20,
                                               device=CPU)}
    reader = "port" if writer == "reference" else "reference"
    lc, li = mk_lc[writer](), mk_li[writer]()
    ids = lc.add_texts(TEXTS, METAS)
    li.add([{"node_id": f"n{i}", "embedding": emb._embed(t), "text": t, "metadata": m}
            for i, (t, m) in enumerate(zip(TEXTS, METAS))])
    want = {q: lc.similarity_search_with_score(q, k=5) for q in QUERIES}
    want_li = {q: li.query(emb._embed(q), similarity_top_k=5) for q in QUERIES}
    lc.db.close()
    li.db.close()
    lc2, li2 = mk_lc[reader](), mk_li[reader]()
    for q in QUERIES:
        _same_docs(lc2.similarity_search_with_score(q, k=5), want[q])
        got = li2.query(emb._embed(q), similarity_top_k=5)
        assert got.ids == want_li[q].ids and got.payloads == want_li[q].payloads
    top = want[QUERIES[0]][0][0].page_content
    assert lc2.delete([ids[TEXTS.index(top)]])
    assert top not in [d.page_content for d in lc2.similarity_search(QUERIES[0], k=5)]
    assert _stable_id(ids[-1]) in lc2._coll.vectors.id_to_slot
    lc2.db.close()
    li2.db.close()


def test_graph_toolkit_equals_reference(tmp_path):
    """The port's copy of ``graph_toolkit`` chunks, extracts and loads as
    the reference's does: the same chunks, entities, relations, stats, node
    ids and edges."""
    import integrations.graph_toolkit as ref_gt
    import velesdb_tpu_torch.integrations.graph_toolkit as gt
    from velesdb_tpu import Database as RefDatabase

    text = ("Marie Curie works at Sorbonne University. Pierre Curie married to Marie Curie. "
            "The Sorbonne University is based in Paris.\n\nAda Lovelace works for Analytical "
            "Engines. Charles Babbage founded Analytical Engines. " * 3)
    for size, overlap in ((80, 20), (200, 40), (1000, 200)):
        a = gt.SemanticChunker(size, overlap).chunk(text)
        b = ref_gt.SemanticChunker(size, overlap).chunk(text)
        assert [(c.text, c.start, c.end) for c in a] == [(c.text, c.start, c.end) for c in b]
    ea, ra = gt.HeuristicExtractor().extract(text)
    eb, rb = ref_gt.HeuristicExtractor().extract(text)
    assert [vars(e) for e in ea] == [vars(e) for e in eb]
    assert [vars(r) for r in ra] == [vars(r) for r in rb]
    cols = [RefDatabase(str(tmp_path / "ref")).create_collection("kg", 16),
            Database(str(tmp_path / "port"), device=CPU).create_collection("kg", 16)]
    stats = [mod.GraphLoader(c).load_document(text, chunker=mod.SemanticChunker(200, 40))
             for mod, c in ((ref_gt, cols[0]), (gt, cols[1]))]
    assert stats[0] == stats[1]
    ids = sorted(cols[0].vectors.id_to_slot)
    assert sorted(cols[1].vectors.id_to_slot) == ids
    for vid in ids:
        assert cols[1].neighbors(vid, "out") == cols[0].neighbors(vid, "out")
        assert cols[1].get(vid)[1] == cols[0].get(vid)[1]


def test_adapters_default_to_the_card(tmp_path):
    """Every adapter that opens a database opens it on ``cuda`` unless the
    caller passes ``device="cpu"``: nothing moves to the CPU on its own."""
    import torch

    from velesdb_tpu_torch.integrations.langchain_velesdb_graph import (
        VelesChatMemory,
        VelesSemanticMemory,
    )

    emb = FakeEmbedder(8)
    made = [VelesDBVectorStore(emb, path=str(tmp_path / "a")),
            VelesDBLlamaStore(path=str(tmp_path / "b")),
            VelesChatMemory(path=str(tmp_path / "c"), dimension=8).memory,
            VelesSemanticMemory(path=str(tmp_path / "d"), embedding=emb, dimension=8).memory]
    assert [m.db.device for m in made] == ["cuda"] * 4
    if not torch.cuda.is_available():
        made[0].add_texts(["a", "b"])  # written to disk; the device is met at the search
        with pytest.raises((RuntimeError, AssertionError)):
            made[0].similarity_search("a")
