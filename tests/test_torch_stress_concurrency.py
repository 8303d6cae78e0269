"""Concurrency stress against the port: many-thread upsert/search/delete
races, and the lazy builds a server's handler threads reach at once.

The first three tests are ``tests/test_stress_concurrency.py`` case for case,
by name, on ``velesdb_tpu_torch`` with the database on the CPU: no crashes,
no torn reads, every acked write visible, search always coherent. The rest
hold the port's repair of the lazy builds (the BM25 index, its device blocks,
the column store, the knowledge graph): a first query that meets a build
still running waits for it under the collection's lock, so a burst of mixed
requests at a freshly reopened collection answers as the same requests in
series do. Every join carries a timeout.
"""

import sys
import threading

import numpy as np
import pytest

import velesdb_tpu_torch.collection as collection_mod
from velesdb_tpu_torch.database import Database as _Database
from velesdb_tpu_torch.text.bm25 import Bm25Index
from velesdb_tpu_torch.utils.tracing import set_level, span, span_stats

TIMEOUT = 60


class Database(_Database):
    """The port's database, on the CPU."""

    @classmethod
    def open(cls, path, device="cpu"):
        return super().open(path, device=device)


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_upsert_search_delete(tmp_db_dir, rng):
    db = Database.open(tmp_db_dir)
    c = db.create_collection("stress", dim=16)
    n_writers, per_writer = 4, 60
    vecs = rng.standard_normal((n_writers * per_writer, 16)).astype(np.float32)
    errors: list[Exception] = []
    stop = threading.Event()

    def writer(w):
        try:
            for i in range(per_writer):
                vid = w * per_writer + i
                c.upsert(vid, vecs[vid], {"w": w, "i": i})
                if i % 7 == 3:
                    c.delete(vid)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def searcher():
        try:
            while not stop.is_set():
                hits = c.search(vecs[0], k=5)
                for h in hits:  # coherent rows only
                    assert h.id >= 0 and h.payload is None or "w" in (h.payload or {})
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(n_writers)]
    s_threads = [threading.Thread(target=searcher) for _ in range(2)]
    for t in threads + s_threads:
        t.start()
    _join(threads)
    stop.set()
    _join(s_threads)
    assert not errors, errors

    expected_alive = {
        w * per_writer + i
        for w in range(n_writers)
        for i in range(per_writer)
        if i % 7 != 3
    }
    assert c.count() == len(expected_alive)
    for vid in list(expected_alive)[:20]:
        got = c.get(vid)
        assert got is not None and got[1]["i"] == vid % per_writer
    # store remains fully searchable after the storm
    alive = sorted(expected_alive)[0]
    assert c.search(vecs[alive], k=1)[0].id == alive
    db.close()


def test_concurrent_text_and_vector(tmp_db_dir, rng):
    db = Database.open(tmp_db_dir)
    c = db.create_collection("mix", dim=8)
    vecs = rng.standard_normal((100, 8)).astype(np.float32)
    c.upsert_bulk(range(100), vecs, [{"body": f"doc number {i}"} for i in range(100)])
    errors = []

    def vec_search():
        try:
            for i in range(30):
                c.search(vecs[i % 100], k=3)
        except Exception as e:
            errors.append(e)

    def txt_search():
        try:
            for i in range(30):
                c.text_search(f"number {i}", k=3)
        except Exception as e:
            errors.append(e)

    def mutate():
        try:
            for i in range(30):
                c.upsert(200 + i, rng.standard_normal(8), {"body": f"new {i}"})
        except Exception as e:
            errors.append(e)

    threads = [
        threading.Thread(target=f) for f in (vec_search, txt_search, mutate)
    ]
    for t in threads:
        t.start()
    _join(threads)
    assert not errors, errors
    assert c.count() == 130
    db.close()


def test_tracing_spans():
    set_level("debug")
    try:
        with span("outer", corpus=10) as path:
            assert path == ("outer",)
            with span("inner") as inner_path:
                assert inner_path == ("outer", "inner")
        assert span_stats("outer").count >= 1
        assert span_stats("inner").count >= 1
        with pytest.raises(ValueError):
            with span("failing"):
                raise ValueError("boom")
    finally:
        set_level("warning")


# -- the lazy builds under concurrent first queries --------------------------


def _docs(tmp_db_dir, n=400):
    """A flushed, reopened collection with text payloads: every lazy build
    (BM25, its blocks, columns, graph) is still ahead."""
    rng = np.random.default_rng(3)
    db = Database.open(tmp_db_dir)
    c = db.create_collection("docs", dim=8)
    vecs = rng.standard_normal((n, 8)).astype(np.float32)
    c.upsert_bulk(range(n), vecs, [{"body": f"doc number {i} of {i % 7}", "grp": i % 5}
                                   for i in range(n)])
    db.close()
    db = Database.open(tmp_db_dir)
    return db, db.get_collection("docs"), vecs


def test_first_text_query_waits_for_the_bm25_build(tmp_db_dir, monkeypatch):
    db, c, _ = _docs(tmp_db_dir)
    started, released = threading.Event(), threading.Event()

    class SlowBuild(Bm25Index):
        added = 0

        def add_document(self, slot, text):
            SlowBuild.added += 1
            if SlowBuild.added == 10:  # park the build a tenth of the way in
                started.set()
                released.wait(timeout=TIMEOUT)
            super().add_document(slot, text)

    monkeypatch.setattr(collection_mod, "Bm25Index", SlowBuild)
    got = {}
    first = threading.Thread(target=lambda: got.setdefault("a", c.text_search("number 5", k=3)))
    first.start()
    assert started.wait(timeout=TIMEOUT)
    second = threading.Thread(
        target=lambda: got.setdefault("b", c.text_search("number 377", k=3)))
    second.start()
    second.join(timeout=0.5)  # blocked on the build, or done on a half-built index
    released.set()
    _join([first, second])
    assert [h.id for h in got["b"]] == [h.id for h in c.text_search("number 377", k=3)]
    assert got["b"][0].id == 377
    db.close()


def test_refresh_waits_for_the_running_block_build():
    idx = Bm25Index("cpu")
    for i in range(50):
        idx.add_document(i, f"alpha beta {i}")
    started, released = threading.Event(), threading.Event()
    build = idx._build_blocks

    def slow_build(docs, doc_len):
        started.set()
        released.wait(timeout=TIMEOUT)
        build(docs, doc_len)

    idx._build_blocks = slow_build
    first = threading.Thread(target=idx.refresh, args=(50,))
    first.start()
    assert started.wait(timeout=TIMEOUT)
    got = {}
    second = threading.Thread(target=lambda: got.setdefault("b", idx.search("beta", 5, 50)))
    second.start()
    second.join(timeout=0.5)
    released.set()
    _join([first, second])
    assert len(got["b"]) == 5 and got["b"] == idx.search("beta", 5, 50)


def test_mixed_burst_at_a_reopened_collection_answers_as_in_series(tmp_db_dir):
    db, c, vecs = _docs(tmp_db_dir)
    filt = {"type": "eq", "field": "grp", "value": 2}
    calls = {
        "search": lambda i: c.search(vecs[i], k=5),
        "filtered": lambda i: c.search_batch(vecs[i : i + 4], k=5, filter=filt),
        "text": lambda i: c.text_search(f"number {i}", k=5),
        "hybrid": lambda i: c.hybrid_search(vecs[i], f"number {i}", k=5),
        "query": lambda i: db.query(
            "SELECT * FROM docs WHERE vector NEAR $v AND grp = 2 LIMIT 5", {"v": vecs[i]}),
        "match": lambda i: c.execute_match(
            "MATCH (a)-[:next]->(b) RETURN b.grp AS g ORDER BY g"),
    }
    jobs = [(name, i) for i in range(0, 48, 3) for name in calls]
    got, errors = {}, []
    barrier = threading.Barrier(len(jobs))

    def go(name, i):
        try:
            barrier.wait(timeout=TIMEOUT)
            got[name, i] = calls[name](i)
        except Exception as e:  # pragma: no cover - reported below
            errors.append((name, i, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=go, args=job) for job in jobs]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for (name, i), rows in got.items():
        assert rows == calls[name](i), (name, i)
    assert c.graph is not None and c.text_index is not None and c._columns_built
    db.close()
