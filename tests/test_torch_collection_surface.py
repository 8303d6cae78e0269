"""The rest of ``Collection``'s vector surface in the port, beside the JAX
package's on the same data: per-query filters, multi-query fusion, the result
cache, vacuum, TTL expiry and auto-vacuum, exact hamming / jaccard search,
the host copies ``compression.py`` and ``storage/payload_log.py``, and the
asyncio facade ``aio.py``.

Tolerances: exact float searches agree id for id except at score ties, with
scores to rtol 1e-5 (fp32, different summation order); hamming and jaccard
scores are integer counts and their ratios, so ids and scores are equal, ties
included (both select the lowest slot); host code gives equal results.
"""

import asyncio
import os
import time

import numpy as np
import pytest

import velesdb_tpu
import velesdb_tpu_torch
from velesdb_tpu.compression import compress as j_compress
from velesdb_tpu.compression import train_dictionary as j_train
from velesdb_tpu.storage.payload_log import PayloadLog as JLog
from velesdb_tpu_torch.cache import BloomFilter, LruCache, SearchResultCache
from velesdb_tpu_torch.compression import compress, decompress, train_dictionary
from velesdb_tpu_torch.index.brute import BruteForceIndex
from velesdb_tpu_torch.storage.payload_log import PayloadLog

RTOL = 1e-5


def _pair(tmp_path, name, dim, n, seed=0, payload=None, **kw):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    payloads = [payload(i) for i in range(n)] if payload else None
    ref = velesdb_tpu.Database.open(str(tmp_path / "ref")).create_collection(name, dim, **kw)
    col = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu").create_collection(
        name, dim, **kw)
    for c in (ref, col):
        c.upsert_bulk(range(n), vecs, payloads)
    return ref, col, vecs


def _same(got_rows, want_rows, exact=False):
    assert len(got_rows) == len(want_rows)
    for got, want in zip(got_rows, want_rows):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if exact:
                assert (g.id, g.score) == (w.id, w.score)
            else:
                assert abs(g.score - w.score) <= RTOL * abs(w.score) + RTOL
                assert g.id == w.id or abs(g.score - w.score) <= RTOL * abs(w.score) + RTOL
            assert g.payload == w.payload


def test_search_batch_with_per_query_filters(tmp_path):
    ref, col, vecs = _pair(tmp_path, "pqf", 8, 60, payload=lambda i: {"grp": i % 3})
    filters = [{"type": "eq", "field": "grp", "value": 0},
               {"type": "eq", "field": "grp", "value": 1}, None,
               {"type": "eq", "field": "grp", "value": 0}]
    res = col.search_batch_with_filters(vecs[:4], k=5, filters=filters)
    _same(res, ref.search_batch_with_filters(vecs[:4], k=5, filters=filters))
    assert all(h.payload["grp"] == 0 for h in res[0] + res[3])
    assert all(h.payload["grp"] == 1 for h in res[1]) and len(res[2]) == 5
    assert res[1][0].id == 1
    # each group is one filtered batch: the same as searching it alone
    _same([res[0], res[3]], col.search_batch(vecs[[0, 3]], k=5, filter=filters[0]))
    _same(col.search_batch_with_filters(vecs[:4], k=5), col.search_batch(vecs[:4], k=5))
    with pytest.raises(ValueError, match="length"):
        col.search_batch_with_filters(vecs[:4], k=2, filters=filters[:2])


@pytest.mark.parametrize("strategy", ["rrf", "average", "maximum", "weighted_average",
                                      "weighted_maximum", "weighted_hit"])
def test_multi_query_search_fusion(tmp_path, strategy):
    ref, col, vecs = _pair(tmp_path, "mq", 16, 50, seed=1, payload=lambda i: {"i": i})
    qs = [vecs[3], vecs[30], vecs[7] + 0.1]
    weights = [1.0, 0.5, 2.0] if strategy.startswith("weighted") else None
    got = col.multi_query_search(qs, k=6, strategy=strategy, weights=weights)
    _same([got], [ref.multi_query_search(qs, k=6, strategy=strategy, weights=weights)])
    if strategy == "rrf":
        assert {3, 30} <= {r.id for r in got}
    w = col.multi_query_search(qs[:2], k=1, strategy="weighted_average", weights=[1.0, 0.0])
    assert w[0].id == 3 and w[0].payload == {"i": 3}


def test_result_cache(tmp_path):
    ref, col, vecs = _pair(tmp_path, "rc", 8, 30, seed=2)
    assert col.cache_stats() is None
    rng = np.random.default_rng(3)
    extra = rng.standard_normal(8)
    stats = []
    for c in (ref, col):
        c.enable_result_cache()
        r1 = c.search(vecs[5], 3)
        assert c.cache_stats()["misses"] == 1
        r2 = c.search(vecs[5], 3)
        assert c.cache_stats()["hits"] == 1 and r2 == r1
        c.search(vecs[5], 4)  # another k, another key
        c.search(vecs[5], 3, filter={"type": "eq", "field": "x", "value": 1})
        c.upsert(99, extra)  # a mutation clears the cache
        c.search(vecs[5], 3)
        stats.append(c.cache_stats())
    assert stats[1] == stats[0] and stats[1]["misses"] == 4


def test_cache_primitives():
    lru = LruCache(2)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1
    lru.put("c", 3)  # evicts b (a was refreshed)
    assert lru.get("b") is None and lru.get("c") == 3 and len(lru) == 2
    with pytest.raises(ValueError):
        LruCache(0)
    bf = BloomFilter(capacity=1000, fp_rate=0.01)
    for i in range(500):
        bf.add(f"item-{i}")
    assert all(f"item-{i}" in bf for i in range(500))
    assert sum(1 for i in range(10_000) if f"other-{i}" in bf) < 300
    q = np.arange(4, dtype=np.float32)
    from velesdb_tpu.cache import SearchResultCache as JCache

    assert SearchResultCache.key(q, 3, {"f": 1}, None, "fast") == JCache.key(
        q, 3, {"f": 1}, None, "fast")


def test_vacuum_compacts_and_preserves_search(tmp_path):
    ref, col, vecs = _pair(tmp_path, "vac", 8, 40, seed=4,
                           payload=lambda i: {"i": i, "text": f"row {i} w{i % 3}"})
    col.text_search("w1", 5)  # build the text index before the vacuum
    for c in (ref, col):
        for i in range(0, 40, 2):
            c.delete(i)
        assert c.vectors.fragmentation_ratio > 0.4
    report = col.vacuum()
    assert report == ref.vacuum() and report["reclaimed_slots"] == 20
    assert col.vectors.used_slots == 20 and col.count() == 20
    hit = col.search(vecs[7], 1)[0]
    assert hit.id == 7 and hit.payload["i"] == 7
    _same(col.search_batch(vecs[:6], 5), ref.search_batch(vecs[:6], 5))
    # slot-keyed state rebuilt against the new slots
    got = col.text_search("w1", 10)
    assert [(h.id, h.score) for h in got] == [(h.id, h.score) for h in ref.text_search("w1", 10)]
    assert {h.id for h in got} == {i for i in range(1, 40, 2) if i % 3 == 1}
    filt = {"type": "gt", "field": "i", "value": 30}
    assert all(h.payload["i"] > 30 for h in col.search(vecs[0], 10, filter=filt))
    assert col.vacuum() == {"reclaimed_slots": 0, "fragmentation": 0.0}


def test_vacuum_invalidates_ivf_and_clears_delta(tmp_path):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    col = velesdb_tpu_torch.Database.open(str(tmp_path), device="cpu").create_collection(
        "v", 16, metric="euclidean")
    col.upsert_bulk(range(3000), x)
    col.index_kind = "ivf"
    assert col.search(x[9], k=3)[0].id == 9 and not col.ivf.dirty
    for i in range(0, 100):
        col.delete(i)
    col.search(x[200], k=3)
    assert col._stale["ivf"]
    assert col.vacuum()["reclaimed_slots"] == 100
    assert col.ivf.dirty and not col._stale["ivf"] and not col._delta_cache
    assert col.search(x[500], k=3)[0].id == 500 and not col.ivf.dirty


def test_ttl_expiry_and_auto_vacuum(tmp_path):
    ref_db = velesdb_tpu.Database.open(str(tmp_path / "ref"))
    db = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu")
    v = np.random.default_rng(7).standard_normal((4, 8)).astype(np.float32)
    for c in (ref_db.create_collection("ttl", dim=8), db.create_collection("ttl", dim=8)):
        c.upsert(0, v[0], {"keep": True})
        c.upsert(1, v[1], {"keep": False}, ttl=0.01)
        c.upsert(2, v[2], {"keep": False}, ttl=0.01)
        c.upsert(3, v[3], {"keep": True}, ttl=3600)
        time.sleep(0.05)
        assert c.expire_rows() == 2
        assert c.count() == 2 and c.get(1) is None and c.get(3) is not None
        c.upsert(5, v[1], ttl=0.01)
        time.sleep(0.05)
        # auto-vacuum at the next refresh: expire, then compact past 0.3
        c.configure_auto_vacuum(interval_s=0.0, fragmentation_threshold=0.3)
        hits = c.search(v[0], k=4)
        assert {h.id for h in hits} == {0, 3}
        assert c.vectors.fragmentation_ratio == 0.0 and c.vectors.used_slots == 2
        c.configure_auto_vacuum(enabled=False)
        assert c._auto_vacuum is None


def test_ttl_survives_reopen(tmp_path):
    path = str(tmp_path / "t")
    db = velesdb_tpu_torch.Database(path, device="cpu")
    c = db.create_collection("t", dim=4)
    c.upsert(1, np.ones(4, np.float32), ttl=0.001)
    c.upsert(2, np.ones(4, np.float32))
    c.upsert(3, np.ones(4, np.float32), ttl=3600)
    c.upsert(3, np.ones(4, np.float32))  # a re-upsert without ttl clears it
    db.close()
    c2 = velesdb_tpu_torch.Database(path, device="cpu").get_collection("t")
    assert 1 in c2._ttl and 2 not in c2._ttl and 3 not in c2._ttl
    r2 = velesdb_tpu.Database(path).get_collection("t")  # the same ttl.json
    assert r2._ttl == c2._ttl
    time.sleep(0.01)
    assert c2.expire_rows() == 1
    assert c2.get(1) is None and c2.get(2) is not None
    assert not os.path.exists(os.path.join(c2.path, "ttl.json"))


@pytest.mark.parametrize("mode", ["full", "f16", "bf16"])
@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_set_metric_exact_search_matches_reference(tmp_path, metric, mode):
    """``fused-xla`` on float storage: the reference's fused program's ids
    and scores, ties to the lowest slot (0/1 rows of 12 dims tie often)."""
    ref, col, vecs = _pair(tmp_path, "s", 12, 1500, seed=8, metric=metric, storage_mode=mode,
                           payload=lambda i: {"cat": i % 4})
    assert col.info()["serve_engine"] == "fused-xla"
    q = np.random.default_rng(9).standard_normal((6, 12)).astype(np.float32)
    cat = {"type": "eq", "field": "cat", "value": 2}
    _same(col.search_batch(q, 20), ref.search_batch(q, 20), exact=True)
    got = col.search_batch(q, 20, filter=cat)
    _same(got, ref.search_batch(q, 20, filter=cat), exact=True)
    assert all(h.payload["cat"] == 2 for row in got for h in row)
    for c in (ref, col):
        c.delete(int(got[0][0].id))
    _same(col.search_batch(q, 20), ref.search_batch(q, 20), exact=True)


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
@pytest.mark.parametrize("mode", ["sq8", "binary"])
def test_set_metrics_on_quantized_storage_still_raise(metric, mode, tmp_path):
    """SQ8 under a set metric still raises: a collection builds and its
    search raises the reference's ``ValueError``. BINARY no longer raises:
    it serves the reference's rows."""
    ref, col, vecs = _pair(tmp_path, "setq", 16, 300, seed=5, metric=metric,
                           storage_mode=mode)
    if mode == "sq8":
        with pytest.raises(ValueError) as je:
            ref.search(vecs[0], k=5)
        with pytest.raises(ValueError, match="not supported in sq8 mode") as te:
            col.search(vecs[0], k=5)
        assert str(te.value) == str(je.value)
        assert isinstance(BruteForceIndex(16, metric, mode, device="cpu"), BruteForceIndex)
        return
    _same(col.search_batch(vecs[:6], k=8), ref.search_batch(vecs[:6], k=8))


def test_dictionary_compression_roundtrip():
    import json

    payloads = [json.dumps({"title": f"product {i}", "category": "shoes", "price": i}).encode()
                for i in range(100)]
    zdict = train_dictionary(payloads)
    assert zdict == j_train(payloads) and 0 < len(zdict) <= 16 * 1024
    blob = b"".join(payloads)
    comp = compress(blob, zdict)
    assert comp == j_compress(blob, zdict) and decompress(comp, zdict) == blob
    assert decompress(compress(blob), b"") == blob
    one = payloads[50]
    assert len(compress(one, zdict)) < len(compress(one))


def test_payload_snapshot_v2_roundtrip_both_ways(tmp_path):
    d = str(tmp_path / "p")
    log = PayloadLog(d)
    for i in range(50):
        log.store(i, {"name": f"item {i}", "tags": ["a", "b"], "n": i})
    log.delete(3)
    log.snapshot()
    log.store(60, {"after": "snapshot"})
    log.close()
    ref = JLog(d)  # the reference reads the port's snapshot and log
    assert len(ref) == 50 and ref.retrieve(17)["n"] == 17 and ref.retrieve(3) is None
    assert ref.retrieve(60) == {"after": "snapshot"}
    ref.store(61, {"from": "reference"})
    ref.snapshot()
    ref.close()
    back = PayloadLog(d)
    assert len(back) == 51 and back.retrieve(61) == {"from": "reference"}
    assert back.retrieve(49) == {"name": "item 49", "tags": ["a", "b"], "n": 49}
    back.close()


def test_async_ops(tmp_path):
    from velesdb_tpu.aio import AsyncCollection as RefAsyncCollection
    from velesdb_tpu.aio import AsyncDatabase as RefAsyncDatabase
    from velesdb_tpu_torch.aio import AsyncCollection, AsyncDatabase

    vecs = np.random.default_rng(0).standard_normal((10, 8)).astype(np.float32)
    got = {}
    for tag, db, acol, adb in (
        ("ref", velesdb_tpu.Database.open(str(tmp_path / "ref")), RefAsyncCollection,
         RefAsyncDatabase),
        ("port", velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu"),
         AsyncCollection, AsyncDatabase),
    ):
        c = db.create_collection("aio", dim=8)

        async def drive():
            ac = acol(c)
            await ac.upsert_bulk(range(10), vecs, [{"i": i} for i in range(10)])
            hits = await ac.search(vecs[4], 2)
            assert hits[0].id == 4
            rows = await adb(db).query("SELECT i FROM aio WHERE i = 7")
            assert rows == [{"i": 7}]
            await ac.flush()
            return hits

        got[tag] = asyncio.run(drive())
        db.close()
    _same([got["port"]], [got["ref"]])
