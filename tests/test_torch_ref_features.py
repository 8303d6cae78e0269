"""Rerank, multi-query fusion, caching, vacuum, auto-reindex, async ops.

Counterpart of the reference's dual-precision / batch / cache / vacuum /
auto-reindex test modules (SURVEY.md §2.2-2.3).

The reference's ``tests/test_features.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made. The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""

import numpy as np
import pytest
import torch

from velesdb_tpu_torch.cache import BloomFilter, LruCache
from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.ops import StorageMode


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def db(tmp_db_dir):
    return Database.open(tmp_db_dir, device="cpu")


def test_rerank_recovers_quantization_loss(db, rng):
    # binary quantization is lossy; f32 rerank must fix the final order
    c = db.create_collection("bq", dim=64, storage_mode=StorageMode.BINARY)
    vecs = rng.standard_normal((200, 64)).astype(np.float32)
    c.upsert_bulk(range(200), vecs)
    q = vecs[17] + 0.01 * rng.standard_normal(64).astype(np.float32)
    coarse = c.search(q, 5)
    reranked = c.search_with_rerank(q, 5, oversample=8)
    assert reranked[0].id == 17
    # rerank scores are exact cosine (bounded by 1), coarse are Hamming-based
    assert -1.001 <= reranked[0].score <= 1.001
    ids = [r.id for r in reranked]
    assert len(set(ids)) == len(ids)
    assert coarse  # coarse path functional too


def test_rerank_with_filter(db, rng):
    c = db.create_collection("sq", dim=32, storage_mode=StorageMode.SQ8)
    vecs = rng.standard_normal((100, 32)).astype(np.float32)
    c.upsert_bulk(range(100), vecs, [{"even": i % 2 == 0} for i in range(100)])
    q = vecs[42]
    out = c.search_with_rerank(
        q, 5, filter={"type": "eq", "field": "even", "value": True}
    )
    assert out[0].id == 42
    assert all(r.payload["even"] for r in out)


def test_auto_reindex_event_on_growth(db, rng):
    c = db.create_collection("ar", dim=8)
    c.ann_min_rows = 64
    c.index_kind = "graph"
    vecs = rng.standard_normal((80, 8)).astype(np.float32)
    c.upsert_bulk(range(80), vecs)
    c.search(vecs[0], 1)
    assert len(c.reindex_events) == 1
    # growth past the next auto-params tier forces a rebuild with wider degree
    more = rng.standard_normal((120_000, 8)).astype(np.float32)
    # (simulate: just check param policy, not a 120K build — params only)
    from velesdb_tpu_torch.index.params import GraphParams

    assert GraphParams.auto(8, 120_000).degree > GraphParams.auto(8, 80).degree


def test_lru_cache_and_bloom():
    lru = LruCache(2)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1
    lru.put("c", 3)  # evicts b (a was refreshed)
    assert lru.get("b") is None and lru.get("c") == 3
    bf = BloomFilter(capacity=1000, fp_rate=0.01)
    for i in range(500):
        bf.add(f"item-{i}")
    assert all(f"item-{i}" in bf for i in range(500))
    fps = sum(1 for i in range(10_000) if f"other-{i}" in bf)
    assert fps < 300  # ~1% fp target with margin
