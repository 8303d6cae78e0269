"""Database/Collection end-to-end tests (integration_scenarios.rs analog).

The reference's ``tests/test_collection.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made. The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""

import numpy as np
import pytest
import torch

from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.ops import DistanceMetric


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_db(tmp_db_dir):
    return Database.open(tmp_db_dir, device="cpu")


def test_create_get_list_delete(tmp_db_dir):
    db = make_db(tmp_db_dir)
    db.create_collection("docs", 64)
    assert db.list_collections() == ["docs"]
    col = db.get_collection("docs")
    assert col.dim == 64
    with pytest.raises(ValueError):
        db.create_collection("docs", 64)
    with pytest.raises(KeyError):
        db.get_collection("nope")
    assert db.delete_collection("docs")
    assert db.list_collections() == []
    db.close()


def test_invalid_collection_name(tmp_db_dir):
    db = make_db(tmp_db_dir)
    for bad in ("", "a/b", "..", "x\0y"):
        with pytest.raises(ValueError):
            db.create_collection(bad, 8)
    db.close()


def test_path_traversal_rejected_on_get_and_delete(tmp_db_dir):
    """ADVICE r1 (high): delete_collection('..') must never rmtree outside
    the data directory; get_collection must validate names too."""
    import os

    db = make_db(tmp_db_dir)
    db.create_collection("safe", 8)
    parent_sentinel = os.path.join(os.path.dirname(db.path), "sentinel.txt")
    with open(parent_sentinel, "w") as f:
        f.write("x")
    for bad in (".", "..", "a/../..", "a\\..", ""):
        with pytest.raises(ValueError):
            db.delete_collection(bad)
        with pytest.raises((ValueError, KeyError)):
            db.get_collection(bad)
    assert os.path.exists(parent_sentinel)
    assert os.path.exists(os.path.join(db.path, "safe", "config.json"))
    db.close()


def test_upsert_get_delete_search(tmp_db_dir, rng):
    db = make_db(tmp_db_dir)
    col = db.create_collection("items", 128, metric="cosine")
    vecs = rng.standard_normal((100, 128)).astype(np.float32)
    col.upsert_bulk(range(100), vecs, [{"i": i} for i in range(100)])
    assert col.count() == 100

    vec, payload = col.get(42)
    np.testing.assert_array_equal(vec, vecs[42])
    assert payload == {"i": 42}

    # exact self-search: top-1 must be the vector itself
    res = col.search(vecs[17], k=5)
    assert res[0]["id"] == 17
    assert res[0]["score"] > 0.999
    assert res[0]["payload"] == {"i": 17}

    # delete removes from results
    col.delete(17)
    assert col.count() == 99
    res = col.search(vecs[17], k=5)
    assert all(r["id"] != 17 for r in res)
    db.close()


def test_batched_search_matches_single(tmp_db_dir, rng):
    db = make_db(tmp_db_dir)
    col = db.create_collection("b", 32, metric="l2")
    vecs = rng.standard_normal((50, 32)).astype(np.float32)
    col.upsert_bulk(range(50), vecs)
    batch = col.search_batch(vecs[:4], k=3)
    for i, row in enumerate(batch):
        assert row[0]["id"] == i
        assert row[0]["score"] < 1e-3


@pytest.mark.parametrize("mode", ["full", "sq8", "binary", "bf16"])
def test_storage_modes_search(tmp_db_dir, rng, mode):
    db = make_db(tmp_db_dir)
    col = db.create_collection("m_" + mode, 256, metric="cosine", storage_mode=mode)
    vecs = rng.standard_normal((200, 256)).astype(np.float32)
    col.upsert_bulk(range(200), vecs)
    res = col.search(vecs[5], k=10)
    assert res[0]["id"] == 5  # self-match survives quantization
    db.close()


def test_persistence_across_reopen(tmp_db_dir, rng):
    db = make_db(tmp_db_dir)
    col = db.create_collection("p", 16, metric="dot")
    vecs = rng.standard_normal((10, 16)).astype(np.float32)
    col.upsert_bulk(range(10), vecs, [{"n": i} for i in range(10)])
    col.flush()
    db.close()

    db2 = Database.open(tmp_db_dir, device="cpu")
    assert db2.list_collections() == ["p"]
    col2 = db2.get_collection("p")
    assert col2.count() == 10
    assert col2.metric == DistanceMetric.DOT_PRODUCT
    res = col2.search(vecs[3], k=1)
    assert res[0]["id"] == 3
    assert res[0]["payload"] == {"n": 3}
    db2.close()


def test_crash_recovery_unflushed_upserts(tmp_db_dir, rng):
    db = make_db(tmp_db_dir)
    col = db.create_collection("c", 8)
    col.flush()
    vecs = rng.standard_normal((5, 8)).astype(np.float32)
    col.upsert_bulk(range(5), vecs, [{"i": i} for i in range(5)])
    # crash: no flush — close raw handles only
    col.vectors._wal_file.close()
    col.payloads._log.close()
    del col.vectors._mmap
    db._collections.clear()

    db2 = Database.open(tmp_db_dir, device="cpu")
    col2 = db2.get_collection("c")
    assert col2.count() == 5
    assert col2.search(vecs[2], k=1)[0]["id"] == 2
    assert col2.get(4)[1] == {"i": 4}
    db2.close()


def test_dimension_mismatch_errors(tmp_db_dir, rng):
    db = make_db(tmp_db_dir)
    col = db.create_collection("d", 8)
    with pytest.raises(ValueError):
        col.upsert(1, np.ones(9, np.float32))
    with pytest.raises(ValueError):
        col.search(np.ones(9, np.float32))
    db.close()


def test_empty_collection_search(tmp_db_dir):
    db = make_db(tmp_db_dir)
    col = db.create_collection("e", 8)
    assert col.search(np.ones(8, np.float32), k=5) == []
    db.close()


def test_k_larger_than_count(tmp_db_dir, rng):
    db = make_db(tmp_db_dir)
    col = db.create_collection("k", 8)
    col.upsert_bulk(range(3), rng.standard_normal((3, 8)).astype(np.float32))
    res = col.search(np.ones(8, np.float32), k=100)
    assert len(res) == 3
    db.close()


def test_ann_path_activates_and_matches_exact(tmp_db_dir, rng):
    """Above ANN_MIN_ROWS the graph index serves searches with high recall."""
    db = make_db(tmp_db_dir)
    col = db.create_collection("ann", 32, metric="l2")
    col.ann_min_rows = 4096  # force the ANN path at test scale
    col.index_kind = "graph"  # pin the beam-search engine (auto picks exact/ivf)
    n = 6000
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    col.upsert_bulk(range(n), vecs)
    res = col.search(vecs[100], k=10, quality="balanced")
    assert col.ann is not None and not col.ann.dirty  # ANN was built
    assert res[0]["id"] == 100
    exact = col.search(vecs[100], k=10, quality="perfect")
    got = {r["id"] for r in res}
    want = {r["id"] for r in exact}
    assert len(got & want) >= 8  # recall@10 >= 0.8 on one query
    # ANN persists across reopen via ann.npz + version check
    col.flush()
    db.close()
    db2 = Database.open(tmp_db_dir, device="cpu")
    col2 = db2.get_collection("ann")
    col2.ann_min_rows = 4096
    col2.index_kind = "graph"
    col2.search(vecs[0], k=1)
    assert not col2.ann.dirty
    db2.close()


def test_ivf_filtered_search_coverage_guard(tmp_db_dir, rng):
    """r4: the IVF probe pool is nprobe*L rows BEFORE the in-kernel mask —
    at selective filters the guard bumps nprobe (expected passing count
    covers k_fetch) or falls back to the masked exact scan when bumped
    coverage approaches a half-corpus read."""
    db = make_db(tmp_db_dir)
    col = db.create_collection("fi", 32, metric="l2")
    col.ann_min_rows = 4096
    col.index_kind = "ivf"
    n = 6000
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    payloads = [{"grp": int(i % 100)} for i in range(n)]
    col.upsert_bulk(range(n), vecs, payloads)
    col.search(vecs[0], k=1)  # build + calibrate
    assert col.ivf is not None and not col.ivf.dirty

    for sel_filter, sel_name in (
        ({"type": "eq", "field": "grp", "value": 7}, "1%"),
        ({"type": "lt", "field": "grp", "value": 30}, "30%"),
    ):
        res = col.search_batch([vecs[107]], k=10, filter=sel_filter)[0]
        assert len(res) == 10, sel_name
        exact = col.search_batch(
            [vecs[107]], k=10, filter=sel_filter, quality="perfect"
        )[0]
        got = {r["id"] for r in res}
        want = {r["id"] for r in exact}
        assert len(got & want) >= 8, (sel_name, got, want)
    db.close()


def test_perfect_quality_routes_through_host_rerank(tmp_db_dir, rng):
    """r3b: quality=perfect engages the host-f32 rerank pass on ANY storage
    mode — device engines select with MXU f32 (~0.2% distance error), so
    the host rescoring pass is the true fidelity ceiling."""
    db = Database.open(tmp_db_dir, device="cpu")
    col = db.create_collection("pf", dim=16)
    vecs = rng.standard_normal((500, 16)).astype(np.float32)
    col.upsert_bulk(range(500), vecs)
    calls = []
    orig = col.search_batch_with_rerank

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    col.search_batch_with_rerank = spy
    res = col.search(vecs[7], k=5, quality="perfect")
    assert res[0].id == 7
    assert calls, "perfect did not engage the rerank pass"
    # balanced on a FULL collection stays on the device path
    calls.clear()
    col.search(vecs[7], k=5, quality="balanced")
    assert not calls


def test_search_batch_records_planner_latency(tmp_db_dir, rng):
    """Regression guard for the r4 _search_device split: the public
    search_batch must still feed the planner's latency EMA (first dispatch
    per signature is warm-up, the second records)."""
    from velesdb_tpu_torch.database import Database

    db = Database.open(tmp_db_dir, device="cpu")
    c = db.create_collection("p", dim=16)
    c.upsert_bulk(range(5000), rng.standard_normal((5000, 16)).astype(np.float32))
    q = rng.standard_normal((4, 16)).astype(np.float32)
    c.search_batch(q, k=5)   # warm-up (untimed)
    c.search_batch(q, k=5)   # timed
    assert c.planner.observed("exact", 4) is not None
