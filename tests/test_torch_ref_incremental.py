"""Incremental ANN maintenance (delta buffer) + planner-driven engine choice.

VERDICT round-1 #2/#3: mutations must not trigger full index rebuilds (the
reference's HNSW inserts one row at a time forever, native/graph.rs:158), and
the graph engine must be reachable through the planner without hand-set
``ann_min_rows``.

The reference's ``tests/test_incremental.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made. The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""

import numpy as np
import pytest
import torch

from velesdb_tpu_torch import Database


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def db(tmp_path):
    d = Database(str(tmp_path / "db"), device="cpu")
    yield d
    d.close()


def _mk(db, n=600, d=32, seed=0, metric="euclidean"):
    rng = np.random.default_rng(seed)
    coll = db.create_collection("c", dim=d, metric=metric)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    coll.upsert_bulk(range(n), vecs)
    return coll, vecs, rng


def test_forced_graph_engine_builds_below_auto_threshold(db):
    coll, vecs, _ = _mk(db)
    coll.index_kind = "graph"
    res = coll.search_batch(vecs[:4], k=5)
    assert coll.ann is not None and not coll.ann.dirty  # built on demand
    assert res[0][0].id == 0  # self is the nearest neighbor
    # first dispatch of a shape class is a compile warm-up — excluded from
    # the latency EMA; the second (warm) one records
    assert coll.planner.observed("graph", 4) is None
    coll.search_batch(vecs[4:8], k=5)
    assert coll.planner.observed("graph", 4) is not None


def test_upserts_do_not_dirty_index_and_are_searchable(db):
    coll, vecs, rng = _mk(db)
    coll.index_kind = "graph"
    coll.search_batch(vecs[:2], k=3)  # build
    assert not coll.ann.dirty

    # insert new rows: index stays clean (delta absorbs them)...
    new = rng.standard_normal((20, vecs.shape[1])).astype(np.float32)
    coll.upsert_bulk(range(1000, 1020), new)
    assert not coll.ann.dirty
    assert len(coll._stale["graph"]) == 20

    # ...and the new rows are immediately findable at exact precision
    res = coll.search(new[7], k=1)
    assert res[0].id == 1007
    assert res[0].score < 1e-2


def test_update_returns_fresh_vector_not_stale_index_copy(db):
    coll, vecs, rng = _mk(db)
    coll.index_kind = "graph"
    coll.search_batch(vecs[:2], k=3)
    # move row 5 far away; the stale index still holds its old position
    moved = vecs[5] + 100.0
    coll.upsert(5, moved)
    assert not coll.ann.dirty
    # query at the OLD location: row 5 must NOT surface with a stale score
    res = coll.search(vecs[5], k=3)
    top_ids = [r.id for r in res]
    if 5 in top_ids:  # only legitimate if genuinely still close
        r5 = res[top_ids.index(5)]
        assert r5.score >= 100.0 - 1e-2
    # query at the NEW location: row 5 is the exact nearest
    res2 = coll.search(moved, k=1)
    assert res2[0].id == 5 and res2[0].score < 1e-3


def test_delete_is_immediately_invisible_without_rebuild(db):
    coll, vecs, _ = _mk(db)
    coll.index_kind = "graph"
    target = coll.search(vecs[10], k=1)[0]
    assert target.id == 10
    coll.delete(10)
    assert not coll.ann.dirty
    res = coll.search(vecs[10], k=5)
    assert 10 not in [r.id for r in res]


def test_delta_overflow_triggers_rebuild(db):
    coll, vecs, rng = _mk(db)
    coll.index_kind = "graph"
    coll.search_batch(vecs[:2], k=3)
    coll.delta_rebuild_fraction = 0.05
    # exceed both the fraction and the 1024-row floor
    n_new = 1100
    new = rng.standard_normal((n_new, vecs.shape[1])).astype(np.float32)
    coll.upsert_bulk(range(2000, 2000 + n_new), new)
    assert coll.ann.dirty  # full rebuild scheduled
    res = coll.search(new[0], k=1)  # rebuild happens here
    assert res[0].id == 2000
    assert not coll.ann.dirty
    assert len(coll._stale["graph"]) == 0


def test_planner_chooses_graph_from_measured_latency(db):
    """End-to-end: an already-built graph index + latency EMAs that favor it
    make the AUTO planner pick the graph engine — no hand-set
    ann_min_rows (VERDICT #2 done-criterion)."""
    coll, vecs, _ = _mk(db)
    coll.index_kind = "graph"
    coll.search_batch(vecs[:1], k=3)  # builds the index
    coll.index_kind = "auto"
    # seed measured latencies: graph wins at batch=1
    coll.planner.record_latency("graph", 1, 0.0005)
    coll.planner.record_latency("exact", 1, 0.0500)
    coll.planner.record_latency("ivf", 1, 0.0500)
    assert coll._choose_engine(1) == "graph"
    res = coll.search(vecs[3], k=3)
    assert res[0].id == 3
    # and the EMA keeps updating through real searches
    assert coll.planner.observed("graph", 1) is not None


def test_ivf_delta_search(db):
    coll, vecs, rng = _mk(db, n=800)
    coll.index_kind = "ivf"
    coll.search_batch(vecs[:2], k=3)
    assert coll.ivf is not None and not coll.ivf.dirty
    new = rng.standard_normal((10, vecs.shape[1])).astype(np.float32)
    coll.upsert_bulk(range(5000, 5010), new)
    assert not coll.ivf.dirty
    res = coll.search(new[3], k=1)
    assert res[0].id == 5003 and res[0].score < 1e-2
    coll.delete(5003)
    res = coll.search(new[3], k=3)
    assert 5003 not in [r.id for r in res]


def test_planner_downshift_ef():
    """Calibrated ef downshift (r3c): the smallest calibrated ef clearing
    the profile's bar serves; explicit/requested ef is the ceiling."""
    from velesdb_tpu_torch.velesql.planner import QueryPlanner

    p = QueryPlanner()
    assert p.downshift_ef("graph", 128, 0.95) == 128  # no data -> as asked
    p.record_recall("graph", 0.968, ef=64)
    p.record_recall("graph", 0.980, ef=128)
    p.record_recall("graph", 0.985, ef=256)
    assert p.downshift_ef("graph", 128, 0.95) == 64
    assert p.downshift_ef("graph", 256, 0.95) == 64
    # 0.968 misses bar+margin at ef=64; 0.980 clears it at ef=128
    assert p.downshift_ef("graph", 256, 0.97) == 128
    assert p.downshift_ef("graph", 64, 0.95) == 64  # never above request
    p.record_recall("graph", 0.91, ef=64)
    assert p.downshift_ef("graph", 128, 0.95) == 128  # weak ef skipped


def test_collection_downshifts_profile_ef(db):
    """A profile-driven search serves the downshifted ef; an explicit ef
    is honored as-is."""
    coll, vecs, _ = _mk(db)
    coll.index_kind = "graph"
    coll.search_batch(vecs[:1], k=3)  # builds + calibrates per profile ef
    # force a decisive calibration picture: ef=64 is the SMALLEST rung
    # clearing BALANCED's bar (the r3d ladder also calibrates 16/32 —
    # pin them below the bar so the expected downshift target is unique)
    coll.planner.record_recall("graph", 0.80, ef=16)
    coll.planner.record_recall("graph", 0.80, ef=32)
    coll.planner.record_recall("graph", 0.99, ef=64)
    served = {}
    orig = coll._ann_delta_search

    def spy(engine, q, k_fetch, ef, mask, **kw):
        served["ef"] = ef
        return orig(engine, q, k_fetch, ef, mask, **kw)

    coll._ann_delta_search = spy
    coll.search_batch(vecs[:1], k=3, quality="balanced")
    assert served["ef"] == 64, served
    coll.search_batch(vecs[:1], k=3, ef=128)
    assert served["ef"] == 128, served  # explicit ef never downshifts


def test_planner_recall_gate_demotes_weak_engine(db):
    """VERDICT r2 weak #2 (honesty gate): an engine whose post-build
    calibration probe measures below the quality profile's recall bar is
    not chosen however fast its latency EMA says it is — and a search
    through the collection falls back to exact."""
    coll, vecs, _ = _mk(db)
    coll.index_kind = "graph"
    coll.search_batch(vecs[:1], k=3)  # builds + calibrates
    coll.index_kind = "auto"
    # a fresh build calibrates at every profile ef with PERTURBED queries
    # (stored rows would measure self-retrieval recall — overestimates)
    for ef in (64, 128, 256):
        assert coll.planner.engine_recall("graph", ef) is not None
    # latency EMAs that would make graph the cheap choice
    coll.planner.record_latency("graph", 1, 0.0005)
    coll.planner.record_latency("exact", 1, 0.0500)
    # simulate a degraded index: calibration says recall 0.6
    coll.planner.record_recall("graph", 0.60)
    assert coll._choose_engine(1) == "exact"
    # explicit pin still honors the user's choice
    coll.index_kind = "graph"
    res = coll.search_batch(vecs[:1], k=3)
    assert len(res[0]) == 3


def test_calibration_runs_on_direct_index_build(db):
    """An explicit index build BEFORE any search must still calibrate:
    r3d found the NN-distance probe crashing on unset brute device state
    (the advisory except then silently disabled the recall gate)."""
    coll, vecs, _ = _mk(db)
    coll.index_kind = "graph"
    coll._ensure_ann(force=True)  # no search_batch ran -> no refresh yet
    assert getattr(coll, "last_calibration_error", None) is None
    for ef in (16, 32, 64, 128, 256):
        r = coll.planner.engine_recall("graph", ef=ef)
        assert r is not None and 0.0 <= r <= 1.0, (ef, r)
