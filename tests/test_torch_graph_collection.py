"""The graph slice as a whole on the CPU: ``Database`` -> ``Collection`` with
``index_kind="graph"`` in the port, against the JAX package on the same data.

20,000 x 32 euclidean rows with integer values, payloads ``{"cat": i % 8}``:
below ``EXACT_KNN_MAX_ROWS`` both packages build the graph from the exact
kNN, and integer rows keep every score exact, so the two packages build one
graph and their beams walk it alike. Searches pass ``ef`` explicitly (the
calibrated downshift depends on each package's calibration probe, which
scores non-integer queries). Plain, filtered, after-upsert (the graph delta)
and reopened searches return the reference's ids; so does ``auto`` with
``ann_min_rows`` lowered, where the planner picks the graph.
"""

import numpy as np
import pytest
import torch

import velesdb_tpu
import velesdb_tpu_torch

N, DIM = 20_000, 32
CAT3 = {"type": "eq", "field": "cat", "value": 3}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for this module: the suite runs several test
    processes side by side, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids(rows):
    return [[h.id for h in r] for r in rows]


def _oracle(x, q, keep=None):
    d2 = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    if keep is not None:
        d2 = np.where(keep[None, :], d2, np.inf)
    return np.argsort(d2, axis=1, kind="stable")[:, :10]


def _recall(rows, truth):
    return np.mean([len({h.id for h in r} & set(t.tolist())) / 10 for r, t in zip(rows, truth)])


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    rng = np.random.default_rng(31)
    x = rng.integers(-5, 5, (N + 48, DIM)).astype(np.float32)
    base, q = x[:N], x[N:]
    payloads = [{"cat": i % 8} for i in range(N)]
    root = tmp_path_factory.mktemp("graph")
    ref_db = velesdb_tpu.Database.open(str(root / "ref"))
    ref = ref_db.create_collection("c", DIM, metric="euclidean")
    ref.index_kind = "graph"
    db = velesdb_tpu_torch.Database.open(str(root / "port"), device="cpu")
    col = db.create_collection("c", DIM, metric="euclidean", index_kind="graph")
    for c in (ref, col):
        c.upsert_bulk(range(N), base, payloads)
    return dict(root=root, ref_db=ref_db, ref=ref, db=db, col=col, base=base, q=q)


def test_graph_collection_matches_reference(pinned):
    ref, col, q = pinned["ref"], pinned["col"], pinned["q"]
    want = ref.search_batch(q, k=10, ef=128)
    got = col.search_batch(q, k=10, ef=128)
    assert not col.ann.dirty and col.ann._entry_ivf is None  # 20K rows: dense seed entries
    np.testing.assert_array_equal(col.ann._adj.numpy(), np.asarray(ref.ann._adj))
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose([h.score for r in got for h in r],
                               [h.score for r in want for h in r], rtol=1e-5)
    assert col.search(q[0], k=10, ef=128) == got[0]
    assert _recall(got, _oracle(pinned["base"], q)) >= 0.9


def test_graph_filtered_search_matches_reference(pinned):
    ref, col, q = pinned["ref"], pinned["col"], pinned["q"]
    want = ref.search_batch(q, k=10, ef=128, filter=CAT3)
    got = col.search_batch(q, k=10, ef=128, filter=CAT3)
    assert all(h.id % 8 == 3 and h.payload == {"cat": 3} for r in got for h in r)
    assert _ids(got) == _ids(want)
    keep = np.arange(N) % 8 == 3
    assert _recall(got, _oracle(pinned["base"], q, keep)) >= 0.9


def test_graph_reopen_then_delta_after_upserts(pinned):
    """Close and reopen: ``ann.npz`` restores the graph (no rebuild) and the
    ids stay the reference's; then upserts land in the graph delta and are
    found, in both packages alike."""
    q = pinned["q"]
    before = _ids(pinned["col"].search_batch(q, k=10, ef=128))
    pinned["ref_db"].close()
    pinned["db"].close()
    ref = velesdb_tpu.Database.open(str(pinned["root"] / "ref")).get_collection("c")
    db = velesdb_tpu_torch.Database.open(str(pinned["root"] / "port"), device="cpu")
    col = db.get_collection("c")
    for c in (ref, col):
        c.index_kind = "graph"
    built = []
    real = col.ann.build
    col.ann.build = lambda *a, **kw: built.append(1) or real(*a, **kw)
    got = col.search_batch(q, k=10, ef=128)
    assert not built and not col.ann.dirty
    assert _ids(got) == before == _ids(ref.search_batch(q, k=10, ef=128))
    new = q[:20] + 0.5
    for c in (ref, col):
        c.upsert_bulk(range(N, N + 20), new, [{"cat": 9}] * 20)
    gone = before[1][0]
    for c in (ref, col):
        c.delete(gone)
    hits = col.search_batch(new, k=3, ef=128)
    assert not col.ann.dirty and len(col._stale["graph"]) == 21
    assert [r[0].id for r in hits] == list(range(N, N + 20))
    assert hits[0][0].payload == {"cat": 9}
    assert _ids(hits) == _ids(ref.search_batch(new, k=3, ef=128))
    after = col.search_batch(q, k=10, ef=128)
    assert gone not in {h.id for r in after for h in r}
    assert _ids(after) == _ids(ref.search_batch(q, k=10, ef=128))


def test_graph_auto_with_lowered_ann_min_rows(tmp_path):
    """``auto`` past a lowered ``ann_min_rows``: the planner considers the
    graph (``have_graph``) as the reference's does. Its static costs (the
    TPU's constants) favour exact at this size, so both planners are given
    one latency sample per engine that makes the graph the cheaper; both
    packages then build and calibrate the graph, plan the same engine and ef,
    and serve the same ids."""
    rng = np.random.default_rng(32)
    x = rng.integers(-5, 5, (6000 + 16, DIM)).astype(np.float32)
    base, q = x[:6000], x[6000:]
    ref = velesdb_tpu.Database.open(str(tmp_path / "ref")).create_collection(
        "a", DIM, metric="euclidean")
    col = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu").create_collection(
        "a", DIM, metric="euclidean")
    engines = []
    for c in (ref, col):
        c.upsert_bulk(range(6000), base)
        engines.append(c._choose_engine(16, ef=128))
        c.ann_min_rows = 4096
        c.planner.record_latency("exact", 16, 1e-2)
        c.planner.record_latency("ivf", 16, 1e-2)
        c.planner.record_latency("graph", 16, 1e-4)
        engines.append(c._choose_engine(16, ef=128))
    assert engines == ["exact", "graph"] * 2
    engine, k_fetch, ef, _ = col._plan_search(q, 10, None, ef=128)
    sig = ref._search_device(q, 10, None, ef=128)[3]  # (engine, batch bucket, k_fetch, ef)
    assert (engine, k_fetch, ef) == (sig[0], sig[2], sig[3]) == ("graph", 10, 128)
    assert not col.ann.dirty and col.planner.engine_recall("graph", 128) is not None
    assert _ids(col.search_batch(q, k=10, ef=128)) == _ids(ref.search_batch(q, k=10, ef=128))
