"""The IVF slice as a whole on the CPU: ``Database`` -> ``Collection`` pinned
to ``index_kind="ivf"`` (and the planner in ``"auto"``) in the port, against
the JAX package on the same data and directories.

The collection is 8,192 x 128 euclidean: 32 clusters, spill 2, L 1,024, so
every unmasked search of at most 64 queries takes the probe op (#10's plain
version here) and larger or filtered batches take ``ivf_search_impl``.
Recall@10 against a float64 oracle is within 0.01 of the reference's, and the
planner's calibrated recall per ef within 0.02 (the two packages' k-means
differ in summation order). The planner tests of
``tests/test_planner_ttl.py`` run against the port's copy.
"""

import os

import numpy as np
import pytest
import torch

import velesdb_tpu
import velesdb_tpu_torch
import velesdb_tpu_torch.index.ivf as tivf
from velesdb_tpu_torch.experiments._common import host_topk
from velesdb_tpu_torch.velesql.planner import QueryPlanner

N, DIM = 8192, 128
CAT3 = {"type": "eq", "field": "cat", "value": 3}


def _clustered(rng, n, d, c=64):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 2.0
    return centers[rng.integers(0, c, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


def _oracle(x, q, keep=None):
    d2 = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    if keep is not None:
        d2 = np.where(keep[None, :], d2, np.inf)
    return np.argsort(d2, axis=1)[:, :10]


def _recall(rows, truth):
    return np.mean([len({h.id for h in r} & set(t.tolist())) / 10 for r, t in zip(rows, truth)])


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    """Both packages' collections over one dataset, pinned to IVF, with the
    probe op's calls counted."""
    rng = np.random.default_rng(21)
    x = _clustered(rng, N + 96, DIM)
    base, q = x[:N], x[N:]
    payloads = [{"cat": i % 8} for i in range(N)]
    root = tmp_path_factory.mktemp("ivf")
    ref_db = velesdb_tpu.Database.open(str(root / "ref"))
    ref = ref_db.create_collection("c", DIM, metric="euclidean")
    db = velesdb_tpu_torch.Database.open(str(root / "port"), device="cpu")
    col = db.create_collection("c", DIM, metric="euclidean")
    for c in (ref, col):
        c.upsert_bulk(range(N), base, payloads)
        c.index_kind = "ivf"
    calls = []
    orig = tivf.ivf_probe_topk
    tivf.ivf_probe_topk = lambda *a, **kw: calls.append(a[0].shape[0]) or orig(*a, **kw)
    try:
        got = col.search_batch(q[:64], k=10)
        assert calls == [64]  # the probe op's branch
        big = col.search_batch(q, k=10)  # b = 96: the plain probing path
        assert calls == [64]
    finally:
        tivf.ivf_probe_topk = orig
    want, want_big = ref.search_batch(q[:64], k=10), ref.search_batch(q, k=10)
    return dict(ref=ref, col=col, db=db, root=root, base=base, q=q, got=got, want=want,
                big=big, want_big=want_big)


def test_ivf_collection_matches_reference(pinned):
    p = pinned
    col, ref = p["col"], p["ref"]
    assert (col.ivf.c_real, col.ivf.part_len, col.ivf.spill) == (ref.ivf.c_real, 1024, 2)
    assert col.ivf.c == ref.ivf.c and not col.ivf.dirty
    truth = _oracle(p["base"], p["q"])
    assert _recall(p["got"], truth[:64]) >= _recall(p["want"], truth[:64]) - 0.01
    assert _recall(p["big"], truth) >= _recall(p["want_big"], truth) - 0.01
    assert _recall(p["got"], truth[:64]) >= 0.95
    one = col.search(p["q"][0], k=5)
    assert [h.id for h in one] == [h.id for h in p["got"][0][:5]]
    for row in p["got"]:
        assert all(h.payload == {"cat": h.id % 8} for h in row)


def test_ivf_planner_calibration_matches_reference(pinned):
    """The post-build probe records recall per ef for both packages; the
    downshift picks from those records."""
    col, ref = pinned["col"], pinned["ref"]
    for ef in (16, 32, 64, 128, 256):
        assert col.planner.engine_recall("ivf", ef) == pytest.approx(
            ref.planner.engine_recall("ivf", ef), abs=0.02)
    for bar in (0.88, 0.95, 0.97):
        want = ref.planner.downshift_ef("ivf", 128, bar)
        got = col.planner.downshift_ef("ivf", 128, bar)
        assert got == want or abs(col.planner.engine_recall("ivf", want)
                                  - ref.planner.engine_recall("ivf", want)) <= 0.02


def test_ivf_filtered_search(pinned):
    p = pinned
    keep = np.arange(N) % 8 == 3
    got = p["col"].search_batch(p["q"][:32], k=10, filter=CAT3)
    want = p["ref"].search_batch(p["q"][:32], k=10, filter=CAT3)
    assert all(h.id % 8 == 3 and h.payload == {"cat": 3} for row in got for h in row)
    truth = _oracle(p["base"], p["q"][:32], keep)
    assert _recall(got, truth) >= _recall(want, truth) - 0.01


def test_ivf_reopen_then_delta_after_upserts(pinned):
    """Reopening restores the index from ``ivf.npz`` with no k-means run and
    the same ids; then new rows are found through the exact delta with no
    rebuild, the unfiltered batch still on the probe op, and a deleted row
    never comes back. (A reopen after mutations
    rebuilds: the recipe records the store's version, as in the reference.)"""
    p = pinned
    q = p["q"]
    before = [[h.id for h in r] for r in p["got"][:16]]
    p["db"].close()
    calls = []
    orig = tivf.kmeans
    tivf.kmeans = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        db = velesdb_tpu_torch.Database.open(str(p["root"] / "port"), device="cpu")
        col = db.get_collection("c")
        col.index_kind = "ivf"
        after = [[h.id for h in r] for r in col.search_batch(q[:16], k=10)]
    finally:
        tivf.kmeans = orig
    assert not calls and not col.ivf.dirty
    assert after == before
    new = q[:20] + 0.001
    col.upsert_bulk(range(N, N + 20), new, [{"cat": 9}] * 20)
    gone = int(p["got"][1][0].id)
    col.delete(gone)
    calls = []
    orig = tivf.ivf_probe_topk
    tivf.ivf_probe_topk = lambda *a, **kw: calls.append(a[0].shape[0]) or orig(*a, **kw)
    try:
        hits = col.search_batch(new, k=3)
    finally:
        tivf.ivf_probe_topk = orig
    assert calls == [20]  # the delta keeps the probe op's branch
    assert not col.ivf.dirty and len(col._stale["ivf"]) == 21
    assert [r[0].id for r in hits] == list(range(N, N + 20))
    assert hits[0][0].payload == {"cat": 9}
    assert gone not in {h.id for r in col.search_batch(q[:4], k=10) for h in r}


def test_graph_index_kind_still_raises(tmp_path):
    """Since the graph slice ``index_kind="graph"`` is served; a kind no
    package knows still raises, and leaves the pin as it was."""
    col = velesdb_tpu_torch.Database(str(tmp_path), device="cpu").create_collection("g", 4)
    col.index_kind = "graph"
    assert col.index_kind == "graph"
    with pytest.raises(ValueError, match="index_kind"):
        col.index_kind = "hnsw"
    assert col.index_kind == "graph"
    col.index_kind = "ivf"
    assert col.index_kind == "ivf"


def test_sq8_ivf_collection_matches_reference(tmp_path):
    """SQ8 storage pinned to IVF: packed-word partitions, the auto-rerank
    over the IVF candidates, the storage recall recorded with the planner."""
    rng = np.random.default_rng(22)
    x = _clustered(rng, 6000 + 32, 32)
    base, q = x[:6000], x[6000:]
    ref = velesdb_tpu.Database.open(str(tmp_path / "ref")).create_collection(
        "s", 32, metric="euclidean", storage_mode="sq8")
    col = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu").create_collection(
        "s", 32, metric="euclidean", storage_mode="sq8")
    for c in (ref, col):
        c.upsert_bulk(range(6000), base, [{"cat": i % 4} for i in range(6000)])
        c.index_kind = "ivf"
    got, want = col.search_batch(q, k=10), ref.search_batch(q, k=10)
    assert col.ivf.storage == "sq8" and col.ivf._parts.dtype == torch.int32
    truth = _oracle(base, q)
    assert _recall(got, truth) >= _recall(want, truth) - 0.01
    assert col.planner.engine_recall("storage") == pytest.approx(
        ref.planner.engine_recall("storage"), abs=0.02)
    filtered = col.search_batch(q, k=10, filter=CAT3)
    assert all(h.payload == {"cat": 3} for row in filtered for h in row)


def test_ivf_calibration_overstates_held_out_recall_in_both_packages(tmp_path):
    """The IVF calibration's probe (stored rows perturbed by their
    nearest-neighbour distance, scored by eps-recall) reads above recall@10
    on held-out queries, in the reference as in the port: a property of the
    reference's method, which the port keeps (ROADMAP.md, faults of the
    reference). A smaller copy of hard1m-ivf: 65,536 x 128 euclidean FULL,
    24 clusters, seed 43, 256 held-out queries, the default ef ladder; at ef
    64 both packages calibrate to 0.768 against 0.703 held out (CPU)."""
    n = 65_536
    x = _clustered(np.random.default_rng(43), n + 256, DIM, c=24)
    base, q = x[:n], x[n:]
    truth = host_topk(base, q, 10, "euclidean")  # float64, unpadded corpus
    read = {}
    for name, db in (("ref", velesdb_tpu.Database.open(str(tmp_path / "ref"))),
                     ("port", velesdb_tpu_torch.Database.open(str(tmp_path / "port"),
                                                              device="cpu"))):
        col = db.create_collection("hard", DIM, metric="euclidean")
        col.upsert_bulk(range(n), base)
        col.index_kind = "ivf"
        held = _recall(col.search_batch(q, k=10, ef=64), truth)
        read[name] = (col.planner.engine_recall("ivf", 64), held)
    for calibrated, held in read.values():
        assert calibrated - held >= 0.03, read
    assert read["port"][0] == pytest.approx(read["ref"][0], abs=0.02), read
    assert read["port"][1] == pytest.approx(read["ref"][1], abs=0.02), read


# -- the planner (tests/test_planner_ttl.py:15-86) against the port's copy ----


def test_cost_model_regimes():
    p = QueryPlanner()
    assert p.choose(10_000, 128, 1, have_ivf=True).engine == "exact"
    c = p.choose(10_000_000, 768, 1, have_ivf=True, ivf_nprobe=32, ivf_part_len=512)
    assert c.engine == "ivf"
    c = p.choose(1_000_000, 768, 4096, have_ivf=True, ivf_nprobe=32, ivf_part_len=512)
    assert c.engine == "exact"


def test_spill2_never_picked_at_large_batch():
    p = QueryPlanner()
    big = p.choose(1_000_000, 128, 256, have_ivf=True, ivf_nprobe=64, ivf_part_len=1024)
    assert big.engine == "exact"
    small = p.choose(10_000_000, 768, 16, have_ivf=True, ivf_nprobe=64, ivf_part_len=1024)
    assert small.engine == "ivf"
    cap_big = p.choose(10_000_000, 768, 4096, have_ivf=True, ivf_nprobe=64, ivf_part_len=1024)
    assert cap_big.engine == "exact"


def test_planner_ema_overrides_model():
    p = QueryPlanner()
    assert p.choose(10_000, 128, 8, have_ivf=True).engine == "exact"
    for _ in range(5):
        p.record_latency("exact", 8, 1.0)
        p.record_latency("ivf", 8, 0.001)
    assert p.choose(10_000, 128, 8, have_ivf=True).engine == "ivf"


def test_collection_engine_selection(tmp_path):
    rng = np.random.default_rng(0)
    db = velesdb_tpu_torch.Database.open(str(tmp_path), device="cpu")
    c = db.create_collection("e", dim=16)
    c.ann_min_rows = 256  # allow the IVF engine at test scale
    vecs = rng.standard_normal((2000, 16)).astype(np.float32)
    c.upsert_bulk(range(2000), vecs)
    c.index_kind = "ivf"
    assert c.search(vecs[7], k=5)[0].id == 7
    assert c.ivf is not None and not c.ivf.dirty
    assert os.path.exists(os.path.join(c.path, "ivf.npz"))
    c.index_kind = "exact"
    assert c.search(vecs[7], k=5)[0].id == 7
    # auto consults the planner and records latencies after the warm-up call
    c.index_kind = "auto"
    c.search(vecs[3], k=3)
    c.search(vecs[4], k=3)
    assert c.planner._ema
