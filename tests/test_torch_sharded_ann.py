"""The JAX package's ``tests/test_sharded_ann.py`` on the port's sharded
graph and IVF (each test under the reference's name), and the port held to
the reference on the same inputs.

The port runs in gloo worlds of 4 and 2 ranks spawned once each for the
module (``tools/sharded_phase.py``), the reference in this process on
``make_mesh`` over the same shard count while the world of 4 runs. On
their own builds the port's recall is no lower than the reference's. On state carried across
(``parallel.carried.sharded_state_from_jax``: the reference's shards,
partitions, graphs and entry IVFs, unchanged) ids equal the reference's:
integer-valued corpora make every euclidean score exact in fp32 in both
packages, ties included. The graph's entry scan is #10's plain version here,
the reference's Pallas kernel in interpret mode there; and the reference's
default XLA entry scan against the port's ``"xla"`` mode."""

import numpy as np
import pytest

from velesdb_tpu.index.params import GraphParams as JParams
from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops.chunked import brute_force_topk
from velesdb_tpu.parallel import make_mesh as j_mesh
from velesdb_tpu.parallel.sharded_ann import ShardedGraphIndex as JGraph
from velesdb_tpu.parallel.sharded_ivf import ShardedIvfIndex as JIvf
from velesdb_tpu_torch.parallel.carried import reference_arrays
from velesdb_tpu_torch.tools import sharded_phase

# each metric at dp 1 and 2, the two worlds alternating
RECALL_CASES = [("cosine", 1, 2), ("cosine", 2, 4), ("euclidean", 1, 4), ("euclidean", 2, 2)]
SMALL = dict(degree=24, knn_k=12)
ENTRY = dict(degree=24, knn_k=12, entry_probes=8, entry_points=32)
FULL_PROBE = 10_000  # past every shard's partition count: every partition probed


def _clustered(rng, n, d, c=16):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 2
    a = rng.integers(0, c, n)
    return centers[a] + 0.5 * rng.standard_normal((n, d)).astype(np.float32)


def _ints(rng, n, d, lo=-4, hi=4):
    """Integer-valued rows: every product and sum stays exact in fp32."""
    return rng.integers(lo, hi, (n, d)).astype(np.float32)


def _recall(rows, gt):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                    for a, b in zip(rows, gt)])


def _inputs():
    """label -> (world, job, the port's kwargs)."""
    cases = {}
    for metric, dp, w in RECALL_CASES:
        rng = np.random.default_rng(20 + 10 * dp + w)
        kw = dict(dp=dp, dim=32, metric=metric, corpus=_clustered(rng, 4000, 32),
                  queries=_clustered(rng, 64, 32), k=10, params=SMALL, ef=128)
        cases[f"ann-{metric}-dp{dp}-w{w}"] = (w, "graph", kw)
    rng = np.random.default_rng(30)
    # 5,000 rows a shard, past the 4,096-row entry-IVF gate (as the
    # reference's 40,000 rows over 8 shards)
    cases["entry"] = (4, "graph", dict(
        dp=1, dim=32, metric="euclidean", corpus=_clustered(rng, 20_000, 32),
        queries=_clustered(rng, 64, 32), k=10, params=ENTRY, ef=128,
        entry_modes=(None, "xla")))
    rng = np.random.default_rng(31)
    corpus = _clustered(rng, 1003, 16)
    cases["uneven"] = (4, "graph", dict(
        dp=1, dim=16, metric="cosine", corpus=corpus, queries=corpus[:8], k=5,
        params=dict(degree=16, knn_k=8), ef=64))
    rng = np.random.default_rng(32)
    cases["ivf"] = (4, "ivf", dict(
        dp=2, dim=32, metric="cosine", corpus=_clustered(rng, 4000, 32),
        queries=_clustered(rng, 48, 32), k=10, n_clusters=16, nprobes=(8, FULL_PROBE)))
    rng = np.random.default_rng(33)
    corpus = _clustered(rng, 999, 16)
    cases["ivf-uneven"] = (2, "ivf", dict(
        dp=1, dim=16, metric="euclidean", corpus=corpus, queries=corpus[:8], k=5,
        n_clusters=4, nprobes=(4,)))
    return cases


def _carried_inputs():
    """Reference engines built here whose state the port's ranks take."""
    out = {}
    rng = np.random.default_rng(40)
    x = _ints(rng, 18_000, 32)
    q = x[rng.integers(0, len(x), 16)] + rng.integers(-1, 2, (16, 32)).astype(np.float32)
    g = JGraph(j_mesh(4), 32, JMetric.EUCLIDEAN, params=JParams(**ENTRY))
    g.build(x)
    assert g._entry is not None and g._entry_kern is not None
    out["carried-graph"] = (4, g, dict(dp=1, queries=q, k=10, searches=(
        {"ef": 64}, {"ef": 64, "entry_mode": "xla"})), x)
    rng = np.random.default_rng(41)
    x = _ints(rng, 8000, 32)
    q = x[rng.integers(0, len(x), 16)] + rng.integers(-1, 2, (16, 32)).astype(np.float32)
    ivf = JIvf(j_mesh(2, dp=2), 32, JMetric.EUCLIDEAN, n_clusters=16)
    ivf.build(x)
    out["carried-ivf"] = (2, ivf, dict(dp=2, queries=q, k=10, searches=(
        {"nprobe": 4}, {"nprobe": FULL_PROBE})), x)
    return out


def _reference(label, world, kw):
    """The reference's own build and searches on ``make_mesh(world, dp)``."""
    mesh = j_mesh(world, dp=kw["dp"])
    metric = JMetric.parse(kw["metric"])
    if "nprobes" in kw:
        idx = JIvf(mesh, kw["dim"], metric, n_clusters=kw["n_clusters"])
        idx.build(kw["corpus"])
        return [idx.search(kw["queries"], kw["k"], nprobe=p) for p in kw["nprobes"]]
    idx = JGraph(mesh, kw["dim"], metric, params=JParams(**kw["params"]))
    idx.build(kw["corpus"])
    return [idx.search(kw["queries"], kw["k"], ef=kw["ef"], entry_mode=m)
            for m in kw.get("entry_modes", (None,))]


@pytest.fixture(scope="module")
def runs():
    cases = _inputs()
    carried = _carried_inputs()
    jobs = {w: [] for w in (2, 4)}
    for lab, (w, job, kw) in cases.items():
        jobs[w].append((lab, job, kw))
    for lab, (w, ref, kw, _) in carried.items():
        jobs[w].append((lab, "carried", dict(kw, arrays=reference_arrays(ref))))

    def reference():
        ref = {lab: _reference(lab, c[0], c[2]) for lab, c in cases.items()}
        for lab, (_, eng, kw, _) in carried.items():
            if "carried-graph" == lab:  # the reference's kernel scan, then its XLA scan
                ref[lab] = [eng.search(kw["queries"], kw["k"], ef=64, entry_mode="kernel"),
                            eng.search(kw["queries"], kw["k"], ef=64, entry_mode="xla")]
            else:
                ref[lab] = [eng.search(kw["queries"], kw["k"], **s) for s in kw["searches"]]
        return ref

    worlds, ref = sharded_phase.run_worlds(
        {w: [(j, kw) for _, j, kw in js] for w, js in jobs.items()}, reference)
    out = {}
    for w, results in worlds.items():
        for (lab, _, kw), per_rank in zip(jobs[w], results):
            for r in per_rank[1:]:  # every rank holds the same global answer
                for (v, i), (v0, i0) in zip(r["found"], per_rank[0]["found"]):
                    np.testing.assert_array_equal(i, i0)
                    np.testing.assert_array_equal(v, v0)
            corpus = carried[lab][3] if lab in carried else kw["corpus"]
            out[lab] = (kw, per_rank[0], ref[lab], corpus)
    return out


@pytest.mark.parametrize("metric,dp,world", RECALL_CASES)
def test_sharded_ann_recall(runs, metric, dp, world):
    kw, got, ref, corpus = runs[f"ann-{metric}-dp{dp}-w{world}"]
    assert got["n_shards"] == world // dp
    vals, rows = got["found"][0]
    queries, k = kw["queries"], kw["k"]
    assert rows.shape == (64, k)
    assert rows.min() >= 0 and rows.max() < len(corpus)
    _, gt = brute_force_topk(queries, corpus, k, JMetric.parse(metric))
    gt = np.asarray(gt)
    recall = _recall(rows, gt)
    assert recall >= 0.9, f"sharded ANN recall {recall:.3f} too low ({metric}, dp={dp})"
    assert recall >= _recall(ref[0][1], gt), "below the reference's own build"
    # scores must be exact for the rows returned
    if metric == "cosine":
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        expect = np.take_along_axis(qn @ cn.T, rows, axis=1)
        np.testing.assert_allclose(vals, expect, rtol=1e-3, atol=1e-3)


def test_sharded_ann_entry_ivf(runs):
    """Per-shard SQ8 entry IVFs serve the beam's entry stage: #10's plain
    version (the port's every unmasked entry scan) and the ``"xla"`` scan
    agree, recall holds on both, and neither is below the reference's."""
    kw, got, ref, corpus = runs["entry"]
    assert got["entry"], "per-shard entry IVFs must assemble"
    assert got["entry_kern"]
    _, gt = brute_force_topk(kw["queries"], corpus, kw["k"], JMetric.EUCLIDEAN)
    gt = np.asarray(gt)
    (_, rk), (_, rx) = got["found"]
    for rows in (rk, rx):
        assert rows.min() >= 0 and rows.max() < len(corpus)
    recall_k, recall_x = _recall(rk, gt), _recall(rx, gt)
    assert recall_k >= 0.9, f"kernel-entry sharded recall {recall_k:.3f}"
    assert recall_x >= 0.9, f"xla-entry sharded recall {recall_x:.3f}"
    assert recall_x >= _recall(ref[0][1], gt), "below the reference's own build"
    assert _recall(rk, rx) >= 0.9, "entry-path agreement"


def test_sharded_ann_uneven_rows(runs):
    kw, got, _, corpus = runs["uneven"]
    _, rows = got["found"][0]
    assert (rows[:, 0] == np.arange(8)).all()  # self is its own NN
    assert rows.max() < len(corpus)  # padding rows never surface


def test_sharded_ivf_recall(runs):
    kw, got, ref, corpus = runs["ivf"]
    (_, rows), (_, full) = got["found"]
    assert rows.shape == (48, 10) and rows.max() < len(corpus) and rows.min() >= 0
    _, gt = brute_force_topk(kw["queries"], corpus, 10, JMetric.COSINE)
    gt = np.asarray(gt)
    assert _recall(rows, gt) >= 0.9, f"sharded IVF recall {_recall(rows, gt):.3f}"
    assert _recall(rows, gt) >= _recall(ref[0][1], gt), "below the reference's own build"
    # full probe per shard -> exact
    assert _recall(full, gt) >= 0.999


def test_sharded_ivf_uneven(runs):
    _, got, _, _ = runs["ivf-uneven"]
    _, rows = got["found"][0]
    assert (rows[:, 0] == np.arange(8)).all()


def test_sharded_graph_carried_state_equals_reference(runs):
    """One reference sharded graph (4 shards of 4,500 integer-valued rows,
    each with its SQ8 entry IVF) as the port's shards: the same ids and
    values through #10's plain version as the reference's Pallas entry
    kernel, and through either package's XLA entry scan."""
    _, got, ref, _ = runs["carried-graph"]
    for (v, i), (jv, ji) in zip(got["found"], ref):
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-6)


def test_sharded_ivf_carried_state_equals_reference(runs):
    """One reference sharded IVF (2 shards, dp 2, integer-valued rows) as the
    port's shards: ids equal at nprobe 4 and at a full probe."""
    _, got, ref, _ = runs["carried-ivf"]
    for (v, i), (jv, ji) in zip(got["found"], ref):
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-6)
