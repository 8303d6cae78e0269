"""The JAX package's ``tests/test_multihost_dcn.py`` on the port's
``parallel.multihost`` (each test under the reference's name), in gloo
worlds spawned once for the module (``tools/sharded_phase.py``), with the
reference's cross-host search on its ``make_hybrid_mesh`` beside them.

A rank is one process and one device here, and a slice is a host
(``num_slices`` counts host names): on this one host ``dcn`` is 1 unless a
mesh asks for more slices, which the two-slice tests do to put the merge's
gather across the ``dcn`` axis. ``test_dcn_two_process_localhost`` stays
slow, as the reference's is; ``test_dcn_two_rank_search`` runs its search in
two ranks unmarked."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops.chunked import brute_force_topk
from velesdb_tpu.parallel.multihost import dcn_sharded_search as j_dcn_search
from velesdb_tpu.parallel.multihost import make_global_rows as j_global_rows
from velesdb_tpu.parallel.multihost import make_hybrid_mesh as j_hybrid_mesh
from velesdb_tpu_torch.tools import sharded_phase

ENTRY = dict(degree=24, knn_k=12, entry_probes=8, entry_points=32)


def _exact_ids(queries, corpus, k):
    d2 = (np.sum(queries**2, 1)[:, None] + np.sum(corpus**2, 1)[None, :]
          - 2 * queries @ corpus.T)
    return np.argsort(np.maximum(d2, 0), axis=1)[:, :k]


def _recall(rows, gt):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                    for a, b in zip(rows, gt)])


def _engines_case(rng, n, d, b, c):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 2.0
    corpus = centers[rng.integers(0, c, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.5
    queries = corpus[rng.integers(0, n, b)] + 1e-3
    return corpus, queries


def _inputs():
    rng = np.random.default_rng(0)
    unit = rng.standard_normal((2048, 32)).astype(np.float32)
    rng = np.random.default_rng(1)
    corpus, queries = _engines_case(rng, 20_000, 32, 32, 16)
    rng = np.random.default_rng(5)
    two = rng.standard_normal((4096, 64)).astype(np.float32)
    two_q = rng.standard_normal((8, 64)).astype(np.float32)
    return {
        4: [("unit", "dcn", dict(dp=2, corpus=unit, queries=unit[:4] + 0.001, k=10,
                                 metric="euclidean")),
            ("graph", "graph", dict(dp=2, dim=32, metric="euclidean", corpus=corpus,
                                    queries=queries, k=10, params=ENTRY, ef=128, hybrid=True)),
            ("ivf", "ivf", dict(dp=2, dim=32, metric="euclidean", corpus=corpus,
                                queries=queries, k=10, nprobes=(16,), hybrid=True))],
        2: [("two", "dcn", dict(dp=1, corpus=two, queries=two_q, k=10, metric="euclidean",
                                slices=2)),
            ("helpers", "helpers", dict(dp=2))],
    }


@pytest.fixture(scope="module")
def runs():
    jobs = _inputs()

    def reference():
        """The reference's cross-host search on the unit-dcn mesh."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        kw = jobs[4][0][2]
        mesh = j_hybrid_mesh(dp=2)
        corpus, n = kw["corpus"], kw["corpus"].shape[0]
        sqn = np.sum(corpus * corpus, axis=1).astype(np.float32)
        ref = j_dcn_search(
            mesh, jax.device_put(kw["queries"], NamedSharding(mesh, P("dp", None))),
            j_global_rows(mesh, lambda s, e: corpus[s:e], n, row_shape=(32,)),
            j_global_rows(mesh, lambda s, e: np.ones(e - s, bool), n, dtype=bool),
            j_global_rows(mesh, lambda s, e: sqn[s:e], n), k=kw["k"], metric=JMetric.EUCLIDEAN)
        return tuple(np.asarray(a) for a in ref)

    worlds, ref = sharded_phase.run_worlds(
        {w: [(j, kw) for _, j, kw in js] for w, js in jobs.items()}, reference)
    out = {"ref-unit": ref}
    for w, results in worlds.items():
        for (lab, _, kw), per_rank in zip(jobs[w], results):
            out[lab] = (kw, per_rank)
    return out


def _same_on_every_rank(per_rank, key):
    for r in per_rank[1:]:
        for a, b in zip(r[key], per_rank[0][key]):
            np.testing.assert_array_equal(a, b)


def test_dcn_search_unit_axis(runs):
    """The (dcn=1, dp, rows) search serves the exact top-k on one host, as
    the reference's does."""
    kw, per_rank = runs["unit"]
    assert per_rank[0]["shape"] == {"dcn": 1, "dp": 2, "rows": 2}
    _same_on_every_rank(per_rank, "search")
    vals, idx = per_rank[0]["search"]
    b = len(kw["queries"])
    assert (idx[:, 0] == np.arange(b)).all()
    ref = _exact_ids(kw["queries"], kw["corpus"], kw["k"])
    assert np.array_equal(np.sort(idx, 1), np.sort(ref, 1))
    jv, ji = runs["ref-unit"]
    np.testing.assert_array_equal(idx, ji)
    # squared distances come from |q|^2 - (2 q.c - |c|^2) in both packages:
    # within rtol 1e-5, and a few ulps of |q|^2 (~32) at the planted rows
    np.testing.assert_allclose(vals**2, jv**2, rtol=1e-5, atol=2e-5)


def test_dcn_graph_and_ivf_engines(runs):
    """The graph and IVF engines row-shard over ("dcn", "rows") on a hybrid
    mesh and merge their partials across both in one gather."""
    kw, per_rank = runs["graph"]
    assert per_rank[0]["n_shards"] == 2  # (dcn=1, dp=2, rows=2)
    _same_on_every_rank(per_rank, "found")
    _, gt = brute_force_topk(kw["queries"], kw["corpus"], kw["k"], JMetric.EUCLIDEAN)
    gt = np.asarray(gt)
    recall = _recall(per_rank[0]["found"][0][1], gt)
    assert recall >= 0.9, f"dcn-mesh graph recall {recall:.3f}"
    kw, per_rank = runs["ivf"]
    assert per_rank[0]["n_shards"] == 2
    _same_on_every_rank(per_rank, "found")
    irecall = _recall(per_rank[0]["found"][0][1], gt)
    assert irecall >= 0.9, f"dcn-mesh ivf recall {irecall:.3f}"


def test_dcn_two_rank_search(runs):
    """Two ranks as two slices: ``dcn`` 2, one row shard each, the merge's
    gather across the slices; equal to the exact single-process answer."""
    kw, per_rank = runs["two"]
    assert per_rank[0]["shape"] == {"dcn": 2, "dp": 1, "rows": 1}
    assert sorted(r["coords"]["dcn"] for r in per_rank) == [0, 1]
    _same_on_every_rank(per_rank, "search")
    _, idx = per_rank[0]["search"]
    ref = _exact_ids(kw["queries"], kw["corpus"], kw["k"])
    assert np.array_equal(np.sort(idx, 1), np.sort(ref, 1))


def test_multihost_helpers_in_a_world(runs):
    """Inside a world the caller started: the bootstrap adopts it, one host
    is one slice, and each rank's segment is contiguous and covering."""
    _, per_rank = runs["helpers"]
    assert all(r["adopted"] for r in per_rank)
    assert all(r["slices"] == 1 for r in per_rank)
    assert per_rank[0]["shape"] == {"dcn": 1, "dp": 2, "rows": 1}
    segs = [r["segment"] for r in per_rank]
    assert segs[0][0] == 0 and segs[-1][1] == 103 and segs[0][1] == segs[1][0]


def test_world_of_one_in_one_process(tmp_path):
    """With no process group and no rendezvous in the environment,
    ``make_mesh`` starts a world of 1 in the process (the reference's
    single-host case) and the sharded engine serves in it."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {repo!r})
        import numpy as np
        import torch.distributed as dist
        from velesdb_tpu_torch.parallel import ShardedBruteForce, make_mesh
        mesh = make_mesh(device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert mesh.shape == {{"dp": 1, "rows": 1}}
        x = np.random.default_rng(0).standard_normal((3000, 16)).astype(np.float32)
        idx = ShardedBruteForce(mesh, 16, "euclidean")
        idx.rebuild(x)
        v, i = idx.search(x[:4], 3)
        assert (i[:, 0] == np.arange(4)).all(), i
        print("world-of-one-ok")
    """)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "VELESDB_COORD_ADDR")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "world-of-one-ok" in out.stdout


@pytest.mark.slow
def test_dcn_two_process_localhost():
    """Two processes, each a slice that owns half the corpus: the cross-host
    top-k equals the single-process answer, and the graph and IVF engines
    shard over both slices."""
    rng = np.random.default_rng(5)
    n, d, b, k = 4096, 64, 8, 10
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 2.0
    ccorpus = centers[rng.integers(0, 8, n)] + rng.standard_normal((n, d)).astype(
        np.float32) * 0.5
    cq = ccorpus[:b] + 1e-3
    res = sharded_phase.run_world(2, [
        ("dcn", dict(dp=1, corpus=corpus, queries=queries, k=k, metric="euclidean", slices=2)),
        ("graph", dict(dp=1, dim=d, metric="euclidean", corpus=ccorpus, queries=cq, k=k,
                       params=dict(degree=24, knn_k=12), ef=128, hybrid=True, slices=2)),
        ("ivf", dict(dp=1, dim=d, metric="euclidean", corpus=ccorpus, queries=cq, k=k,
                     nprobes=(8,), hybrid=True, slices=2)),
    ])
    assert res[1][0]["n_shards"] == res[2][0]["n_shards"] == 2
    _, idx = res[0][0]["search"]
    assert np.array_equal(np.sort(idx, 1), np.sort(_exact_ids(queries, corpus, k), 1))
    cref = _exact_ids(cq, ccorpus, k)
    assert _recall(res[1][0]["found"][0][1], cref) >= 0.9
    assert _recall(res[2][0]["found"][0][1], cref) >= 0.9
