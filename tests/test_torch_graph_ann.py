"""``tests/test_ann.py`` against the port's graph index, on the CPU.

Each of the reference suite's 23 tests runs here on
``velesdb_tpu_torch.index.graph_index`` with the reference's data generator,
widths and bars (recall against the exact top-k of ``ops/chunked.py``); the
module's corpus has 10,000 rows where the reference's has 20,000, the
approximate-build tests share one 8,000-row corpus, and indexes with the
same data and parameters are built once per module. Where a
reference test reaches into a TPU-only switch, the port's rule is checked
instead: ``test_entry_kernel_smem_gate`` holds the port's entry rule (#10 on
every unmasked search, ``ivf_search_impl`` under a mask; no scalar-memory
gate), and ``test_entry_batch_stitching`` the port's dispatch cap.
``test_device_build_lazy_host_adj`` lowers ``EXACT_KNN_MAX_ROWS`` to reach
the device pipeline at 8,000 rows instead of building 80,000. Also here: the
two kNN-builder tests of ``tests/test_ivf.py`` and
``tests/test_collection.py::test_graph_filtered_search_starvation_guard``.
"""

import os

import numpy as np
import pytest
import torch

import velesdb_tpu_torch
from velesdb_tpu_torch.index import graph_index as gmod
from velesdb_tpu_torch.index import ivf as ivfmod
from velesdb_tpu_torch.index.graph_index import GraphIndex, _assemble_adjacency
from velesdb_tpu_torch.index.params import GraphParams, SearchQuality
from velesdb_tpu_torch.ops import DistanceMetric
from velesdb_tpu_torch.ops.chunked import brute_force_topk


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for this module: the suite runs several test
    processes side by side, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gi(dim, metric, params=None):
    return GraphIndex(dim, metric, params, device="cpu")


def _topk(*args, **kwargs):
    return brute_force_topk(*args, device="cpu", **kwargs)


def clustered(rng, n, dim, n_clusters=32, spread=0.15, centers=None):
    """Clustered Gaussian data (the reference test's generator)."""
    if centers is None:
        centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, len(centers), n)
    data = (
        centers[assign] + spread * rng.standard_normal((n, dim)).astype(np.float32)
    ).astype(np.float32)
    return data, centers


def recall_at_k(got_idx, true_idx, k):
    got_idx = got_idx.numpy() if isinstance(got_idx, torch.Tensor) else np.asarray(got_idx)
    hits = 0
    for g, t in zip(got_idx, true_idx):
        hits += len(set(g[:k].tolist()) & set(t[:k].tolist()))
    return hits / (len(got_idx) * k)


@pytest.fixture(scope="module")
def corpus_and_truth():
    rng = np.random.default_rng(3)
    corpus, centers = clustered(rng, 10_000, 64)
    queries, _ = clustered(rng, 64, 64, centers=centers)
    valid = np.ones(len(corpus), bool)
    truth = {}
    for metric in (DistanceMetric.EUCLIDEAN, DistanceMetric.COSINE):
        _, ti = _topk(queries, corpus, 10, metric, valid=valid)
        truth[metric] = ti
    return corpus, queries, valid, truth


_BUILT = {}


def _built(corpus_and_truth, metric, **params):
    """One build per (metric, params) over the module's corpus."""
    key = (metric, tuple(sorted(params.items())))
    if key not in _BUILT:
        corpus, _, valid, _ = corpus_and_truth
        idx = _gi(64, metric, GraphParams(degree=32, knn_k=16, **params))
        idx.build(corpus, valid)
        _BUILT[key] = idx
    return _BUILT[key]


@pytest.mark.parametrize("metric", [DistanceMetric.EUCLIDEAN, DistanceMetric.COSINE])
def test_recall_balanced(corpus_and_truth, metric):
    _, queries, _, truth = corpus_and_truth
    idx = _built(corpus_and_truth, metric)
    _, got = idx.search(queries, 10, quality=SearchQuality.BALANCED)
    r = recall_at_k(got, truth[metric], 10)
    assert r >= 0.90, f"recall@10={r:.3f} below 0.90 (balanced, {metric})"


def test_recall_profiles_ordered(corpus_and_truth):
    _, queries, _, truth = corpus_and_truth
    metric = DistanceMetric.EUCLIDEAN
    idx = _built(corpus_and_truth, metric)
    recalls = {}
    for q in (SearchQuality.FAST, SearchQuality.BALANCED, SearchQuality.ACCURATE):
        _, got = idx.search(queries, 10, quality=q)
        recalls[q] = recall_at_k(got, truth[metric], 10)
    assert recalls[SearchQuality.FAST] >= 0.75
    assert recalls[SearchQuality.ACCURATE] >= 0.95
    assert recalls[SearchQuality.ACCURATE] >= recalls[SearchQuality.FAST] - 0.02


def test_tombstones_excluded(corpus_and_truth):
    corpus, queries, valid, _ = corpus_and_truth
    valid2 = valid.copy()
    # tombstone the true nearest neighbors of query 0
    _, ti = _topk(queries[:1], corpus, 5, DistanceMetric.EUCLIDEAN)
    dead = set(ti[0].tolist())
    for d in dead:
        valid2[d] = False
    idx = _gi(64, DistanceMetric.EUCLIDEAN, GraphParams(degree=32, knn_k=16))
    idx.build(corpus, valid2)
    _, got = idx.search(queries[:1], 10)
    assert not (set(got[0].tolist()) & dead)


def test_result_filter_mask(corpus_and_truth):
    corpus, queries, _, _ = corpus_and_truth
    idx = _built(corpus_and_truth, DistanceMetric.EUCLIDEAN)
    mask = np.zeros(idx.n_pad, bool)
    mask[: len(corpus) : 2] = True  # only even slots allowed
    _, got = idx.search(queries[:4], 10, ef=256, mask=mask)
    got = got.numpy()
    real = got[got >= 0]
    assert len(real) and np.all(real % 2 == 0)


def test_save_load_roundtrip(tmp_path, corpus_and_truth):
    corpus, queries, valid, _ = corpus_and_truth
    idx = _built(corpus_and_truth, DistanceMetric.EUCLIDEAN)
    path = str(tmp_path / "ann.npz")
    idx.save(path, version=42)
    _, want = idx.search(queries[:8], 10)

    idx2 = _gi(64, DistanceMetric.EUCLIDEAN)
    assert not idx2.load(path, corpus, valid, version=41)  # stale version
    assert idx2.load(path, corpus, valid, version=42)
    _, got = idx2.search(queries[:8], 10)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_assemble_adjacency_reverse_edges():
    fwd = np.array([[1, 2], [2, -1], [0, -1]], dtype=np.int32)
    adj = _assemble_adjacency(fwd, 3, 4)
    assert adj.shape == (3, 4)
    # forward edges preserved
    assert {1, 2} <= set(adj[0].tolist())
    # reverse edge 0<-2 (because 2->0) present in row 0
    assert 0 in adj[2].tolist() or 2 in adj[0].tolist()
    # all slots filled (random long-range fill) and no self-edges
    assert (adj >= 0).all()
    for i, row in enumerate(adj):
        assert i not in row.tolist()


def test_assemble_adjacency_device_matches_host(rng):
    """The device assembly (_assemble_adjacency_dev) is bit-identical to the
    host path, including hole-y pruned rows and pad rows."""
    for n, k, degree, pad in [(500, 16, 32, 0), (701, 32, 64, 323), (2, 4, 8, 0)]:
        fwd = rng.integers(0, n, (n, k)).astype(np.int32)
        fwd[rng.random((n, k)) < 0.2] = -1  # pruned holes
        host = _assemble_adjacency(fwd.copy(), n, degree)
        fwd_p = np.pad(fwd, ((0, pad), (0, 0)), constant_values=-1)
        dev = gmod._assemble_adjacency_dev(torch.from_numpy(fwd_p), n=n, degree=degree).numpy()
        assert dev.shape == (n + pad, degree)
        assert (dev[n:] == -1).all()  # pad rows stay empty
        np.testing.assert_array_equal(dev[:n], host)


def test_device_build_lazy_host_adj(rng, monkeypatch):
    """A device-assembled build defers the host adjacency copy; save()
    materializes it (the device pipeline reached past a lowered
    ``EXACT_KNN_MAX_ROWS``)."""
    monkeypatch.setattr(GraphIndex, "EXACT_KNN_MAX_ROWS", 2_000)
    n, d = 8_000, 16
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    dev = torch.from_numpy(corpus)
    idx = _gi(d, DistanceMetric.EUCLIDEAN)
    idx.build(corpus, np.ones(n, bool), corpus_dev=dev)
    assert idx._adj_host is None  # deferred until persistence
    adj = idx._host_adj()
    assert adj is not None and adj.shape == (n, idx.params.degree)
    assert idx._adj_host is adj  # cached


def test_unsupported_metric_raises():
    with pytest.raises(ValueError):
        _gi(8, DistanceMetric.HAMMING)


def test_chunked_topk_matches_exact(rng):
    corpus = rng.standard_normal((3000, 32)).astype(np.float32)
    queries = rng.standard_normal((10, 32)).astype(np.float32)
    vals, idx = _topk(queries, corpus, 7, DistanceMetric.EUCLIDEAN)
    # exact numpy truth
    d = np.linalg.norm(queries[:, None] - corpus[None], axis=-1)
    ti = np.argsort(d, axis=1)[:, :7]
    assert (idx == ti).mean() > 0.99  # ties may reorder
    np.testing.assert_allclose(vals, np.sort(d, axis=1)[:, :7], rtol=1e-3, atol=1e-3)


def test_chunked_exclude_self(rng):
    corpus = rng.standard_normal((500, 16)).astype(np.float32)
    _, idx = _topk(corpus, corpus, 3, DistanceMetric.EUCLIDEAN, exclude_self=True)
    for i in range(500):
        assert i not in idx[i]


@pytest.mark.parametrize("metric", [DistanceMetric.COSINE, DistanceMetric.EUCLIDEAN])
def test_quantized_traversal_matches_f32(corpus_and_truth, metric):
    """Dual-precision beam: SQ8 gathers + f32 final rerank hold the same
    recall bar as the f32 beam, and the returned scores are f32-exact."""
    corpus, queries, _, truth = corpus_and_truth
    gi = _built(corpus_and_truth, metric, quantized_traversal=True)
    assert gi._sq8trav is not None
    vals, idx = gi.search(queries, 10, quality=SearchQuality.BALANCED)
    r = recall_at_k(idx, truth[metric], 10)
    assert r >= 0.95, f"quantized-traversal recall {r:.3f}"
    top = idx.numpy()[:, 0]
    q = queries
    if metric is DistanceMetric.EUCLIDEAN:
        exact = np.linalg.norm(corpus[top] - q, axis=1)
    else:
        num = np.sum(corpus[top] * q, axis=1)
        den = np.linalg.norm(corpus[top], axis=1) * np.linalg.norm(q, axis=1)
        exact = 1.0 - (1.0 - num / den)  # cosine similarity
    np.testing.assert_allclose(vals.numpy()[:, 0], exact, rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def approx_corpus():
    """8,000 x 32 clustered rows past a shrunk ``EXACT_KNN_MAX_ROWS`` (the
    approximate build), queries and their exact top-10; builds cached per
    params."""
    rng = np.random.default_rng(7)
    corpus, centers = clustered(rng, 8_000, 32, n_clusters=16)
    queries, _ = clustered(rng, 64, 32, centers=centers)
    valid = np.ones(len(corpus), bool)
    _, truth = _topk(queries, corpus, 10, DistanceMetric.EUCLIDEAN, valid=valid)
    return corpus, queries, valid, truth, {}


def _approx_built(approx_corpus, **params):
    corpus, _, valid, _, cache = approx_corpus
    key = tuple(sorted(params.items()))
    if key not in cache:
        old = GraphIndex.EXACT_KNN_MAX_ROWS
        GraphIndex.EXACT_KNN_MAX_ROWS = 2_000
        try:
            gi = _gi(32, DistanceMetric.EUCLIDEAN, GraphParams(degree=32, knn_k=16, **params))
            gi.build(corpus, valid)
        finally:
            GraphIndex.EXACT_KNN_MAX_ROWS = old
        cache[key] = gi
    return cache[key]


def test_approx_build_with_routed_entries(tmp_path, approx_corpus):
    """The approximate build (IVF-bucketed kNN + routed beam entries) past a
    shrunk threshold: a router, recall, and a save/load round trip of it."""
    corpus, queries, valid, truth, _ = approx_corpus
    metric = DistanceMetric.EUCLIDEAN
    gi = _approx_built(approx_corpus)
    assert gi._route_cents is not None, "approx build must keep its router"
    _, got = gi.search(queries, 10, quality=SearchQuality.BALANCED)
    r = recall_at_k(got, truth, 10)
    assert r >= 0.9, f"routed-entry recall {r:.3f}"

    p = str(tmp_path / "ann.npz")
    gi.save(p, version=1)
    gi2 = _gi(32, metric, GraphParams(degree=32, knn_k=16))
    assert gi2.load(p, corpus, valid, version=1)
    assert gi2._route_cents is not None, "router must survive save/load"
    _, got2 = gi2.search(queries, 10, quality=SearchQuality.BALANCED)
    assert torch.equal(got, got2)


def test_wide_entry_probes_lift_recall(approx_corpus):
    """entry_probes widens the scan that seeds the beam; on a small
    clustered corpus the wide-entry search stays valid and recall does not
    regress."""
    corpus, queries, _, truth, _ = approx_corpus
    recalls = {}
    for probes in (2, 8):
        gi = _approx_built(approx_corpus, entry_probes=probes, entry_points=32)
        assert gi._route_cents is not None
        vals, got = gi.search(queries, 10, quality=SearchQuality.BALANCED)
        got = got.numpy()
        assert (got >= 0).all() and (got < len(corpus)).all()
        recalls[probes] = recall_at_k(got, truth, 10)
    assert recalls[8] >= recalls[2] - 0.01, recalls
    assert recalls[8] >= 0.9, recalls


def test_entry_ivf_survives_save_load(tmp_path, monkeypatch, approx_corpus):
    """The entry-IVF k-means recipe persists next to the graph artifact;
    load re-assembles it without re-clustering and search results match."""
    corpus, queries, valid, _, _ = approx_corpus
    params = GraphParams(degree=32, knn_k=16, entry_probes=8, entry_points=32)

    gi = _approx_built(approx_corpus, entry_probes=8, entry_points=32)
    assert gi._entry_ivf is not None
    _, got = gi.search(queries, 10, quality=SearchQuality.BALANCED)

    p = str(tmp_path / "ann.npz")
    gi.save(p, version=1)
    assert os.path.exists(GraphIndex._entry_path(p))

    monkeypatch.setattr(ivfmod, "kmeans", lambda *a, **kw: pytest.fail("re-clustered"))
    gi2 = _gi(32, DistanceMetric.EUCLIDEAN, params)
    assert gi2.load(p, corpus, valid, version=1)
    assert gi2._entry_ivf is not None, "entry IVF must re-assemble on load"
    _, got2 = gi2.search(queries, 10, quality=SearchQuality.BALANCED)
    assert torch.equal(got, got2)


@pytest.fixture(scope="module")
def entry_graph():
    """12,000 x 64 clustered, approximate build with a wide entry scan."""
    old = GraphIndex.EXACT_KNN_MAX_ROWS
    GraphIndex.EXACT_KNN_MAX_ROWS = 2_000
    try:
        rng = np.random.default_rng(13)
        corpus, centers = clustered(rng, 12_000, 64, n_clusters=16)
        queries, _ = clustered(rng, 100, 64, centers=centers)
        gi = _gi(64, DistanceMetric.EUCLIDEAN,
                 GraphParams(degree=32, knn_k=16, entry_probes=8, entry_points=32))
        gi.build(corpus, np.ones(len(corpus), bool))
    finally:
        GraphIndex.EXACT_KNN_MAX_ROWS = old
    return gi, queries


def test_entry_ivf_kernel_matches_xla(entry_graph):
    """The SQ8 entry IVF serves the wide entry scan two ways, #10 (its plain
    version on the CPU) and ``ivf_search_impl``; both seed the beam alike:
    ids agree up to coarse-score near-ties, values to 1e-4."""
    gi, queries = entry_graph
    eiv = gi._entry_ivf
    assert eiv is not None, "entry_probes >= 8 must build the entry IVF"
    assert eiv.storage == "sq8"
    qp = torch.from_numpy(queries[:16])
    common = dict(k=10, beam=64, expansions=64, degree=gi._adj.shape[1], entry_points=32,
                  metric=DistanceMetric.EUCLIDEAN, entry_probes=min(8, eiv.c))
    base = (qp, gi._corpus, gi._adj, gi._sqnorm, gi._valid, gi._seed_ids, None, None, None)
    vk, ik = gmod.beam_search_impl(
        *base, (eiv._centroids, eiv._cent_sq, eiv._parts, *eiv._kernel_state()),
        entry_mode="kernel", **common)
    vx, ix = gmod.beam_search_impl(
        *base, (eiv._centroids, eiv._cent_sq, (eiv._parts, eiv._part_scale, eiv._part_minv),
                eiv._part_rows, eiv._part_sq),
        entry_mode="xla", **common)
    agree = np.mean([len(set(ik[i].tolist()) & set(ix[i].tolist())) / 10 for i in range(16)])
    assert agree >= 0.95, agree
    np.testing.assert_allclose(np.sort(vk.numpy(), axis=1), np.sort(vx.numpy(), axis=1),
                               rtol=1e-4, atol=1e-4)


def test_quantized_traversal_capacity_mode(corpus_and_truth):
    """traversal_rerank=False drops the f32 corpus (4x graph capacity);
    recall holds a lower bar without the head rerank and recovers with a
    host f32 rerank of a 4x pool."""
    corpus, queries, _, truth = corpus_and_truth
    metric = DistanceMetric.EUCLIDEAN
    gi = _built(corpus_and_truth, metric, quantized_traversal=True, traversal_rerank=False)
    assert gi._corpus is None and gi._sq8trav is not None
    _, idx = gi.search(queries, 40, quality=SearchQuality.BALANCED)
    idx = idx.numpy()
    r_raw = recall_at_k(idx, truth[metric], 10)
    assert r_raw >= 0.7, f"capacity-mode coarse recall {r_raw:.3f}"
    reranked = []
    for qi in range(len(queries)):
        cand = idx[qi][idx[qi] >= 0]
        d = np.linalg.norm(corpus[cand] - queries[qi], axis=1)
        reranked.append(cand[np.argsort(d)][:10])
    r = recall_at_k(np.asarray(reranked), truth[metric], 10)
    assert r >= 0.93, f"capacity-mode reranked recall {r:.3f}"


def test_expand_width_recall_invariant(corpus_and_truth):
    """Wider multi-expansion does not cost recall."""
    _, queries, _, truth = corpus_and_truth
    metric = DistanceMetric.EUCLIDEAN
    idx = _built(corpus_and_truth, metric, expand_width=16)
    _, got = idx.search(queries, 10, quality=SearchQuality.BALANCED)
    r = recall_at_k(got, truth[metric], 10)
    assert r >= 0.90, f"recall@10={r:.3f} below 0.90 at expand_width=16"


def test_auto_params_expand_width():
    assert GraphParams.auto(128, 1_000_000).expand_width == 16
    assert GraphParams.auto(768, 100_000).expand_width == 16
    assert GraphParams.auto(64, 20_000).expand_width == 4
    p = GraphParams.auto(128, 1_000_000)
    assert (p.degree, p.knn_k, p.build_nprobe, p.entry_probes, p.entry_points) == (
        64, 32, 32, 64, 96)
    assert p.beam_for_ef(128, 10) == (128, 128) and p.beam_for_ef(5, 10) == (32, 16)


def test_load_keeps_runtime_expand_width(tmp_path, corpus_and_truth):
    """load() restores graph properties from disk and keeps the caller's
    runtime knobs."""
    corpus, _, valid, _ = corpus_and_truth
    metric = DistanceMetric.EUCLIDEAN
    idx = _built(corpus_and_truth, metric, expand_width=16)
    path = str(tmp_path / "g.npz")
    idx.save(path)
    idx2 = _gi(64, metric, GraphParams(degree=32, knn_k=16, expand_width=16))
    assert idx2.load(path, corpus, valid)
    assert idx2.params.expand_width == 16


def test_sq8_knn_build_graph_recall(corpus_and_truth, monkeypatch):
    """The SQ8 bucketed self-kNN build (auto past SQ8_BUILD_MIN_ROWS) makes
    a graph of the f32 build's recall bar."""
    corpus, queries, valid, truth = corpus_and_truth
    metric = DistanceMetric.EUCLIDEAN
    monkeypatch.setattr(GraphIndex, "EXACT_KNN_MAX_ROWS", 4096)
    monkeypatch.setattr(ivfmod, "SQ8_BUILD_MIN_ROWS", 0)
    idx = _gi(64, metric, GraphParams(degree=32, knn_k=16))
    idx.build(corpus, valid)
    _, got = idx.search(queries, 10, quality=SearchQuality.BALANCED)
    r = recall_at_k(got, truth[metric], 10)
    assert r >= 0.90, f"sq8-built graph recall@10={r:.3f}"


def test_entry_kernel_smem_gate(entry_graph, monkeypatch):
    """The reference gates its entry kernel on the TPU's scalar memory
    (``probe_table_fits``); the port has no such gate. Its rule: every
    unmasked search with an entry IVF runs #10 (``ivf_probe_topk``), at any
    batch; a masked one runs ``ivf_search_impl``; with restarts there is no
    entry IVF stage."""
    gi, queries = entry_graph
    seen = []
    real_probe, real_impl = gmod.ivf_probe_topk, gmod.ivf_search_impl
    monkeypatch.setattr(gmod, "ivf_probe_topk",
                        lambda *a, **kw: seen.append("kernel") or real_probe(*a, **kw))
    monkeypatch.setattr(gmod, "ivf_search_impl",
                        lambda *a, **kw: seen.append("xla") or real_impl(*a, **kw))
    gi.search(queries[:24], 5)
    assert seen == ["kernel"]
    gi.search(queries, 5)  # b = 100: still the kernel
    assert seen[-1] == "kernel"
    mask = np.ones(gi.n_pad, bool)
    mask[::3] = False
    _, got = gi.search(queries[:24], 5, mask=mask)
    assert seen[-1] == "xla" and mask[got.numpy()[got.numpy() >= 0]].all()
    assert gi._entry_mode(None) == "kernel" and gi._entry_mode(torch.from_numpy(mask)) == "xla"


def test_entry_batch_stitching(entry_graph, monkeypatch):
    """Batches beyond the dispatch cap stitch chunked dispatches, and the
    stitched results equal the per-chunk searches. The cap keeps #10's
    ``[B, probes, L]`` scores under ``_ENTRY_GATHER_BUDGET``; shrunk here so
    that b = 100 splits into 64 + 36."""
    gi, queries = entry_graph
    eiv = gi._entry_ivf
    monkeypatch.setattr(gmod, "_ENTRY_GATHER_BUDGET", 64 * 4 * 8 * eiv.part_len)
    assert gi._dispatch_cap() == 64

    widths = []
    real = gmod.beam_search_impl

    def spy(*a, **kw):
        widths.append((kw["entry_mode"], a[0].shape[0]))
        return real(*a, **kw)

    monkeypatch.setattr(gmod, "beam_search_impl", spy)
    vals, ids = gi.search(queries, 10)
    assert tuple(ids.shape) == (100, 10)
    assert widths == [("kernel", 64), ("kernel", 36)]
    v1, i1 = gi.search(queries[:64], 10)
    v2, i2 = gi.search(queries[64:], 10)
    assert torch.equal(ids, torch.cat([i1, i2]))
    np.testing.assert_allclose(vals.numpy(), torch.cat([v1, v2]).numpy(), rtol=1e-5, atol=1e-5)


# -- the kNN-builder tests of tests/test_ivf.py --------------------------------


def test_merge_ranked_device_matches_host(rng):
    """The device union-merge reproduces merge_ranked's dedup and ranking."""
    n, k = 257, 8
    v1 = rng.standard_normal((n, k)).astype(np.float32)
    i1 = rng.integers(0, 50, (n, k)).astype(np.int32)
    # duplicates across lists carry identical scores (deterministic per
    # (row, id) pair) — mirror that invariant
    v2 = rng.standard_normal((n, k)).astype(np.float32)
    i2 = rng.integers(0, 50, (n, k)).astype(np.int32)
    for r in range(n):
        for c in range(k):
            m = i1[r] == i2[r, c]
            if m.any():
                v2[r, c] = v1[r][m][0]
    i1[:, -1] = -1
    v1[:, -1] = -np.inf
    want = ivfmod.merge_ranked([v1, v2], [i1, i2], k)
    got = ivfmod._merge_ranked_device(
        torch.cat([torch.from_numpy(v1), torch.from_numpy(v2)], dim=1),
        torch.cat([torch.from_numpy(i1), torch.from_numpy(i2)], dim=1).long(), k=k).numpy()
    assert np.array_equal(got, want)


def test_scatter_knn_device(rng):
    """Partition-shaped kNN results scatter to row shape with dead-slot
    drops."""
    P, L, k_eff, k, n = 4, 8, 3, 5, 25
    rows = np.full((P, L), -1, np.int64)
    live = rng.permutation(n)
    rows.reshape(-1)[:n] = live
    vals = rng.standard_normal((P, L, k_eff)).astype(np.float32)
    nbrs = rng.integers(0, n, (P, L, k_eff)).astype(np.int64)
    sv, si = ivfmod._scatter_knn(torch.from_numpy(vals), torch.from_numpy(nbrs),
                                 torch.from_numpy(rows), n=n, k=k, k_eff=k_eff)
    sv, si = sv.numpy(), si.numpy()
    for slot, r in enumerate(rows.reshape(-1)):
        if r < 0:
            continue
        assert np.array_equal(si[r, :k_eff], nbrs.reshape(-1, k_eff)[slot])
        assert np.allclose(sv[r, :k_eff], vals.reshape(-1, k_eff)[slot])
    assert (si[:, k_eff:] == -1).all()


# -- tests/test_collection.py::test_graph_filtered_search_starvation_guard ------


def test_graph_filtered_search_starvation_guard(tmp_db_dir, rng):
    """The graph filters at result selection, so a selective filter starves
    k unless the pool is oversized by 1/selectivity: the guard bumps ef
    (moderate selectivity) or falls back to the masked exact scan (below
    the beam cap's coverage)."""
    db = velesdb_tpu_torch.Database.open(tmp_db_dir, device="cpu")
    col = db.create_collection("fg", 32, metric="l2")
    col.ann_min_rows = 4096
    col.index_kind = "graph"
    n = 6000
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    payloads = [{"grp": int(i % 100)} for i in range(n)]
    col.upsert_bulk(range(n), vecs, payloads)

    # 1% selectivity (grp == 7): need > beam cap -> exact fallback
    f1 = {"type": "eq", "field": "grp", "value": 7}
    assert col._plan_search(vecs[107:108], 10, col._filter_mask(f1))[0] == "exact"
    res = col.search_batch([vecs[107]], k=10, filter=f1)[0]
    assert len(res) == 10
    assert all(r["payload"]["grp"] == 7 for r in res)
    assert res[0]["id"] == 107

    # ~30% selectivity (grp < 30): the ef bump keeps the graph serving
    f30 = {"type": "lt", "field": "grp", "value": 30}
    col.search(vecs[0], k=1)  # ensure the graph is built
    assert col.ann is not None and not col.ann.dirty
    plan = col._plan_search(vecs[205:206], 10, col._filter_mask(f30))
    assert plan[0] == "graph" and plan[2] > 128
    res30 = col.search_batch([vecs[205]], k=10, filter=f30)[0]
    assert len(res30) == 10
    assert all(r["payload"]["grp"] < 30 for r in res30)
    exact30 = col.search_batch([vecs[205]], k=10, filter=f30, quality="perfect")[0]
    got = {r["id"] for r in res30}
    want = {r["id"] for r in exact30}
    assert len(got & want) >= 8  # filtered recall@10 >= 0.8
    db.close()
