"""The graph slice's building blocks on the CPU against the JAX package.

Each test feeds the same numpy-seeded inputs to ``velesdb_tpu`` and to
``velesdb_tpu_torch``: the exact kNN builders (``ops/chunked.py``), the alpha
prune and both adjacency assemblies, the bucketed approximate kNN on the
reference's own partitions, ``ivf_self_knn``'s kNN recall, and
``beam_search_impl`` in every entry mode ("kernel": #10's plain version here,
the reference's Pallas kernel in interpret mode; "xla" with a mask; routed;
the dense seed scan) over three metrics, on one graph handed over by
``graph_state_from_jax`` (k-means is not bit-reproducible across devices, so
the beam is compared on carried-over state). Integer-valued corpora make
every euclidean and dot score exact in fp32 in both packages, so ids must be
equal there whatever the summation order, ties included; cosine scores go
through a normalization and are held to rtol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu.index.graph_index as jg
import velesdb_tpu.index.ivf as jivf
from velesdb_tpu.index.params import GraphParams as JParams
from velesdb_tpu.ops import chunked as jch
from velesdb_tpu.ops.distance import DistanceMetric as JMetric
import velesdb_tpu_torch.index.graph_index as tg
import velesdb_tpu_torch.index.ivf as tivf
from velesdb_tpu_torch.index.params import GraphParams
from velesdb_tpu_torch.ops import chunked as tch

METRICS = ["euclidean", "cosine", "dot_product"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for this module: the suite runs several test
    processes side by side, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ints(rng, n, d, lo=-6, hi=6):
    """Integer-valued rows: every product and sum stays exact in fp32."""
    return rng.integers(lo, hi, (n, d)).astype(np.float32)


def _clustered(rng, n, d, c=16, spread=0.15):
    centers = rng.standard_normal((c, d)).astype(np.float32)
    return (centers[rng.integers(0, c, n)] + spread * rng.standard_normal((n, d))).astype(
        np.float32)


def _ivf_arrays(e) -> dict:
    """A reference ``IvfIndex``'s state as ``ivf_state_from_jax`` takes it."""
    keys = ("centroids", "cent_sq", "parts", "part_scale", "part_minv", "part_rows", "part_sq",
            "kmeans_cents")
    out = {k: None if getattr(e, "_" + k) is None else np.asarray(getattr(e, "_" + k))
           for k in keys}
    out.update(n=e.n, c=e.c, c_real=e.c_real, part_len=e.part_len, spill=e.spill,
               storage=e.storage, metric=e.metric, aux=np.asarray(e._kernel_state()[0]))
    return out


def ref_graph_arrays(g) -> dict:
    """A reference ``GraphIndex``'s state as ``graph_state_from_jax`` takes it."""

    def host(a):
        return None if a is None else np.asarray(a)

    return dict(
        dim=g.dim, n=g.n, n_pad=g.n_pad, metric=g.metric, params=g.params,
        corpus=host(g._corpus), adj=host(g._adj), sqnorm=host(g._sqnorm), valid=host(g._valid),
        seed_ids=host(g._seed_ids),
        sq8trav=None if g._sq8trav is None else tuple(np.asarray(t) for t in g._sq8trav),
        route_cents=host(g._route_cents), route_csq=host(g._route_csq),
        route_rows=host(g._route_rows),
        entry_ivf=None if g._entry_ivf is None else _ivf_arrays(g._entry_ivf))


def _cos64(q, rows):
    q = q.astype(np.float64) / np.linalg.norm(q, axis=-1, keepdims=True)
    r = rows.astype(np.float64) / np.linalg.norm(rows, axis=-1, keepdims=True)
    return np.einsum("bd,bkd->bk", q, r)


def _assert_ids_up_to_cosine_ties(x, q, got, want):
    """Cosine ids: equal, except where the two packages' fp32 normalizations
    round a near-tie apart; there the float64 scores of both choices agree."""
    assert np.mean(got == want) >= 0.999
    np.testing.assert_allclose(_cos64(q, x[got]), _cos64(q, x[want]), rtol=0, atol=1e-6)


def _assert_same(jv, ji, tv, ti, metric="euclidean"):
    """Ids equal and values to rtol 1e-5; cosine ids up to near-tie swaps
    (position by position the values still agree to rtol 1e-5)."""
    ji, jv = np.asarray(ji), np.asarray(jv)
    if metric == "cosine":
        assert np.mean(ti.numpy() == ji) >= 0.98
    else:
        np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("higher_is_better", [True, False])
def test_build_select_ties_to_lowest_position(higher_is_better):
    """The build's select (``chunked._best``, ``first_topk`` in the metric's
    orientation) orders by value, then position, as ``lax.top_k`` does:
    ties (-inf, -0.0 against 0.0, repeated values across the k-th) go to
    the smallest position."""
    g = torch.Generator().manual_seed(0)
    for _ in range(60):
        m = int(torch.randint(1, 400, (1,), generator=g))
        k = int(torch.randint(1, m + 1, (1,), generator=g))
        s = torch.randint(-4, 4, (6, m), generator=g).float()
        s[s == 3] = -torch.inf
        s[s == 2] = -0.0
        v, p = tch._best(s, k, higher_is_better)
        key = -s.numpy() if higher_is_better else s.numpy()
        want = np.stack([np.lexsort((np.arange(m), row))[:k] for row in key + 0.0])
        np.testing.assert_array_equal(p.numpy(), want)
        assert torch.equal(v, torch.gather(s, 1, p))


@pytest.mark.parametrize("metric", METRICS)
def test_self_knn_matches_reference(rng, metric):
    x = _ints(rng, 3000, 24)
    valid = rng.random(3000) > 0.1
    want = jch.self_knn(x, 10, JMetric(metric), valid=valid, q_block=512, c_chunk=1024)
    got = tch.self_knn(x, 10, metric, valid=valid, q_block=384, c_chunk=1000, device="cpu")
    if metric == "cosine":
        _assert_ids_up_to_cosine_ties(x, x, got, want)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", METRICS)
def test_chunked_topk_matches_reference(rng, metric):
    x = _ints(rng, 4096, 32)
    q = x[:40] + 1.0
    valid = rng.random(4096) > 0.2
    jv, ji = jch.chunked_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), 12,
                              JMetric(metric), chunk=1024, exclude_self_base=0)
    tv, ti = tch.chunked_topk(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid),
                              12, metric, chunk=700, exclude_self_base=0)
    _assert_same(jv, ji, tv, ti, metric)
    bv, bi = tch.brute_force_topk(q, x, 12, metric, valid=valid, q_block=16, c_chunk=512,
                                  device="cpu")
    rv, ri = jch.brute_force_topk(q, x, 12, JMetric(metric), valid=valid, q_block=16,
                                  c_chunk=1024)
    _assert_same(rv, ri, torch.from_numpy(bv), torch.from_numpy(bi), metric)


@pytest.mark.parametrize("metric", METRICS)
def test_prune_and_assembly_match_reference(rng, metric):
    """Given the reference's kNN, the alpha prune and both assemblies give
    the reference's adjacency exactly (holes, pad rows and the fill hash
    included)."""
    n, k, degree = 2500, 16, 24
    x = _ints(rng, n, 16)
    knn = jch.self_knn(x, k, JMetric(metric), valid=np.ones(n, bool))
    block = 512
    n_pad = -(-n // block) * block
    keep_ref = np.asarray(jg._alpha_prune_scan(
        jnp.pad(jnp.asarray(x), ((0, n_pad - n), (0, 0))),
        jnp.pad(jnp.asarray(knn), ((0, n_pad - n), (0, 0)), constant_values=-1),
        JMetric(metric), 1.2, block))[:n]
    xt = torch.from_numpy(x)
    keep = tg._alpha_prune_block(xt, torch.tensor(knn).long(), xt, tg.DistanceMetric(metric),
                                 1.2)
    if metric == "cosine":  # alpha * cc <= node_d near equality rounds either way
        assert np.mean(keep.numpy() == keep_ref) >= 0.999
    else:
        np.testing.assert_array_equal(keep.numpy(), keep_ref)
    fwd = np.where(keep_ref, knn, -1).astype(np.int32)
    host = tg._assemble_adjacency(fwd, n, degree)
    np.testing.assert_array_equal(host, jg._assemble_adjacency(fwd.copy(), n, degree))
    fwd_p = np.pad(fwd, ((0, 300), (0, 0)), constant_values=-1)
    dev = tg._assemble_adjacency_dev(torch.from_numpy(fwd_p), n=n, degree=degree)
    ref_dev = np.asarray(jg._assemble_adjacency_dev(jnp.asarray(fwd_p), n=n, degree=degree))
    np.testing.assert_array_equal(dev.numpy(), ref_dev)
    assert (dev.numpy()[n:] == -1).all()


def test_fill_hash_wraps_like_uint32():
    """The fill hash in int64 with ``& 0xFFFFFFFF`` equals the reference's
    wrapping uint32 arithmetic, past the first wrap (rows > 1,618)."""
    rows = np.array([0, 1, 1617, 1618, 99_999, 1_000_447, 8_388_607, 2**31 - 1], np.int64)
    cols = np.arange(64, dtype=np.int64)
    for n in (2, 1000, 1_000_000, 8_388_608):
        with np.errstate(over="ignore"):
            want = ((rows[:, None].astype(np.uint32) * np.uint32(2654435761)
                     + cols[None].astype(np.uint32) * np.uint32(40503) + np.uint32(12345))
                    % np.uint32(n)).astype(np.int64)
        want = np.where(want == rows[:, None], (want + 1) % n, want)
        got = tg._fill_hash(torch.from_numpy(rows)[:, None], torch.from_numpy(cols)[None], n)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_build_adjacency_matches_reference(rng, metric):
    """The exact-kNN build (below ``EXACT_KNN_MAX_ROWS``): kNN, prune and
    assembly in both packages give one adjacency, tombstones included."""
    n = 3000
    x = _ints(rng, n, 16)
    valid = rng.random(n) > 0.05
    ref = jg.GraphIndex(16, JMetric(metric), JParams(degree=24, knn_k=12))
    ref.build(x, valid)
    port = tg.GraphIndex(16, metric, GraphParams(degree=24, knn_k=12), device="cpu")
    port.build(x, valid)
    if metric == "cosine":  # near-ties of the normalized scores round either way
        assert np.mean(port._adj.numpy() == np.asarray(ref._adj)) >= 0.995
    else:
        np.testing.assert_array_equal(port._adj.numpy(), np.asarray(ref._adj))
    np.testing.assert_array_equal(port._seed_ids.numpy(), np.asarray(ref._seed_ids))


@pytest.mark.parametrize("storage", ["f32", "sq8"])
@pytest.mark.parametrize("metric", METRICS)
def test_bucketed_knn_on_reference_partitions(rng, metric, storage):
    """The approximate kNN of one set of partitions (the reference's, carried
    over): the port's bucketed select and scatter give the reference's
    neighbours."""
    n = 4000
    x = _ints(rng, n, 16)
    src = x
    if storage == "sq8":
        from velesdb_tpu.ops.quantization import sq8_quantize

        src = sq8_quantize(jnp.asarray(x))
    ref = jivf.IvfIndex(16, JMetric(metric), n_clusters=32)
    ref.build(src, np.ones(n, bool))
    port = tivf.ivf_state_from_jax(_ivf_arrays(ref), "cpu")
    k = 8
    if storage == "f32":
        jv, jn = jivf._bucketed_self_knn(ref._parts, ref._part_rows, ref._part_sq, ref._centroids,
                                        ref._cent_sq, k=k, nprobe=4, metric=JMetric(metric))
        tv, tn = tivf._bucketed_self_knn(port._parts, port._part_rows, port._part_sq,
                                         port._centroids, port._cent_sq, k=k, nprobe=4,
                                         metric=tg.DistanceMetric(metric))
        sv, si = jivf._scatter_knn(jv, jn, ref._part_rows, n=n, k=10, k_eff=k)
        pv, pi = tivf._scatter_knn(tv, tn, port._part_rows, n=n, k=10, k_eff=k)
        got, want = pi.numpy(), np.asarray(si)
    else:
        _, want = jivf._bucketed_self_knn_sq8(
            ref._parts, ref._part_scale, ref._part_minv, ref._part_rows, ref._part_sq,
            ref._centroids, ref._cent_sq, k=k, nprobe=4, metric=JMetric(metric), d=16,
            block_parts=16)
        _, got = tivf._bucketed_self_knn_sq8(
            port._parts, port._part_scale, port._part_minv, port._part_rows, port._part_sq,
            port._centroids, port._cent_sq, k=k, nprobe=4, metric=tg.DistanceMetric(metric),
            d=16, block_parts=16)
    if metric == "cosine" or storage == "sq8":
        # normalized or dequantized scores round differently: ids agree up to
        # near-ties at the k-th place
        assert np.mean(got == np.asarray(want)) >= 0.995
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


def _knn_recall(knn, exact):
    return np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max(1, (b >= 0).sum())
                    for a, b in zip(knn, exact)])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_ivf_self_knn_recall_matches_reference(rng, metric):
    """Each package's own approximate build: kNN recall against the exact
    kNN within 0.01 of the reference's; the router comes back stripped of
    padded partitions, and the device result equals the host one."""
    n = 5_000
    x = _clustered(rng, n, 24, c=16)
    valid = np.ones(n, bool)
    exact = jch.self_knn(x, 16, JMetric(metric), valid=valid)
    want, jr = jivf.ivf_self_knn(x, 16, JMetric(metric), valid=valid, nprobe=6,
                                 return_router=True)
    got, router = tivf.ivf_self_knn(x, 16, metric, valid=valid, nprobe=6, return_router=True,
                                    device="cpu")
    r_ref, r_port = _knn_recall(np.asarray(want), exact), _knn_recall(got, exact)
    assert r_port >= r_ref - 0.01, (r_port, r_ref)
    assert router[0].shape == (router[1].shape[0], 24) and (router[1] >= -1).all()
    assert router[1].max() < n and router[0].shape[0] >= jr[0].shape[0] - 1
    dev = tivf.ivf_self_knn(torch.from_numpy(x), 16, metric, valid=valid, nprobe=6,
                            return_device=True)
    np.testing.assert_array_equal(dev.numpy(), got)
    two = tivf.ivf_self_knn(x, 16, metric, valid=valid, nprobe=6, passes=2, device="cpu")
    assert _knn_recall(two, exact) >= r_port - 0.005
    sq8 = tivf.ivf_self_knn(x, 16, metric, valid=valid, nprobe=6, sq8=True, device="cpu")
    assert _knn_recall(sq8, exact) >= r_port - 0.05


def test_nn_descent_round_matches_reference(rng):
    """One NN-descent round on the same weak kNN: the reference's result
    (exact on integer rows), never below the input's recall."""
    n = 4000
    x = _ints(rng, n, 16)
    valid = rng.random(n) > 0.05
    exact = jch.self_knn(x, 10, JMetric.EUCLIDEAN, valid=valid)
    weak = tivf.ivf_self_knn(x, 10, "euclidean", valid=valid, nprobe=1, device="cpu")
    refined = tivf.nn_descent_round(x, weak, "euclidean", valid=valid, device="cpu")
    want = jivf.nn_descent_round(x, weak, JMetric.EUCLIDEAN, valid=valid)
    np.testing.assert_array_equal(refined, want)
    assert _knn_recall(refined, exact) >= _knn_recall(weak, exact)


def test_expansion_dedup_equals_literal_form():
    """The sort-based dedup of an expansion equals the reference's literal
    ``[B, M, beam]`` pool test and ``[B, M, M]`` first-occurrence sum."""
    g = torch.Generator().manual_seed(1)
    for _ in range(20):
        b, beam, m = 5, 24, 64
        ids = torch.randint(-1, 40, (b, beam), generator=g)
        nbrs = torch.randint(-1, 40, (b, m), generator=g)
        bad0 = (nbrs < 0) | (torch.rand((b, m), generator=g) < 0.2)
        bad = bad0 | torch.any(nbrs[:, :, None] == ids[:, None, :], dim=2)
        eq = nbrs[:, :, None] == nbrs[:, None, :]
        first = torch.sum(torch.tril(eq, -1) & ~bad[:, None, :] & ~bad[:, :, None], dim=2) == 0
        want = bad | ~first
        assert torch.equal(bad0 | tg._expansion_dups(ids, nbrs, bad0), want)
        lit = torch.sum(torch.tril(ids[:, :, None] == ids[:, None, :], -1), dim=2) == 0
        assert torch.equal(tg._first_occurrence(ids), lit)


@pytest.fixture(scope="module")
def graphs():
    """One reference graph per metric (the approximate build, with router,
    entry IVF and SQ8 shadow), its port twin by ``graph_state_from_jax``,
    and queries."""
    rng = np.random.default_rng(5)
    x = _ints(rng, 4500, 32, -4, 4)
    q = x[rng.integers(0, 4500, 16)] + rng.integers(-1, 2, (16, 32)).astype(np.float32)
    valid = rng.random(4500) > 0.03
    old = jg.GraphIndex.EXACT_KNN_MAX_ROWS
    jg.GraphIndex.EXACT_KNN_MAX_ROWS = 2000
    try:
        out = {}
        for metric in METRICS:
            ref = jg.GraphIndex(32, JMetric(metric), JParams(
                degree=24, knn_k=12, entry_probes=8, entry_points=32, quantized_traversal=True))
            ref.build(x, valid)
            assert ref._entry_ivf is not None and ref._route_cents is not None
            out[metric] = (ref, tg.graph_state_from_jax(ref_graph_arrays(ref), "cpu"))
    finally:
        jg.GraphIndex.EXACT_KNN_MAX_ROWS = old
    mask = np.random.default_rng(6).random(out["euclidean"][0].n_pad) < 0.3
    return out, q, mask


#: slots a graph delta leaves out (``exclude``): every 10th, and a run
EXCLUDED = np.r_[np.arange(0, 4500, 10), np.arange(200, 260)]


def _entry_args(g, mode, port, excluded=None):
    if mode in ("routed", "dense"):
        router = None
        if mode == "routed":
            router = (g._route_cents, g._route_csq, g._route_rows)
        return router, None
    e = g._entry_ivf
    if mode == "kernel":
        aux, frows = e._kernel_state()
        if excluded is not None:  # the delta's slots dead in the probe state
            if port:
                aux = e._excluded_state(np.unique(excluded))
            else:
                dead = jnp.isin(e._part_rows, jnp.asarray(excluded))
                aux = aux.at[:, 2, :].set(jnp.where(dead, jnp.inf, aux[:, 2, :]))
        return None, (e._centroids, e._cent_sq, e._parts, aux, frows)
    return None, (e._centroids, e._cent_sq, (e._parts, e._part_scale, e._part_minv),
                  e._part_rows, e._part_sq)


@pytest.mark.parametrize("mode", ["kernel", "xla", "routed", "dense"])
@pytest.mark.parametrize("metric", METRICS)
def test_beam_search_matches_reference(graphs, metric, mode):
    """``beam_search_impl`` on one carried-over graph returns the reference's
    ids and values in each entry mode, for the f32 beam and the quantized
    traversal with its f32 head rerank, with and without a mask (the
    filtered accumulator); "kernel" takes the graph delta's exclusion (its
    slots dead in #10's state, the mask at the accumulator and the final
    selection); on euclidean also capacity mode (no rerank) and two
    restarts (routed and dense entries)."""
    out, q, mask = graphs
    ref, port = out[metric]
    common = dict(k=10, beam=32, expansions=32, degree=24, entry_points=32, expand_width=8,
                  entry_probes=8 if mode in ("kernel", "xla") else 2)
    keep = np.ones(ref.n_pad, bool)
    keep[EXCLUDED] = False
    variants = {"kernel": [("f32", None, 1), ("quant", None, 1), ("f32", keep, 1),
                           ("quant", keep, 1)],
                "xla": [("f32", mask, 1), ("quant", mask, 1)]}.get(
        mode, [("f32", None, 1), ("quant", None, 1), ("f32", mask, 1), ("quant", mask, 1)])
    if metric == "euclidean":
        variants += [("capacity", None, 1)]
        if mode in ("routed", "dense"):
            variants += [("f32", None, 2), ("quant", mask, 2)]
    for corpus, m, restarts in variants:
        runs = []
        excluded = EXCLUDED if m is keep else None
        for g, is_port in ((ref, False), (port, True)):
            quant = corpus != "f32"
            router, state = _entry_args(g, mode, is_port, excluded)
            base = (g._sq8trav if quant else g._corpus, g._adj, g._sqnorm, g._valid, g._seed_ids)
            rer = g._corpus if corpus == "quant" else None
            kw = dict(common, restarts=restarts,
                      entry_mode=mode if mode in ("kernel", "xla") else "legacy")
            if is_port:
                mm = None if m is None else torch.from_numpy(m)
                runs.append(tg.beam_search_impl(torch.from_numpy(q), *base, mm, rer, router,
                                                state, metric=metric, **kw))
            else:
                if mode == "kernel":
                    kw["entry_interpret"] = True
                mm = None if m is None else jnp.asarray(m)
                runs.append(jg.beam_search_impl(jnp.asarray(q), *base, mm, rer, router, state,
                                                metric=JMetric(metric), **kw))
        (jv, ji), (tv, ti) = runs
        if m is not None:
            got = ti.numpy()
            assert m[got[got >= 0]].all()
        _assert_same(jv, ji, tv, ti, metric)


def test_graph_exclude_keeps_the_entry_kernel(graphs, monkeypatch):
    """``GraphIndex.search(exclude=...)``, the graph delta: an unmasked
    search keeps its #10 entry scan (no ``ivf_search_impl``), with the
    excluded slots dead in #10's state and masked at the selection, so it
    returns what ``beam_search_impl`` returns in "kernel" mode on that state,
    and no excluded slot; a masked search folds the exclusion into the mask
    ("xla"). Both agree with the reference's search under the same mask
    (its entry stage takes ``ivf_search_impl``: coarse near-ties may
    differ, the bar of the reference's own kernel-against-xla test)."""
    out, q, mask = graphs
    ref, port = out["euclidean"]
    calls = []
    for name in ("ivf_probe_topk", "ivf_search_impl"):
        real = getattr(tg, name)
        monkeypatch.setattr(tg, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    keep = np.ones(port.n_pad, bool)
    keep[EXCLUDED] = False
    vals, ids = port.search(q, 10, ef=64, exclude=EXCLUDED[::-1])
    assert calls == ["ivf_probe_topk"] and not np.isin(ids.numpy(), EXCLUDED).any()
    beam, expansions = port.params.beam_for_ef(64, 10)
    _, state = _entry_args(port, "kernel", True, EXCLUDED)
    want = tg.beam_search_impl(
        torch.from_numpy(q), port._sq8trav, port._adj, port._sqnorm, port._valid,
        port._seed_ids, torch.from_numpy(keep), port._corpus, None, state, k=10, beam=beam,
        expansions=expansions, degree=port._adj.shape[1],
        entry_points=min(port.params.entry_points, beam), metric="euclidean",
        entry_probes=port.params.entry_probes, entry_mode="kernel",
        expand_width=port.params.expand_width)
    assert torch.equal(ids, want[1]) and torch.equal(vals, want[0])
    _, ref_ids = ref.search(q, 10, ef=64, mask=keep)
    agree = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids.numpy(), np.asarray(ref_ids))])
    assert agree >= 0.95, agree
    calls.clear()
    _, mids = port.search(q, 10, ef=64, mask=mask, exclude=EXCLUDED)
    assert calls == ["ivf_search_impl"]
    _, want_ids = port.search(q, 10, ef=64, mask=mask & keep)
    assert torch.equal(mids, want_ids)


def test_reference_ann_npz_restores_in_the_port(tmp_path, rng, monkeypatch):
    """``ann.npz`` and ``ann.npz.entry.npz`` written by the reference restore
    in the port with no rebuild and no k-means run: one adjacency and router,
    the entry IVF's rows in the same partitions, and the same ids as the
    reference's search (its entry stage takes ``ivf_search_impl`` on the CPU,
    the port's #10's plain version: coarse near-ties may differ, the bar of
    the reference's own kernel-against-xla test)."""
    monkeypatch.setattr(jg.GraphIndex, "EXACT_KNN_MAX_ROWS", 2000)
    x = _clustered(rng, 8000, 32)
    q = _clustered(np.random.default_rng(8), 24, 32)
    valid = np.ones(8000, bool)
    params = JParams(degree=32, knn_k=16, entry_probes=8, entry_points=32)
    ref = jg.GraphIndex(32, JMetric.EUCLIDEAN, params)
    ref.build(x, valid)
    path = str(tmp_path / "ann.npz")
    ref.save(path, version=3)
    monkeypatch.setattr(tivf, "kmeans", lambda *a, **kw: pytest.fail("k-means ran on load"))
    port = tg.GraphIndex(32, "euclidean", GraphParams(**dataclasses.asdict(params)),
                         device="cpu")
    assert not port.load(path, x, valid, version=2)
    assert port.load(path, x, valid, version=3)
    np.testing.assert_array_equal(port._adj.numpy(), np.asarray(ref._adj))
    np.testing.assert_array_equal(port._route_rows.numpy(), np.asarray(ref._route_rows))
    e, re_ = port._entry_ivf, ref._entry_ivf
    assert e is not None and (e.c, e.c_real, e.part_len) == (re_.c, re_.c_real, re_.part_len)
    of = np.full(port.n_pad, -1)
    for p, rows in enumerate(np.asarray(re_._part_rows)):
        of[rows[rows >= 0]] = p
    same = [of[r] == p for p, rows in enumerate(e._part_rows.numpy()) for r in rows[rows >= 0]]
    assert np.mean(same) >= 0.999
    _, want = ref.search(q, 10, ef=64)
    _, got = port.search(q, 10, ef=64)
    agree = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got.numpy(), np.asarray(want))])
    assert agree >= 0.95, agree
    port.save(str(tmp_path / "port.npz"), version=3)
    back = jg.GraphIndex(32, JMetric.EUCLIDEAN, params)
    assert back.load(str(tmp_path / "port.npz"), x, valid, version=3)
    np.testing.assert_array_equal(np.asarray(back._adj), np.asarray(ref._adj))
