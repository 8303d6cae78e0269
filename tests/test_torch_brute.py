"""Parity of the port's exact index with the JAX package's ``BruteForceIndex``.

On the CPU the reference serves its fused exact XLA program; the port serves
``streamed-scan`` below ``BUCKET_MIN_ROWS`` and ``int8-assist-pd`` (through the
CUDA kernel's plain torch version) from 131,072 padded rows. Tolerances:
exact cores give equal ids and values to rtol 1e-5 (fp32, different
summation order); the pd core reaches recall@10 >= 0.99 against the
reference's exact result, with values to rtol 1e-5 on shared ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu.ops.bucket_kernel as jbk
from velesdb_tpu.index.brute import BruteForceIndex as JIndex
from velesdb_tpu.index.brute import pad_rows as j_pad_rows
from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops import StorageMode as JMode
from velesdb_tpu_torch.index.brute import BruteForceIndex as TIndex
from velesdb_tpu_torch.index.brute import pad_rows, state_from_jax

RTOL = 1e-5


def _clustered(rng, n, d, n_clusters=64):
    """The reference benchmark's data model (bench.py:41)."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, n)
    return centers[assign] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


def _indexes(slots, valid, metric):
    d = slots.shape[1]
    j = JIndex(d, JMetric.parse(metric), JMode.FULL)
    j.rebuild(slots, valid)
    t = TIndex(d, metric, device="cpu")
    t.rebuild(slots, valid)
    return j, t


def _search_both(j, t, queries, k, mask=None):
    jv, ji = j.search(queries, k, mask=None if mask is None else np.asarray(mask))
    tv, ti = t.search(queries, k, mask=mask)
    return np.array(jv), np.array(ji), tv.numpy(), ti.numpy()


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


def _values_on_shared(tv, ti, jv, ji):
    for row_v, row_i, ref_v, ref_i in zip(tv, ti, jv, ji):
        ref = dict(zip(ref_i.tolist(), ref_v.tolist()))
        for v, i in zip(row_v, row_i):
            if i in ref:
                assert abs(v - ref[i]) <= RTOL * abs(ref[i]) + RTOL


@pytest.mark.parametrize("n", [0, 1, 1000, 65536, 65537, 1_000_000, 2_000_001])
def test_pad_rows_matches_reference(n):
    assert pad_rows(n) == j_pad_rows(n)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product"])
def test_streamed_scan_matches_reference(metric):
    rng = np.random.default_rng(5)
    slots = rng.standard_normal((4096, 48)).astype(np.float32)
    valid = rng.random(4096) > 0.15  # tombstones
    queries = rng.standard_normal((13, 48)).astype(np.float32)
    j, t = _indexes(slots, valid, metric)
    assert t.serve_engine() == "streamed-scan"
    mask = rng.random(4096) > 0.3
    for m in (None, mask):
        jv, ji, tv, ti = _search_both(j, t, queries, 10, m)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=RTOL)
        dead = ~valid if m is None else ~(valid & m)
        assert not set(ti.ravel().tolist()) & set(np.flatnonzero(dead))


@pytest.fixture(scope="module")
def big():
    rng = np.random.default_rng(21)
    slots = _clustered(rng, 131_072 + 64, 32)
    return slots[:131_072], slots[131_072:]


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_pd_core_recall_vs_reference(big, metric):
    slots, queries = big
    valid = np.ones(slots.shape[0], bool)
    valid[::97] = False
    j, t = _indexes(slots, valid, metric)
    assert t.n_pad == 131_072
    assert t.serve_engine() == "int8-assist-pd"
    assert t._pd_ptile is not None  # built at rebuild time, not first search
    jv, ji, tv, ti = _search_both(j, t, queries, 10)
    assert _recall(ti, ji) >= 0.99
    _values_on_shared(tv, ti, jv, ji)
    assert not set(ti.ravel().tolist()) & set(np.flatnonzero(~valid))
    # one filtered search: half the rows pass
    mask = np.arange(slots.shape[0]) % 2 == 0
    jv, ji, tv, ti = _search_both(j, t, queries, 10, mask)
    assert not set(ti.ravel().tolist()) & set(np.flatnonzero(~(mask & valid)))
    assert _recall(ti, ji) >= 0.99
    _values_on_shared(tv, ti, jv, ji)


def test_state_from_jax_serves_identical_shadow(big):
    """The reference index's padded arrays plus its pd shadow, handed over
    with ``state_from_jax``, serve the same results as the port's own build."""
    slots, queries = big
    valid = np.ones(slots.shape[0], bool)
    j, t = _indexes(slots, valid, "euclidean")
    pd = jbk.sq8pd_build(j._full, j._valid, 32, JMetric.EUCLIDEAN)
    names = ("rows_pd", "pen_int", "pen_f32", "sdim", "mid")
    arrays = {k: np.array(v) for k, v in zip(names, pd[:5])}
    arrays.update(
        qu=pd[5], full=np.array(j._full), valid=np.array(j._valid),
        full_sqnorm=np.array(j._full_sqnorm), bucket_pen=np.array(j._bucket_pen),
    )
    h = TIndex(32, "euclidean", device="cpu")
    h.load_state(state_from_jax(arrays, "cpu"))
    assert h.serve_engine() == "int8-assist-pd"
    hv, hi = h.search(queries, 10)
    tv, ti = t.search(queries, 10)
    jv, ji = j.search(queries, 10)
    assert _recall(hi.numpy(), np.array(ji)) >= 0.99
    assert (hi == ti).float().mean() >= 0.99
    torch.testing.assert_close(hv, tv, rtol=RTOL, atol=RTOL)


def test_cosine_pd_raw_queries_reference_fault(big):
    """Raw cosine queries through both packages' pd cores.

    The reference's ``sq8pd_rerank_topk`` quantizes the caller's queries with
    a step calibrated on the pre-normalized corpus, so a query of norm >> 1
    clips at +-127 in every dimension and the coarse pass loses most of the
    true top-k. Given the same queries normalized, the reference keeps its
    recall, so the loss is that clipping alone. The port normalizes cosine
    queries before the coarse pass (ROADMAP.md, faults of the reference)."""
    slots, queries = big
    valid = np.ones(slots.shape[0], bool)
    j, t = _indexes(slots, valid, "cosine")
    assert t.serve_engine() == "int8-assist-pd"
    assert np.linalg.norm(queries, axis=1).min() > 5.0  # raw, norm >> 1
    truth = np.array(j.search(queries, 10)[1])  # the reference's exact result
    rows_pd, pen_int, _, sdim, _, qu = jbk.sq8pd_build(j._full, j._valid, 32, JMetric.COSINE)
    chunk = t._pd_chunk
    ptile = jbk.sq8pd_ptile(pen_int, chunk)

    def reference_pd(q):
        _, ids = jbk.sq8pd_rerank_topk(
            jnp.asarray(q), rows_pd, ptile, sdim, qu, j._full, k=10, m=16,
            metric=JMetric.COSINE, chunk=chunk, dim=32, interpret=True,
        )
        return np.array(ids)

    raw = _recall(reference_pd(queries), truth)
    normed = _recall(
        reference_pd(queries / np.linalg.norm(queries, axis=1, keepdims=True)), truth
    )
    port = _recall(t.search(queries, 10)[1].numpy(), truth)
    assert raw < 0.5, raw
    assert normed >= 0.99, normed
    assert port >= 0.99, port


def test_unported_storage_and_metric_raise():
    for mode in ("sq8", "binary", "f16", "bf16"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TIndex(16, "cosine", mode, device="cpu")
    for metric in ("hamming", "jaccard"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TIndex(16, metric, device="cpu")
