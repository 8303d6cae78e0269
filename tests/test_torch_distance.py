"""Parity of the PyTorch port's distance and top-k ops with the JAX package.

The same numpy inputs (seeded) go through ``velesdb_tpu.ops`` and
``velesdb_tpu_torch.ops`` on the CPU. Scores agree to rtol 1e-5 (both fp32,
different summation order); the empty-slot conventions agree exactly.
"""

import numpy as np
import pytest
import torch

import velesdb_tpu.ops as jops
import velesdb_tpu_torch.ops as tops

ALL_METRICS = ["cosine", "euclidean", "dot_product", "hamming", "jaccard"]
RTOL = 1e-5  # fp32 on both sides, different summation order


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    corpus = rng.standard_normal((300, 40)).astype(np.float32)
    corpus[7] = 0.0  # a zero vector: normalizes to zero, not NaN
    queries = rng.standard_normal((9, 40)).astype(np.float32)
    return corpus, queries


@pytest.mark.parametrize(
    "name", ["cosine", "euclidean", "l2", "dot", "ip", "dot_product", "hamming", "jaccard"]
)
def test_metric_enum_parity(name):
    jm = jops.DistanceMetric.parse(name)
    tm = tops.DistanceMetric.parse(name)
    assert jm.value == tm.value
    assert jm.higher_is_better == tm.higher_is_better
    assert jm.worst_score == tm.worst_score
    assert tops.StorageMode.parse("FULL").value == jops.StorageMode.parse("FULL").value


@pytest.mark.parametrize("metric", ALL_METRICS)
def test_pairwise_scores_parity(data, metric):
    corpus, queries = data
    j = np.asarray(jops.pairwise_scores(queries, corpus, jops.DistanceMetric.parse(metric)))
    t = tops.pairwise_scores(
        torch.from_numpy(queries), torch.from_numpy(corpus), metric
    ).numpy()
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL)


def test_normalize_parity(data):
    corpus, _ = data
    j = np.asarray(jops.normalize(corpus))
    t = tops.normalize(torch.from_numpy(corpus)).numpy()
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-7)
    assert np.all(t[7] == 0.0)


@pytest.mark.parametrize("higher", [True, False])
def test_top_k_parity_and_empty_slots(data, higher):
    corpus, queries = data
    scores = np.array(
        jops.pairwise_scores(queries, corpus, jops.DistanceMetric.DOT_PRODUCT)
    )
    mask = np.zeros(corpus.shape[0], bool)
    mask[::60] = True  # 5 valid entries, k = 8: three empty slots per row
    jv, ji = jops.top_k(scores, 8, higher_is_better=higher, mask=mask[None, :])
    tv, ti = tops.top_k(
        torch.from_numpy(scores), 8, higher_is_better=higher,
        mask=torch.from_numpy(mask)[None, :],
    )
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(tv, jv)  # same scores in: values exact
    filled = np.isfinite(jv)
    assert filled.sum(axis=1).tolist() == [5] * queries.shape[0]
    np.testing.assert_array_equal(ti[filled], ji[filled])
    assert np.all(ti[~filled] == -1)
    assert np.all(tv[~filled] == (-np.inf if higher else np.inf))


def test_merge_top_k_parity(data):
    corpus, queries = data
    scores = np.array(
        jops.pairwise_scores(queries, corpus, jops.DistanceMetric.EUCLIDEAN)
    )
    vals = scores[:, :240].reshape(queries.shape[0], 4, 60)
    ids = np.broadcast_to(np.arange(240).reshape(4, 60), vals.shape).copy()
    jv, ji = jops.merge_top_k(vals, ids, 10, higher_is_better=False)
    tv, ti = tops.merge_top_k(torch.from_numpy(vals), torch.from_numpy(ids), 10,
                              higher_is_better=False)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
