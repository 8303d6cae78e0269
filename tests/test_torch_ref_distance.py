"""Unit tests for distance ops vs NumPy ground truth.

Mirrors the reference's co-located SIMD tests (``simd_explicit.rs`` tests,
``simd_avx512_tests.rs``) — every metric validated against a scalar reference.

The reference's ``tests/test_distance.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made. The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""

import numpy as np
import pytest
import torch

from velesdb_tpu_torch.ops import (
    DistanceMetric,
    pairwise_hamming_packed,
    pairwise_scores,
    score_one,
    binary_quantize,
    top_k,
    merge_top_k,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np_scores(q, c, metric):
    out = np.zeros((q.shape[0], c.shape[0]), np.float32)
    for i, a in enumerate(q):
        for j, b in enumerate(c):
            if metric == DistanceMetric.DOT_PRODUCT:
                out[i, j] = a @ b
            elif metric == DistanceMetric.COSINE:
                na, nb = np.linalg.norm(a), np.linalg.norm(b)
                out[i, j] = 0.0 if na == 0 or nb == 0 else (a @ b) / (na * nb)
            elif metric == DistanceMetric.EUCLIDEAN:
                out[i, j] = np.linalg.norm(a - b)
            elif metric == DistanceMetric.HAMMING:
                out[i, j] = np.sum((a > 0.5) != (b > 0.5))
            elif metric == DistanceMetric.JACCARD:
                am, bm = a > 0.5, b > 0.5
                union = np.sum(am | bm)
                out[i, j] = 1.0 if union == 0 else np.sum(am & bm) / union
    return out


@pytest.mark.parametrize("metric", list(DistanceMetric))
@pytest.mark.parametrize("dim", [8, 128, 768, 100])
def test_pairwise_matches_numpy(rng, metric, dim):
    q = rng.standard_normal((4, dim)).astype(np.float32)
    c = rng.standard_normal((16, dim)).astype(np.float32)
    if metric in (DistanceMetric.HAMMING, DistanceMetric.JACCARD):
        q = (q > 0).astype(np.float32)
        c = (c > 0).astype(np.float32)
    got = np.asarray(pairwise_scores(q, c, metric))
    want = np_scores(q, c, metric)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_zero_vector_cosine_is_zero():
    a = np.zeros((1, 16), np.float32)
    b = np.ones((1, 16), np.float32)
    assert float(pairwise_scores(a, b, DistanceMetric.COSINE)[0, 0]) == 0.0


def test_jaccard_empty_sets_is_one():
    a = np.zeros((1, 32), np.float32)
    assert score_one(a[0], a[0], "jaccard") == 1.0


def test_score_one_parity(rng):
    a = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    assert abs(score_one(a, b, "dot") - float(a @ b)) < 1e-3
    assert abs(score_one(a, b, "l2") - float(np.linalg.norm(a - b))) < 1e-3


def test_higher_is_better_flags():
    assert DistanceMetric.COSINE.higher_is_better
    assert DistanceMetric.DOT_PRODUCT.higher_is_better
    assert DistanceMetric.JACCARD.higher_is_better
    assert not DistanceMetric.EUCLIDEAN.higher_is_better
    assert not DistanceMetric.HAMMING.higher_is_better


def test_packed_hamming_matches_float(rng):
    dim = 100  # non-multiple of 32 exercises padding
    a = (rng.standard_normal((3, dim)) > 0).astype(np.float32)
    b = (rng.standard_normal((7, dim)) > 0).astype(np.float32)
    pa = binary_quantize(a, threshold_half=True)
    pb = binary_quantize(b, threshold_half=True)
    got = np.asarray(pairwise_hamming_packed(pa, pb))
    want = np_scores(a, b, DistanceMetric.HAMMING)
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_top_k_with_mask(rng):
    scores = rng.standard_normal((2, 50)).astype(np.float32)
    mask = np.ones(50, bool)
    mask[:25] = False
    vals, idx = top_k(scores, 5, higher_is_better=True, mask=mask[None, :])
    assert np.asarray(idx).min() >= 25
    # lower-is-better returns original (non-negated) values, ascending
    vals2, idx2 = top_k(scores, 5, higher_is_better=False)
    row = np.sort(scores[0])[:5]
    np.testing.assert_allclose(np.asarray(vals2)[0], row, rtol=1e-6)


def test_merge_top_k(rng):
    # two shards of partial top-k -> global top-k
    v = rng.standard_normal((2, 2, 4)).astype(np.float32)  # [B, S, K]
    i = rng.integers(0, 1000, size=(2, 2, 4))
    vals, idx = merge_top_k(v, i, k=3, higher_is_better=True)
    flat_v = v.reshape(2, -1)
    flat_i = i.reshape(2, -1)
    for b in range(2):
        order = np.argsort(-flat_v[b])[:3]
        np.testing.assert_allclose(np.asarray(vals)[b], flat_v[b][order], rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(idx)[b], flat_i[b][order])
