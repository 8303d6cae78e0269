"""Parity of the port's ``fused_topk`` (kernel #8) with the JAX package's.

The five ``fused_topk`` tests of the reference (``tests/test_pallas.py:28-82``)
run against the port, through the CUDA kernel's plain torch version, and
each also against the JAX op (interpret mode) on the same numpy inputs. Both
are exact: ids equal except where the next score is within rtol 1e-5 (the
packages sum each dot in another order), values to the reference test's
rtol 1e-4 against its oracle and 1e-5 against the JAX op. Half corpora (f16,
bf16) are upcast to f32 in both. ``k`` above ``MAX_K`` raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velesdb_tpu.ops import DistanceMetric, pairwise_scores
from velesdb_tpu.ops.pallas_kernels import fused_topk as j_fused
from velesdb_tpu_torch.ops import pallas_kernels as tpk

METRICS = [DistanceMetric.COSINE, DistanceMetric.DOT_PRODUCT, DistanceMetric.EUCLIDEAN]


def _reference(q, c, k, metric, valid=None):
    s = np.asarray(pairwise_scores(q, c, metric))
    if valid is not None:
        s = np.where(np.asarray(valid)[None, :], s,
                     -np.inf if metric.higher_is_better else np.inf)
    order = (np.argsort(-s, axis=1) if metric.higher_is_better else np.argsort(s, axis=1))[:, :k]
    return np.take_along_axis(s, order, axis=1), order


def _port(q, c, valid=None, **kw):
    v, i = tpk.fused_topk(torch.from_numpy(q), torch.from_numpy(c),
                          valid=None if valid is None else torch.from_numpy(valid), **kw)
    return v.numpy(), i.numpy()


def _against_jax(q, c, valid=None, **kw):
    jv, ji = j_fused(q, c, valid=valid, interpret=True, **kw)
    tv, ti = _port(q, c, valid, **{k: (v.value if k == "metric" else v) for k, v in kw.items()})
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    for rv, ri, wv, wi in zip(tv, ti, jv, ji):
        for j in np.flatnonzero(ri != wi):
            tol = 1e-5 * abs(wv[j]) + 1e-5
            assert any(abs(wv[j] - wv[i]) <= tol for i in (j - 1, j + 1) if 0 <= i < len(wv))
    return tv, ti


@pytest.mark.parametrize("metric", METRICS)
def test_fused_topk_matches_reference(rng, metric):
    b, n, d, k = 16, 1000, 96, 10
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    vals, idx = _against_jax(q, c, k=k, metric=metric, chunk=256)
    ref_v, ref_i = _reference(q, c, k, metric)
    assert np.array_equal(idx, ref_i), metric
    np.testing.assert_allclose(vals, ref_v, rtol=1e-4, atol=1e-4)


def test_fused_topk_masked(rng):
    b, n, d, k = 4, 500, 32, 8
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    valid = rng.random(n) < 0.4
    _, idx = _against_jax(q, c, valid=valid, k=k, metric=DistanceMetric.COSINE, chunk=256)
    assert valid[idx[idx >= 0]].all()
    _, ref_i = _reference(q, c, k, DistanceMetric.COSINE, valid=valid)
    assert np.array_equal(idx, ref_i)


def test_fused_topk_k_exceeds_valid_rows(rng):
    q = rng.standard_normal((2, 16)).astype(np.float32)
    c = rng.standard_normal((20, 16)).astype(np.float32)
    valid = np.zeros(20, bool)
    valid[[3, 7]] = True
    vals, idx = _against_jax(q, c, valid=valid, k=5, metric=DistanceMetric.DOT_PRODUCT)
    assert set(idx[0][idx[0] >= 0]) == {3, 7}
    assert (vals[idx < 0] == -np.inf).all()
    # k beyond N: the extra slots are empty, as in the reference
    vals, idx = _against_jax(q, c, valid=valid, k=30, metric=DistanceMetric.EUCLIDEAN)
    assert (idx[:, 2:] == -1).all() and (vals[:, 2:] == np.inf).all()


def test_fused_topk_duplicate_scores_unique_indices(rng):
    # ties must not yield duplicated indices; they go to the smallest rows
    c = np.zeros((64, 8), np.float32)
    c[:, 0] = 1.0  # every row identical
    q = np.ones((1, 8), np.float32)
    _, idx = _against_jax(q, c, k=10, metric=DistanceMetric.DOT_PRODUCT, chunk=128)
    assert idx[0].tolist() == list(range(10))


def test_fused_topk_unaligned_shapes(rng):
    # b=3, d=100 (pad to 128), n=777
    q = rng.standard_normal((3, 100)).astype(np.float32)
    c = rng.standard_normal((777, 100)).astype(np.float32)
    vals, idx = _against_jax(q, c, k=7, metric=DistanceMetric.EUCLIDEAN, chunk=256)
    ref_v, ref_i = _reference(q, c, 7, DistanceMetric.EUCLIDEAN)
    assert np.array_equal(idx, ref_i)
    np.testing.assert_allclose(vals, ref_v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["f16", "bf16"])
@pytest.mark.parametrize("metric", METRICS)
def test_fused_topk_half_corpus(rng, dtype, metric):
    """f16/bf16 rows upcast to f32 per chunk in the reference; the port
    upcasts the same values."""
    jdt, tdt = {"f16": (jnp.float16, torch.float16), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    q = rng.standard_normal((9, 64)).astype(np.float32)
    c32 = rng.standard_normal((3000, 64)).astype(np.float32)
    valid = rng.random(3000) > 0.2
    jv, ji = j_fused(q, jnp.asarray(c32).astype(jdt), valid=valid, k=10, metric=metric,
                     interpret=True)
    tv, ti = tpk.fused_topk(torch.from_numpy(q), torch.from_numpy(c32).to(tdt),
                            valid=torch.from_numpy(valid), k=10, metric=metric.value)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


def test_fused_topk_k_cap_and_chunk():
    q = torch.ones((1, 8))
    c = torch.randn(2048, 8, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="1024"):
        tpk.fused_topk(q, c, k=tpk.MAX_K + 1)
    a = tpk.fused_topk(q, c, k=tpk.MAX_K, chunk=256)
    b = tpk.fused_topk(q, c, k=tpk.MAX_K)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])  # chunk changes nothing
    from velesdb_tpu.ops.pallas_kernels import fit_chunk as j_fit

    for args in ((256, 768, 10), (16, 128, 100, 2, 5000), (1024, 96, 1000, 4)):
        assert tpk.fit_chunk(*args) == j_fit(*args)
