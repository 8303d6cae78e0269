"""Parity of the port's streamed exact scan with the JAX package's.

``velesdb_tpu_torch.ops.streamed.streamed_topk`` against
``velesdb_tpu.ops.streamed.streamed_topk(approx=False)`` on the same seeded
numpy inputs: ids equal, values to rtol 1e-5 (fp32 on both sides, different
summation order), with a validity mask, ``k > n``, and an ``n`` that no
chunk divides.
"""

import numpy as np
import pytest
import torch

from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops.streamed import streamed_topk as j_streamed
from velesdb_tpu_torch.ops.streamed import _pick_chunk, streamed_topk as t_streamed

METRICS = ["cosine", "euclidean", "dot_product"]
RTOL = 1e-5


def _run_both(corpus, queries, valid, k, metric, chunk):
    jv, ji = j_streamed(
        queries, corpus, valid=valid, k=k, metric=JMetric.parse(metric),
        chunk=chunk, approx=False,
    )
    tv, ti = t_streamed(
        torch.from_numpy(queries), torch.from_numpy(corpus),
        valid=None if valid is None else torch.from_numpy(valid),
        k=k, metric=metric, chunk=chunk,
    )
    return np.array(jv), np.array(ji), tv.numpy(), ti.numpy()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize(
    "n,k,chunk,masked",
    [
        (4096, 10, 1024, True),  # chunked, 15% invalid rows
        (3000, 10, 1024, False),  # no multiple of 1024 divides 3000: padded
        (50, 64, 1024, True),  # k > n: clamped, empties past the valid rows
    ],
)
def test_streamed_topk_parity(metric, n, k, chunk, masked):
    rng = np.random.default_rng(n)
    corpus = rng.standard_normal((n, 48)).astype(np.float32)
    queries = rng.standard_normal((13, 48)).astype(np.float32)
    valid = (rng.random(n) > 0.15) if masked else None
    jv, ji, tv, ti = _run_both(corpus, queries, valid, k, metric, chunk)
    assert tv.shape == jv.shape == (13, min(k, n))
    np.testing.assert_array_equal(ti, ji)
    filled = ji >= 0
    np.testing.assert_allclose(tv[filled], jv[filled], rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(tv[~filled], jv[~filled])
    if valid is not None:
        assert not set(ti[filled].ravel().tolist()) & set(np.flatnonzero(~valid))


def test_pick_chunk_matches_reference():
    from velesdb_tpu.ops.streamed import _pick_chunk as j_pick

    for n in (1024, 3000, 106496, 131072, 1_048_576):
        assert _pick_chunk(n, 65536) == j_pick(n, 65536)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n,chunk,masked", [(4096, 1024, True), (3000, 1024, False)])
def test_sq8_streamed_topk_against_dequantized_oracle(metric, n, chunk, masked):
    """The SQ8 scan without a dequantized copy ranks exactly as a float64
    scan of the dequantized rows against the bf16-rounded queries it scores
    with (``sum(q)`` from the unrounded ones, as in the reference): ids
    equal except at ties under 1e-5, values to rtol 1e-5."""
    from velesdb_tpu_torch.ops.quantization import sq8_dequantize, sq8_quantize
    from velesdb_tpu_torch.ops.streamed import sq8_streamed_topk

    rng = np.random.default_rng(n + 1)
    corpus = rng.standard_normal((n, 48)).astype(np.float32)
    queries = rng.standard_normal((13, 48)).astype(np.float32)
    valid = (rng.random(n) > 0.15) if masked else np.ones(n, bool)
    sq = sq8_quantize(torch.from_numpy(corpus))
    tv, ti = sq8_streamed_topk(
        torch.from_numpy(queries), sq, valid=torch.from_numpy(valid), k=10,
        metric=metric, chunk=chunk,
    )
    deq = sq8_dequantize(sq).double().numpy()
    codes = sq.codes.double().numpy()
    scale, minv = sq.scale.double().numpy(), sq.minv.double().numpy()
    q = torch.from_numpy(queries)
    if metric == "cosine":
        q = q / q.norm(dim=1, keepdim=True)
    qb = q.to(torch.bfloat16).double().numpy()
    q = q.double().numpy()
    dots = (qb @ codes.T) * scale[None, :] + q.sum(1)[:, None] * minv[None, :]
    dn = (deq ** 2).sum(1)
    if metric == "euclidean":
        s = -np.sqrt(np.maximum((q * q).sum(1)[:, None] + dn[None, :] - 2.0 * dots, 0.0))
    elif metric == "cosine":
        s = dots / np.sqrt(dn)[None, :]
    else:
        s = dots
    s = np.where(valid[None, :], s, -np.inf)
    want_i = np.argsort(-s, axis=1, kind="stable")[:, :10]
    want_v = np.take_along_axis(s, want_i, 1)
    if metric == "euclidean":
        want_v = -want_v
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, want_v, rtol=1e-5, atol=1e-5)
    differ = ti != want_i
    assert np.all(np.abs(tv[differ] - want_v[differ]) <= 1e-5 * np.abs(want_v[differ]) + 1e-5)
    assert not set(ti.ravel().tolist()) & set(np.flatnonzero(~valid))


def _gap_ok(tv, ti, jv, ji):
    """Ids equal wherever the score gap to the next rank exceeds rtol 1e-5."""
    for row_v, row_i, ref_v, ref_i in zip(tv, ti, jv, ji):
        for j in range(len(ref_i)):
            if row_i[j] == ref_i[j]:
                continue
            near = [ref_v[i] for i in (j - 1, j + 1) if 0 <= i < len(ref_v)]
            tol = RTOL * abs(ref_v[j]) + RTOL
            assert any(abs(ref_v[j] - x) <= tol for x in near), (j, row_i, ref_i)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", [True, False])
def test_sq8_streamed_matches_reference(metric, masked):
    """The port's SQ8 scan against the JAX package's ``sq8_streamed_topk``
    (``approx=False``) on the same codes: values to rtol 1e-5, ids equal
    wherever the gap to the next score exceeds that."""
    import jax.numpy as jnp

    from velesdb_tpu.ops.quantization import sq8_quantize as j_quantize
    from velesdb_tpu.ops.streamed import sq8_streamed_topk as j_sq8
    from velesdb_tpu_torch.ops.quantization import SQ8Vectors
    from velesdb_tpu_torch.ops.streamed import sq8_streamed_topk

    rng = np.random.default_rng(31 + masked)
    n = 4096
    corpus = rng.standard_normal((n, 48)).astype(np.float32)
    queries = (rng.standard_normal((13, 48)) * 3.0).astype(np.float32)
    valid = (rng.random(n) > 0.15) if masked else None
    jsq = j_quantize(jnp.asarray(corpus))
    jv, ji = j_sq8(queries, jsq, valid=valid, k=10, metric=JMetric.parse(metric),
                   chunk=1024, approx=False)
    tsq = SQ8Vectors(*(torch.from_numpy(np.array(a)) for a in jsq))
    tv, ti = sq8_streamed_topk(
        torch.from_numpy(queries), tsq, valid=None if valid is None else torch.from_numpy(valid),
        k=10, metric=metric, chunk=1024,
    )
    jv, ji, tv, ti = np.array(jv), np.array(ji), tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=RTOL)
    _gap_ok(tv, ti, jv, ji)
