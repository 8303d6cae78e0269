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
