"""Quantization tests vs NumPy reference (mirrors ``quantization.rs`` tests).

The reference's ``tests/test_quantization.py`` held against the port: each test
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
    binary_quantize,
    binary_unpack,
    hamming_similarity,
    pairwise_hamming_packed,
    pairwise_scores,
    sq8_dequantize,
    sq8_dot_scores,
    sq8_quantize,
)
from velesdb_tpu_torch.ops.quantization import numpy_sq8_roundtrip


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sq8_roundtrip_error_small(rng):
    x = rng.standard_normal((32, 768)).astype(np.float32)
    q = sq8_quantize(x)
    deq = np.asarray(sq8_dequantize(q))
    # max error is half a quantization step = range / 510
    step = (x.max(axis=-1) - x.min(axis=-1)) / 255.0
    assert np.all(np.abs(deq - x).max(axis=-1) <= step * 0.51 + 1e-6)
    np.testing.assert_allclose(deq, numpy_sq8_roundtrip(x), rtol=1e-5, atol=1e-5)


def test_sq8_constant_vector(rng):
    x = np.full((2, 64), 3.25, np.float32)
    deq = np.asarray(sq8_dequantize(sq8_quantize(x)))
    np.testing.assert_allclose(deq, x, atol=1e-6)


def test_sq8_dot_scores_close_to_f32(rng):
    x = rng.standard_normal((128, 256)).astype(np.float32)
    q = rng.standard_normal((4, 256)).astype(np.float32)
    sq = sq8_quantize(x)
    got = np.asarray(sq8_dot_scores(q, sq))
    exact = np.asarray(pairwise_scores(q, x, DistanceMetric.DOT_PRODUCT))
    # SQ8 + bf16 matmul: relative error well under 1%
    denom = np.abs(exact).max()
    assert np.abs(got - exact).max() / denom < 0.02


def test_sq8_recall_preserved(rng):
    """SQ8 top-10 overlaps f32 top-10 >= 80% (ref claims ~0.5-1% recall loss)."""
    x = rng.standard_normal((2000, 128)).astype(np.float32)
    q = rng.standard_normal((8, 128)).astype(np.float32)
    sq = sq8_quantize(x)
    approx = np.asarray(sq8_dot_scores(q, sq))
    exact = np.asarray(pairwise_scores(q, x, DistanceMetric.DOT_PRODUCT))
    overlap = 0
    for b in range(8):
        a10 = set(np.argsort(-approx[b])[:10].tolist())
        e10 = set(np.argsort(-exact[b])[:10].tolist())
        overlap += len(a10 & e10)
    assert overlap / 80 >= 0.8


def test_binary_pack_unpack_roundtrip(rng):
    for dim in (32, 100, 768):
        x = rng.standard_normal((5, dim)).astype(np.float32)
        packed = binary_quantize(x)
        assert packed.shape == (5, (dim + 31) // 32)
        bits = np.asarray(binary_unpack(packed, dim))
        np.testing.assert_array_equal(bits, (x >= 0).astype(np.float32))


def test_binary_hamming_and_similarity(rng):
    dim = 768
    x = rng.standard_normal((50, dim)).astype(np.float32)
    packed = binary_quantize(x)
    d = pairwise_hamming_packed(packed[:1], packed)
    assert int(np.asarray(d)[0, 0]) == 0
    sim = np.asarray(hamming_similarity(d, dim))
    assert sim[0, 0] == 1.0
    assert np.all((sim >= -1e-6) & (sim <= 1.0 + 1e-6))
