"""Parity of the port's quantizers with the JAX package's.

``velesdb_tpu_torch.ops.quantization`` against ``velesdb_tpu.ops.quantization``
on the same seeded numpy inputs, on the CPU: SQ8 codes, scales and minima are
bit-equal, binary words are bit-equal (the port's int32 words hold the
reference's uint32 bits), and unpacking returns the sign bits exactly.
"""

import numpy as np
import pytest
import torch

from velesdb_tpu.ops import quantization as jq
from velesdb_tpu_torch.ops import quantization as tq


def _data(n, d, seed):
    x = (np.random.default_rng(seed).standard_normal((n, d)) * 3.0).astype(np.float32)
    x[0] = 0.0  # zero range: scale 1
    x[1] = 1.5  # constant row
    x[2, : d // 2] = -0.0
    return x


@pytest.mark.parametrize("n,d", [(5000, 100), (3000, 128), (100, 768), (7, 3)])
def test_sq8_quantize_bit_equal(n, d):
    x = _data(n, d, n + d)
    j = jq.sq8_quantize(x)
    t = tq.sq8_quantize(torch.from_numpy(x))
    assert t.codes.dtype == torch.uint8
    np.testing.assert_array_equal(t.codes.numpy(), np.array(j.codes))
    np.testing.assert_array_equal(t.scale.numpy(), np.array(j.scale))
    np.testing.assert_array_equal(t.minv.numpy(), np.array(j.minv))


def test_sq8_dequantize_matches_reference():
    x = _data(2000, 48, 3)
    t = tq.sq8_quantize(torch.from_numpy(x))
    got = tq.sq8_dequantize(t).numpy()
    want = np.array(jq.sq8_dequantize(jq.sq8_quantize(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # round trip within half a step of the row's range
    step = (x.max(1) - x.min(1)) / 255.0
    assert np.all(np.abs(got - x) <= 0.5 * step[:, None] + 1e-5)


@pytest.mark.parametrize("d", [1, 31, 32, 33, 100, 768])
def test_binary_quantize_bit_equal(d):
    x = _data(300, d, d)
    j = np.array(jq.binary_quantize(x))
    t = tq.binary_quantize(torch.from_numpy(x))
    assert t.dtype == torch.int32 and t.shape == (300, tq.packed_words(d))
    np.testing.assert_array_equal(t.numpy().view(np.uint32), j)
    assert tq.packed_words(d) == jq.packed_words(d)


@pytest.mark.parametrize("d", [32, 100, 768])
def test_binary_unpack_roundtrip(d):
    x = _data(50, d, 7 * d)
    packed = tq.binary_quantize(torch.from_numpy(x))
    bits = tq.binary_unpack(packed, d).numpy()
    np.testing.assert_array_equal(bits, (x >= 0).astype(np.float32))
    np.testing.assert_array_equal(
        bits, np.array(jq.binary_unpack(np.array(jq.binary_quantize(x)), d))
    )
