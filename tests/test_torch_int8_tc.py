"""The int8 tensor-core scans (#7 with #12's epilogues, #5 and #1) at the
edges of their kernel's tiling, on the CPU: the port's plain versions against
the JAX package's Pallas kernels, and the int32 headroom the kernel relies on.

- ``sq8i_bucket_ref`` against ``_sq8i_kernel`` and ``hamming_mxu_ref``
  against ``_hamming_mxu_kernel`` (``velesdb_tpu/ops/bucket_kernel.py``),
  both run through ``pl.pallas_call`` in interpret mode as the JAX package's
  own tests run them, on the same seeded inputs: B_pad 24 (a ragged query
  tile on the card), D 48 (a zero-filled half K step), chunk 128 (one slice
  a bucket) and 1,024, a bucket lane whose every slice holds the same row
  (ties go to the smallest slice), and a chunk whose rows are all knocked
  out (``pen = +inf``: ``-inf`` buckets return slice 0; #5: ``aux + 2^20``).
  ``(gm, gi)`` are compared exactly: the dot is an exact int32 in both, and
  each epilogue rounds the same fp32 sums in the same order. XLA on the CPU
  contracts #7's products into FMAs (``fma(doti, scale, sqi am)``, then
  ``fma(-invqs, pen, t)``), where the port rounds each product as PyTorch
  and the CUDA kernel do; so #7's per-row and per-query values carry few
  significant bits, every product is exact in fp32, and the contraction
  cannot change a rounding.
- ``sq8pd_bucket_gm_ref`` against ``_sq8pd_kernel`` (#1, int32 ``gm``
  alone) at chunk 128 / 2,048 / 8,192, B_pad 8 / 24 / 136 and D_pad 16 / 48
  / 112 / 512, with knocked-out rows at ``_pd_invalid_pen``'s limit, a
  knocked-out chunk, the most negative dot on a knocked-out row and a bucket
  lane whose slices hold one row (the slice bits decide), compared exactly.
- The int32 headroom stated in ``csrc/sq8i_bucket.cu``: at #7's cap
  (D_pad 12,288) the largest |dot| of ``code - 128`` rows and [-127, 127]
  queries stays below 2^31, at #5's cap (6,144) every score is exact in
  fp32, and at #1's (512) every encoded score, the invalid penalty's
  included, fits int32 with no wrap; the caps in the source are the
  wrappers'.

The CUDA kernel itself is held to these plain versions bit for bit on a
card (``test_torch_kernels_gpu.py``).
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu_torch.ops.bucket_kernel as tbk
from velesdb_tpu_torch.ops import _cuda

B_PAD, D, N = 24, 48, 4096
TIE_LANE = 5


def _tie_lane(chunk):
    """The rows of bucket lane ``TIE_LANE`` in chunk 1, one a slice: each
    case gives them all one row and one set of per-row values."""
    return chunk + TIE_LANE + np.arange(chunk // 128) * 128


def _sq8i_inputs(chunk, seed):
    rng = np.random.default_rng(seed)
    qi = rng.integers(-127, 128, (B_PAD, D)).astype(np.int8)
    rows = rng.integers(-128, 128, (N, D)).astype(np.int8)
    # products exact in fp32: |doti| < 2^20 by 4-bit scales, |sqi| < 2^13 by
    # 11-bit am, 5-bit 1/qs by 16-bit pen
    scale = (rng.integers(8, 16, N) * 2.0**-10).astype(np.float32)
    am = (rng.integers(-1024, 1024, N) * 2.0**-10).astype(np.float32)
    pen = (rng.integers(0, 1 << 16, N) * 2.0**-8).astype(np.float32)
    pen[rng.random(N) < 0.15] = np.inf  # knocked-out rows
    pen[:chunk] = np.inf  # chunk 0: every row knocked out
    lane = _tie_lane(chunk)
    for v in (rows, scale, am, pen):
        v[lane] = v[lane[0]]
    invqs = (rng.integers(4, 17, B_PAD) / 8.0).astype(np.float32)
    sqi = qi.astype(np.float32).sum(axis=1)
    return qi, rows, scale, am, pen, sqi, invqs


def _reference(kernel, chunk, qi, rows, row_vecs, query_vec=None):
    """The JAX package's Pallas ``kernel`` in interpret mode: per-row vectors
    as ``[8, N]`` tiles, the per-query one as ``[B_pad, 128]``, as its
    wrappers pass them."""
    b, d = qi.shape
    n = rows.shape[0]
    nb = n // chunk * 128
    specs = [pl.BlockSpec((b, d), lambda c: (0, 0)), pl.BlockSpec((chunk, d), lambda c: (c, 0))]
    args = [jnp.asarray(qi), jnp.asarray(rows)]
    for v in row_vecs:
        specs.append(pl.BlockSpec((8, chunk), lambda c: (0, c)))
        args.append(jnp.broadcast_to(jnp.asarray(v)[None, :], (8, n)))
    if query_vec is not None:
        specs.append(pl.BlockSpec((b, 128), lambda c: (0, 0)))
        args.append(jnp.broadcast_to(jnp.asarray(query_vec)[:, None], (b, 128)))
    gm, gi = pl.pallas_call(
        functools.partial(kernel, chunk=chunk),
        grid=(n // chunk,),
        in_specs=specs,
        out_specs=(pl.BlockSpec((b, 128), lambda c: (0, c)),
                   pl.BlockSpec((b, 128), lambda c: (0, c))),
        out_shape=(jax.ShapeDtypeStruct((b, nb), jnp.float32),
                   jax.ShapeDtypeStruct((b, nb), jnp.int32)),
        interpret=True,
    )(*args)
    return torch.from_numpy(np.array(gm)), torch.from_numpy(np.array(gi))


@pytest.mark.parametrize("chunk", [128, 1024])
def test_sq8i_plain_equals_reference_kernel(chunk):
    qi, rows, scale, am, pen, sqi, invqs = _sq8i_inputs(chunk, seed=chunk)
    want = _reference(jbk._sq8i_kernel, chunk, qi, rows, (scale, am, pen), invqs)
    got = tbk.sq8i_bucket_ref(*(torch.from_numpy(a) for a in (qi, rows, scale, am, pen, sqi,
                                                              invqs)), chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    gm, gi = got
    assert bool(torch.isneginf(gm[:, :128]).all())  # the knocked-out chunk
    assert torch.equal(gi[:, :128], torch.arange(128, dtype=torch.int32).expand(B_PAD, 128))
    if chunk > 128:  # every slice of the planted lane ties: slice 0 wins
        assert bool((gi[:, 128 + TIE_LANE] == chunk + TIE_LANE).all())


def _hamming_inputs(chunk, seed):
    rng = np.random.default_rng(seed)
    qbits = (rng.random((B_PAD, D)) < 0.5).astype(np.int8)
    bits = (rng.random((N, D)) < 0.5).astype(np.int8)
    knocked = rng.random(N) < 0.15
    knocked[:chunk] = True
    lane = _tie_lane(chunk)
    for v in (bits, knocked):
        v[lane] = v[lane[0]]
    aux = (bits.astype(np.int32).sum(axis=1) + jbk._HAM_BIG * knocked).astype(np.int32)
    return (2 * qbits).astype(np.int8), bits, aux


@pytest.mark.parametrize("chunk", [128, 1024])
def test_hamming_mxu_plain_equals_reference_kernel(chunk):
    qi, bits, aux = _hamming_inputs(chunk, seed=chunk + 1)
    want = _reference(jbk._hamming_mxu_kernel, chunk, qi, bits, (aux,))
    got = tbk.hamming_mxu_ref(torch.from_numpy(qi), torch.from_numpy(bits),
                              torch.from_numpy(aux), chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    gm, gi = got
    assert bool((gm[:, :128] <= -jbk._HAM_BIG + 2 * D).all())  # the knocked-out chunk
    if chunk > 128:
        assert bool((gi[:, 128 + TIE_LANE] == chunk + TIE_LANE).all())


# (B_pad, D_pad, chunk, N) of #1: the query tiles 8 .. 128 (ragged at 24 and
# 136), zero-filled K steps (16, 48, 112), the cap (512), one slice a bucket
# (chunk 128) up to 64 (8,192).
_PD_SHAPES = [(8, 16, 128, 1024), (24, 48, 2048, 4096), (136, 112, 8192, 16_384),
              (8, 512, 8192, 8192), (24, 512, 128, 1024), (136, 16, 2048, 4096)]


def _pd_inputs(b_pad, d_pad, chunk, n, seed):
    """Seeded per-dimension operands of #1: 15% of rows and all of chunk 0
    knocked out (``pen_int = _pd_invalid_pen(D_pad)``, the largest penalty
    the encoding takes), the rest up to ``_PD_PEN_CAP``; row 1 of the
    knocked-out chunk the most negative dot against query 0; every slice of
    bucket lane 5 in chunk 1 one row with one penalty."""
    rng = np.random.default_rng(seed)
    qi = rng.integers(-127, 128, (b_pad, d_pad)).astype(np.int8)
    rows = rng.integers(-127, 128, (n, d_pad)).astype(np.int8)
    pen = rng.integers(0, tbk._PD_PEN_CAP + 1, n).astype(np.int32)
    knocked = rng.random(n) < 0.15
    knocked[:chunk] = True
    pen[knocked] = tbk._pd_invalid_pen(d_pad)
    qi[0] = 127
    rows[1] = -127
    if n > chunk:
        lane = _tie_lane(chunk)
        rows[lane], pen[lane] = rows[lane[0]], pen[lane[0]]
    ptile = tbk.sq8pd_ptile(torch.from_numpy(pen), chunk).numpy()
    return qi, rows, ptile


def _pd_reference(chunk, qi, rows, ptile):
    """``_sq8pd_kernel`` in interpret mode, as ``sq8pd_candidates`` calls it."""
    b, d = qi.shape
    n = rows.shape[0]
    (gm,) = pl.pallas_call(
        functools.partial(jbk._sq8pd_kernel, chunk=chunk),
        grid=(n // chunk,),
        in_specs=[pl.BlockSpec((b, d), lambda c: (0, 0)),
                  pl.BlockSpec((chunk, d), lambda c: (c, 0)),
                  pl.BlockSpec((8, chunk), lambda c: (0, c))],
        out_specs=(pl.BlockSpec((b, 128), lambda c: (0, c)),),
        out_shape=(jax.ShapeDtypeStruct((b, n // chunk * 128), jnp.int32),),
        interpret=True,
    )(jnp.asarray(qi), jnp.asarray(rows), jnp.broadcast_to(jnp.asarray(ptile)[None, :], (8, n)))
    return torch.from_numpy(np.array(gm))


@pytest.mark.parametrize("b_pad,d_pad,chunk,n", _PD_SHAPES)
def test_sq8pd_plain_equals_reference_kernel(b_pad, d_pad, chunk, n):
    qi, rows, ptile = _pd_inputs(b_pad, d_pad, chunk, n, seed=b_pad + d_pad + chunk)
    want = _pd_reference(chunk, qi, rows, ptile)
    gm = tbk.sq8pd_bucket_gm_ref(torch.from_numpy(qi), torch.from_numpy(rows),
                                 torch.from_numpy(ptile), chunk)
    assert gm.dtype == torch.int32 and torch.equal(gm, want)
    exact = (qi.astype(np.int64) @ rows.T.astype(np.int64)) * 64 + ptile[None, :]
    exact = exact.reshape(b_pad, n // chunk, chunk // 128, 128).max(axis=2).reshape(b_pad, -1)
    assert np.array_equal(gm.numpy(), exact)  # no int32 wrap anywhere
    # the knocked-out chunk's buckets: below the decode's empty threshold
    assert bool((gm[:, :128] // 64 < tbk._pd_empty_thresh(d_pad)).all())
    if n > chunk:  # the tied lane: every slice scores alike, the last slice wins
        assert bool((gm[:, 128 + TIE_LANE] & 63 == chunk // 128 - 1).all())


def test_sq8pd_wrapper_refuses_widths_off_the_k_step():
    """D_pad must be a multiple of 16 (the kernel's 16-byte row copies) and
    at most 512, on the CPU as on the card."""
    qi = torch.zeros((8, 132), dtype=torch.int8)
    rows = torch.zeros((1024, 132), dtype=torch.int8)
    ptile = torch.zeros(1024, dtype=torch.int32)
    for d in (132, 100, 528):
        with pytest.raises(ValueError):
            tbk.sq8pd_bucket_gm(torch.zeros((8, d), dtype=torch.int8),
                                torch.zeros((1024, d), dtype=torch.int8), ptile, 512)
    gm = tbk.sq8pd_bucket_gm(qi[:, :128].contiguous(), rows[:, :128].contiguous(), ptile, 512)
    assert gm.shape == (8, 256)


def _source_caps() -> dict:
    """The D_pad caps the C entries of ``csrc/sq8i_bucket.cu`` check."""
    with open(os.path.join(_cuda._CSRC, "sq8i_bucket.cu")) as f:
        src = f.read()
    caps = {}
    for entry in ("sq8i_bucket_launch", "sq8i_v2_bucket_launch", "hamming_mxu_launch",
                  "sq8pd_bucket_launch"):
        body = src[src.index(f'extern "C" int {entry}'):]
        caps[entry] = int(re.search(r"bad_shape\([^)]*,\s*(\d+)\)", body).group(1))
    return caps


def test_int32_headroom_at_the_caps():
    caps = _source_caps()
    assert caps["sq8i_bucket_launch"] == tbk._SQ8I_MAX_DPAD == 12288
    assert caps["hamming_mxu_launch"] == tbk._HAM_MAX_DPAD == 6144
    assert caps["sq8i_v2_bucket_launch"] == 1024
    assert caps["sq8pd_bucket_launch"] == tbk._PD_MAX_DPAD == 512
    # #7: the largest |dot| at the cap, every term (-127) * (-128), and the
    # plain version's int32 equal to the exact int64 sum
    d = tbk._SQ8I_MAX_DPAD
    qi = torch.full((8, d), -127, dtype=torch.int8)
    qi[1] = 127
    rows = torch.full((128, d), -128, dtype=torch.int8)
    rows[1] = 127
    dot = tbk._int8_dot(qi, rows)
    exact = qi.long() @ rows.long().T
    assert torch.equal(dot.long(), exact)
    assert int(exact.abs().max()) == 128 * 127 * d < 2**31
    # #5: every score at the cap is exact in fp32 (|s| <= 2^20 + 2 D_pad < 2^24)
    d = tbk._HAM_MAX_DPAD
    qi = torch.full((8, d), 2, dtype=torch.int8)
    qi[1] = 0
    bits = torch.ones((128, d), dtype=torch.int8)
    bits[64:] = 0
    aux = bits.to(torch.int32).sum(1) + tbk._HAM_BIG * (torch.arange(128) % 3 == 0)
    gm, _ = tbk.hamming_mxu_ref(qi, bits, aux.to(torch.int32), 128)
    exact = (qi.long() @ bits.long().T - aux.long()).reshape(8, 1, 128).amax(1)
    assert torch.equal(gm.double(), exact.double())
    assert 2**20 + 2 * d < 2**24
    # #1: the largest encoded scores at the cap, a valid row at the penalty
    # cap and a knocked-out one, equal the exact int64 sums and fit int32
    d = caps["sq8pd_bucket_launch"]
    qi = torch.full((8, d), 127, dtype=torch.int8)
    qi[1] = -127
    rows = torch.full((128, d), 127, dtype=torch.int8)
    rows[64:] = -127
    pen = torch.zeros(128, dtype=torch.int32)
    pen[1::4] = tbk._PD_PEN_CAP
    pen[2::4] = tbk._pd_invalid_pen(d)
    ptile = tbk.sq8pd_ptile(pen, 128)
    gm = tbk.sq8pd_bucket_gm_ref(qi, rows, ptile, 128)
    enc = (qi.long() @ rows.long().T) * 64 + ptile.long()
    assert torch.equal(gm.long(), enc)
    assert int(enc.max()) == 127 * 127 * d * 64 < 2**29
    assert int(enc.min()) == -127 * 127 * d * 64 - 64 * tbk._pd_invalid_pen(d) > -2**31
