"""#4, the packed Hamming bucket scan, in the arithmetic of its tensor-core kernel.

The CUDA kernel (``velesdb_tpu_torch/csrc/hamming_bucket.cu``) unpacks each
packed word into 32 int8 K positions, the corpus's bits as 0/1 and 0/16 and
the query's as +-64 and +-4, so that one s32 product of the two gives
``64 (|q| - popc(q ^ c))``; it then keeps one int32 key a (row lane, query)
while a thread's rows carry only the penalties +0.0 and +inf, and turns to a
float select for the rest of a chunk where they do not. ``_model`` below is
that arithmetic in plain torch: the same bit expressions on uint32 words (its
constants read from the source), an exact integer product, the keys, the
switch per thread (rows ``l`` and ``l + 8``), the decode. On inputs made from
numpy seeds, two results are held:

- the model against the plain version ``hamming_bucket_ref``, which the CUDA
  kernel is held to on a card (``test_torch_kernels_gpu.py``): ``gm`` bit for
  bit (``-0.0`` included) and ``gi`` equal, and the product equal to
  ``64 (|q| - d)`` for every (query, row);
- the model's winners through the port's final select against the JAX
  package's ``hamming_bucket_topk`` (its Pallas kernel in interpret mode, as
  the package's own tests run it): distances equal, and the id sets equal
  below the k-th distance.

The cases: W 1, 3, 4, 8, 24 and 256 with D not a multiple of 32 (zero bits
past D in every word), chunk 128, 1,024 and 2,048, B_pad 8, 16 and 24, 15% of
rows knocked out, a bucket lane and a whole chunk knocked out, rows repeated
across the slices of one lane (ties go to the smallest slice), and penalties
other than +0.0 and +inf (finite, -0.0) that send some threads to the float
select part way through a chunk.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu_torch.ops.bucket_kernel as tbk
from velesdb_tpu_torch.ops import _cuda
from velesdb_tpu_torch.ops.quantization import binary_quantize

_SRC = os.path.join(_cuda._CSRC, "hamming_bucket.cu")


def _constant(name: str) -> int:
    """A constant of ``csrc/hamming_bucket.cu``: an integer literal, a hex
    literal with a ``u`` suffix, or ``1 << n``."""
    with open(_SRC) as f:
        expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", f.read()).group(1)
    expr = expr.strip()
    if "<<" in expr:
        a, b = expr.split("<<")
        return int(a) << int(b)
    return int(expr.rstrip("u"), 0)


K_LO, K_HI = _constant("kLo"), _constant("kHi")
K_KNOCK, K_MAGIC, INF_BITS = _constant("kKnock"), _constant("kMagic"), _constant("kInfBits")
KEY_INIT = -(1 << 31) + 63
LANES = 128


def _bytes(v: torch.Tensor) -> torch.Tensor:
    """The four bytes of uint32 values (int64 ``[...]``) as int8 ``[..., 4]``,
    byte b at index b."""
    b = torch.stack([(v >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def _spread_rows(words: torch.Tensor) -> torch.Tensor:
    """The A operand: each word of ``[N, W]`` as 32 int8 K positions, lane
    ``j``'s registers ``(x >> j) & kLo`` at K 4 j .. + 3 and ``(x >> j) & kHi``
    at K 16 + 4 j .. + 3."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty((*x.shape, 32), dtype=torch.int8)
    for j in range(4):
        t = x >> j
        out[..., 4 * j:4 * j + 4] = _bytes(t & K_LO)
        out[..., 16 + 4 * j:16 + 4 * j + 4] = _bytes(t & K_HI)
    return out.reshape(x.shape[0], -1)


def _spread_queries(words: torch.Tensor) -> torch.Tensor:
    """The B operand: ``query_bytes(word, h, jj)`` at K 16 h + 4 jj .. + 3."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty((*x.shape, 32), dtype=torch.int8)
    for h in range(2):
        for jj in range(4):
            t = (x >> (4 * h + jj)) & K_LO
            v = ((t << 2) | ((t ^ K_LO) * 0xFC)) if h else ((t << 6) | ((t ^ K_LO) * 0xC0))
            out[..., 16 * h + 4 * jj:16 * h + 4 * jj + 4] = _bytes(v)
    return out.reshape(x.shape[0], -1)


def _dist_of(z: torch.Tensor) -> torch.Tensor:
    """``(float bits z) - 2^23`` in fp32 (exact: z's float is 2^23 + d)."""
    zf = z.to(torch.int32).view(torch.float32)
    return zf - 8388608.0


def _knocked(key: torch.Tensor) -> torch.Tensor:
    return key < -(K_KNOCK >> 1)


def _key_score(key: torch.Tensor, cq: torch.Tensor) -> torch.Tensor:
    z = (cq - (key >> 6)) & 0xFFFFFFFF
    z = torch.where(z >= 1 << 31, z - (1 << 32), z)
    return torch.where(_knocked(key), -torch.inf, -_dist_of(z))


def _key_slice(key: torch.Tensor) -> torch.Tensor:
    return torch.where(_knocked(key), 0, 63 - (key & 63))


def _model(q: torch.Tensor, packed: torch.Tensor, pen: torch.Tensor, chunk: int):
    """The kernel's arithmetic: ``(gm f32, gi int32, dot int64 [B, N])``."""
    b, n = q.shape[0], packed.shape[0]
    dot = _spread_queries(q).long() @ _spread_rows(packed).long().T
    ones = torch.stack([((q.long() & 0xFFFFFFFF) >> i) & 1 for i in range(32)]).sum((0, 2))
    cq = (K_MAGIC + ones)[:, None]  # [B, 1]
    n_chunks, slices = n // chunk, chunk // LANES
    acc = dot.reshape(b, n_chunks, slices, LANES)
    pens = pen.reshape(n_chunks, slices, LANES)
    bits = pens.view(torch.int32).long() & 0xFFFFFFFF
    odd = (bits != 0) & (bits != INF_BITS)
    # a thread holds lanes l and l + 8 (l % 16 < 8): it switches when either does
    pair = torch.arange(LANES) ^ 8
    odd = odd | odd[:, :, pair]
    key = torch.full((b, n_chunks, LANES), KEY_INIT, dtype=torch.int64)
    fmax = torch.full((b, n_chunks, LANES), -torch.inf)
    slice_of = torch.zeros((b, n_chunks, LANES), dtype=torch.int64)
    gen = torch.zeros((n_chunks, LANES), dtype=torch.bool)
    for s in range(slices):
        turn = odd[:, s] & ~gen  # these threads' keys become (float max, slice)
        fmax = torch.where(turn, _key_score(key, cq[:, :, None]), fmax)
        slice_of = torch.where(turn, _key_slice(key), slice_of)
        gen = gen | odd[:, s]
        r = torch.where(bits[:, s] == INF_BITS, -K_KNOCK, 63 - s)
        key = torch.where(gen, key, torch.maximum(key, acc[:, :, s] + r))
        z = cq[:, :, None] - (acc[:, :, s] >> 6)
        v = -_dist_of(z) - pens[:, s]
        better = gen & (v > fmax)
        fmax = torch.where(better, v, fmax)
        slice_of = torch.where(better, s, slice_of)
    gm = torch.where(gen, fmax, _key_score(key, cq[:, :, None]))
    slice_of = torch.where(gen, slice_of, _key_slice(key))
    lane = torch.arange(LANES)
    gi = torch.arange(n_chunks)[:, None] * chunk + slice_of * LANES + lane
    return gm.reshape(b, -1), gi.reshape(b, -1).to(torch.int32), dot


def _case(w, d, b, n, chunk, seed, odd_pens=False):
    """Packed sign words of clustered rows: 15% knocked out, lane 5 of chunk 0
    knocked out in every slice, the last chunk wholly knocked out, lane 9 of
    chunk 0 holding one row in every slice, and with ``odd_pens`` finite and
    -0.0 penalties on a few rows of the middle chunks."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32)
    x = centers[rng.integers(0, 16, n + b)] + 0.8 * rng.standard_normal((n + b, d)).astype(
        np.float32)
    for s in range(1, chunk // LANES):
        x[s * LANES + 9] = x[9]
    pen = np.where(rng.random(n) < 0.15, np.inf, 0.0).astype(np.float32)
    pen[5:chunk:LANES] = np.inf
    pen[n - chunk:] = np.inf
    if odd_pens:
        mid = np.arange(chunk, n - chunk)
        pick = rng.choice(mid, size=min(12, mid.size), replace=False)
        pen[pick] = rng.choice(np.array([0.5, 3.0, 17.25, -0.0, -2.0], np.float32), size=pick.size)
    words = binary_quantize(torch.from_numpy(x))
    assert words.shape[1] == w
    b_pad = -(-max(b, 8) // 8) * 8
    q = torch.nn.functional.pad(words[n:], (0, 0, 0, b_pad - b))
    return q, words[:n].contiguous(), torch.from_numpy(pen), x


CASES = [  # (W, D, B, N, chunk)
    (1, 20, 5, 4096, 1024),
    (3, 90, 13, 4096, 128),
    (4, 100, 13, 8192, 2048),
    (8, 256, 24, 4096, 2048),
    (24, 760, 16, 2048, 1024),
    (256, 8190, 8, 2048, 512),
]


@pytest.mark.parametrize("odd_pens", [False, True])
@pytest.mark.parametrize("w,d,b,n,chunk", CASES)
def test_tensor_core_arithmetic_equals_plain(w, d, b, n, chunk, odd_pens):
    q, packed, pen, _ = _case(w, d, b, n, chunk, seed=w * 7 + odd_pens, odd_pens=odd_pens)
    gm, gi, dot = _model(q, packed, pen, chunk)
    dist = tbk.hamming_distances(q, packed).long()
    qones = tbk.hamming_distances(q, torch.zeros_like(packed[:1])).long()
    assert torch.equal(dot, 64 * (qones - dist))
    assert int(dot.abs().max()) <= 64 * 32 * w
    rm, ri = tbk.hamming_bucket_ref(q, packed, pen, chunk)
    assert torch.equal(gm.view(torch.int32), rm.view(torch.int32))
    assert torch.equal(gi, ri)
    assert bool((gm == -torch.inf).any())


@pytest.mark.parametrize("w,d,b,n,chunk", CASES)
def test_tensor_core_arithmetic_topk_equals_jax(w, d, b, n, chunk):
    q, packed, pen, x = _case(w, d, b, n, chunk, seed=w * 11, odd_pens=True)
    gm, gi, _ = _model(q, packed, pen, chunk)
    k = 10
    vals, idx = tbk._final_select(gm, gi, k, b)
    td = torch.where(idx < 0, torch.inf, -vals).numpy()
    ti = idx.numpy()
    jd, ji = jbk.hamming_bucket_topk(
        jnp.asarray(q[:b].numpy()), jnp.asarray(packed.numpy()), jnp.asarray(pen.numpy()),
        k=k, chunk=chunk, interpret=True)
    jd, ji = np.array(jd), np.array(ji)
    np.testing.assert_array_equal(td, jd)
    kth = td[:, -1:]
    assert [set(r[m].tolist()) for r, m in zip(ti, td < kth)] == \
        [set(r[m].tolist()) for r, m in zip(ji, jd < kth)]
    # the winners' distances are the exact popcounts plus their penalties
    qb, cb = x[n:n + b, :d] >= 0, x[:n, :d] >= 0
    exact = (qb[:, None, :] != cb[None, :, :]).sum(-1).astype(np.float32) + pen.numpy()[None]
    ok = ti >= 0
    np.testing.assert_array_equal(td[ok], np.take_along_axis(exact, np.maximum(ti, 0), 1)[ok])


def test_repeated_rows_tie_to_the_smallest_slice():
    """Lane 9 of chunk 0 holds one row in every slice: its winner is slice 0
    for every query, in the model as in the plain version."""
    q, packed, pen, _ = _case(4, 100, 13, 8192, 2048, seed=3)
    pen[9:2048:LANES] = 0.0
    gm, gi, _ = _model(q, packed, pen, 2048)
    assert bool((gi[:, 9] == 9).all())
    rm, ri = tbk.hamming_bucket_ref(q, packed, pen, 2048)
    assert torch.equal(gi, ri) and torch.equal(gm.view(torch.int32), rm.view(torch.int32))


def test_knocked_out_buckets_return_slice_zero():
    q, packed, pen, _ = _case(8, 256, 24, 4096, 2048, seed=4)
    gm, gi, _ = _model(q, packed, pen, 2048)
    last = slice(4096 // 2048 * LANES - LANES, None)
    assert bool((gm[:, last] == -torch.inf).all())
    assert torch.equal(gi[:, last][0], torch.arange(4096 - 2048, 4096 - 2048 + LANES,
                                                    dtype=torch.int32))
    assert bool((gm[:, 5] == -torch.inf).all()) and bool((gi[:, 5] == 5).all())


def test_keys_stay_inside_int32_at_the_caps():
    """At W 256 the largest |dot| is 64 * 8,192 = 2^19: the keys of valid
    rows, ``dot + 63 - slice``, lie above -2^20 and those of knocked-out
    rows, ``dot - kKnock``, below it, all inside int32 and above the initial
    key; the magic-number bits of every distance up to 8,192 decode
    exactly."""
    top = 64 * 8192
    assert -top > -(K_KNOCK >> 1) > top + 63 - K_KNOCK > -top - K_KNOCK > KEY_INIT
    assert top + 63 < 1 << 31
    d = torch.arange(8193, dtype=torch.int64)
    assert torch.equal(_dist_of(K_MAGIC + d), d.float())
