"""The tolerances of the split-bf16 tensor-core kernels, on the CPU: #3
(``split_scan_tolerance``), #8 (``fused_topk_tolerance``), #2 on f32 rows
(``f32_scan_tolerance``) and #6 (``sq8_scan_tolerance``), and the one
checker they share with #2b (``ranked_error``).

- A plain emulation of each kernel's arithmetic lies within its tolerance:
  the split products (``qhi hi``, ``qhi lo``, ``qlo hi``; #8 splits the f32
  query and row first) summed in another order than the plain version's,
  sequentially within blocks of 16 dims, then a pairwise tree over the
  blocks. On SIFT-like clustered data (three metrics) and on the same data
  offset by +100 per coordinate (euclidean), where ``2 q.c - |c|^2``
  cancels.
- The JAX package's split-bf16 Pallas kernel (``_kernel_hl``, interpret
  mode) on the same split inputs lies within ``split_scan_tolerance``.
- The checker rejects a winner moved by twice the tolerance, an id swapped
  where the plain gap exceeds twice the tolerance, (#8) a row returned
  twice, and a kernel that drops both ``lo`` products (``qhi hi`` alone), at
  the widths where a worst-case order bound would admit it (#3 at D_pad
  1,536, #8 at D 768).
- #2 on f32 rows and #6 (the f32 and SQ8 modes of ``csrc/dense_bucket_tc.cu``):
  a plain emulation of each mode's arithmetic (#2: #8's split products; #6:
  the queries' exact three-part split times the codes, in the kernel's K
  order, summed in blocks, then the fixed-order affine) lies within its
  tolerance at D 100 (a zero-filled last K step), 128 and 768, three
  metrics; the three parts sum to the queries exactly; the JAX package's
  ``_sq8_kernel`` (interpret mode) with the f32 unpack lies within
  ``sq8_scan_tolerance``. Lower-precision controls are rejected by more
  than 2x: #6 with the queries rounded to bf16 once (the reference's
  ``unpack_bf16=True`` function, and its Pallas kernel) and #2 with ``qhi
  hi`` alone.
- The kernel libraries' names hash every ``csrc/`` header their source
  includes, so an edited header rebuilds them.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu_torch.ops.bucket_kernel as tbk
import velesdb_tpu_torch.ops.pallas_kernels as tpk
from velesdb_tpu_torch.index.brute import _affine_fold
from velesdb_tpu_torch.ops import _cuda
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.quantization import sq8_pack_blocked, sq8_quantize, sq8_unpack_blocked

METRICS = ["euclidean", "cosine", "dot_product"]


def _clustered(rng, n, d, offset=0.0):
    """SIFT-like data: the benchmark's clustered Gaussians (64 centers)."""
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 64, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7
    return torch.from_numpy(x + np.float32(offset))


def _blocked_tree_sum(terms):
    """fp32 sum of ``terms`` (a list over dims of lists of ``[B, N]``
    products, in the dim's order): sequential within blocks of 16 dims, then
    a pairwise tree over the blocks."""
    blocks = []
    for d0 in range(0, len(terms), 16):
        acc = None
        for per_dim in terms[d0 : d0 + 16]:
            for t in per_dim:
                acc = t if acc is None else acc + t
        blocks.append(acc)
    while len(blocks) > 1:
        nxt = [blocks[i] + blocks[i + 1] for i in range(0, len(blocks) - 1, 2)]
        if len(blocks) % 2:
            nxt.append(blocks[-1])
        blocks = nxt
    return blocks[0]


def _split_dot(qhi, qlo, hi, lo):
    """The tensor-core kernels' dot in another order: ``qhi hi + qhi lo +
    qlo hi`` per dim, each product exact in fp32."""
    qh, ql, h, lw = qhi.float(), qlo.float(), hi.float(), lo.float()
    terms = [[qh[:, d, None] * h[None, :, d], qh[:, d, None] * lw[None, :, d],
              ql[:, d, None] * h[None, :, d]] for d in range(qh.shape[1])]
    return _blocked_tree_sum(terms)


# -- #3 -------------------------------------------------------------------------


def _hl_case(metric, offset=0.0, b=16, n=4096, d=100, chunk=1024, seed=0):
    """Split operands as ``bucket_topk_hl`` prepares them: D padded to a
    multiple of 128, 15% of rows knocked out, one chunk wholly knocked out."""
    rng = np.random.default_rng(seed)
    x = _clustered(rng, n + b, d, offset)
    rows, q = x[:n], x[n:]
    if metric == "cosine":
        rows, q = rows / rows.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)
    elif metric == "euclidean":
        q = 2.0 * q
    cc = (rows * rows).sum(1) if metric == "euclidean" else torch.zeros(n)
    cc = torch.where(torch.from_numpy(rng.random(n) < 0.15), torch.inf, cc)
    cc[:chunk] = torch.inf
    d_pad = -(-d // 128) * 128
    q = torch.nn.functional.pad(q, (0, d_pad - d))
    rows = torch.nn.functional.pad(rows, (0, d_pad - d))
    return (*tbk.split_f32_rows(q), *tbk.split_f32_rows(rows), cc, chunk)


def _hl_emulation(qhi, qlo, hi, lo, cc, chunk):
    return tbk._bucket_select(_split_dot(qhi, qlo, hi, lo) - cc[None, :], chunk)


@pytest.mark.parametrize("metric,offset", [(m, 0.0) for m in METRICS] + [("euclidean", 100.0)])
def test_split_scan_tolerance_accepts_a_reordered_sum(metric, offset):
    args = _hl_case(metric, offset)
    ref = tbk.split_scan_tolerance(*args)
    gm_ref, gi_ref, s_ref, tol = ref
    want = tbk.hl_bucket_ref(*args)
    assert torch.equal(gm_ref, want[0]) and torch.equal(gi_ref, want[1])
    got = _hl_emulation(*args)
    worst, max_tol, _ = tbk.split_scan_error(*args, *got, ref=ref)
    assert worst <= 1.0 and max_tol > 0.0
    assert not torch.equal(got[0], gm_ref)  # another order: the sums do differ
    assert tbk.split_scan_error(*args, *ref[:2], ref=ref)[0] == 0.0


@pytest.mark.parametrize("metric", METRICS)
def test_split_scan_tolerance_rejects_a_winner_moved_twice_the_bound(metric):
    args = _hl_case(metric, seed=3)
    gm, gi, _, tol = ref = tbk.split_scan_tolerance(*args)
    fin = torch.nonzero(torch.isfinite(gm))[0]
    for scale, ok in ((0.99, True), (2.0, False)):
        moved = gm.clone()
        moved[fin[0], fin[1]] -= scale * tol[fin[0], fin[1]]
        assert (tbk.split_scan_error(*args, moved, gi, ref=ref)[0] <= 1.0) == ok


def test_split_scan_tolerance_rejects_a_swapped_row():
    args = _hl_case("dot_product", seed=4)
    chunk = args[-1]
    gm, gi, s, tol = ref = tbk.split_scan_tolerance(*args)
    b, n = s.shape
    t = s.reshape(b, n // chunk, chunk // 128, 128)
    top2 = torch.topk(t, 2, dim=2)
    gap = (top2.values[:, :, 0] - top2.values[:, :, 1]).reshape(b, -1)
    second = ((torch.arange(0, n, chunk)[:, None] + top2.indices[:, :, 1] * 128
               + torch.arange(128)[None, :]).reshape(b, -1)).int()
    clear = torch.nonzero(torch.isfinite(gap) & (gap > 2 * tol))[0]
    swapped = gi.clone()
    swapped[clear[0], clear[1]] = second[clear[0], clear[1]]
    assert tbk.split_scan_error(*args, gm, swapped, ref=ref)[0] == float("inf")


@pytest.mark.parametrize("metric", ["euclidean", "dot_product"])
@pytest.mark.parametrize("d", [100, 1536])
def test_split_scan_tolerance_rejects_a_kernel_without_the_lo_products(metric, d):
    """``qhi hi`` alone (a bf16 scan) strays by about ``2^-9 |q.c|`` over
    ``sqrt(D)``: outside the bound up to the 1,536 cap of #3's width, where
    the reordered split sum stays inside it."""
    args = _hl_case(metric, d=d, seed=11)
    qhi, _, hi, _, cc, chunk = args
    ref = tbk.split_scan_tolerance(*args)
    assert tbk.split_scan_error(*args, *_hl_emulation(*args), ref=ref)[0] <= 1.0
    bf16_only = tbk._bucket_select(qhi.float() @ hi.float().T - cc[None, :], chunk)
    assert tbk.split_scan_error(*args, *bf16_only, ref=ref)[0] > 2.0


@pytest.mark.parametrize("metric,offset", [("euclidean", 0.0), ("cosine", 0.0),
                                           ("euclidean", 100.0)])
def test_reference_split_kernel_within_the_tolerance(metric, offset):
    """The JAX package's split-bf16 Pallas kernel (``_kernel_hl``, interpret
    mode) on the same split inputs: its two products (``qhi.hi`` and
    ``[qhi|qlo].[lo|hi]``) summed in XLA's order, within the port's
    tolerance."""
    qhi, qlo, hi, lo, cc, chunk = args = _hl_case(metric, offset, seed=9)

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    b, d = qhi.shape
    n = hi.shape[0]
    nb = n // chunk * 128
    gm, gi = pl.pallas_call(
        functools.partial(jbk._kernel_hl, chunk=chunk),
        grid=(n // chunk,),
        in_specs=[pl.BlockSpec((b, d), lambda c: (0, 0)),
                  pl.BlockSpec((b, d), lambda c: (0, 0)),
                  pl.BlockSpec((chunk, d), lambda c: (c, 0)),
                  pl.BlockSpec((chunk, d), lambda c: (c, 0)),
                  pl.BlockSpec((8, chunk), lambda c: (0, c))],
        out_specs=(pl.BlockSpec((b, 128), lambda c: (0, c)),
                   pl.BlockSpec((b, 128), lambda c: (0, c))),
        out_shape=(jax.ShapeDtypeStruct((b, nb), jnp.float32),
                   jax.ShapeDtypeStruct((b, nb), jnp.int32)),
        interpret=True,
    )(to_jax(qhi), to_jax(qlo), to_jax(hi), to_jax(lo),
      jnp.broadcast_to(jnp.asarray(cc.numpy())[None, :], (8, n)))
    got = (torch.from_numpy(np.asarray(gm)), torch.from_numpy(np.asarray(gi)))
    assert tbk.split_scan_error(*args, *got)[0] <= 1.0


# -- #8 -------------------------------------------------------------------------


def _fused_case(metric, dtype=torch.float32, offset=0.0, b=9, n=3000, d=100, seed=0):
    """``fused_topk``'s operands: queries normalized for cosine, D padded to
    a multiple of 128, rows in ``dtype``, 15% invalid; ``aux`` and ``qq`` as
    the op computes them."""
    rng = np.random.default_rng(seed)
    x = _clustered(rng, n + b, d, offset)
    q = x[n:]
    if metric == "cosine":
        q = q / q.norm(dim=1, keepdim=True)
    d_pad = -(-d // 128) * 128
    q = torch.nn.functional.pad(q, (0, d_pad - d))
    rows = torch.nn.functional.pad(x[:n], (0, d_pad - d)).to(dtype)
    cn = (rows.float() ** 2).sum(1)
    aux = torch.where(cn > 1e-30, torch.rsqrt(cn.clamp_min(1e-30)), 0.0) \
        if metric == "cosine" else cn
    valid = torch.from_numpy(rng.random(n) > 0.15)
    return q, rows, valid, aux, (q * q).sum(1)


def _fused_emulation(q, rows, valid, aux, qq, k, metric):
    """#8's arithmetic: the query and the row split into bf16 pairs, the
    split dot in another order, the metric fixup, the top-k of the keys."""
    qhi, qlo = tbk.split_f32_rows(q)
    hi, lo = tbk.split_f32_rows(rows.float())
    dot = _split_dot(qhi, qlo, hi, lo)
    if metric == "cosine":
        s = dot * aux[None, :]
    elif metric == "euclidean":
        s = -((qq[:, None] + aux[None, :]) - 2.0 * dot).clamp_min(0.0)
    else:
        s = dot
    return tpk._top_keys(torch.where(valid[None, :], s, -torch.inf), k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("metric", METRICS)
def test_fused_topk_tolerance_accepts_the_split_arithmetic(dtype, metric):
    args = _fused_case(metric, dtype)
    for k in (1, 10, 100):
        ref = tpk.fused_topk_tolerance(*args, k, metric)
        want = tpk.fused_topk_ref(*args, k, metric)
        assert torch.equal(ref[0], want[0]) and torch.equal(ref[1], want[1])
        got = _fused_emulation(*args, k, metric)
        worst, max_tol, _ = tpk.fused_topk_error(*args, k, metric, *got, ref=ref)
        assert worst <= 1.0 and max_tol > 0.0, (k, worst)
        assert tpk.fused_topk_error(*args, k, metric, *ref[:2], ref=ref)[0] == 0.0


def test_fused_topk_tolerance_on_the_offset_corpus():
    """+100 per coordinate: the euclidean form cancels, and the split's
    error scales with ``A`` (the row's sum of |q_d x_d|), not with the
    distance; the emulation stays within the bound."""
    args = _fused_case("euclidean", offset=100.0, seed=5)
    for k in (10, 100):
        got = _fused_emulation(*args, k, "euclidean")
        assert tpk.fused_topk_error(*args, k, "euclidean", *got)[0] <= 1.0


@pytest.mark.parametrize("metric", METRICS)
def test_fused_topk_tolerance_rejects_a_kernel_without_the_lo_products(metric):
    """At D 768, the slice's width, the split arithmetic stays within the
    bound and ``qhi hi`` alone (the query and row each rounded to bf16) lies
    outside it."""
    args = _fused_case(metric, b=16, d=768, seed=12)
    q, rows, valid, aux, qq = args
    for k in (10, 100):
        ref = tpk.fused_topk_tolerance(*args, k, metric)
        got = _fused_emulation(*args, k, metric)
        assert tpk.fused_topk_error(*args, k, metric, *got, ref=ref)[0] <= 1.0
        dot = q.to(torch.bfloat16).float() @ rows.to(torch.bfloat16).float().T
        if metric == "cosine":
            s = dot * aux[None, :]
        elif metric == "euclidean":
            s = -((qq[:, None] + aux[None, :]) - 2.0 * dot).clamp_min(0.0)
        else:
            s = dot
        bf16_only = tpk._top_keys(torch.where(valid[None, :], s, -torch.inf), k)
        assert tpk.fused_topk_error(*args, k, metric, *bf16_only, ref=ref)[0] > 2.0


def test_fused_topk_tolerance_rejects_a_value_moved_twice_the_bound():
    args = _fused_case("dot_product", seed=6)
    vals, ids, _, tol, _ = ref = tpk.fused_topk_tolerance(*args, 10, "dot_product")
    for scale, ok in ((0.99, True), (2.0, False)):
        moved = vals.clone()
        moved[0, 0] += scale * tol[0, 0]
        assert (tpk.fused_topk_error(*args, 10, "dot_product", moved, ids, ref=ref)[0]
                <= 1.0) == ok


def test_fused_topk_tolerance_rejects_swapped_and_repeated_rows():
    args = _fused_case("euclidean", seed=7)
    k = 10
    vals, ids, s, tol, gap = ref = tpk.fused_topk_tolerance(*args, k, "euclidean")
    clear = torch.nonzero(gap > 2 * tol)
    b0, r0 = clear[-1].tolist()
    nxt = tpk.fused_topk_ref(*args, k + 1, "euclidean")[1][b0, k]  # the plain (k+1)-th row
    swapped = ids.clone()
    swapped[b0, r0] = nxt
    assert tpk.fused_topk_error(*args, k, "euclidean", vals, swapped, ref=ref)[0] == float("inf")
    # a near tie may return either row, but never one row twice
    twice = ids.clone()
    twice[0, 1] = twice[0, 0]
    flat = torch.full_like(gap, 0.0)  # as if every rank were a near tie
    ref_tied = (vals, ids, s, tol, flat)
    assert tpk.fused_topk_error(*args, k, "euclidean", vals, ids, ref=ref_tied)[0] == 0.0
    assert tpk.fused_topk_error(*args, k, "euclidean", vals, twice, ref=ref_tied)[0] == float("inf")


def test_fused_topk_tolerance_with_empty_ranks():
    """Fewer valid rows than k: the plain ranks past them are -inf / -1,
    which the kernel must return exactly."""
    q, rows, valid, aux, qq = _fused_case("cosine", seed=8, n=200)
    valid = torch.zeros_like(valid)
    valid[[3, 50, 199]] = True
    args = (q, rows, valid, aux, qq)
    vals, ids = tpk.fused_topk_ref(*args, 10, "cosine")
    assert (ids[:, 3:] == -1).all()
    assert tpk.fused_topk_error(*args, 10, "cosine", vals, ids)[0] == 0.0
    filled = ids.clone()
    filled[:, 3] = 4  # an invalid row where the plain version has none
    assert tpk.fused_topk_error(*args, 10, "cosine", vals, filled)[0] == float("inf")


# -- #2 on f32 rows and #6: the f32 and SQ8 modes of the tensor-core scan -------

WIDTHS = [100, 128, 768]


def _f32_case(metric, d, seed, b=16, n=4096, chunk=1024):
    """``dense_bucket_gm``'s f32 operands as ``bucket_topk_entry`` prepares
    them: D padded to a multiple of 8, 15% of rows knocked out, one chunk
    wholly knocked out."""
    rng = np.random.default_rng(seed)
    x = _clustered(rng, n + b, d)
    rows, q = x[:n], x[n:]
    if metric == "cosine":
        rows, q = rows / rows.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)
    elif metric == "euclidean":
        q = 2.0 * q
    cc = (rows * rows).sum(1) if metric == "euclidean" else torch.zeros(n)
    cc = torch.where(torch.from_numpy(rng.random(n) < 0.15), torch.inf, cc)
    cc[:chunk] = torch.inf
    d_pad = -(-d // 8) * 8
    q = torch.nn.functional.pad(q, (0, d_pad - d, 0, (-b) % 8))
    return q, torch.nn.functional.pad(rows, (0, d_pad - d)), cc, chunk


def _f32_emulation(q, rows, cc, chunk):
    """The f32 mode's arithmetic: query and row split into bf16 pairs, the
    three split products summed in another order, then ``- cc``."""
    dot = _split_dot(*tbk.split_f32_rows(q), *tbk.split_f32_rows(rows))
    return tbk._bucket_select(dot - cc[None, :], chunk)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", WIDTHS)
def test_f32_scan_tolerance_accepts_the_split_arithmetic(metric, d):
    args = _f32_case(metric, d, seed=d + 1)
    ref = tbk.f32_scan_tolerance(*args)
    want = tbk.dense_bucket_ref(*args)
    assert torch.equal(ref[0], want[0]) and torch.equal(ref[1], want[1])
    got = _f32_emulation(*args)
    worst, max_tol, _ = tbk.f32_scan_error(*args, *got, ref=ref)
    assert worst <= 1.0 and max_tol > 0.0, worst
    assert not torch.equal(got[0], ref[0])  # another order: the sums do differ
    assert tbk.f32_scan_error(*args, *ref[:2], ref=ref)[0] == 0.0


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", WIDTHS)
def test_f32_scan_tolerance_rejects_a_kernel_without_the_lo_products(metric, d):
    """``qhi hi`` alone (query and row each rounded to bf16 once)."""
    q, rows, cc, chunk = args = _f32_case(metric, d, seed=d + 2)
    ref = tbk.f32_scan_tolerance(*args)
    bf16_only = q.to(torch.bfloat16).float() @ rows.to(torch.bfloat16).float().T
    got = tbk._bucket_select(bf16_only - cc[None, :], chunk)
    assert tbk.f32_scan_error(*args, *got, ref=ref)[0] > 2.0


def _sq8_case(metric, d, seed, b=16, n=4096, chunk=1024):
    """``sq8_bucket_gm``'s operands as ``sq8_bucket_topk`` prepares them
    from an SQ8 index's words and affine: queries normalized (cosine) or
    doubled (euclidean), padded to 4 W; 15% of rows invalid and one chunk
    wholly invalid."""
    rng = np.random.default_rng(seed)
    x = _clustered(rng, n + b, d)
    rows, q = x[:n], x[n:]
    if metric == "cosine":
        rows, q = rows / rows.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)
    elif metric == "euclidean":
        q = 2.0 * q
    sq = sq8_quantize(rows)
    valid = torch.from_numpy(rng.random(n) > 0.15)
    valid[:chunk] = False
    scale, minv, pen, _ = _affine_fold(sq, valid, DistanceMetric.parse(metric))
    words = sq8_pack_blocked(sq.codes)
    q = torch.nn.functional.pad(q, (0, 4 * words.shape[1] - d, 0, (-b) % 8))
    return q, words, scale, minv, pen, q.sum(1), chunk


def _sq8_scores(dot, scale, minv, pen, qsum):
    return (dot * scale[None, :] + qsum[:, None] * minv[None, :]) - pen[None, :]


def _sq8_emulation(q, words, scale, minv, pen, qsum, chunk):
    """The SQ8 mode's arithmetic: the queries' three exact bf16 parts times
    the codes in the kernel's K order (K position ``4 w + j`` is dim ``j W +
    w``), summed in blocks of 16 positions and a tree over the blocks, then
    the affine in the plain version's order."""
    w = words.shape[1]
    perm = torch.arange(4 * w).reshape(4, w).T.reshape(-1)
    parts = [p.float()[:, perm] for p in tbk.split3_f32(q)]
    codes = sq8_unpack_blocked(words)[:, perm]
    dot = _blocked_tree_sum([[p[:, k, None] * codes[None, :, k] for p in parts]
                             for k in range(4 * w)])
    return tbk._bucket_select(_sq8_scores(dot, scale, minv, pen, qsum), chunk)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", WIDTHS)
def test_sq8_scan_tolerance_accepts_the_exact_split(metric, d):
    args = _sq8_case(metric, d, seed=d)
    q = args[0]
    hi, mid, lo = tbk.split3_f32(q)
    assert torch.equal(hi.double() + mid.double() + lo.double(), q.double())
    ref = tbk.sq8_scan_tolerance(*args)
    want = tbk.sq8_bucket_ref(*args)
    assert torch.equal(ref[0], want[0]) and torch.equal(ref[1], want[1])
    got = _sq8_emulation(*args)
    worst, max_tol, _ = tbk.sq8_scan_error(*args, *got, ref=ref)
    assert worst <= 1.0 and max_tol > 0.0, worst
    assert not torch.equal(got[0], ref[0])  # another order: the sums do differ
    assert tbk.sq8_scan_error(*args, *ref[:2], ref=ref)[0] == 0.0


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", WIDTHS)
def test_sq8_scan_tolerance_rejects_queries_rounded_to_bf16(metric, d):
    """The reference's ``unpack_bf16=True`` function: the queries rounded to
    bf16 once, their products with the codes summed exactly."""
    q, words, scale, minv, pen, qsum, chunk = args = _sq8_case(metric, d, seed=d + 5)
    ref = tbk.sq8_scan_tolerance(*args)
    dot = (q.to(torch.bfloat16).double() @ sq8_unpack_blocked(words).double().T).float()
    got = tbk._bucket_select(_sq8_scores(dot, scale, minv, pen, qsum), chunk)
    assert tbk.sq8_scan_error(*args, *got, ref=ref)[0] > 2.0


def _reference_sq8_kernel(q, words, scale, minv, pen, chunk, unpack_bf16):
    """The JAX package's ``_sq8_kernel`` in interpret mode on the port's
    operands: ``(gm, gi)`` as torch tensors."""
    b, d_pad = q.shape
    n, w = words.shape
    nb = n // chunk * 128

    def rows8(v):
        return jnp.broadcast_to(jnp.asarray(v.numpy())[None, :], (8, n))

    gm, gi = pl.pallas_call(
        functools.partial(jbk._sq8_kernel, chunk=chunk, d_pad=d_pad, unpack_bf16=unpack_bf16),
        grid=(n // chunk,),
        in_specs=[pl.BlockSpec((b, d_pad), lambda c: (0, 0)),
                  pl.BlockSpec((chunk, w), lambda c: (c, 0)),
                  pl.BlockSpec((8, chunk), lambda c: (0, c)),
                  pl.BlockSpec((8, chunk), lambda c: (0, c)),
                  pl.BlockSpec((8, chunk), lambda c: (0, c))],
        out_specs=(pl.BlockSpec((b, 128), lambda c: (0, c)),
                   pl.BlockSpec((b, 128), lambda c: (0, c))),
        out_shape=(jax.ShapeDtypeStruct((b, nb), jnp.float32),
                   jax.ShapeDtypeStruct((b, nb), jnp.int32)),
        interpret=True,
    )(jnp.asarray(q.numpy()), jnp.asarray(words.numpy()), rows8(scale), rows8(minv), rows8(pen))
    return torch.from_numpy(np.asarray(gm)), torch.from_numpy(np.asarray(gi))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_reference_sq8_kernel_within_the_tolerance(metric):
    """The JAX package's #6 (interpret mode) on the same words: the f32
    unpack (the function the port's mode computes) within
    ``sq8_scan_tolerance``, the bf16 unpack outside it by more than 2x. The
    reference sums ``qsum`` inside its kernel, so the plain pass takes its
    sum."""
    q, words, scale, minv, pen, _, chunk = _sq8_case(metric, 128, seed=21)
    qsum = torch.from_numpy(np.asarray(jnp.sum(jnp.asarray(q.numpy()), axis=1)))
    args = (q, words, scale, minv, pen, qsum, chunk)
    ref = tbk.sq8_scan_tolerance(*args)
    f32 = _reference_sq8_kernel(q, words, scale, minv, pen, chunk, unpack_bf16=False)
    assert tbk.sq8_scan_error(*args, *f32, ref=ref)[0] <= 1.0
    bf16 = _reference_sq8_kernel(q, words, scale, minv, pen, chunk, unpack_bf16=True)
    assert tbk.sq8_scan_error(*args, *bf16, ref=ref)[0] > 2.0


def test_sq8_query_parts_follow_the_words():
    """The kernel's query parts: column ``4 v + j`` is dim ``j W + v``, zero
    past 4 W up to a multiple of 8, and the parts sum to the query."""
    q = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 100)).astype(np.float32))
    parts = tbk._sq8_query_parts(q, 25)
    assert all(p.shape == (8, 104) and p.dtype == torch.bfloat16 for p in parts)
    total = sum(p.double() for p in parts)
    perm = torch.arange(100).reshape(4, 25).T.reshape(-1)
    assert torch.equal(total[:, :100], q.double()[:, perm])
    assert not total[:, 100:].any()


# -- the build hash ---------------------------------------------------------------


def test_library_names_hash_the_headers_their_sources_include(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda._CSRC, csrc)
    monkeypatch.setattr(_cuda, "_CSRC", str(csrc))
    srcs = _cuda._sources(str(csrc / "fused_topk.cu"), [])
    assert [os.path.basename(p) for p in srcs] == ["fused_topk.cu", "wgmma.cuh"]
    before = {name: _cuda._paths(name)[1]
              for name in ("fused_topk", "dense_bucket_tc", "sq8i_bucket", "hamming_topk")}
    with open(csrc / "wgmma.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: _cuda._paths(name)[1] for name in before}
    assert after["fused_topk"] != before["fused_topk"]
    assert after["dense_bucket_tc"] != before["dense_bucket_tc"]
    assert after["sq8i_bucket"] != before["sq8i_bucket"]
    assert after["hamming_topk"] == before["hamming_topk"]  # includes no header
