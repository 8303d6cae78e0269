"""The tolerances of the split-bf16 tensor-core kernels, on the CPU: #3
(``split_scan_tolerance``) and #8 (``fused_topk_tolerance``), and the one
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
from velesdb_tpu_torch.ops import _cuda

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


# -- the build hash ---------------------------------------------------------------


def test_library_names_hash_the_headers_their_sources_include(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda._CSRC, csrc)
    monkeypatch.setattr(_cuda, "_CSRC", str(csrc))
    srcs = _cuda._sources(str(csrc / "fused_topk.cu"), [])
    assert [os.path.basename(p) for p in srcs] == ["fused_topk.cu", "wgmma.cuh"]
    before = {name: _cuda._paths(name)[1]
              for name in ("fused_topk", "dense_bucket_tc", "dense_bucket")}
    with open(csrc / "wgmma.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: _cuda._paths(name)[1] for name in before}
    assert after["fused_topk"] != before["fused_topk"]
    assert after["dense_bucket_tc"] != before["dense_bucket_tc"]
    assert after["dense_bucket"] == before["dense_bucket"]  # includes no header
