"""The redesigned kernels' plain parts, on the CPU: #10's probe schedule and
grouped scoring order, and the tolerance #2b (half rows on the tensor cores)
is held to.

- Schedule (``probe_runs``, hypothesis): every (query, probe) slot exactly
  once, sorted by (partition, slot); runs maximal; groups start at run
  starts and every ``group`` entries; ids that are not partitions kept, as
  partition -1.
- Grouped order: a plain emulation of the kernel's data movement (each
  group's partition read once, scored for the group's queries) equals
  ``ivf_probe_ref`` bit for bit, and through ``ivf_probe_topk`` the JAX
  package's probe op (Pallas in interpret mode) to rtol 1e-5 with ids equal
  up to near-ties, the tolerances of ``test_torch_ivf.py``.
- Tolerance (``half_scan_tolerance`` / ``half_scan_error``): accepts a fp32
  sum of the exact half products in another order (pairwise) and the JAX
  package's Pallas bucket kernel on the same half inputs; rejects a winner
  moved just past the bound, a row outside its bucket, and a finite score
  where the plain bucket is ``-inf``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

import velesdb_tpu.index.ivf as jivf
import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu_torch.index.ivf as tivf
import velesdb_tpu_torch.ops.bucket_kernel as tbk
import velesdb_tpu_torch.ops.ivf_kernel as tik
from velesdb_tpu.ops.ivf_kernel import ivf_probe_topk as j_probe_topk
from velesdb_tpu.ops.quantization import sq8_quantize as j_sq8
from velesdb_tpu_torch.ops.quantization import sq8_pack_blocked, sq8_quantize

METRICS = ["euclidean", "cosine", "dot_product"]


def _clustered(rng, n, d, c=8, scale=3.0, spread=0.6):
    centers = rng.standard_normal((c, d)).astype(np.float32) * scale
    return centers[rng.integers(0, c, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)


# -- #10's schedule -------------------------------------------------------------


def _check_schedule(probe, n_parts, group, order, spid, gsize):
    flat = probe.reshape(-1)
    m = flat.size
    order, spid, gsize = order.numpy(), spid.numpy(), gsize.numpy()
    assert sorted(order.tolist()) == list(range(m))  # every (b, j) exactly once
    want_pid = np.where((flat >= 0) & (flat < n_parts), flat, -1)
    np.testing.assert_array_equal(spid, want_pid[order])  # invalid ids kept as -1
    keys = list(zip(spid.tolist(), order.tolist()))
    assert keys == sorted(keys)  # by partition, then by slot
    starts = [0] + [i for i in range(1, m) if spid[i] != spid[i - 1]] + [m]
    want = np.zeros(m, np.int64)
    for s, e in zip(starts[:-1], starts[1:]):
        assert len(set(spid[s:e].tolist())) == 1  # a run is one partition...
        assert e == m or spid[e] != spid[s]  # ...and maximal
        for g0 in range(s, e, group):  # groups at the run start, then every `group`
            want[g0] = min(group, e - g0)
    np.testing.assert_array_equal(gsize, want)


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 20), nprobe=st.integers(1, 12), n_parts=st.integers(1, 30),
       group=st.sampled_from([1, 2, 3, 8]), seed=st.integers(0, 2**31 - 1))
def test_probe_runs_schedule_invariants(b, nprobe, n_parts, group, seed):
    rng = np.random.default_rng(seed)
    probe = rng.integers(-3, n_parts + 3, (b, nprobe)).astype(np.int32)
    _check_schedule(probe, n_parts, group, *tik.probe_runs(torch.from_numpy(probe), n_parts, group))


@pytest.mark.parametrize("group", [1, 8])
def test_probe_runs_long_runs_and_all_invalid(group):
    """A partition probed by every query (one run of 64, cut into groups),
    one probed 13 times by one query, and a batch whose ids are all invalid."""
    rng = np.random.default_rng(5)
    probe = rng.integers(0, 40, (64, 20)).astype(np.int32)
    probe[:, 0] = 7
    probe[3, 1:14] = 11
    _check_schedule(probe, 40, group, *tik.probe_runs(torch.from_numpy(probe), 40, group))
    bad = np.full((3, 4), -1, np.int32)
    bad[1, 2] = 99
    order, spid, gsize = tik.probe_runs(torch.from_numpy(bad), 40, group)
    assert (spid == -1).all() and int(gsize.sum()) == 12
    _check_schedule(bad, 40, group, order, spid, gsize)


def test_probe_schedule_on_cpu_is_probe_runs():
    """``ivf_probe_scores(..., sched=)`` on the CPU writes :func:`probe_runs`'s
    schedule there and returns the plain version's scores, uncounted."""
    args = _probe_case(np.random.default_rng(1), "f32", "euclidean")
    probe, n_parts = args[2], args[3].shape[0]
    sched = torch.full((3, probe.numel()), -7, dtype=torch.int32)
    before = dict(tik.LAUNCHES)
    out = tik.ivf_probe_scores(*args, sched=sched)
    assert torch.equal(out, tik.ivf_probe_ref(*args))
    for got, want in zip(sched, tik.probe_runs(probe, n_parts)):
        assert torch.equal(got, want)
    assert tik.LAUNCHES == before  # the CPU path never counts


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides"])
def test_probe_schedule_output_is_checked(bad):
    args = _probe_case(np.random.default_rng(2), "sq8", "cosine")
    m = args[2].numel()
    sched = {"dtype": torch.empty((3, m), dtype=torch.int64),
             "shape": torch.empty((3, m + 1), dtype=torch.int32),
             "strides": torch.empty((m, 3), dtype=torch.int32).T}[bad]
    with pytest.raises(ValueError):
        tik.ivf_probe_scores(*args, sched=sched)


# -- #10's grouped scoring order --------------------------------------------------


def grouped_probe_scores(q, qsum, probe, rows, aux, group=tik.PROBE_GROUP):
    """Plain emulation of the kernel's data movement: walk the schedule's
    groups, read each group's partition once and score it for the group's
    queries, each dot in dim order as the kernel sums it."""
    n_parts, L, _ = rows.shape
    b, nprobe = probe.shape
    order, spid, gsize = tik.probe_runs(probe, n_parts, group)
    out = torch.full((b * nprobe, L), torch.nan)
    for i in torch.nonzero(gsize).flatten().tolist():
        slots = order[i:i + int(gsize[i])].long()
        pid, qrows = int(spid[i]), slots // nprobe
        if pid < 0:
            out[slots] = -torch.inf
            continue
        blk = rows[pid]
        if rows.dtype == torch.int32:
            blk = torch.cat([(blk >> (8 * j)) & 0xFF for j in range(4)], dim=-1)
        dot = tik._ordered_bdot(q[qrows], blk[None].expand(len(slots), -1, -1))
        a = aux[pid]
        out[slots] = ((dot * a[0]) + (qsum[qrows][:, None] * a[1])) - a[2]
    return out.reshape(b, nprobe, L)


def _probe_case(rng, storage, metric, b=9, nprobe=6, L=40, d=24, n_parts=30):
    """Operands as ``ivf_probe_topk`` prepares them, 15% dead slots, the last
    four partitions all dead, probes sharing partitions, two invalid ids."""
    x = torch.from_numpy(_clustered(rng, n_parts * L + b, d))
    rows, q = x[: n_parts * L], x[n_parts * L:]
    live = torch.from_numpy(rng.random(n_parts * L) > 0.15)
    live[-4 * L:] = False
    if metric == "cosine":
        q = q / q.norm(dim=1, keepdim=True)
    elif metric == "euclidean":
        q = 2.0 * q
    psq = (rows * rows).sum(1)
    inv = torch.rsqrt(psq) if metric == "cosine" else torch.ones_like(psq)
    if storage == "sq8":
        sq = sq8_quantize(rows)
        parts = sq8_pack_blocked(torch.where(live[:, None], sq.codes, 0)).reshape(n_parts, L, -1)
        mul, add = sq.scale * inv, sq.minv * inv
        d_pad = 4 * parts.shape[2]
    else:
        parts = torch.where(live[:, None], rows, 0.0).reshape(n_parts, L, d)
        mul, add, d_pad = inv, torch.zeros_like(psq), d
    pen = torch.where(live, psq if metric == "euclidean" else 0.0, torch.inf)
    aux = torch.stack([t.reshape(n_parts, L) for t in (mul, add, pen)], 1).contiguous()
    q = torch.nn.functional.pad(q, (0, d_pad - d))
    qsum = q.sum(1)
    if storage == "sq8":
        q = q.to(torch.bfloat16).float()
    probe = torch.from_numpy(rng.integers(0, 6, (b, nprobe)).astype(np.int32))
    probe[:, 0] = n_parts - 1
    probe[0, 1], probe[2, 3] = -1, n_parts + 4
    return q.contiguous(), qsum, probe, parts.contiguous(), aux


@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("storage", ["f32", "sq8"])
@pytest.mark.parametrize("metric", METRICS)
def test_grouped_order_equals_plain_bit_for_bit(metric, storage, group):
    args = _probe_case(np.random.default_rng(len(metric) + group), storage, metric)
    got = grouped_probe_scores(*args, group=group)
    want = tik.ivf_probe_ref(*args)
    assert torch.equal(got, want)
    assert bool(torch.isneginf(want[0, 1]).all()) and bool(torch.isneginf(want[:, 0]).all())


def _jax_state(j):
    arrays = {k: (None if getattr(j, "_" + k) is None else np.asarray(getattr(j, "_" + k)))
              for k in ("centroids", "cent_sq", "parts", "part_scale", "part_minv", "part_rows",
                        "part_sq", "kmeans_cents")}
    arrays.update(n=j.n, c=j.c, c_real=j.c_real, part_len=j.part_len, spill=j.spill,
                  storage=j.storage, metric=j.metric.value)
    arrays["aux"] = np.asarray(j._kernel_state()[0])
    return arrays


@pytest.mark.parametrize("storage", ["f32", "sq8"])
@pytest.mark.parametrize("metric", METRICS)
def test_grouped_order_matches_reference_probe_op(monkeypatch, storage, metric):
    """``ivf_probe_topk`` scoring through the grouped emulation against the
    reference's (Pallas in interpret mode) on a reference index carried over:
    24 clusters over 3,000 x 32, 15% of rows invalid, 16 queries, nprobe 8."""
    rng = np.random.default_rng(21)
    x = _clustered(rng, 3000, 32)
    q = np.concatenate([_clustered(rng, 8, 32), _clustered(rng, 8, 32)])
    valid = rng.random(3000) > 0.15
    j = jivf.IvfIndex(32, metric, n_clusters=24, spill=2)
    j.build(j_sq8(jnp.asarray(x)) if storage == "sq8" else x, valid)
    t = tivf.ivf_state_from_jax(_jax_state(j), "cpu")
    k, nprobe = 10, 8
    aux, flat = j._kernel_state()
    jv, ji = j_probe_topk(jnp.asarray(q), j._centroids, j._cent_sq, j._parts, aux, flat, k=k,
                          nprobe=nprobe, metric=j.metric, interpret=True)
    monkeypatch.setattr(tik, "ivf_probe_scores", grouped_probe_scores)
    tv, ti = tik.ivf_probe_topk(torch.from_numpy(q), t._centroids, t._cent_sq, t._parts,
                                *t._kernel_state(), k=k, nprobe=nprobe, metric=t.metric)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    for g, w in zip(ti.numpy(), np.asarray(ji)):
        assert len(set(g.tolist()) & set(w.tolist())) >= len(set(w.tolist())) - 1, (g, w)


# -- #2b's tolerance --------------------------------------------------------------


def _half_case(dtype, metric, b=16, n=4096, d=100, chunk=1024, seed=0):
    """Half operands as ``bucket_topk_entry`` prepares them (D 100 padded to
    104, 15% of rows knocked out, one chunk wholly knocked out)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_clustered(rng, n + b, d, c=16))
    rows, q = x[:n], x[n:]
    if metric == "cosine":
        rows, q = rows / rows.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)
    elif metric == "euclidean":
        q = 2.0 * q
    cc = (rows * rows).sum(1) if metric == "euclidean" else torch.zeros(n)
    cc = torch.where(torch.from_numpy(rng.random(n) < 0.15), torch.inf, cc)
    cc[:chunk] = torch.inf
    q = torch.nn.functional.pad(q, (0, 4)).to(dtype)
    rows = torch.nn.functional.pad(rows, (0, 4)).to(dtype).contiguous()
    return q, rows, cc, chunk


def _pairwise(q, rows, cc, chunk):
    """fp32 pairwise sums of the exact half products, then ``- cc`` and the
    bucket select: one other order of the same sums."""
    p = q.float()[:, None, :] * rows.float()[None]
    p = torch.nn.functional.pad(p, (0, (-p.shape[-1]) % 128))
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return tbk._bucket_select(p[..., 0] - cc[None, :], chunk)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("metric", METRICS)
def test_tolerance_accepts_a_reordered_sum(dtype, metric):
    args = _half_case(dtype, metric)
    ref = tbk.half_scan_tolerance(*args)
    worst, max_tol, _ = tbk.half_scan_error(*args, *_pairwise(*args), ref=ref)
    assert worst <= 1.0 and max_tol > 0.0
    assert tbk.half_scan_error(*args, *ref[:2], ref=ref)[0] == 0.0


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("metric", METRICS)
def test_tolerance_rejects_a_winner_past_the_bound(dtype, metric):
    args = _half_case(dtype, metric, seed=3)
    gm, gi, _, tol = ref = tbk.half_scan_tolerance(*args)
    fin = torch.nonzero(torch.isfinite(gm))[0]
    for scale, ok in ((0.99, True), (1.01, False)):
        moved = gm.clone()
        moved[fin[0], fin[1]] += scale * tol[fin[0], fin[1]]
        assert (tbk.half_scan_error(*args, moved, gi, ref=ref)[0] <= 1.0) == ok


def test_tolerance_rules_for_rows():
    """A near-tie may return the other row; a clear winner may not; a row of
    another bucket never; a ``-inf`` bucket stays ``-inf`` on its slice-0
    row."""
    q, rows, cc, chunk = args = _half_case(torch.bfloat16, "dot_product", seed=4)
    gm, gi, s, tol = ref = tbk.half_scan_tolerance(*args)
    b, n = s.shape
    t = s.reshape(b, n // chunk, chunk // 128, 128)
    top2 = torch.topk(t, 2, dim=2)
    margin = (top2.values[:, :, 0] - top2.values[:, :, 1]).reshape(b, -1)
    second = ((torch.arange(0, n, chunk)[:, None] + top2.indices[:, :, 1] * 128
               + torch.arange(128)[None, :]).reshape(b, -1)).int()
    clear = torch.nonzero(torch.isfinite(margin) & (margin > 2 * tol))[0]
    swapped = gi.clone()
    swapped[clear[0], clear[1]] = second[clear[0], clear[1]]
    assert tbk.half_scan_error(*args, gm, swapped, ref=ref)[0] == float("inf")
    # make a near-tie: the second row scores the winner's value exactly
    near = rows.clone()
    b0, k0 = clear.tolist()
    near[second[b0, k0]] = rows[gi[b0, k0]]
    args2 = (q, near, cc.clone(), chunk)
    cc2 = args2[2]
    cc2[second[b0, k0]] = cc[gi[b0, k0]]
    ref2 = tbk.half_scan_tolerance(*args2)
    alt = ref2[1].clone()
    alt[b0, k0] = second[b0, k0] if ref2[1][b0, k0] != second[b0, k0] else gi[b0, k0]
    assert tbk.half_scan_error(*args2, ref2[0], alt, ref=ref2)[0] <= 1.0
    other = gi.clone()
    other[b0, k0] = (gi[b0, k0] + 1) % n  # the next lane: another bucket
    assert tbk.half_scan_error(*args, gm, other, ref=ref)[0] == float("inf")
    dead = torch.nonzero(torch.isneginf(gm))[0]  # the knocked-out first chunk
    assert int(gi[dead[0], dead[1]]) == int(dead[1]) % 128
    lifted = gm.clone()
    lifted[dead[0], dead[1]] = 0.0
    assert tbk.half_scan_error(*args, lifted, gi, ref=ref)[0] == float("inf")


@pytest.mark.parametrize("dtype,jdtype", [(torch.float16, jnp.float16),
                                          (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("metric", METRICS)
def test_reference_bucket_kernel_within_the_tolerance(dtype, jdtype, metric):
    """The JAX package's Pallas bucket kernel (``_kernel``, interpret mode)
    on the same half inputs: XLA's fp32 accumulation of the half products,
    another order of the same sums, within the port's tolerance."""
    q, rows, cc, chunk = args = _half_case(dtype, metric, seed=9)
    jq = jnp.asarray(q.float().numpy()).astype(jdtype)
    jrows = jnp.asarray(rows.float().numpy()).astype(jdtype)
    jcc = jnp.asarray(cc.numpy())
    b, d = q.shape
    n = rows.shape[0]
    nb = n // chunk * 128
    gm, gi = pl.pallas_call(
        functools.partial(jbk._kernel, chunk=chunk),
        grid=(n // chunk,),
        in_specs=[pl.BlockSpec((b, d), lambda c: (0, 0)),
                  pl.BlockSpec((chunk, d), lambda c: (c, 0)),
                  pl.BlockSpec((8, chunk), lambda c: (0, c))],
        out_specs=(pl.BlockSpec((b, 128), lambda c: (0, c)),
                   pl.BlockSpec((b, 128), lambda c: (0, c))),
        out_shape=(jax.ShapeDtypeStruct((b, nb), jnp.float32),
                   jax.ShapeDtypeStruct((b, nb), jnp.int32)),
        interpret=True,
    )(jq, jrows, jnp.broadcast_to(jcc[None, :], (8, n)))
    got = (torch.from_numpy(np.asarray(gm)), torch.from_numpy(np.asarray(gi)))
    assert tbk.half_scan_error(*args, *got)[0] <= 1.0


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_rows_on_cpu_take_the_plain_version(dtype):
    args = _half_case(dtype, "euclidean", seed=2)
    before = dict(tbk.LAUNCHES)
    got = tbk.dense_bucket_gm(*args)
    want = tbk.dense_bucket_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tbk.LAUNCHES == before
