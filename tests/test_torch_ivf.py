"""Parity of the port's IVF building blocks with the JAX package, on the CPU.

The same seeded numpy inputs go through ``velesdb_tpu.index.ivf`` /
``velesdb_tpu.ops.ivf_kernel`` (JAX on the CPU, the Pallas probe kernel in
interpret mode) and their counterparts in ``velesdb_tpu_torch`` (the CUDA
kernel's plain version on the CPU). Tolerances:

- k-means: the same init rows exactly; centroids to rtol 1e-4 on
  well-separated data and assignments equal on >= 0.999 of rows (the cluster
  sums add in another order);
- assembly from the reference's assignment: partitions, rows, routing
  norms, scales and offsets exactly (at D 128, where the reference's CPU row
  sum adds in the 32-column blocks of the port's ``_row_sumsq``; its order
  at other widths is XLA's choice); ``part_sq`` to rtol 1e-6;
- probe op and ``ivf_search_impl`` on state carried over by
  ``ivf_state_from_jax``: values to rtol 1e-5 (summation order), ids equal
  up to near-ties (>= k - 1 shared per query, the reference's own rule).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu.index.ivf as jivf
import velesdb_tpu_torch.index.ivf as tivf
import velesdb_tpu_torch.ops.ivf_kernel as tik
from velesdb_tpu.ops.ivf_kernel import ivf_probe_topk as j_probe_topk
from velesdb_tpu.ops.quantization import sq8_quantize as j_sq8
from velesdb_tpu_torch.ops.quantization import sq8_pack_blocked

METRICS = ["euclidean", "cosine", "dot_product"]


def _clustered(rng, n, d, c=8, scale=3.0, spread=0.6):
    centers = rng.standard_normal((c, d)).astype(np.float32) * scale
    return centers[rng.integers(0, c, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- k-means and assignment ---------------------------------------------------


@pytest.mark.parametrize("train_sample", [None, 1000])
def test_kmeans_matches_reference(train_sample):
    """Same init rows (``iters=0`` returns them), then Lloyd on the full set
    or a training sample (4,000 rows > 1,000) with one assignment pass."""
    x = _clustered(np.random.default_rng(1), 4000, 16, c=8, scale=10.0)
    j0, _ = jivf.kmeans(x, 8, iters=0, seed=3, train_sample=train_sample)
    t0, _ = tivf.kmeans(x, 8, iters=0, seed=3, train_sample=train_sample)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    jc, ja = jivf.kmeans(x, 8, iters=10, seed=3, train_sample=train_sample)
    tc, ta = tivf.kmeans(x, 8, iters=10, seed=3, train_sample=train_sample)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)
    assert ta.shape == (4000,)
    assert np.mean(ta.numpy() == np.asarray(ja)) >= 0.999


def test_kmeans_pads_with_row_zero_like_reference():
    """4,001 rows pad to 4,008 with copies of row 0, which enter the sums."""
    x = _clustered(np.random.default_rng(2), 4001, 8, c=4)
    padded = tivf._pad_rows_like_reference(torch.from_numpy(x))
    assert padded.shape == (4008, 8)
    np.testing.assert_array_equal(padded[4001:].numpy(), np.repeat(x[:1], 7, axis=0))
    jc, ja = jivf.kmeans(x, 5, iters=4, seed=0)
    tc, ta = tivf.kmeans(x, 5, iters=4, seed=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)
    assert np.mean(ta.numpy() == np.asarray(ja)) >= 0.999


@pytest.mark.parametrize("cosine", [False, True])
def test_spill_assignment_matches_reference(cosine):
    """Top-2 centroids per row, f32 and SQ8 (dequantized block by block);
    ties go to the lower centroid id in both packages (duplicated centroids
    make exact ties)."""
    rng = np.random.default_rng(4)
    x = _clustered(rng, 3000, 24, c=6)
    cents = _clustered(rng, 12, 24, c=6)
    cents[7] = cents[2]  # an exact tie
    jt = np.asarray(jivf._assign_topk(jnp.asarray(x), jnp.asarray(cents), s=2))
    tt = tivf._assign_topk(torch.from_numpy(x), torch.from_numpy(cents), s=2).numpy()
    assert np.mean(np.all(tt == jt, axis=1)) >= 0.999
    sq = j_sq8(jnp.asarray(x))
    js = np.asarray(jivf._assign_topk_sq8(sq.codes, sq.scale, sq.minv, jnp.asarray(cents), s=2,
                                          cosine=cosine))
    ts = tivf._assign_topk_sq8(torch.from_numpy(np.array(sq.codes)),
                               torch.from_numpy(np.array(sq.scale)),
                               torch.from_numpy(np.array(sq.minv)), torch.from_numpy(cents),
                               s=2, cosine=cosine).numpy()
    assert np.mean(np.all(ts == js, axis=1)) >= 0.999


# -- partition assembly ---------------------------------------------------------


@pytest.fixture(scope="module")
def assembly():
    """A skewed assignment (clusters far above L split into several
    partitions sharing a centroid), from the reference's own k-means."""
    rng = np.random.default_rng(6)
    n, d, c = 3000, 128, 24
    x = _clustered(rng, n, d, c=4)
    cents, assign = jivf.kmeans(x, c, iters=4, seed=0)
    rows = np.flatnonzero(rng.random(n) > 0.1)
    live, assign = x[rows], np.asarray(assign)[rows]
    L = 128
    raw = jivf._exact_n_parts(jnp.asarray(assign), c, L)
    n_parts = jivf._padded_n_parts_capped(raw, c, len(rows), L, row_bytes=4 * d)
    return live, assign, np.asarray(cents), rows.astype(np.int32), c, L, raw, n_parts


def test_group_partitions_matches_reference(assembly):
    live, assign, cents, rows, c, L, raw, n_parts = assembly
    assert n_parts > raw > c  # splits and padded partitions both present
    assert tivf._exact_n_parts(torch.from_numpy(assign).long(), c, L) == raw
    want = jivf._group_partitions(jnp.asarray(live), jnp.asarray(assign), jnp.asarray(cents),
                                  jnp.asarray(rows), c=c, L=L, n_parts=n_parts)
    got = tivf._group_partitions(torch.from_numpy(live), torch.from_numpy(assign).long(),
                                 torch.from_numpy(cents), torch.from_numpy(rows).long(), c=c,
                                 L=L, n_parts=n_parts)
    for name, g, w in zip(("route_cents", "cent_sq", "parts", "part_rows"), got[:4], want[:4]):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-6)


def test_group_partitions_sq8_matches_reference(assembly):
    live, assign, cents, rows, c, L, _, n_parts = assembly
    sq = j_sq8(jnp.asarray(live))
    want = jivf._group_partitions_sq8(sq.codes, sq.scale, sq.minv, jnp.asarray(assign),
                                      jnp.asarray(cents), jnp.asarray(rows), c=c, L=L,
                                      n_parts=n_parts)
    t = [torch.from_numpy(np.array(a)) for a in (sq.codes, sq.scale, sq.minv)]
    got = tivf._group_partitions_sq8(*t, torch.from_numpy(assign).long(),
                                     torch.from_numpy(cents), torch.from_numpy(rows).long(),
                                     c=c, L=L, n_parts=n_parts)
    names = ("route_cents", "cent_sq", "words", "part_scale", "part_minv", "part_rows")
    for name, g, w in zip(names, got[:6], want[:6]):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]), rtol=1e-6)


@pytest.mark.parametrize("d", [1, 4, 33, 128])
def test_pack_and_unpack_words_match_reference(d):
    codes = np.random.default_rng(d).integers(0, 256, (37, d)).astype(np.uint8)
    words = sq8_pack_blocked(torch.from_numpy(codes))
    want_words = np.asarray(jivf._pack_words_2d(jnp.asarray(codes)))
    np.testing.assert_array_equal(words.numpy(), want_words)
    got = tivf.sq8_unpack_words(words, torch.float32).numpy()
    want = np.asarray(jivf.sq8_unpack_words(jnp.asarray(words.numpy()), jnp.float32))
    np.testing.assert_array_equal(got, want)
    d_pad = words.shape[1] * 4
    np.testing.assert_array_equal(got[:, :d], codes.astype(np.float32))
    assert d_pad == -(-d // 4) * 4 and (got[:, d:] == 0).all()


@pytest.mark.parametrize("raw_off", [-40, 0, 5, 300, 2000])
@pytest.mark.parametrize("c,n,L,row_bytes", [(4000, 1_000_000, 512, 512), (24, 6000, 500, 64),
                                             (8192, 10_000_000, 2441, 768), (32, 8192, 1024, 512),
                                             (3906, 2_000_000, 1032, 512)])
def test_n_parts_policy_matches_reference(raw_off, c, n, L, row_bytes):
    raw = max(1, c + raw_off)
    assert tivf._padded_n_parts_capped(raw, c, n, L, row_bytes) == jivf._padded_n_parts_capped(
        raw, c, n, L, row_bytes)
    assert tivf._padded_n_parts(raw, c) == jivf._padded_n_parts(raw, c)
    assert tivf._bucket_n_parts(raw) == jivf._bucket_n_parts(raw)
    assert tivf._parts_per_block(L, raw) == jivf._parts_per_block(L, raw)


def test_padded_n_parts_policy():
    """``test_ivf.py::test_padded_n_parts_policy`` against the port."""
    c, n, L = 4000, 1_000_000, 512
    a = tivf._padded_n_parts_capped(4210, c, n, L, row_bytes=512)
    b = tivf._padded_n_parts_capped(4241, c, n, L, row_bytes=512)
    assert a == b == c + c // 8
    assert tivf._padded_n_parts_capped(c + c // 2, c, n, L, row_bytes=512) >= c + c // 2
    c2, L2, rb = 8192, 2441, 768
    p = tivf._padded_n_parts_capped(c2 + 100, c2, 10_000_000, L2, row_bytes=rb)
    assert (p - (c2 + 100)) * L2 * rb <= tivf._PAD_BYTES_BUDGET + 16 * L2 * rb
    assert tivf._padded_n_parts_capped(26, 24, 6000, 500, row_bytes=64) <= 24 + 6000 // 500 + 1


# -- the probe op and the plain probing path, on carried-over state ----------


def _jax_state(j):
    """A reference IvfIndex's arrays and scalars for ``ivf_state_from_jax``."""
    arrays = {k: (None if getattr(j, "_" + k) is None else np.asarray(getattr(j, "_" + k)))
              for k in ("centroids", "cent_sq", "parts", "part_scale", "part_minv", "part_rows",
                        "part_sq", "kmeans_cents")}
    arrays.update(n=j.n, c=j.c, c_real=j.c_real, part_len=j.part_len, spill=j.spill,
                  storage=j.storage, metric=j.metric.value)
    arrays["aux"] = np.asarray(j._kernel_state()[0])
    return arrays


@pytest.fixture(scope="module", params=[(s, m) for s in ("f32", "sq8") for m in METRICS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def carried(request):
    """A reference index (24 clusters over 4,000 x 32, 15% of rows invalid,
    so splits, pads and dead slots all occur) and the port's copy of it."""
    storage, metric = request.param
    rng = np.random.default_rng(11)
    x = _clustered(rng, 4000, 32, c=8)
    q = _clustered(rng, 8, 32, c=8)
    valid = rng.random(4000) > 0.15
    j = jivf.IvfIndex(32, metric, n_clusters=24, spill=2)
    j.build(j_sq8(jnp.asarray(x)) if storage == "sq8" else x, valid)
    return j, tivf.ivf_state_from_jax(_jax_state(j), "cpu"), q, x, valid


def _close_ids(got, want):
    """Equal id sets up to one near-tie per query (spilled duplicates count
    once)."""
    for g, w in zip(got, want):
        assert len(set(g.tolist()) & set(w.tolist())) >= len(set(w.tolist())) - 1, (g, w)


def test_state_from_jax_carries_the_index(carried):
    j, t, *_ = carried
    assert (t.n, t.c, t.c_real, t.part_len, t.spill, t.storage) == (
        j.n, j.c, j.c_real, j.part_len, j.spill, j.storage)
    assert t._parts.dtype == (torch.int32 if j.storage == "sq8" else torch.float32)
    aux, flat = t._kernel_state()
    assert aux.shape == (t.c, 3, t.part_len) and flat.dtype == torch.int64
    t._kern = None  # derived anew: the same folds, rsqrt to 1 ulp
    np.testing.assert_allclose(t._kernel_state()[0].numpy(), aux.numpy(), rtol=1e-6)


def test_probe_topk_matches_reference(carried):
    """The port's ``ivf_probe_topk`` (plain version of #10) against the
    reference's (Pallas in interpret mode), k 10, nprobe 8."""
    j, t, q, *_ = carried
    k, nprobe = 10, 8
    aux, flat = j._kernel_state()
    jv, ji = j_probe_topk(jnp.asarray(q), j._centroids, j._cent_sq, j._parts, aux, flat, k=k,
                          nprobe=nprobe, metric=j.metric, interpret=True)
    before = dict(tik.LAUNCHES)
    tv, ti = tik.ivf_probe_topk(torch.from_numpy(q), t._centroids, t._cent_sq, t._parts,
                                *t._kernel_state(), k=k, nprobe=nprobe, metric=t.metric)
    assert tik.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    _close_ids(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("mask_kind", ["none", "random", "correlated"])
def test_ivf_search_impl_matches_reference(carried, mask_kind):
    """The plain probing path, with no mask, a random 30% mask, and a mask
    of one cluster's rows (the probes re-aim at the partitions holding
    them), k 28 (spill 2 over-fetch), nprobe 6."""
    j, t, q, x, valid = carried
    rng = np.random.default_rng(12)
    mask = None
    if mask_kind == "random":
        mask = rng.random(4000) < 0.3
    elif mask_kind == "correlated":
        near = np.argmin(((x[:, None, :] - x[None, :8, :]) ** 2).sum(-1), axis=1)
        mask = near == 5
    parts = (j._parts, j._part_scale, j._part_minv) if j.storage == "sq8" else j._parts
    jv, ji = jivf._ivf_search(jnp.asarray(q), j._centroids, j._cent_sq, parts, j._part_rows,
                              j._part_sq, None if mask is None else jnp.asarray(mask), k=28,
                              nprobe=6, metric=j.metric)
    tparts = (t._parts, t._part_scale, t._part_minv) if t.storage == "sq8" else t._parts
    tv, ti = tivf.ivf_search_impl(torch.from_numpy(q), t._centroids, t._cent_sq, tparts,
                                  t._part_rows, t._part_sq,
                                  None if mask is None else torch.from_numpy(mask), k=28,
                                  nprobe=6, metric=t.metric)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    _close_ids(ti.numpy(), np.asarray(ji))
    live = ti.numpy()[ti.numpy() >= 0]
    assert valid[live].all()
    if mask is not None:
        assert mask[live].all()


def test_ivf_search_impl_exclude_rows_matches_reference(carried):
    """``exclude_rows``, the self-kNN probe's option: stored rows as queries,
    each leaving its own row out, k 12, nprobe 4, against the reference's
    ``ivf_search_impl`` on the same partitions."""
    j, t, _, x, valid = carried
    rows = np.flatnonzero(valid)[::400][:10]
    q = x[rows]
    parts = (j._parts, j._part_scale, j._part_minv) if j.storage == "sq8" else j._parts
    jv, ji = jivf.ivf_search_impl(jnp.asarray(q), j._centroids, j._cent_sq, parts, j._part_rows,
                                  j._part_sq, None, k=12, nprobe=4, metric=j.metric,
                                  exclude_rows=jnp.asarray(rows, jnp.int32))
    tparts = (t._parts, t._part_scale, t._part_minv) if t.storage == "sq8" else t._parts
    tv, ti = tivf.ivf_search_impl(torch.from_numpy(q), t._centroids, t._cent_sq, tparts,
                                  t._part_rows, t._part_sq, None, k=12, nprobe=4,
                                  metric=t.metric, exclude_rows=torch.from_numpy(rows))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    _close_ids(ti.numpy(), np.asarray(ji))
    assert not (ti.numpy() == rows[:, None]).any()
    if j.metric.value == "dot_product":
        return  # a row of larger norm can outscore a row's own dot
    # without the option each stored row finds itself
    _, own = tivf.ivf_search_impl(torch.from_numpy(q), t._centroids, t._cent_sq, tparts,
                                  t._part_rows, t._part_sq, None, k=12, nprobe=4,
                                  metric=t.metric)
    assert (own.numpy() == rows[:, None]).any(axis=1).all()
