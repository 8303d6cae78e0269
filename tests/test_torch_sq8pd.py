"""Parity of the port's pd family (per-dim int8 enc-select + exact rerank).

Same seeded numpy inputs through ``velesdb_tpu.ops.bucket_kernel`` (the
Pallas kernel in interpret mode on the CPU) and
``velesdb_tpu_torch.ops.bucket_kernel`` (the CUDA kernel's plain torch
version on the CPU), at 4096 x 48, chunk 512, 13 queries, 15% invalid rows.

Tolerances:
- ``sq8pd_build``: ``sdim``/``mid``/``qu`` exact; ``rows_pd`` and ``pen_int``
  within +-1 on at most 0.01% of entries (XLA and torch may round a value
  sitting on a .5 boundary differently); ``pen_f32`` to rtol 1e-6 (sum
  order; the port sums in the order XLA uses on the CPU, see ``_row_sumsq``).
- ``sq8pd_ptile``: exact.
- ``sq8pd_candidates`` from identical shadows: ids agree on >= 99% of
  (query, rank) entries, and every disagreement is a pair whose encoded
  values are equal after a float32 cast (the reference selects on an f32
  cast of the int32 tile; the port selects on the int32 tile itself).
- ``sq8pd_rerank_topk``: values to rtol 1e-5 (fp32 dots, different order),
  ids equal except at ties under 1e-5. Cosine queries go in normalized: the
  port normalizes them before the coarse pass and the reference does not
  (ROADMAP.md, faults of the reference), so raw queries would compare a fix
  with the fault.

The CUDA kernel itself is compared with this plain version on a card in
``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu_torch.ops.bucket_kernel as tbk
from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu_torch.index.brute import state_from_jax

METRICS = ["cosine", "euclidean", "dot_product"]
CHUNK = 512
DIM = 48


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    corpus = rng.standard_normal((4096, DIM)).astype(np.float32)
    queries = rng.standard_normal((13, DIM)).astype(np.float32)
    valid = rng.random(4096) > 0.15
    return corpus, queries, valid


def _corpus_for(corpus, metric):
    if metric == "cosine":  # the index stores cosine rows pre-normalized
        return corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    return corpus


@pytest.fixture(scope="module", params=METRICS)
def shadows(request, data):
    """(metric, corpus, JAX shadow as numpy, port shadow, port state)."""
    metric = request.param
    corpus, _, valid = data
    c = _corpus_for(corpus, metric)
    jpd = jbk.sq8pd_build(jnp.asarray(c), jnp.asarray(valid), DIM, JMetric.parse(metric))
    names = ("rows_pd", "pen_int", "pen_f32", "sdim", "mid")
    jnp_pd = {k: np.array(v) for k, v in zip(names, jpd[:5])}
    jnp_pd["qu"] = jpd[5]
    tpd = tbk.sq8pd_build(torch.from_numpy(c), torch.from_numpy(valid), DIM, metric)
    arrays = dict(jnp_pd, full=c, valid=valid, full_sqnorm=(c * c).sum(1))
    state = state_from_jax(arrays, "cpu")
    return metric, c, jnp_pd, tpd, state


def test_sq8pd_build_parity(shadows):
    _, _, j, t, _ = shadows
    assert t is not None
    rows_pd, pen_int, pen_f32, sdim, mid, qu = t
    np.testing.assert_array_equal(sdim.numpy(), j["sdim"])
    np.testing.assert_array_equal(mid.numpy(), j["mid"])
    assert qu == j["qu"]
    for got, want in ((rows_pd.numpy(), j["rows_pd"]), (pen_int.numpy(), j["pen_int"])):
        assert got.dtype == want.dtype
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1
        assert np.count_nonzero(diff) <= 1e-4 * diff.size
    np.testing.assert_allclose(pen_f32.numpy(), j["pen_f32"], rtol=1e-6)


def test_sq8pd_ptile_parity(shadows):
    _, _, j, _, state = shadows
    want = np.array(jbk.sq8pd_ptile(jnp.asarray(j["pen_int"]), CHUNK))
    got = tbk.sq8pd_ptile(state["assist_pd"][1], CHUNK).numpy()
    np.testing.assert_array_equal(got, want)


def _enc(idx, val):
    return val.astype(np.int64) * 64 + (idx % CHUNK) // 128


def test_sq8pd_candidates_parity(shadows, data):
    metric, _, j, _, state = shadows
    _, queries, _ = data
    m = 40
    jptile = jbk.sq8pd_ptile(jnp.asarray(j["pen_int"]), CHUNK)
    ji, jv = jbk.sq8pd_candidates(
        jnp.asarray(queries), jnp.asarray(j["rows_pd"]), jptile,
        jnp.asarray(j["sdim"]), j["qu"], m=m, chunk=CHUNK, dim=DIM, interpret=True,
    )
    ji, jv = np.array(ji), np.array(jv)
    rows_pd, pen_int, _, sdim, _, qu = state["assist_pd"]
    ti, tv = tbk.sq8pd_candidates(
        torch.from_numpy(queries), rows_pd, tbk.sq8pd_ptile(pen_int, CHUNK), sdim,
        qu, m=m, chunk=CHUNK, dim=DIM,
    )
    ti, tv = ti.numpy(), tv.numpy()
    assert (ji >= 0).all() and (ti >= 0).all()
    same = ti == ji
    assert same.mean() >= 0.99, same.mean()
    je, te = _enc(ji, jv), _enc(ti, tv)
    np.testing.assert_array_equal(
        te[~same].astype(np.float32), je[~same].astype(np.float32)
    )
    assert np.all(np.diff(te, axis=1) <= 0)  # exact int order, best first


def test_sq8pd_topk_coarse_values_parity(shadows, data):
    """Coarse-only top-k with metric-native values restored, from identical
    shadows: ids as for the candidates, values to rtol 1e-5 where ids agree."""
    metric, _, j, _, state = shadows
    _, queries, valid = data
    jptile = jbk.sq8pd_ptile(jnp.asarray(j["pen_int"]), CHUNK)
    jv, ji = jbk.sq8pd_topk(
        jnp.asarray(queries), jnp.asarray(j["rows_pd"]), jptile, jnp.asarray(j["sdim"]),
        jnp.asarray(j["mid"]), j["qu"], k=10, chunk=CHUNK, dim=DIM,
        metric=JMetric.parse(metric), interpret=True,
    )
    jv, ji = np.array(jv), np.array(ji)
    rows_pd, pen_int, _, sdim, mid, qu = state["assist_pd"]
    tv, ti = tbk.sq8pd_topk(
        torch.from_numpy(queries), rows_pd, tbk.sq8pd_ptile(pen_int, CHUNK), sdim, mid,
        qu, k=10, chunk=CHUNK, dim=DIM, metric=metric,
    )
    tv, ti = tv.numpy(), ti.numpy()
    same = ti == ji
    assert same.mean() >= 0.99
    np.testing.assert_allclose(tv[same], jv[same], rtol=1e-5, atol=1e-5)
    assert not set(ti.ravel().tolist()) & set(np.flatnonzero(~valid))


def test_sq8pd_rerank_parity(shadows, data):
    metric, c, j, _, state = shadows
    _, queries, valid = data
    if metric == "cosine":
        queries = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    kw = dict(k=10, m=40, chunk=CHUNK, dim=DIM)
    jptile = jbk.sq8pd_ptile(jnp.asarray(j["pen_int"]), CHUNK)
    jv, ji = jbk.sq8pd_rerank_topk(
        jnp.asarray(queries), jnp.asarray(j["rows_pd"]), jptile,
        jnp.asarray(j["sdim"]), j["qu"], jnp.asarray(c),
        metric=JMetric.parse(metric), interpret=True, **kw,
    )
    jv, ji = np.array(jv), np.array(ji)
    rows_pd, pen_int, _, sdim, _, qu = state["assist_pd"]
    tv, ti = tbk.sq8pd_rerank_topk(
        torch.from_numpy(queries), rows_pd, tbk.sq8pd_ptile(pen_int, CHUNK), sdim,
        qu, state["full"], metric=tbk.DistanceMetric.parse(metric), **kw,
    )
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    differ = ti != ji
    assert np.all(np.abs(tv[differ] - jv[differ]) <= 1e-5 * np.abs(jv[differ]) + 1e-6)
    assert not set(ti.ravel().tolist()) & set(np.flatnonzero(~valid))


def test_sq8pd_mask_knockout_and_empties(shadows, data):
    metric, _, _, _, state = shadows
    _, queries, valid = data
    rows_pd, pen_int, _, sdim, _, qu = state["assist_pd"]
    ptile = tbk.sq8pd_ptile(pen_int, CHUNK)
    kw = dict(k=10, m=40, chunk=CHUNK, dim=DIM, metric=tbk.DistanceMetric.parse(metric))
    q = torch.from_numpy(queries)
    _, ids = tbk.sq8pd_rerank_topk(q, rows_pd, ptile, sdim, qu, state["full"], **kw)
    banned = ids[:, 0].numpy()
    mask = valid.copy()
    mask[banned] = False
    knock = -64 * tbk._pd_invalid_pen(DIM)
    ptile_m = torch.where(torch.from_numpy(mask), ptile, knock)
    _, ids_m = tbk.sq8pd_rerank_topk(q, rows_pd, ptile_m, sdim, qu, state["full"], **kw)
    ids_m = ids_m.numpy()
    for i, b in enumerate(banned):
        assert b not in ids_m[i]
    # only 4 rows pass: 6 empty slots per query come back as -1
    keep = np.flatnonzero(valid)[:4]
    few = np.zeros_like(valid)
    few[keep] = True
    ptile_f = torch.where(torch.from_numpy(few), ptile, knock)
    vals_f, ids_f = tbk.sq8pd_rerank_topk(q, rows_pd, ptile_f, sdim, qu, state["full"], **kw)
    ids_f, vals_f = ids_f.numpy(), vals_f.numpy()
    for row in ids_f:
        assert set(row[:4].tolist()) == set(keep.tolist())
        assert np.all(row[4:] == -1)
    worst = np.inf if metric == "euclidean" else -np.inf
    assert np.all(vals_f[:, 4:] == worst)


def test_sq8pd_negative_enc_decode():
    """Every enc is negative here (pen_int dominates doti): the decode
    ``i = enc & 63``, ``val = (enc - i) // 64`` must still return the exact
    per-bucket winner, as a numpy brute force and the reference find it."""
    rng = np.random.default_rng(3)
    n, d_pad, chunk = 1024, 128, 512
    rows = rng.integers(-127, 128, (n, d_pad)).astype(np.int8)
    pen_int = rng.integers(1_000_000, 2_000_000, n).astype(np.int32)
    sdim = np.ones(d_pad, np.float32)
    qu = 2.0
    queries = rng.integers(-120, 120, (8, d_pad)).astype(np.float32)  # qi = q
    ptile = tbk.sq8pd_ptile(torch.from_numpy(pen_int), chunk)
    ti, tv = tbk.sq8pd_candidates(
        torch.from_numpy(queries), torch.from_numpy(rows), ptile,
        torch.from_numpy(sdim), qu, m=5, chunk=chunk, dim=d_pad,
    )
    ti, tv = ti.numpy(), tv.numpy()
    assert (tv < 0).all()
    score = queries.astype(np.int64) @ rows.T.astype(np.int64) - pen_int[None, :]
    for b in range(queries.shape[0]):
        buckets = {}
        for r in range(n):
            key = (r // chunk, r % 128)
            enc = score[b, r] * 64 + (r % chunk) // 128
            if key not in buckets or enc > buckets[key][0]:
                buckets[key] = (enc, r)
        top = sorted(buckets.values(), reverse=True)[:5]
        assert ti[b].tolist() == [r for _, r in top]
        assert tv[b].tolist() == [score[b, r] for _, r in top]
    ji, jv = jbk.sq8pd_candidates(
        jnp.asarray(queries), jnp.asarray(rows), jnp.asarray(ptile.numpy()),
        jnp.asarray(sdim), qu, m=5, chunk=chunk, dim=d_pad, interpret=True,
    )
    np.testing.assert_array_equal(np.array(jv), tv)


def test_bucket_gm_wrapper_checks():
    before = tbk.LAUNCHES["sq8pd_bucket_gm"]
    qi = torch.zeros((8, 128), dtype=torch.int8)
    rows = torch.zeros((1024, 128), dtype=torch.int8)
    ptile = torch.zeros(1024, dtype=torch.int32)
    gm = tbk.sq8pd_bucket_gm(qi, rows, ptile, 512)
    assert gm.shape == (8, 256) and gm.dtype == torch.int32
    with pytest.raises(TypeError):
        tbk.sq8pd_bucket_gm(qi.float(), rows, ptile, 512)
    with pytest.raises(ValueError):
        tbk.sq8pd_bucket_gm(qi, rows, ptile, 384)  # does not divide N
    with pytest.raises(ValueError):
        tbk.sq8pd_bucket_gm(qi, rows, ptile, 16384)  # slice index past 6 bits
    with pytest.raises(ValueError):
        tbk.sq8pd_bucket_gm(qi[:, :126], rows[:, :126], ptile, 512)
    with pytest.raises(ValueError):  # neither the CPU twin nor the CUDA kernel
        tbk.sq8pd_bucket_gm(qi.to("meta"), rows.to("meta"), ptile.to("meta"), 512)
    assert tbk.LAUNCHES["sq8pd_bucket_gm"] == before  # the CPU path never counts
