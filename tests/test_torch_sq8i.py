"""Parity of the port's per-row SQ8 int8 scan (kernel #7) with the JAX package's.

Same seeded numpy inputs through ``velesdb_tpu.ops.bucket_kernel`` (the
Pallas kernel in interpret mode on the CPU) and
``velesdb_tpu_torch.ops.bucket_kernel`` (the CUDA kernel's plain torch
version on the CPU), from identical SQ8 state: N 16,384, chunk 8192, B 13,
D 100 and 128, three metrics, 15% of rows masked.

Tolerances: values to rtol 1e-6 (both packages round every product of the
epilogue to fp32; XLA may contract one into an FMA), for euclidean on the
scanned score ``|q|^2 - d^2`` (the restore ``sqrt(|q|^2 - s)`` cancels), and
every id whose value is strictly better than the k-th value is returned by
both. The CUDA kernel
itself is compared with the plain version bit for bit on a card in
``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu_torch.ops.bucket_kernel as tbk
from velesdb_tpu.index.brute import BruteForceIndex as JIndex
from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops import StorageMode as JMode
from velesdb_tpu_torch.index.brute import BruteForceIndex as TIndex
from velesdb_tpu_torch.index.brute import _assist_shadow, state_from_jax
from velesdb_tpu_torch.ops.distance import DistanceMetric

N, CHUNK, B = 16_384, 8192, 13
RAW_RECALL = 0.9
METRICS = ["cosine", "euclidean", "dot_product"]


def _clustered(rng, n, d):
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    return centers[rng.integers(0, 64, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


def _sq8_state(x, valid, metric):
    """The reference index's SQ8 scan state, built by its own rebuild."""
    j = JIndex(x.shape[1], JMetric.parse(metric), JMode.SQ8)
    j.rebuild(x, valid)
    if j._sq8_rows8 is None:  # built only where Pallas compiles (a TPU)
        j._sq8_rows8 = jbk.sq8_int8_rows(j._sq8.codes)
    return j


def _better_than_kth(vals, ids, hib):
    kth = vals[:, -1:]
    better = vals > kth if hib else vals < kth
    return [set(row[m].tolist()) for row, m in zip(ids, better)]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [100, 128])
def test_sq8i_bucket_topk_parity(metric, d):
    rng = np.random.default_rng(d)
    x = _clustered(rng, N + B, d)
    valid = np.ones(N, bool)
    j = _sq8_state(x[:N], valid, metric)
    queries = x[N:]
    mask = rng.random(N) >= 0.15
    pen = np.where(mask, np.array(j._sq8_pen), np.inf).astype(np.float32)
    jv, ji = jbk.sq8i_bucket_topk(
        jnp.asarray(queries), j._sq8_rows8, j._sq8_scale, j._sq8_minv, jnp.asarray(pen),
        k=10, metric=JMetric.parse(metric), chunk=CHUNK, interpret=True,
    )
    jv, ji = np.array(jv), np.array(ji)
    tv, ti = tbk.sq8i_bucket_topk(
        torch.from_numpy(queries), torch.from_numpy(np.array(j._sq8_rows8)),
        torch.from_numpy(np.array(j._sq8_scale)), torch.from_numpy(np.array(j._sq8_minv)),
        torch.from_numpy(pen), k=10, metric=metric, chunk=CHUNK,
    )
    tv, ti = tv.numpy(), ti.numpy()
    if metric == "euclidean":  # compare the scanned scores |q|^2 - d^2
        qq = (queries.astype(np.float32) ** 2).sum(1, keepdims=True)
        np.testing.assert_allclose(qq - tv * tv, qq - jv * jv, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    hib = metric != "euclidean"
    assert _better_than_kth(tv, ti, hib) == _better_than_kth(jv, ji, hib)
    assert not set(ti.ravel().tolist()) & set(np.flatnonzero(~mask))


def test_sq8_int8_rows_match_reference():
    codes = np.random.default_rng(1).integers(0, 256, (300, 100)).astype(np.uint8)
    got = tbk.sq8_int8_rows(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, np.array(jbk.sq8_int8_rows(jnp.asarray(codes))))


def test_bucket_select_tie_rule_matches_reference():
    """Ties within a bucket go to the smallest slice; all -inf gives slice 0."""
    rng = np.random.default_rng(2)
    s = rng.integers(0, 4, (8, 4096)).astype(np.float32)  # many ties
    s[:, 128:256] = -np.inf
    s[:, :128] = -np.inf  # first chunk's first two slices empty
    s[3, : 1024] = -np.inf  # a whole chunk empty for one query
    jm, jg = jbk._bucket_select(jnp.asarray(s[:, :1024]), 0)
    tm, tg = tbk._bucket_select(torch.from_numpy(s), 1024)
    np.testing.assert_array_equal(tm.numpy()[:, :128], np.array(jm))
    np.testing.assert_array_equal(tg.numpy()[:, :128], np.array(jg))
    assert (tg.numpy()[3, :128] == np.arange(128)).all()


@pytest.mark.parametrize("metric", METRICS)
def test_sq8i_rerank_parity(metric):
    """The FULL int8-assist core from the reference's own per-row shadow
    (uncentered): ids as the reference's, values to rtol 1e-5."""
    rng = np.random.default_rng(5)
    x = _clustered(rng, N + B, 48)
    corpus = x[:N]
    if metric == "cosine":
        corpus = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    sq = jbk.sq8_int8_rows
    from velesdb_tpu.ops import sq8_quantize as j_sq8

    q8 = j_sq8(jnp.asarray(corpus))
    j = _sq8_state(x[:N], np.ones(N, bool), metric)  # same per-metric fold
    kw = dict(k=10, m=40, chunk=CHUNK)
    jv, ji = jbk.sq8i_rerank_topk(
        jnp.asarray(x[N:]), sq(q8.codes), j._sq8_scale, j._sq8_minv, j._sq8_pen,
        jnp.asarray(corpus), metric=JMetric.parse(metric), interpret=True, **kw,
    )
    tv, ti = tbk.sq8i_rerank_topk(
        torch.from_numpy(x[N:]), torch.from_numpy(np.array(sq(q8.codes))),
        torch.from_numpy(np.array(j._sq8_scale)), torch.from_numpy(np.array(j._sq8_minv)),
        torch.from_numpy(np.array(j._sq8_pen)), torch.from_numpy(corpus),
        metric=DistanceMetric.parse(metric), **kw,
    )
    jv, ji, tv, ti = np.array(jv), np.array(ji), tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    differ = ti != ji
    assert np.all(np.abs(tv[differ] - jv[differ]) <= 1e-5 * np.abs(jv[differ]) + 1e-5)


def test_sq8i_wrapper_checks():
    before = dict(tbk.LAUNCHES)
    qi = torch.zeros((8, 128), dtype=torch.int8)
    rows = torch.zeros((1024, 128), dtype=torch.int8)
    f, fq = torch.zeros(1024), torch.ones(8)
    gm, gi = tbk.sq8i_bucket_gm(qi, rows, f, f, f, fq, fq, 512)
    assert gm.shape == gi.shape == (8, 256) and gm.dtype == torch.float32
    assert gi.dtype == torch.int32
    with pytest.raises(TypeError):
        tbk.sq8i_bucket_gm(qi, rows, f.double(), f, f, fq, fq, 512)
    with pytest.raises(ValueError):
        tbk.sq8i_bucket_gm(qi, rows, f, f, f, fq, fq, 384)  # does not divide N
    with pytest.raises(ValueError):
        tbk.sq8i_bucket_gm(qi[:, :120], rows[:, :120], f, f, f, fq, fq, 512)
    with pytest.raises(ValueError):
        tbk.sq8i_bucket_gm(qi, rows, f[:512], f, f, fq, fq, 512)
    with pytest.raises(ValueError):  # neither the CPU version nor the kernel
        tbk.sq8i_bucket_gm(*(t.to("meta") for t in (qi, rows, f, f, f, fq, fq)), 512)
    assert tbk.LAUNCHES == before  # the CPU path never counts


def _offset_data(n=65_536, d=128, b=32):
    x = _clustered(np.random.default_rng(42), n + b, d) + 100.0
    corpus, queries = x[:n], x[n:]
    c64, q64 = corpus.astype(np.float64), queries.astype(np.float64)
    d2 = (q64 * q64).sum(1)[:, None] + (c64 * c64).sum(1)[None, :] - 2.0 * q64 @ c64.T
    return corpus, queries, np.argsort(d2, axis=1)[:, :10]


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


def test_int8_assist_offset_corpus_reference_fault():
    """A FULL euclidean corpus offset by 100 per coordinate: ``sq8pd_build``
    refuses it in both packages and the per-row int8 assist serves. The
    reference quantizes the raw rows, whose per-row codes spend their range
    on the offset, and reranks with ``|q|^2 + |c|^2 - 2 q.c``, which cancels
    in fp32 at these norms. The port centers the shadow on the mean and
    reranks by differences (ROADMAP.md, faults of the reference)."""
    corpus, queries, truth = _offset_data()
    valid = np.ones(corpus.shape[0], bool)
    assert jbk.sq8pd_build(jnp.asarray(corpus), jnp.asarray(valid), 128,
                           JMetric.EUCLIDEAN) is None
    from velesdb_tpu.index.brute import _deq_sqnorm
    from velesdb_tpu.ops import sq8_quantize as j_sq8

    sq = j_sq8(jnp.asarray(corpus))
    pen = _deq_sqnorm(sq.codes, sq.scale, sq.minv)
    _, ji = jbk.sq8i_rerank_topk(
        jnp.asarray(queries), jbk.sq8_int8_rows(sq.codes), sq.scale, sq.minv, pen,
        jnp.asarray(corpus), k=10, m=16, metric=JMetric.EUCLIDEAN, chunk=CHUNK,
        interpret=True,
    )
    full = torch.from_numpy(corpus)
    rows8, scale, minv, pen_t, shift = _assist_shadow(
        full, torch.from_numpy(valid), DistanceMetric.EUCLIDEAN
    )
    _, ti = tbk.sq8i_rerank_topk(
        torch.from_numpy(queries), rows8, scale, minv, pen_t, full, k=10, m=16,
        metric=DistanceMetric.EUCLIDEAN, chunk=CHUNK, shift=shift,
    )
    reference, port = _recall(np.array(ji), truth), _recall(ti.numpy(), truth)
    assert reference < 0.95, reference
    assert port >= 0.99, port


def test_state_from_jax_sq8_serves_identical_results():
    """The reference SQ8 index's arrays, handed over with ``state_from_jax``,
    serve through ``sq8-int8`` what the reference serves from them."""
    rng = np.random.default_rng(9)
    x = _clustered(rng, 131_072 + B, 64)
    valid = rng.random(131_072) > 0.1
    j = _sq8_state(x[:131_072], valid, "cosine")
    arrays = {
        "valid": np.array(j._valid), "sq_norm": np.array(j._sq_norm),
        "sq8": tuple(np.array(a) for a in j._sq8), "sq8_rows8": np.array(j._sq8_rows8),
        "sq8_scale": np.array(j._sq8_scale), "sq8_minv": np.array(j._sq8_minv),
        "sq8_pen": np.array(j._sq8_pen),
    }
    t = TIndex(64, "cosine", "sq8", device="cpu")
    t.load_state(state_from_jax(arrays, "cpu"))
    assert t.serve_engine() == "sq8-int8"
    tv, ti = t.search(x[131_072:], 10)
    jv, ji = jbk.sq8i_bucket_topk(
        jnp.asarray(x[131_072:]), j._sq8_rows8, j._sq8_scale, j._sq8_minv, j._sq8_pen,
        k=10, metric=JMetric.COSINE, chunk=t._chunk, interpret=True,
    )
    np.testing.assert_allclose(tv.numpy(), np.array(jv), rtol=1e-6, atol=1e-6)
    assert _better_than_kth(tv.numpy(), ti.numpy(), True) == _better_than_kth(
        np.array(jv), np.array(ji), True
    )
    # the reference's raw search on the CPU is its fused exact SQ8 scan: the
    # int8 coarse pass (queries quantized too) finds most of its top-10
    _, want = j.search(x[131_072:], 10)
    assert _recall(ti.numpy(), np.array(want)) >= RAW_RECALL


def test_state_from_jax_full_assist_serves_the_reference_candidates(monkeypatch):
    """The reference FULL index's per-row ``_assist`` shadow (built where its
    ``sq8pd_build`` refuses the corpus), handed over with ``state_from_jax``:
    ``int8-assist`` serves from the same coarse candidates the reference's
    #7 finds in that shadow, reranked to exact fp32 distances."""
    from velesdb_tpu.index import brute as jbrute

    monkeypatch.setattr(jbrute, "use_pallas", lambda: True)  # builds _assist
    n, d = 131_072, 64
    x = _clustered(np.random.default_rng(12), n + 16, d) + 100.0
    valid = np.random.default_rng(13).random(n) > 0.1
    j = JIndex(d, JMetric.EUCLIDEAN, JMode.FULL)
    j.rebuild(x[:n], valid)
    assert j._assist_pd is None and j._assist is not None
    arrays = {
        "valid": np.array(j._valid), "full": np.array(j._full),
        "full_sqnorm": np.array(j._full_sqnorm),
        "assist": tuple(np.array(a) for a in j._assist),
    }
    t = TIndex(d, "euclidean", device="cpu")
    t.load_state(state_from_jax(arrays, "cpu"))
    assert t.serve_engine() == "int8-assist"
    tv, ti = t.search(x[n:], 10)
    rows8, scale, minv, pen = j._assist
    _, cand = jbk.sq8i_bucket_topk(
        jnp.asarray(x[n:]), rows8, scale, minv, pen, k=16, metric=JMetric.EUCLIDEAN,
        chunk=t._chunk, interpret=True,
    )
    cand, ti = np.array(cand), ti.numpy()
    for row in range(ti.shape[0]):
        assert set(ti[row].tolist()) <= set(cand[row].tolist())
    exact = np.linalg.norm(x[:n][ti].astype(np.float64) - x[n:, None, :], axis=-1)
    np.testing.assert_allclose(tv.numpy(), exact, rtol=1e-5)
