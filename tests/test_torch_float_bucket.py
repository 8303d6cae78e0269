"""Parity of the port's float-score bucket scans with the JAX package's.

``bucket_topk`` (#2, f32/f16/bf16 corpora), ``bucket_topk_hl`` (#3) and
``sq8_bucket_topk`` (#6) in the port, through their CUDA kernels' plain torch
versions, against the JAX package's Pallas kernels in interpret mode
(``approx_max_k`` is exact on the CPU), on the same seeded numpy inputs. The
reference tests these mirror (``tests/test_streamed.py``) hold each kernel to
an exact oracle at recall@10 >= 0.97, the bucket collision envelope; the
port keeps those floors. Against the reference the two packages sum each dot
in another order, so: ids equal wherever the next score is more than rtol
1e-5 away, and values on shared ids to rtol 1e-5 (fp32 sums of the same
products).

Then the index: each new serve core (``bucket-f32``, ``split-bf16``,
``sq8-bucket``) searching from the reference's own state through
``state_from_jax``, and the ``_SQ8I_MAX_DIM`` dispatch rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu.index.brute as jbrute
import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu_torch.index.brute as tbrute
import velesdb_tpu_torch.ops.bucket_kernel as tbk
from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops import StorageMode as JMode
from velesdb_tpu.ops.chunked import brute_force_topk
from velesdb_tpu.ops.quantization import sq8_dequantize as j_dequantize
from velesdb_tpu.ops.quantization import sq8_quantize as j_quantize
from velesdb_tpu_torch.index.brute import BruteForceIndex as TIndex
from velesdb_tpu_torch.index.brute import state_from_jax

METRICS = ["cosine", "euclidean", "dot_product"]
RTOL = 1e-5
HALF = {"f32": (jnp.float32, torch.float32), "f16": (jnp.float16, torch.float16),
        "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def data():
    """The reference tests' inputs (``tests/test_streamed.py:21``)."""
    rng = np.random.default_rng(7)
    n, d = 4096, 48
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((13, d)).astype(np.float32)
    valid = rng.random(n) > 0.15
    return corpus, queries, valid


def _recall(a, b):
    return np.mean([len(set(x) & set(y)) / len(y) for x, y in zip(a, b)])


def _to_torch(a, dtype=None):
    """numpy (bfloat16 included) -> torch, bits unchanged."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def assert_parity(tv, ti, jv, ji):
    """Ids equal except where neighbouring reference scores lie within rtol
    1e-5 (a near-tie the two summation orders may order apart), values on
    shared ids to rtol 1e-5."""
    tv, ti, jv, ji = (np.asarray(x) for x in (tv, ti, jv, ji))
    assert tv.shape == jv.shape
    for rv, ri, wv, wi in zip(tv, ti, jv, ji):
        ref = dict(zip(wi.tolist(), wv.tolist()))
        for v, i in zip(rv, ri):
            if i in ref and np.isfinite(ref[i]):
                assert abs(v - ref[i]) <= RTOL * abs(ref[i]) + RTOL, (i, v, ref[i])
        for j in np.flatnonzero(ri != wi):
            tol = RTOL * abs(wv[j]) + RTOL
            near = [wv[i] for i in (j - 1, j + 1) if 0 <= i < len(wv)]
            assert any(abs(wv[j] - x) <= tol for x in near), (j, ri, wi)


def _penalty(x, valid, metric):
    if metric == "euclidean":
        return np.where(valid, (x.astype(np.float32) ** 2).sum(1), np.inf).astype(np.float32)
    return np.where(valid, 0.0, np.inf).astype(np.float32)


# -- #2: bucket_topk (reference tests/test_streamed.py:54-71) ---------------


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("metric", METRICS)
def test_bucket_topk_matches_reference(data, metric, dtype):
    corpus, queries, valid = data
    m = JMetric.parse(metric)
    jdt, tdt = HALF[dtype]
    jc = jnp.asarray(corpus).astype(jdt)
    pen = _penalty(np.asarray(jc.astype(jnp.float32)), valid, metric)
    jv, ji = jbk.bucket_topk(queries, jc, penalty=pen, k=10, metric=m, chunk=512,
                             interpret=True)
    tv, ti = tbk.bucket_topk(torch.from_numpy(queries), _to_torch(jc), torch.from_numpy(pen),
                             k=10, metric=metric, chunk=512)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64
    # the exact oracle of the function scored: a half corpus takes queries
    # rounded to its dtype (cosine: after normalizing; 2q rounds as q does)
    qr = queries
    if dtype != "f32":
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True) if metric == "cosine" \
            else queries
        qr = np.asarray(jnp.asarray(qn).astype(jdt).astype(jnp.float32))
    _, gi = brute_force_topk(qr, np.asarray(jc.astype(jnp.float32)), 10, m, valid=valid)
    gi = np.asarray(gi)
    assert _recall(ti.numpy(), gi) >= 0.97  # one winner per 128-lane bucket
    if dtype == "f32":
        assert np.all(ti.numpy()[:, 0] == gi[:, 0])
    assert_parity(tv, ti, jv, ji)
    assert not set(ti.numpy().ravel().tolist()) & set(np.flatnonzero(~valid))


def test_bucket_topk_entry_mask_and_padding():
    """A ragged batch (13 -> 16), width (100 -> 128) and row count (3000 ->
    3072) with a filter folded into the penalty, on a bf16 corpus."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3000, 100)).astype(np.float32)
    q = rng.standard_normal((13, 100)).astype(np.float32)
    mask = rng.random(3000) > 0.3
    jc = jnp.asarray(x).astype(jnp.bfloat16)
    pen = _penalty(np.asarray(jc.astype(jnp.float32)), np.ones(3000, bool), "euclidean")
    jv, ji = jbk.bucket_topk_entry(
        jnp.asarray(q), jc, jnp.asarray(pen), jnp.asarray(mask), k=10,
        metric=JMetric.EUCLIDEAN, chunk=512, interpret=True)
    tv, ti = tbk.bucket_topk_entry(
        torch.from_numpy(q), _to_torch(jc), torch.from_numpy(pen), torch.from_numpy(mask),
        k=10, metric="euclidean", chunk=512)
    assert tv.shape == (13, 10)
    assert mask[ti.numpy()].all()
    assert_parity(tv, ti, jv, ji)


def test_dense_bucket_ref_sums_in_dim_order():
    """The plain version is the fixed-order fp32 sum the kernel computes:
    over bf16 operands every product is exact, so it equals a float64 sum
    rounded to fp32 after every term."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).to(torch.bfloat16)
    rows = torch.from_numpy(rng.standard_normal((256, 16)).astype(np.float32)).to(torch.bfloat16)
    cc = torch.from_numpy(rng.random(256).astype(np.float32))
    gm, gi = tbk.dense_bucket_ref(q, rows, cc, 256)
    qd, rd = q.double().numpy(), rows.double().numpy()
    acc = np.zeros((8, 256), np.float32)
    for w in range(16):
        acc = (acc.astype(np.float64) + qd[:, w, None] * rd[None, :, w]).astype(np.float32)
    s = acc - cc.numpy()[None, :]
    want = np.maximum(s[:, :128], s[:, 128:])
    np.testing.assert_array_equal(gm.numpy(), want)
    np.testing.assert_array_equal(gi.numpy(), np.where(s[:, 128:] > s[:, :128],
                                                       np.arange(128, 256), np.arange(128)))


# -- #6: sq8_bucket_topk (reference tests/test_streamed.py:291-321) ---------


@pytest.mark.parametrize("metric", METRICS)
def test_sq8_bucket_topk_matches_reference(data, metric):
    corpus, queries, valid = data
    m = JMetric.parse(metric)
    sq = j_quantize(jnp.asarray(corpus))
    deq = np.asarray(j_dequantize(sq))
    words = jbk.sq8_pack_blocked(sq.codes)
    dn = (deq ** 2).sum(1)
    scale, minv = np.asarray(sq.scale), np.asarray(sq.minv)
    if metric == "cosine":
        inv = 1.0 / np.maximum(np.sqrt(dn), 1e-30)
        scale, minv = (scale * inv).astype(np.float32), (minv * inv).astype(np.float32)
    pen = np.where(valid, dn if metric == "euclidean" else 0.0, np.inf).astype(np.float32)
    jv, ji = jbk.sq8_bucket_topk(
        jnp.asarray(queries), words, jnp.asarray(scale), jnp.asarray(minv), jnp.asarray(pen),
        k=10, metric=m, chunk=512, interpret=True)
    tv, ti = tbk.sq8_bucket_topk(
        torch.from_numpy(queries), _to_torch(words), torch.from_numpy(scale),
        torch.from_numpy(minv), torch.from_numpy(pen), k=10, metric=metric, chunk=512)
    _, gi = brute_force_topk(queries, deq, 10, m, valid=valid)
    assert _recall(ti.numpy(), np.asarray(gi)) >= 0.97
    assert_parity(tv, ti, jv, ji)


def test_sq8_bucket_ref_unpacks_in_dim_order():
    """Byte j of word w is dim j * (D_pad / 4) + w: the plain version scores
    the unpacked codes exactly as the dequantized dot (D 100 -> 100)."""
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 256, (256, 100)).astype(np.uint8))
    from velesdb_tpu_torch.ops.quantization import sq8_pack_blocked

    words = sq8_pack_blocked(codes)
    q = torch.zeros((8, 100))
    q[0, 57] = 1.0  # picks dim 57 alone
    ones = torch.ones(256)
    gm, gi = tbk.sq8_bucket_ref(q, words, ones, torch.zeros(256), torch.zeros(256),
                                q.sum(1), 256)
    best = torch.maximum(codes[:128, 57], codes[128:, 57]).float()
    assert torch.equal(gm[0], best)


# -- #3: bucket_topk_hl (reference tests/test_streamed.py:499-529) ----------


@pytest.mark.parametrize("metric", METRICS)
def test_bucket_topk_hl_matches_reference(data, metric):
    corpus, queries, valid = data
    m = JMetric.parse(metric)
    xs = corpus.copy()
    if metric == "cosine":
        xs = xs / np.maximum(np.linalg.norm(xs, axis=1, keepdims=True), 1e-30)
    pen = _penalty(xs, valid, metric)
    padded = jnp.pad(jnp.asarray(xs), ((0, 0), (0, 128 - xs.shape[1])))
    hi, lo = jbk.split_f32_rows(padded)
    jv, ji = jbk.bucket_topk_hl(jnp.asarray(queries), hi, lo, jnp.asarray(pen), k=10,
                                metric=m, chunk=512, interpret=True)
    thi, tlo = tbk.split_f32_rows(torch.from_numpy(np.asarray(padded)))
    assert torch.equal(thi, _to_torch(hi)) and torch.equal(tlo, _to_torch(lo))
    tv, ti = tbk.bucket_topk_hl(torch.from_numpy(queries), thi, tlo, torch.from_numpy(pen),
                                k=10, metric=metric, chunk=512)
    gv, gi = brute_force_topk(queries, xs, 10, m, valid=valid)
    gv, gi = np.asarray(gv), np.asarray(gi)
    tv_, ti_ = tv.numpy(), ti.numpy()
    assert _recall(ti_, gi) >= 0.97  # bucket collisions only
    agree = ti_[:, 0] == gi[:, 0]
    assert agree.mean() >= 0.95
    np.testing.assert_allclose(tv_[agree, 0], gv[agree, 0], rtol=2e-4, atol=2e-4)
    assert_parity(tv, ti, jv, ji)


# -- the index: each new core from the reference's state ---------------------

BIG_N, BIG_D = 131_072, 32


@pytest.fixture(scope="module")
def big():
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((64, BIG_D)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 64, BIG_N + 16)] + rng.standard_normal(
        (BIG_N + 16, BIG_D)).astype(np.float32) * 0.7
    valid = np.ones(BIG_N, bool)
    valid[::97] = False
    return x[:BIG_N], x[BIG_N:], valid


def _jstate(j, **extra):
    arrays = {"valid": np.array(j._valid)}
    for key in ("full", "full_sqnorm", "bucket_pen", "sq_norm", "sq8_words", "sq8_scale",
                "sq8_minv", "sq8_pen"):
        value = getattr(j, f"_{key}")
        if value is not None:
            arrays[key] = np.array(value)
    if j._sq8 is not None:
        arrays["sq8"] = tuple(np.array(a) for a in j._sq8)
    arrays.update(extra)
    return state_from_jax(arrays, "cpu")


@pytest.mark.parametrize("mode,metric", [("bf16", "euclidean"), ("f16", "cosine"),
                                         ("bf16", "dot_product")])
def test_bucket_f32_core_from_reference_state(big, mode, metric):
    x, q, valid = big
    j = jbrute.BruteForceIndex(BIG_D, JMetric.parse(metric), JMode.parse(mode))
    j.rebuild(x, valid)
    t = TIndex(BIG_D, metric, mode, device="cpu")
    t.load_state(_jstate(j))
    assert t._full.dtype == HALF[mode][1]
    assert torch.equal(t._full.view(torch.int16), _to_torch(j._full).view(torch.int16))
    assert t.serve_engine() == "bucket-f32"
    mask = np.arange(BIG_N) % 3 != 0
    for msk in (None, mask):
        tv, ti = t.search(q, 10, mask=msk)
        jv, ji = jbk.bucket_topk_entry(
            jnp.asarray(q), j._full, j._bucket_pen, None if msk is None else jnp.asarray(msk),
            k=10, metric=JMetric.parse(metric), chunk=t._chunk, interpret=True)
        assert_parity(tv, ti, jv, ji)
        keep = valid if msk is None else valid & msk
        assert keep[ti.numpy()].all()


def test_split_bf16_core_from_reference_state(big):
    x, q, valid = big
    j = jbrute.BruteForceIndex(BIG_D, JMetric.EUCLIDEAN, JMode.FULL)
    j.rebuild(x, valid)
    padded = jnp.pad(j._full, ((0, 0), (0, 128 - BIG_D)))
    hi, lo = jbk.split_f32_rows(padded)
    t = TIndex(BIG_D, "euclidean", device="cpu")
    t.load_state(_jstate(j, full_hl=(np.array(hi), np.array(lo))))
    assert t.serve_engine() == "split-bf16"
    tv, ti = t.search(q, 10)
    jv, ji = jbk.bucket_topk_hl(jnp.asarray(q), hi, lo, j._bucket_pen, k=10,
                                metric=JMetric.EUCLIDEAN, chunk=t._chunk, interpret=True)
    assert_parity(tv, ti, jv, ji)
    ev, ei = j.search(q, 10)  # the reference's exact result
    assert _recall(ti.numpy(), np.array(ei)) >= 0.99


def test_sq8_bucket_core_from_reference_state(big):
    """On the CPU the reference builds the block-packed words (its int8 rows
    need the TPU), so its own state serves the port's ``sq8-bucket``."""
    x, q, valid = big
    j = jbrute.BruteForceIndex(BIG_D, JMetric.COSINE, JMode.SQ8)
    j.rebuild(x, valid)
    assert j._sq8_words is not None
    t = TIndex(BIG_D, "cosine", "sq8", device="cpu")
    t.load_state(_jstate(j))
    assert t.serve_engine() == "sq8-bucket"
    mask = np.arange(BIG_N) % 2 == 0
    tv, ti = t.search(q, 10, mask=mask)
    pen = jnp.where(jnp.asarray(mask), j._sq8_pen, jnp.inf)
    jv, ji = jbk.sq8_bucket_topk(jnp.asarray(q), j._sq8_words, j._sq8_scale, j._sq8_minv, pen,
                                 k=10, metric=JMetric.COSINE, chunk=t._chunk, interpret=True)
    assert_parity(tv, ti, jv, ji)
    assert (mask & valid)[ti.numpy()].all()


def test_sq8i_max_dim_dispatch(big, monkeypatch):
    """``_SQ8I_MAX_DIM`` is read at rebuild: at or above it FULL builds the
    (hi, lo) shadow where ``sq8pd_build`` refuses (an offset corpus), and
    SQ8 the packed words; below it the int8 shadows, as before."""
    x, q, valid = big
    off = x + 100.0
    for limit, full_engine, sq8_engine in ((1 << 30, "int8-assist", "sq8-int8"),
                                           (BIG_D, "split-bf16", "sq8-bucket")):
        monkeypatch.setattr(tbrute, "_SQ8I_MAX_DIM", [limit])
        full = TIndex(BIG_D, "euclidean", device="cpu")
        full.rebuild(off, valid)
        assert full._assist_pd is None
        assert (full._full_hl is not None) == (full_engine == "split-bf16")
        assert full.serve_engine() == full_engine
        sq8 = TIndex(BIG_D, "euclidean", "sq8", device="cpu")
        sq8.rebuild(x, valid)
        assert (sq8._sq8_words is None) == (sq8_engine == "sq8-int8")
        assert sq8.serve_engine() == sq8_engine
        tv, ti = full.search(q + 100.0, 10)
        assert valid[ti.numpy()].all()
    # the split-bf16 core computes what the reference's does on its shadow;
    # 2 q.c - |c|^2 cancels in fp32 at these norms, so the two summation
    # orders may swap near neighbours: ids agree, values are not compared
    hi, lo = (np.asarray(t.view(torch.int16)).view(jnp.bfloat16) for t in full._full_hl)
    _, ji = jbk.bucket_topk_hl(jnp.asarray(q + 100.0), jnp.asarray(hi), jnp.asarray(lo),
                               jnp.asarray(full._bucket_pen.numpy()), k=10,
                               metric=JMetric.EUCLIDEAN, chunk=full._chunk, interpret=True)
    assert _recall(ti.numpy(), np.asarray(ji)) >= 0.99
    # the guard: a k past the collision bound leaves the bucket cores
    assert full.serve_engine(k=1000) == "streamed-scan"
    assert sq8.serve_engine(k=1000) == "sq8-streamed"


def _offset_recalls(offset):
    """recall@10 of the reference's and the port's split-bf16 scans against
    a float64 oracle on clustered data (``bench.py:41`` model, seed 42,
    131,072 x 128 euclidean, 32 queries) + ``offset`` on every coordinate."""
    rng = np.random.default_rng(42)
    n, d = 131_072, 128
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 64, n + 32)] + rng.standard_normal((n + 32, d)).astype(
        np.float32) * 0.7
    x = (x + np.float32(offset)).astype(np.float32)
    xs, q = x[:n], x[n:]
    pen = (xs * xs).sum(1, dtype=np.float32)
    hi, lo = jbk.split_f32_rows(jnp.asarray(xs))
    _, ji = jbk.bucket_topk_hl(jnp.asarray(q), hi, lo, jnp.asarray(pen), k=10,
                               metric=JMetric.EUCLIDEAN, chunk=8192, interpret=True)
    _, ti = tbk.bucket_topk_hl(torch.from_numpy(q), *tbk.split_f32_rows(torch.from_numpy(xs)),
                               torch.from_numpy(pen), k=10, metric="euclidean", chunk=8192)
    x64, q64 = xs.astype(np.float64), q.astype(np.float64)
    d2 = (q64 ** 2).sum(1)[:, None] + (x64 ** 2).sum(1)[None, :] - 2.0 * q64 @ x64.T
    oracle = np.argsort(d2, axis=1, kind="stable")[:, :10]
    return _recall(np.asarray(ji), oracle), _recall(ti.numpy(), oracle)


def test_split_bf16_offset_corpus_loses_neighbours_in_both_packages():
    """``2 q.c - |c|^2`` cancels in fp32 when the norms dwarf the distances
    (|c|^2 near 1.3e6 at +100 per coordinate: an fp32 ulp of 0.125), so the
    split-bf16 scan loses near neighbours there, in the reference as in the
    port: a property of the form (ROADMAP.md section 3), not of either
    package. Without the offset both find the exact top-10."""
    ref_off, port_off = _offset_recalls(100.0)
    ref_base, port_base = _offset_recalls(0.0)
    print(f"split-bf16 recall@10: offset {ref_off:.4f} (reference) {port_off:.4f} (port); "
          f"no offset {ref_base:.4f} / {port_base:.4f}")
    assert ref_base >= 0.99 and port_base >= 0.99
    assert ref_off < ref_base and port_off < port_base
    assert abs(port_off - ref_off) <= 0.02


def test_full_falls_to_bucket_f32_past_the_assist_guard(big):
    """FULL storage whose assist guard fails for m = 2k - 4 candidates but
    whose bucket guard holds for k serves ``bucket-f32``, as the reference's
    order does (here 2,048 buckets: k 23 .. 41)."""
    x, q, valid = big
    t = TIndex(BIG_D, "euclidean", device="cpu")
    t.rebuild(x, valid)
    assert t.serve_engine(k=10) == "int8-assist-pd"
    assert t.serve_engine(k=30) == "bucket-f32"
    tv, ti = t.search(q, 30)
    ev, ei = brute_force_topk(q, x, 30, JMetric.EUCLIDEAN, valid=valid)
    assert _recall(ti.numpy(), np.asarray(ei)) >= 0.97
