"""Half-precision storage (F16, BF16) in the port against the JAX package.

The streamed scan over a half corpus against the reference's
``streamed_topk(approx=False)`` (queries cast to the corpus dtype, fp32
sums): ids equal except at near-ties, values to rtol 1e-5. Then collections
through ``Database``: a small BF16/F16 collection as in the reference's
``tests/test_collection.py:93`` (self-match), and one past
``BUCKET_MIN_ROWS`` that serves ``bucket-f32`` through the kernel's plain
version, filters, and reopens. The reference serves its exact fused program
on the CPU with f32 queries; the port, like the reference on the TPU, rounds
the queries to the corpus dtype, so the two agree on ids to recall@10 >=
0.95 (bf16 queries carry 8 mantissa bits) and the port is held to the exact
oracle of the function it computes at recall@10 >= 0.97 (bucket collisions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu
import velesdb_tpu_torch
from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops.streamed import streamed_topk as j_streamed
from velesdb_tpu_torch.ops.streamed import streamed_topk as t_streamed

DT = {"f16": (jnp.float16, torch.float16), "bf16": (jnp.bfloat16, torch.bfloat16)}
CAT3 = {"type": "eq", "field": "cat", "value": 3}


def _recall(a, b):
    return np.mean([len(set(x) & set(y)) / len(y) for x, y in zip(a, b)])


@pytest.mark.parametrize("dtype", ["f16", "bf16"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product"])
def test_streamed_half_corpus_matches_reference(dtype, metric):
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(17)
    x = rng.standard_normal((3000, 600)).astype(np.float32)  # D >= 512
    q = rng.standard_normal((13, 600)).astype(np.float32)
    valid = rng.random(3000) > 0.15
    jc = jnp.asarray(x).astype(jdt)
    cn = np.asarray(jnp.sum(jc.astype(jnp.float32) ** 2, axis=1))
    jv, ji = j_streamed(q, jc, valid=valid, k=10, metric=JMetric.parse(metric), chunk=1024,
                        corpus_sqnorm=cn, approx=False)
    tc = torch.from_numpy(x).to(tdt)
    tv, ti = t_streamed(torch.from_numpy(q), tc, valid=torch.from_numpy(valid), k=10,
                        metric=metric, chunk=1024, corpus_sqnorm=torch.from_numpy(cn))
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    for rv, ri, wv, wi in zip(tv, ti, jv, ji):
        for j in np.flatnonzero(ri != wi):
            tol = 1e-5 * abs(wv[j]) + 1e-5
            assert any(abs(wv[j] - wv[i]) <= tol for i in (j - 1, j + 1) if 0 <= i < len(wv))
    assert valid[ti].all()


@pytest.mark.parametrize("mode", ["f16", "bf16"])
def test_small_half_collection_matches_reference(tmp_path, mode):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((200, 256)).astype(np.float32)
    ref = velesdb_tpu.Database.open(str(tmp_path / "ref")).create_collection(
        "m", 256, metric="cosine", storage_mode=mode)
    db = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu")
    col = db.create_collection("m", 256, metric="cosine", storage_mode=mode)
    for c in (ref, col):
        c.upsert_bulk(range(200), vecs)
    res = col.search(vecs[5], k=10)
    assert res[0]["id"] == 5  # self-match survives the half cast
    assert col.info()["serve_engine"] == "streamed-scan"
    assert col._brute._full.dtype == DT[mode][1]
    got = col.search_batch(vecs[:8] + 0.1, k=10)
    want = ref.search_batch(vecs[:8] + 0.1, k=10)
    assert _recall([[h.id for h in r] for r in got], [[h.id for h in r] for r in want]) >= 0.95
    for g, w in zip(got, want):
        assert g[0].id == w[0].id
        np.testing.assert_allclose(g[0].score, w[0].score, rtol=1e-2)


BIG_N, BIG_D = 140_000, 16


@pytest.fixture(scope="module")
def big():
    rng = np.random.default_rng(23)
    centers = rng.standard_normal((64, BIG_D)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 64, BIG_N + 16)] + rng.standard_normal(
        (BIG_N + 16, BIG_D)).astype(np.float32) * 0.7
    return x[:BIG_N], x[BIG_N:]


def _same_function_oracle(x, q, mode, metric, keep):
    """Exact top-10 of what bucket-f32 scores: the queries rounded to the
    corpus dtype (cosine: normalized first) against the rows as stored, less
    the f32 rows' squared norms (euclidean), ``bf16(2q).bf16(c) - |c|^2``."""
    jdt, _ = DT[mode]
    rows = x / np.linalg.norm(x, axis=1, keepdims=True) if metric == "cosine" else x
    sqn = (rows.astype(np.float64) ** 2).sum(1)
    rows = np.asarray(jnp.asarray(rows).astype(jdt).astype(jnp.float32)).astype(np.float64)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cosine" else q
    qr = np.asarray(jnp.asarray(qn).astype(jdt).astype(jnp.float32)).astype(np.float64)
    s = 2.0 * qr @ rows.T - sqn[None, :] if metric == "euclidean" else qr @ rows.T
    s = np.where(keep[None, :], s, -np.inf)
    return np.argsort(-s, axis=1)[:, :10]


@pytest.mark.parametrize("mode,metric", [("bf16", "euclidean"), ("f16", "cosine")])
def test_half_collection_serves_bucket_f32(tmp_path, big, mode, metric):
    x, q = big
    payloads = [{"cat": i % 4} for i in range(BIG_N)]
    ref = velesdb_tpu.Database.open(str(tmp_path / "ref")).create_collection(
        "h", BIG_D, metric=metric, storage_mode=mode)
    db = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu")
    col = db.create_collection("h", BIG_D, metric=metric, storage_mode=mode)
    for c in (ref, col):
        c.upsert_bulk(range(BIG_N), x, payloads)
    col.delete(17)
    ref.delete(17)
    got = col.search_batch(q, k=10)
    info = col.info()
    assert info["serve_engine"] == "bucket-f32" and info["storage_mode"] == mode
    assert info["storage_recall"] is None and col._rerank_oversample == 4.0  # no auto-rerank
    live = np.arange(BIG_N) != 17
    ids = [[h.id for h in r] for r in got]
    assert _recall(ids, _same_function_oracle(x, q, mode, metric, live)) >= 0.97
    want = ref.search_batch(q, k=10)
    assert _recall(ids, [[h.id for h in r] for r in want]) >= 0.95
    filtered = col.search_batch(q, k=10, filter=CAT3)
    assert all(h.payload == {"cat": 3} and h.id % 4 == 3 for r in filtered for h in r)
    cat3 = live & (np.arange(BIG_N) % 4 == 3)
    assert _recall([[h.id for h in r] for r in filtered],
                   _same_function_oracle(x, q, mode, metric, cat3)) >= 0.97
    db.close()
    col = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu").get_collection("h")
    assert col.storage_mode.value == mode and col.count() == BIG_N - 1
    assert [[h.id for h in r] for r in col.search_batch(q, k=10)] == ids


@pytest.mark.parametrize("mode,d", [("bf16", 20), ("f16", 16)])
def test_bucket_f32_hands_the_stored_rows_to_the_kernel(monkeypatch, mode, d):
    """The float rows are stored once, zero-padded in width to a multiple of
    8 (the kernel's row width), and ``bucket-f32`` hands that buffer to the
    kernel's wrapper without a copy; the result equals the scan of the
    unpadded rows."""
    import velesdb_tpu_torch.ops.bucket_kernel as tbk
    from velesdb_tpu_torch.index.brute import BruteForceIndex

    n = 131_072
    x = np.random.default_rng(d).standard_normal((n + 8, d)).astype(np.float32)
    index = BruteForceIndex(d, "euclidean", mode, device="cpu")
    index.rebuild(x[:n], np.ones(n, bool))
    assert index.serve_engine() == "bucket-f32"
    assert tuple(index._full.shape) == (n, d)
    assert tuple(index._full_w.shape) == (n, -(-d // 8) * 8)
    assert index._full.data_ptr() == index._full_w.data_ptr()
    seen, real = [], tbk.dense_bucket_gm

    def spy(q, rows, cc, chunk):
        seen.append(rows.data_ptr())
        return real(q, rows, cc, chunk)

    monkeypatch.setattr(tbk, "dense_bucket_gm", spy)
    q = torch.from_numpy(x[n:])
    vals, ids = index.search(q, 10)
    assert seen == [index._full_w.data_ptr()]
    want_v, want_i = tbk.bucket_topk_entry(q, index._full.contiguous(), index._bucket_pen,
                                           k=10, metric="euclidean", chunk=index._chunk)
    assert torch.equal(ids, want_i) and torch.equal(vals, want_v)
