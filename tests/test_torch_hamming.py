"""Parity of the port's three Hamming kernels' plain versions with the JAX package.

Same seeded numpy inputs through ``velesdb_tpu.ops`` (the Pallas kernels in
interpret mode on the CPU) and ``velesdb_tpu_torch.ops`` (the CUDA kernels'
plain torch versions on the CPU), 15% of rows knocked out:

- #5 bit-plane scan (``hamming_mxu_topk``) and #4 packed bucket scan
  (``hamming_bucket_topk``): distances equal exactly, and the id sets equal
  below the k-th distance (one bucket winner per lane: at the k-th distance
  either package may keep any of the tied rows);
- #9 exact top-k (``hamming_topk``): distances and ids equal exactly.

Distances are also held against an exact numpy popcount. The CUDA kernels
are compared with these plain versions bit for bit in
``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu.ops.pallas_kernels as jpk
import velesdb_tpu_torch.ops.bucket_kernel as tbk
import velesdb_tpu_torch.ops.pallas_kernels as tpk
from velesdb_tpu.index.brute import BruteForceIndex as JIndex
from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops import StorageMode as JMode
from velesdb_tpu.ops import binary_quantize as j_pack
from velesdb_tpu_torch.index.brute import BruteForceIndex as TIndex
from velesdb_tpu_torch.index.brute import state_from_jax
from velesdb_tpu_torch.ops.quantization import binary_quantize as t_pack

B = 13


def _clustered(rng, n, d):
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    return centers[rng.integers(0, 64, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


def _numpy_hamming(q, c, d):
    qb, cb = q[:, :d] >= 0, c[:, :d] >= 0
    return (qb[:, None, :] != cb[None, :, :]).sum(-1)


def _below_kth(dist, idx):
    kth = dist[:, -1:]
    return [set(row[m].tolist()) for row, m in zip(idx, dist < kth)]


@pytest.fixture(scope="module", params=[100, 256])
def data(request):
    d = request.param
    rng = np.random.default_rng(d)
    x = _clustered(rng, 16_384 + B, d)
    keep = rng.random(16_384) >= 0.15
    return d, x[:16_384], x[16_384:], keep


def test_hamming_mxu_topk_parity(data):
    d, corpus, queries, keep = data
    bits = np.array(jbk.hamming_bits_rows(jnp.asarray(corpus), d))
    tbits = tbk.hamming_bits_rows(torch.from_numpy(corpus), d)
    np.testing.assert_array_equal(tbits.numpy(), bits)
    csum = bits.astype(np.int32).sum(1)
    aux = np.where(keep, csum, csum + jbk._HAM_BIG).astype(np.int32)
    qbits = np.pad((queries >= 0).astype(np.int8), ((0, 0), (0, bits.shape[1] - d)))
    jd, ji = jbk.hamming_mxu_topk(jnp.asarray(qbits), jnp.asarray(bits), jnp.asarray(aux),
                                  k=10, chunk=8192, interpret=True)
    td, ti = tbk.hamming_mxu_topk(torch.from_numpy(qbits), tbits, torch.from_numpy(aux),
                                  k=10, chunk=8192)
    jd, ji, td, ti = np.array(jd), np.array(ji), td.numpy(), ti.numpy()
    np.testing.assert_array_equal(td, jd)
    assert _below_kth(td, ti) == _below_kth(jd, ji)
    exact = _numpy_hamming(queries, corpus, d)
    np.testing.assert_array_equal(td, np.take_along_axis(exact, ti, 1))
    assert not set(ti.ravel().tolist()) & set(np.flatnonzero(~keep))


def test_hamming_bucket_topk_parity(data):
    d, corpus, queries, keep = data
    packed = np.array(j_pack(corpus))
    pen = np.where(keep, 0.0, np.inf).astype(np.float32)
    jd, ji = jbk.hamming_bucket_topk(
        j_pack(queries), jnp.asarray(packed), jnp.asarray(pen), k=10, chunk=2048,
        interpret=True,
    )
    td, ti = tbk.hamming_bucket_topk(
        t_pack(torch.from_numpy(queries)), t_pack(torch.from_numpy(corpus)),
        torch.from_numpy(pen), k=10, chunk=2048,
    )
    jd, ji, td, ti = np.array(jd), np.array(ji), td.numpy(), ti.numpy()
    np.testing.assert_array_equal(td, jd)
    assert _below_kth(td, ti) == _below_kth(jd, ji)
    exact = _numpy_hamming(queries, corpus, d)
    np.testing.assert_array_equal(td, np.take_along_axis(exact, ti, 1))
    assert not set(ti.ravel().tolist()) & set(np.flatnonzero(~keep))


@pytest.mark.parametrize("n,k", [(8192, 10), (3000, 64), (50, 64), (4096, 1)])
def test_hamming_topk_parity(n, k):
    rng = np.random.default_rng(n + k)
    x = _clustered(rng, n + B, 100)
    corpus, queries = x[:n], x[n:]
    valid = rng.random(n) >= 0.15
    jd, ji = jpk.hamming_topk(j_pack(queries), j_pack(corpus), valid=valid, k=min(k, n),
                              interpret=True)
    td, ti = tpk.hamming_topk(t_pack(torch.from_numpy(queries)), t_pack(torch.from_numpy(corpus)),
                              valid=torch.from_numpy(valid), k=k)
    jd, ji = np.array(jd), np.array(ji)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(ti.numpy(), ji)
    if valid.sum() < k:  # fewer valid rows than k: +inf / -1 empties
        assert (ti.numpy()[:, valid.sum():] == -1).all()


def test_hamming_topk_ties_go_to_the_smallest_row():
    """Every row at the same distance: the first k rows, in order."""
    corpus = np.ones((1000, 64), np.float32)
    queries = np.ones((3, 64), np.float32)
    td, ti = tpk.hamming_topk(t_pack(torch.from_numpy(queries)),
                              t_pack(torch.from_numpy(corpus)), k=7)
    assert (ti.numpy() == np.arange(7)).all() and (td.numpy() == 0).all()


def test_hamming_wrapper_checks():
    before, before9 = dict(tbk.LAUNCHES), dict(tpk.LAUNCHES)
    words = torch.zeros((1024, 4), dtype=torch.int32)
    pen = torch.zeros(1024)
    gm, gi = tbk.hamming_bucket_gm(words[:8].clone(), words, pen, 512)
    assert gm.shape == gi.shape == (8, 256)
    with pytest.raises(TypeError):
        tbk.hamming_bucket_gm(words[:8].float(), words, pen, 512)
    with pytest.raises(ValueError):
        tbk.hamming_bucket_gm(words[:8].clone(), words, pen[:100], 512)
    bits = torch.zeros((1024, 128), dtype=torch.int8)
    aux = torch.zeros(1024, dtype=torch.int32)
    tbk.hamming_mxu_gm(bits[:8].clone(), bits, aux, 1024)
    with pytest.raises(TypeError):
        tbk.hamming_mxu_gm(bits[:8].clone(), bits, aux.float(), 1024)
    with pytest.raises(ValueError):
        tbk.hamming_mxu_gm(bits[:8].clone(), bits, aux, 16_384)
    with pytest.raises(ValueError):
        tpk.hamming_topk(words[:8].clone(), words, valid=torch.ones(10, dtype=torch.bool))
    with pytest.raises(TypeError):
        tpk.hamming_topk(words[:8].clone(), words, valid=torch.ones(1024))
    assert tbk.LAUNCHES == before and tpk.LAUNCHES == before9


@pytest.mark.parametrize("budget,engine", [(None, "hamming-mxu"), ("0", "hamming-bucket")])
def test_state_from_jax_binary_serves_identical_distances(monkeypatch, budget, engine):
    """The reference BINARY index's arrays (packed words, and the bit shadow
    while it fits the budget) through ``state_from_jax``: the port's raw
    search returns the reference's exact distances at every rank."""
    if budget is not None:
        monkeypatch.setenv("VELESDB_HAMMING_MXU_MAX_BYTES", budget)
    rng = np.random.default_rng(17)
    n = 131_072
    x = _clustered(rng, n + B, 100)
    valid = rng.random(n) > 0.1
    j = JIndex(100, JMetric.EUCLIDEAN, JMode.BINARY)
    j.rebuild(x[:n], valid)
    arrays = {"valid": np.array(j._valid), "packed": np.array(j._packed)}
    if budget is None:  # the reference builds its shadow only on a TPU
        bits = jbk.hamming_bits_rows(jnp.asarray(x[:n]), 100)
        csum = np.array(bits).astype(np.int32).sum(1)
        arrays["ham_bits"] = np.array(bits)
        arrays["ham_aux"] = np.where(valid, csum, csum + jbk._HAM_BIG).astype(np.int32)
    t = TIndex(100, "euclidean", "binary", device="cpu")
    t.load_state(state_from_jax(arrays, "cpu"))
    assert t.serve_engine() == engine
    td, ti = t.search(x[n:], 10)
    jd, ji = j.search(x[n:], 10)  # the reference's exact fused scan on the CPU
    np.testing.assert_array_equal(td.numpy(), np.array(jd))
    assert _below_kth(td.numpy(), ti.numpy()) == _below_kth(np.array(jd), np.array(ji))


def _hamming_rerank_topk(queries, packed_q, packed_corpus, penalty, corpus, *, k, m, chunk):
    """The reference's ``hamming_rerank_topk`` (cosine) composed from the
    port's parts: the packed scan (#4) keeps ``m`` coarse winners per query,
    which are gathered from the f32 ``corpus`` and rescored in fp32 over
    their norms. The port serves binary collections with a host rerank
    instead, so this composition lives here and not in the package."""
    _, ci = tbk.hamming_bucket_topk(packed_q, packed_corpus, penalty, k=m, chunk=chunk)
    cand = corpus[ci.clamp_min(0)].float()  # [B, m, D]
    qn = queries / torch.linalg.norm(queries, dim=1, keepdim=True)
    dots = torch.bmm(cand, qn[:, :, None])[:, :, 0]
    dots = dots / torch.sqrt(torch.sum(cand * cand, dim=-1).clamp_min(1e-30))
    vals, order = tbk.first_topk(torch.where(ci < 0, -torch.inf, dots), k)
    return vals, torch.where(vals == -torch.inf, -1, torch.gather(ci, 1, order))


def test_hamming_rerank_topk_matches_oracle():
    """``test_recall_validation.py::test_hamming_rerank_topk_matches_oracle``
    against the port's packed scan, beside the reference on the same inputs:
    the coarse Hamming winners (#4) rescored exactly reach the oracle's ids,
    and the values are the exact cosine scores of the returned ids."""
    rng = np.random.default_rng(5)
    n, d, b, k = 8192, 128, 16, 10
    centers = rng.standard_normal((512, d)).astype(np.float32) * 2.0
    corpus = centers[rng.integers(0, 512, n)] + 0.7 * rng.standard_normal((n, d)).astype(np.float32)
    queries = corpus[rng.integers(0, n, b)] + 0.02 * rng.standard_normal((b, d)).astype(np.float32)
    qt, ct = torch.from_numpy(queries), torch.from_numpy(corpus)
    vals, ids = _hamming_rerank_topk(qt, t_pack(qt), t_pack(ct), torch.zeros(n), ct, k=k, m=64,
                                     chunk=2048)
    jv, ji = jbk.hamming_rerank_topk(
        jnp.asarray(queries), j_pack(jnp.asarray(queries)), j_pack(jnp.asarray(corpus)),
        jnp.zeros(n, jnp.float32), jnp.asarray(corpus), k=k, m=64, metric=JMetric.COSINE,
        chunk=2048, interpret=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ cn.T), axis=1)[:, :k]
    ids = ids.numpy()

    def recall(rows):
        return np.mean([len(set(r.tolist()) & set(g.tolist())) / k for r, g in zip(rows, gt)])

    assert recall(ids) >= 0.9 and recall(ids) >= recall(np.asarray(ji)) - 0.01
    np.testing.assert_allclose(vals.numpy(), np.einsum("bd,bkd->bk", qn, cn[ids]), atol=2e-5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
