"""BINARY storage under the hamming and jaccard metrics, the set-metric host
rerank and the storage gate: the port against the JAX package on the CPU.

The same seeded numpy data goes through both packages' public entry points:

- BINARY x {hamming, jaccard} at 20,000 x 100 (the reference's
  ``test_recall_validation.py`` recipe, seed 23, 512 centres) and at 8,192 x
  256 bits (the signs of clustered Gaussians as +-1, and the same signs as
  0/1, where the reference packs every bit as 1: ROADMAP.md, faults of the
  reference). ``search_batch`` runs the storage gate (>= 4,096 rows) and the
  auto-rerank; the oversample the gate settles on and its calibrated recall
  must equal the reference's. ``_raw=True`` is held against the reference's
  coarse pass (``_fused_search`` on its CPU path), and ``search``,
  ``search_with_rerank``, ``hybrid_search_batch``, VelesQL ``NEAR`` and
  REST ``/search`` against the reference's answers.
- FULL hamming / jaccard collections under ``quality="perfect"`` and
  ``search_batch_with_rerank`` (the host rerank's set-metric scores).
- The plain versions of kernels #4, #5 and #9 at 256 bits (W 8 words, D_pad
  256) against the reference's Pallas kernels in interpret mode.

Tolerances: ids equal but where exact scores tie (integer distances tie
often; a swapped pair must carry the same score), values to atol 1e-6 (the
coarse ``1 - d/D`` is a true fp32 division in the port, a reciprocal
multiply in XLA: one ulp apart).
"""

import contextlib
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu
import velesdb_tpu.collection as jcol
import velesdb_tpu.ops.bucket_kernel as jbk
import velesdb_tpu.ops.pallas_kernels as jpk
import velesdb_tpu_torch
import velesdb_tpu_torch.collection as tcol
import velesdb_tpu_torch.ops.bucket_kernel as tbk
import velesdb_tpu_torch.ops.pallas_kernels as tpk
from velesdb_tpu.index.brute import BruteForceIndex as JIndex
from velesdb_tpu.ops import DistanceMetric as JMetric
from velesdb_tpu.ops import StorageMode as JMode
from velesdb_tpu.ops import binary_quantize as j_pack
from velesdb_tpu.server.app import make_server as ref_make_server
from velesdb_tpu_torch.index.brute import BruteForceIndex as TIndex
from velesdb_tpu_torch.ops import DistanceMetric, binary_quantize
from velesdb_tpu_torch.server.app import make_server as port_make_server

ATOL = 1e-6
WORDS = ["coffee", "laptop", "guitar", "jacket", "novel", "espresso", "keyboard"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def glove_class(n=20_000, d=100, nq=96, seed=23):
    """The reference's ``test_binary_hamming_serve_recall_glove_class``
    recipe: 512 centres, queries around the corpus's centres."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((512, d)).astype(np.float32) * 2.0
    corpus = centers[rng.integers(0, 512, n)] + 0.7 * rng.standard_normal((n, d)).astype(
        np.float32)
    queries = centers[rng.integers(0, 512, nq)] + 0.7 * rng.standard_normal((nq, d)).astype(
        np.float32)
    return corpus, queries


def sign_codes(n=8192, d=256, nq=64, seed=5, zero_one=False):
    """256-bit sign codes: the signs of ``make_clustered`` (``bench.py:41``)
    as +-1, or as 0/1. Queries are held-out rows of the same recipe."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 64, n + nq)] + 0.7 * rng.standard_normal((n + nq, d)).astype(
        np.float32)
    x = np.where(x >= 0, 1.0, 0.0 if zero_one else -1.0).astype(np.float32)
    return x[:n], x[n:]


DATASETS = {
    "glove100": glove_class,
    "signs256": sign_codes,
    "bits01_256": lambda: sign_codes(zero_one=True),
}


def _payload(i):
    w = np.array(WORDS)
    return {"title": f"{w[i % 7]} {w[(3 * i) % 7]} item {i}", "grp": i % 4}


def _same(got_rows, want_rows, atol=ATOL):
    """Ids equal but at exact score ties, values to ``atol``."""
    assert len(got_rows) == len(want_rows)
    for got, want in zip(got_rows, want_rows):
        assert len(got) == len(want)
        gs = np.array([h["score"] for h in got])
        ws = np.array([h["score"] for h in want])
        np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)
        for g, w in zip(got, want):
            if g["id"] != w["id"]:
                assert abs(g["score"] - w["score"]) <= atol
        # a tie swap may reorder ids, but every tie group that ends before the
        # last rank holds the same ids in both
        for s in np.unique(ws[ws != ws[-1]]):
            assert ({h["id"] for h in got if abs(h["score"] - s) <= atol}
                    == {h["id"] for h in want if abs(h["score"] - s) <= atol})


@pytest.fixture(scope="module", params=[(ds, m) for ds in DATASETS
                                        for m in ("hamming", "jaccard")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request, tmp_path_factory):
    """Both packages' BINARY collections over one dataset, each searched once
    (the gate runs there)."""
    ds, metric = request.param
    corpus, queries = DATASETS[ds]()
    root = tmp_path_factory.mktemp(f"{ds}-{metric}")
    rdb = velesdb_tpu.Database.open(str(root / "ref"))
    pdb = velesdb_tpu_torch.Database.open(str(root / "port"), device="cpu")
    payloads = [_payload(i) for i in range(len(corpus))]
    cols = []
    for db in (rdb, pdb):
        c = db.create_collection("c", corpus.shape[1], metric=metric, storage_mode="binary")
        c.upsert_bulk(range(len(corpus)), corpus, payloads)
        cols.append(c)
    ref, col = cols
    first = (col.search_batch(queries, 10), ref.search_batch(queries, 10))
    yield dict(ds=ds, metric=metric, corpus=corpus, queries=queries, ref=ref, col=col,
               rdb=rdb, pdb=pdb, first=first)
    pdb.close()
    rdb.close()


def test_search_batch_matches_reference_and_its_gate(pair):
    col, ref = pair["col"], pair["ref"]
    got, want = pair["first"]
    _same(got, want)
    assert col._storage_gate_used == ref._storage_gate_used == len(pair["corpus"])
    assert col._rerank_oversample == ref._rerank_oversample
    assert col._storage_recall == ref._storage_recall
    assert col.planner.engine_recall("storage") == ref.planner.engine_recall("storage")
    assert col.info()["serve_engine"] == "hamming-topk"  # below the bucket guard's rows
    if pair["ds"] == "glove100":  # the figures the reference's recipe gives
        want_os, want_r = {"hamming": (32.0, 0.90859375), "jaccard": (4.0, 0.959375)}[
            pair["metric"]]
        assert (col._rerank_oversample, col._storage_recall[1]) == (want_os, want_r)
    if pair["ds"] == "bits01_256":
        # the reference's fault on 0/1 codes: BINARY packs ``v >= 0``, so
        # every stored bit is 1 and the coarse pass ranks nothing; the gate
        # widens to 32 and the rerank (``v > 0.5``) decides, in both packages
        assert (col._brute._packed.numpy()[: len(pair["corpus"])] == -1).all()
        assert col._rerank_oversample == 32.0 and col._storage_recall[1] < 0.1
        raw = col.search_batch(pair["queries"][:4], 10, _raw=True)
        assert all(h.score == (0.0 if pair["metric"] == "hamming" else 1.0)
                   for row in raw for h in row)


def test_raw_coarse_pass_matches_fused_search(pair):
    q = pair["queries"][:24]
    got = pair["col"].search_batch(q, 40, _raw=True)
    want = pair["ref"].search_batch(q, 40, _raw=True)
    _same(got, want)


def test_search_and_search_with_rerank(pair):
    col, ref, q = pair["col"], pair["ref"], pair["queries"]
    for i in (0, 7):
        _same([col.search(q[i], k=10)], [ref.search(q[i], k=10)])
        _same([col.search_with_rerank(q[i], k=5, oversample=8)],
              [ref.search_with_rerank(q[i], k=5, oversample=8)])
    filt = {"type": "eq", "field": "grp", "value": 2}
    got, want = col.search_batch(q[:8], 10, filter=filt), ref.search_batch(q[:8], 10, filter=filt)
    _same(got, want)
    assert all(h.payload["grp"] == 2 for row in got for h in row)


def test_hybrid_search_batch(pair):
    col, ref, q = pair["col"], pair["ref"], pair["queries"][:6]
    texts = ["coffee laptop", "novel", "guitar jacket", "espresso", "keyboard item", "laptop"]
    got = col.hybrid_search_batch(q, texts, k=10)
    want = ref.hybrid_search_batch(q, texts, k=10)
    assert [[h.id for h in r] for r in got] == [[h.id for h in r] for r in want]
    _same(got, want)


def test_velesql_near(pair):
    v = pair["queries"][3].tolist()
    sql = "SELECT * FROM c WHERE vector NEAR $v LIMIT 10"
    got, want = pair["pdb"].query(sql, {"v": v}), pair["rdb"].query(sql, {"v": v})
    assert len(got) == len(want) == 10
    _same([got], [want])


# -- REST ------------------------------------------------------------------


@contextlib.contextmanager
def _serving(make, path, **kw):
    httpd = make(path, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        for bt in httpd.app._batchers.values():
            bt.stop()
        httpd.app.db.close()
        thread.join(timeout=60)


def _req(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read().decode())


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_rest_binary_set_metric_search(tmp_path, metric):
    """``POST /collections`` with ``storage_mode: binary`` and a set metric,
    the points, then ``/search`` and ``/search/batch`` (past the gate's 4,096
    rows), against the reference's server on the same requests."""
    corpus, queries = sign_codes(n=5000, d=64, nq=6, seed=11)
    points = [{"id": i, "vector": corpus[i].tolist(), "payload": {"grp": i % 3}}
              for i in range(len(corpus))]
    qs = [v.tolist() for v in queries]
    answers = []
    for make, kw, name in ((ref_make_server, {}, "ref"), (port_make_server, {"device": "cpu"},
                                                         "port")):
        with _serving(make, str(tmp_path / name), **kw) as base:
            out = [_req(base, "POST", "/collections", {"name": "codes", "dim": 64,
                                                       "metric": metric,
                                                       "storage_mode": "binary"})]
            for s in range(0, len(points), 2500):
                out.append(_req(base, "PUT", "/collections/codes/points",
                                {"points": points[s : s + 2500]}))
            for i in range(3):
                out.append(_req(base, "POST", "/collections/codes/search",
                                {"vector": qs[i], "k": 10}))
            out.append(_req(base, "POST", "/collections/codes/search/batch",
                            {"vectors": qs, "k": 7,
                             "filter": {"type": "eq", "field": "grp", "value": 1}}))
            answers.append(out)
    want, got = answers
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got[-4:], want[-4:]):
        g_rows = g["results"] if "results" in g else g
        w_rows = w["results"] if "results" in w else w
        if g_rows and isinstance(g_rows[0], dict):
            g_rows, w_rows = [g_rows], [w_rows]
        _same(g_rows, w_rows)


# -- FULL storage: the host rerank's set-metric scores ---------------------


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_full_set_metric_perfect_and_rerank_return_reference_rows(tmp_path, metric):
    """``quality="perfect"`` and ``search_batch_with_rerank`` rescore on the
    host: hamming and jaccard there are the set metrics (``v > 0.5``), not
    euclidean distance."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((2000, 48)).astype(np.float32)
    q = rng.standard_normal((3, 48)).astype(np.float32)
    ref = velesdb_tpu.Database.open(str(tmp_path / "r")).create_collection(
        "f", 48, metric=metric)
    col = velesdb_tpu_torch.Database.open(str(tmp_path / "p"), device="cpu").create_collection(
        "f", 48, metric=metric)
    for c in (ref, col):
        c.upsert_bulk(range(2000), vecs)
    _same(col.search_batch(q, 5, quality="perfect"), ref.search_batch(q, 5, quality="perfect"))
    _same(col.search_batch_with_rerank(q, 5, oversample=4),
          ref.search_batch_with_rerank(q, 5, oversample=4))
    exact = tcol._host_scores(q[0], vecs, DistanceMetric.parse(metric))
    hib = metric == "jaccard"
    best = np.sort(exact)[::-1][:5] if hib else np.sort(exact)[:5]
    np.testing.assert_array_equal([h.score for h in col.search(q[0], 5, quality="perfect")],
                                  best)


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_host_scores_equal_the_reference_bit_for_bit(metric):
    rng = np.random.default_rng(8)
    vecs = rng.standard_normal((300, 40)).astype(np.float32)
    vecs[:3] = -1.0  # empty sets: jaccard 1 against an empty query
    for q in (rng.standard_normal(40).astype(np.float32), np.full(40, -1.0, np.float32)):
        got = tcol._host_scores(q, vecs, DistanceMetric.parse(metric))
        want = jcol._host_scores(q, vecs, JMetric.parse(metric))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["hamming", "jaccard", "euclidean", "cosine", "dot"])
def test_host_topk_is_the_gate_oracle(metric):
    """Set metrics rank exactly as the reference's oracle (``np.argsort`` of
    each full row, dead rows last); float metrics by the exact score."""
    rng = np.random.default_rng(9)
    corpus = np.where(rng.standard_normal((3000, 32)) >= 0, 1.0, -1.0).astype(np.float32)
    if metric in ("euclidean", "cosine", "dot"):
        corpus = rng.standard_normal((3000, 32)).astype(np.float32)
    live = rng.random(3000) > 0.1
    q = corpus[:20] + 0.3 * rng.standard_normal((20, 32)).astype(np.float32)
    m = DistanceMetric.parse(metric)
    got = tcol._host_topk(corpus, live, q, 10, m)
    hib = m.higher_is_better
    for i in range(len(q)):
        s = jcol._host_scores(q[i], corpus, JMetric.parse(metric))
        s = np.where(live, s, -np.inf if hib else np.inf)
        want = np.argsort(-s if hib else s)[:10]
        if metric in ("hamming", "jaccard"):
            np.testing.assert_array_equal(got[i], want)
        else:
            np.testing.assert_allclose(s[got[i]], s[want], rtol=1e-5, atol=1e-5)
        assert live[got[i]].all()


@pytest.mark.parametrize("mode", ["full", "binary", "sq8", "bf16"])
@pytest.mark.parametrize("metric", ["hamming", "jaccard", "euclidean", "cosine"])
def test_index_scores_match_the_reference(mode, metric):
    """``BruteForceIndex.scores``: ``[B, N_pad]`` in the metric's direction;
    SQ8 under a set metric raises the reference's ``ValueError``."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((700, 48)).astype(np.float32)
    valid = np.ones(700, bool)
    t = TIndex(48, metric, mode, device="cpu")
    j = JIndex(48, JMetric.parse(metric), JMode.parse(mode))
    t.rebuild(x, valid)
    j.rebuild(x, valid)
    q = x[:5] + 0.1
    if mode == "sq8" and metric in ("hamming", "jaccard"):
        with pytest.raises(ValueError) as je:
            j.scores(jnp.asarray(q))
        with pytest.raises(ValueError) as te:
            t.scores(q)
        assert str(te.value) == str(je.value)
        return
    got, want = t.scores(q).numpy(), np.asarray(j.scores(jnp.asarray(q)))
    assert got.shape == want.shape
    tol = 2e-2 if mode == "sq8" else 1e-4 if mode == "bf16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- the kernels' plain versions at 256 bits (W 8, D_pad 256) --------------


@pytest.fixture(scope="module")
def codes256():
    corpus, queries = sign_codes(n=8192, d=256, nq=13, seed=17)
    keep = np.random.default_rng(17).random(8192) >= 0.15
    return corpus, queries, keep


def _below_kth(dist, idx):
    kth = dist[:, -1:]
    return [set(row[m].tolist()) for row, m in zip(idx, dist < kth)]


def test_hamming_mxu_plain_at_256_bits(codes256):
    corpus, queries, keep = codes256
    bits = np.array(jbk.hamming_bits_rows(jnp.asarray(corpus), 256))
    tbits = tbk.hamming_bits_rows(torch.from_numpy(corpus), 256)
    np.testing.assert_array_equal(tbits.numpy(), bits)
    assert bits.shape[1] == 256
    csum = bits.astype(np.int32).sum(1)
    aux = np.where(keep, csum, csum + jbk._HAM_BIG).astype(np.int32)
    qbits = (queries >= 0).astype(np.int8)
    jd, ji = jbk.hamming_mxu_topk(jnp.asarray(qbits), jnp.asarray(bits), jnp.asarray(aux),
                                  k=40, chunk=8192, interpret=True)
    td, ti = tbk.hamming_mxu_topk(torch.from_numpy(qbits), tbits, torch.from_numpy(aux),
                                  k=40, chunk=8192)
    np.testing.assert_array_equal(td.numpy(), np.array(jd))
    assert _below_kth(td.numpy(), ti.numpy()) == _below_kth(np.array(jd), np.array(ji))


def test_hamming_bucket_plain_at_8_words(codes256):
    corpus, queries, keep = codes256
    pen = np.where(keep, 0.0, np.inf).astype(np.float32)
    jd, ji = jbk.hamming_bucket_topk(j_pack(queries), j_pack(corpus), jnp.asarray(pen), k=40,
                                     chunk=2048, interpret=True)
    tq, tc = binary_quantize(queries), binary_quantize(corpus)
    assert tq.shape[1] == tc.shape[1] == 8
    td, ti = tbk.hamming_bucket_topk(tq, tc, torch.from_numpy(pen), k=40, chunk=2048)
    np.testing.assert_array_equal(td.numpy(), np.array(jd))
    assert _below_kth(td.numpy(), ti.numpy()) == _below_kth(np.array(jd), np.array(ji))


@pytest.mark.parametrize("k", [10, 320])
def test_hamming_topk_plain_at_8_words(codes256, k):
    """#9 exact: distances and ids equal, ties to the smallest row."""
    corpus, queries, keep = codes256
    jd, ji = jpk.hamming_topk(j_pack(queries), j_pack(corpus), valid=keep, k=k, interpret=True)
    td, ti = tpk.hamming_topk(binary_quantize(queries), binary_quantize(corpus),
                              valid=torch.from_numpy(keep), k=k)
    np.testing.assert_array_equal(td.numpy(), np.array(jd))
    np.testing.assert_array_equal(ti.numpy(), np.array(ji))


def test_public_ops_accept_host_arrays():
    """The reference's public ops take numpy arrays; the port's return CPU
    tensors for them, equal to the tensor inputs' results."""
    from velesdb_tpu_torch import ops

    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 40)).astype(np.float32)
    b = rng.standard_normal((9, 40)).astype(np.float32)
    for metric in DistanceMetric:
        got = ops.pairwise_scores(a, b, metric)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert torch.equal(got, ops.pairwise_scores(torch.from_numpy(a), torch.from_numpy(b),
                                                    metric))
    packed = ops.binary_quantize(b)
    assert torch.equal(packed, ops.binary_quantize(torch.from_numpy(b)))
    assert torch.equal(ops.pairwise_hamming_packed(np.asarray(j_pack(a)), packed),
                       ops.pairwise_hamming_packed(ops.binary_quantize(a), packed))
    assert torch.equal(ops.binary_unpack(packed.numpy(), 40), ops.binary_unpack(packed, 40))
    sq = ops.sq8_quantize(b)
    assert torch.equal(ops.sq8_dot_scores(a, sq), ops.sq8_dot_scores(torch.from_numpy(a), sq))
    vals, idx = ops.top_k(a, 4, higher_is_better=False, mask=np.arange(40) % 3 > 0)
    assert (idx.numpy() % 3 > 0).all()
    mv, mi = ops.merge_top_k(a.reshape(3, 4, 10), np.arange(120).reshape(3, 4, 10), 5)
    np.testing.assert_array_equal(mv.numpy(), np.sort(a, axis=1)[:, ::-1][:, :5])
    assert ops.score_one(a[0], a[0], "hamming") == 0.0
    assert DistanceMetric.HAMMING.sort_results([(1, 3.0), (2, 1.0)]) == [(2, 1.0), (1, 3.0)]
