"""Text and hybrid search through the port's ``Collection``, beside the JAX
package's on the same data: the counterparts of ``tests/test_collection_text.py``.

Tolerances: text results equal (ids and f32 BM25 scores, bit for bit); hybrid
results equal in ids and to 1e-6 in fused score (f32 RRF on both sides) where
both packages' vector branches are exact. The port has one device-fused
form where the reference has two (its jitted mono program and its
3-program form); the reference's mono tests are held against it by name.
From 131,072 padded rows the port's vector branch is an int8 assist core
(#1's or #7's plain version) and the reference's is exact on the CPU: there
the hybrid ids overlap the reference's >= 0.9 (on the far-offset corpus,
where the reference's f32 scores cancel, the vector branch reaches
recall@10 >= 0.9 against a float64 oracle instead).
"""

import numpy as np
import pytest

import velesdb_tpu
import velesdb_tpu_torch
import velesdb_tpu_torch.index.brute as tbrute
import velesdb_tpu_torch.collection as tcol
from velesdb_tpu_torch.fusion import weighted_rrf

PRODUCTS = [
    {"title": "red running shoes", "price": 59},
    {"title": "blue running shorts", "price": 25},
    {"title": "espresso coffee machine", "price": 120},
    {"title": "red coffee mug", "price": 9},
    {"title": "trail running shoes waterproof", "price": 89},
    {"title": "decaf coffee beans", "price": 14},
]
CHEAP = {"type": "lt", "field": "price", "value": 50.0}


def _both(tmp_path, name, dim, vecs, payloads, **kw):
    ref = velesdb_tpu.Database.open(str(tmp_path / "ref")).create_collection(name, dim, **kw)
    col = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu").create_collection(
        name, dim, **kw)
    for c in (ref, col):
        c.upsert_bulk(range(len(vecs)), vecs, payloads)
    return ref, col


@pytest.fixture
def products(tmp_path):
    vecs = np.random.default_rng(0).standard_normal((6, 16)).astype(np.float32)
    ref, col = _both(tmp_path, "products", 16, vecs, PRODUCTS)
    return ref, col, vecs


def _rows(rows):
    return [[(h.id, h.score) for h in row] for row in rows]


def _same_hybrid(got, want, tol=1e-6):
    for g, w in zip(got, want):
        assert [h.id for h in g] == [h.id for h in w]
        for a, b in zip(g, w):
            assert abs(a.score - b.score) <= tol


def test_text_search_ranks_matches(products):
    ref, col, _ = products
    hits = col.text_search("running shoes", k=4)
    assert _rows([hits]) == _rows([ref.text_search("running shoes", k=4)])
    assert set(h.id for h in hits[:2]) == {0, 4}
    assert all(h.score > 0 for h in hits) and hits[0].payload["title"]


def test_text_search_with_filter(products):
    ref, col, _ = products
    filt = {"type": "lt", "field": "price", "value": 20}
    hits = col.text_search("coffee", k=5, filter=filt)
    assert {h.id for h in hits} == {3, 5}
    assert _rows([hits]) == _rows([ref.text_search("coffee", k=5, filter=filt)])


def test_hybrid_search_fuses_branches(products):
    ref, col, vecs = products
    for k, w in ((4, 0.5), (1, 1.0), (1, 0.0)):
        got = col.hybrid_search(vecs[2], "running shoes", k=k, vector_weight=w)
        _same_hybrid([got], [ref.hybrid_search(vecs[2], "running shoes", k=k, vector_weight=w)])
    ids = {h.id for h in col.hybrid_search(vecs[2], "running shoes", k=4)}
    assert 2 in ids and ids & {0, 4}
    assert col.hybrid_search(vecs[2], "running shoes", k=1, vector_weight=1.0)[0].id == 2
    assert col.hybrid_search(vecs[2], "running shoes", k=1, vector_weight=0.0)[0].id in (0, 4)


def test_text_index_follows_mutations(products):
    ref, col, vecs = products
    for c in (ref, col):
        assert {h.id for h in c.text_search("coffee", k=5)} == {2, 3, 5}
        c.delete(3)
        assert {h.id for h in c.text_search("coffee", k=5)} == {2, 5}
        c.upsert(7, vecs[0], {"title": "cold brew coffee kit"})
        c.upsert(2, vecs[2], {"title": "espresso machine"})  # loses "coffee"
        c.upsert_bulk([8, 9], vecs[:2], [{"title": "coffee coffee"}, None])
    assert _rows([col.text_search("coffee", k=5)]) == _rows([ref.text_search("coffee", k=5)])
    assert {h.id for h in col.text_search("coffee", k=5)} == {5, 7, 8}


def test_like_mask(products):
    ref, col, vecs = products
    mask = col.like_mask("%running%")
    np.testing.assert_array_equal(mask, ref.like_mask("%running%"))
    assert {int(col.vectors.occupancy()[0][s]) for s in np.flatnonzero(mask)} == {0, 1, 4}
    # the trigram index, built at the first like_mask, follows mutations
    for c in (ref, col):
        c.delete(1)
        c.upsert(10, vecs[1], {"title": "running late"})
    np.testing.assert_array_equal(col.like_mask("%RUNNING%", case_insensitive=True),
                                  ref.like_mask("%RUNNING%", case_insensitive=True))


def test_text_survives_reopen(tmp_path):
    path = str(tmp_path / "shared")
    rng = np.random.default_rng(1)
    db = velesdb_tpu_torch.Database.open(path, device="cpu")
    c = db.create_collection("docs", dim=8)
    c.upsert(1, rng.standard_normal(8).astype(np.float32), {"body": "hello world"})
    c.upsert(2, rng.standard_normal(8).astype(np.float32), {"body": "goodbye world"})
    assert [h.id for h in c.text_search("hello", k=3)] == [1]
    c.flush()
    db.close()
    c2 = velesdb_tpu_torch.Database.open(path, device="cpu").get_collection("docs")
    assert [h.id for h in c2.text_search("hello", k=3)] == [1]
    r2 = velesdb_tpu.Database.open(path).get_collection("docs")
    assert _rows([c2.text_search("world", k=3)]) == _rows([r2.text_search("world", k=3)])


@pytest.fixture(scope="module")
def alpha(tmp_path_factory):
    rng = np.random.default_rng(5)
    n = 3000
    vecs = rng.standard_normal((n, 24)).astype(np.float32)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    payloads = [{"text": f"{words[i % 6]} {words[(i // 6) % 6]}", "price": float(i % 100)}
                for i in range(n)]
    ref, col = _both(tmp_path_factory.mktemp("alpha"), "h", 24, vecs, payloads, metric="cosine")
    return ref, col, vecs


@pytest.mark.parametrize("w,filtered", [(0.5, False), (0.5, True), (0.3, True), (1.0, False),
                                        (0.0, False)])
def test_hybrid_fused_matches_host_fusion(alpha, w, filtered):
    """The device-fused RRF against ``weighted_rrf`` over the two branch
    lists read back, and against the reference's hybrid on the same data."""
    ref, col, vecs = alpha
    f = CHEAP if filtered else None
    q = vecs[17] + 0.01 * np.random.default_rng(int(w * 10)).standard_normal(24).astype(
        np.float32)
    got = col.hybrid_search(q, "alpha beta", k=10, vector_weight=w, filter=f)
    _same_hybrid([got], [ref.hybrid_search(q, "alpha beta", k=10, vector_weight=w, filter=f)])
    want = weighted_rrf([(r.id, r.score) for r in col.search(q, 20, filter=f)],
                        [(r.id, r.score) for r in col.text_search("alpha beta", 20, filter=f)],
                        10, vector_weight=w)
    assert [r.id for r in got] == [vid for vid, s in want if s > 0]
    want_map = dict(want)
    assert all(abs(r.score - want_map[r.id]) < 1e-6 for r in got)
    if filtered:
        assert all(r.payload["price"] < 50.0 for r in got)


def test_hybrid_out_of_vocabulary_text_is_vector_ranks(alpha):
    ref, col, vecs = alpha
    got = col.hybrid_search_batch(vecs[5:8], ["qwertyuiop"] * 3, k=5, vector_weight=0.5)
    for row, q in zip(got, vecs[5:8]):
        assert [r.id for r in row] == [r.id for r in col.search(q, 20)[:5]]
    _same_hybrid(got, ref.hybrid_search_batch(vecs[5:8], ["qwertyuiop"] * 3, k=5))


@pytest.mark.parametrize("mode", ["sq8", "binary"])
def test_hybrid_quantized_rides_host_rerank_path(tmp_path, monkeypatch, mode):
    """Quantized collections fuse the reranked host lists (the device-fused
    form never engages) and find the planted near-duplicate, as the
    reference."""
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(2)
    n = 2000
    vecs = rng.standard_normal((n, 24)).astype(np.float32)
    ref, col = _both(tmp_path, "hq", 24, vecs,
                     [{"text": "alpha" if i % 2 else "beta"} for i in range(n)],
                     metric="euclidean" if mode == "sq8" else "cosine", storage_mode=mode)
    got = col.hybrid_search(vecs[33], "alpha", k=5, vector_weight=0.8)
    assert not calls
    assert got and got[0].id == 33
    assert got[0].id == ref.hybrid_search(vecs[33], "alpha", k=5, vector_weight=0.8)[0].id


def _spy(monkeypatch):
    """Record the exact core behind each device-fused hybrid batch."""
    calls = []
    orig = tcol.Collection._hybrid_device

    def spy(self, q, texts, k, fetch, *a, **kw):
        calls.append(self._brute.serve_engine(fetch))
        return orig(self, q, texts, k, fetch, *a, **kw)

    monkeypatch.setattr(tcol.Collection, "_hybrid_device", spy)
    return calls


def test_hybrid_mono_path_engages_and_matches(alpha, monkeypatch):
    """The exact FULL serve's hybrid is the device-fused form with the
    exact core as its vector branch, and equals the reference's mono form
    on the same data."""
    ref, col, vecs = alpha
    calls = _spy(monkeypatch)
    q = vecs[10:14] + 0.01
    texts = ["alpha beta", "gamma", "delta zeta zeta", "nothing"]
    got = col.hybrid_search_batch(q, texts, k=10, vector_weight=0.4, filter=CHEAP)
    assert calls == ["streamed-scan"]
    assert all(r.payload["price"] < 50.0 for row in got for r in row)
    _same_hybrid(got, ref.hybrid_search_batch(q, texts, k=10, vector_weight=0.4, filter=CHEAP))


def test_hybrid_mono_skips_explicit_quality_and_unknown_text(alpha, monkeypatch):
    """Where the reference's mono form steps aside (explicit ef or quality,
    no query term in the vocabulary) the port keeps its one device-fused
    form and returns the reference's results; so do VelesQL's keywords."""
    ref, col, vecs = alpha
    calls = _spy(monkeypatch)
    for kw in ({"ef": 64}, {"quality": "fast"}):
        got = col._hybrid_fused_batch(vecs[:2], ["alpha", "beta"], 10, w_vec=0.5, w_txt=0.5,
                                      filter=None, **kw)
        _same_hybrid(got, ref._hybrid_fused_batch(vecs[:2], ["alpha", "beta"], 10, w_vec=0.5,
                                                  w_txt=0.5, filter=None, **kw))
    _same_hybrid([col.hybrid_search(vecs[0], "qwertyuiop", k=5)],
                 [ref.hybrid_search(vecs[0], "qwertyuiop", k=5)])
    # VelesQL's keywords: rrf_k and fetch, both weights 1
    got = col._hybrid_fused_batch(vecs[:2], ["alpha", "beta"], 10, w_vec=1.0, w_txt=1.0,
                                  filter=None, rrf_k=20, fetch=30)
    assert calls == ["streamed-scan"] * 4
    _same_hybrid(got, ref._hybrid_fused_batch(vecs[:2], ["alpha", "beta"], 10, w_vec=1.0,
                                              w_txt=1.0, filter=None, rrf_k=20, fetch=30))


def _overlap(got, want):
    return np.mean([len({h.id for h in g} & {h.id for h in w}) / max(len(w), 1)
                    for g, w in zip(got, want)])


@pytest.mark.parametrize("offset", [False, True])
def test_hybrid_mono_composes_assist_cores(tmp_path, monkeypatch, offset):
    """From 131,072 padded rows the hybrid's vector branch is the int8
    assist core: ``int8-assist-pd`` (#1's plain version on the CPU) on a
    clustered corpus, ``int8-assist`` (#7's) where the pd build refuses a
    far-offset, tiny-spread one. On the clustered corpus the ids overlap
    the reference's (exact branch) >= 0.9, on the offset one the vector
    branch reaches recall@10 >= 0.9 against a float64 oracle."""
    calls = _spy(monkeypatch)
    coarse = []
    for name in ("sq8pd_rerank_topk", "sq8i_rerank_topk"):
        fn = getattr(tbrute, name)
        monkeypatch.setattr(tbrute, name,
                            lambda *a, _fn=fn, _n=name, **kw: coarse.append(_n) or _fn(*a, **kw))
    rng = np.random.default_rng(9)
    n, d = 131_072, 24
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2.0
    vecs = centers[rng.integers(0, 64, n)] + 0.7 * rng.standard_normal((n, d)).astype(np.float32)
    metric = "cosine"
    if offset:
        vecs = (vecs * 0.001 + 1000.0).astype(np.float32)
        metric = "euclidean"
    words = ["alpha", "beta", "gamma", "delta"]
    payloads = [{"text": f"{words[i % 4]} {words[(i // 4) % 4]}", "price": float(i % 100)}
                for i in range(n)]
    ref, col = _both(tmp_path, "hma", d, vecs, payloads, metric=metric)
    core = "int8-assist" if offset else "int8-assist-pd"
    col.refresh_device()
    assert col._brute.serve_engine(20) == core
    q = vecs[[17, 33, 4000, 90_000]] + (1e-4 if offset else 0.05) * rng.standard_normal(
        (4, d)).astype(np.float32)
    texts = ["alpha beta", "alpha", "gamma delta", "beta"]
    got = col.hybrid_search_batch(q, texts, k=10, vector_weight=0.6, filter=CHEAP)
    assert calls == [core]
    assert coarse == [{"int8-assist-pd": "sq8pd_rerank_topk",
                       "int8-assist": "sq8i_rerank_topk"}[core]]
    assert all(r.payload["price"] < 50.0 for row in got for r in row)
    if not offset:
        want = ref.hybrid_search_batch(q, texts, k=10, vector_weight=0.6, filter=CHEAP)
        assert _overlap(got, want) >= 0.9
    else:
        # the reference's exact f32 scores cancel at these norms (ROADMAP.md,
        # faults of the reference): hold the vector branch to a float64 oracle
        d2 = ((vecs[None].astype(np.float64) - q[:, None].astype(np.float64)) ** 2).sum(-1)
        truth = np.argsort(d2, axis=1)[:, :10]
        hits = col.search_batch(q, 10)
        assert np.mean([len({h.id for h in r} & set(t)) / 10 for r, t in zip(hits, truth)]) >= 0.9
