"""The port's text layer against the JAX package's, on the CPU.

Same inputs through ``velesdb_tpu`` and ``velesdb_tpu_torch``: the tokenizer,
the trigram LIKE index, the BM25 index and the fusion functions.

Tolerances:
- tokenizer, trigram masks, ``fusion.py``: equal (host code on both sides).
- BM25: the blocks the port builds equal the reference's bit for bit; scores
  and slots from ``bm25_score_blocks`` equal the reference's
  ``_bm25_score`` bit for bit, ties included (templated documents tie by the
  hundred: the select must give equal scores to the lowest slot, and the
  term-ordered sums must round as the reference's CPU scatter does).
- ``rrf_fuse_topk``: slots equal, fused values within 1e-7 (f32 on both
  sides; a slot's total sums at most one contribution a list in the same
  order, so they agree exactly in practice).
"""

import math
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velesdb_tpu.fusion as jfusion
from velesdb_tpu.ops.fused_rrf import rrf_fuse_topk as j_rrf
from velesdb_tpu.text import Bm25Index as JBm25
from velesdb_tpu.text import TrigramIndex as JTrigram
from velesdb_tpu.text import extract_text as j_extract
from velesdb_tpu.text import tokenize as j_tokenize
from velesdb_tpu.text.bm25 import _bm25_score as j_score
from velesdb_tpu.text.trigram import like_to_regex as j_like

import velesdb_tpu_torch.fusion as tfusion
from velesdb_tpu_torch.ops.fused_rrf import rrf_fuse_topk as t_rrf
from velesdb_tpu_torch.text import Bm25Index as TBm25
from velesdb_tpu_torch.text import TrigramIndex as TTrigram
from velesdb_tpu_torch.text import extract_text as t_extract
from velesdb_tpu_torch.text import tokenize as t_tokenize
from velesdb_tpu_torch.text.bm25 import BLOCK, B, K1, bm25_score_blocks, bm25_state_from_jax
from velesdb_tpu_torch.text.trigram import like_to_regex as t_like

DOCS = {
    0: "the quick brown fox jumps over the lazy dog",
    1: "a fast auburn fox leaps across a sleepy canine",
    2: "grumpy wizards make toxic brew for the evil queen",
    3: "the five boxing wizards jump quickly",
    4: "pack my box with five dozen liquor jugs",
    5: "quick brown foxes are quick",
}
WORDS = ["coffee", "espresso", "latte", "laptop", "screen", "guitar", "amp", "novel", "poem",
         "wool"]


@pytest.mark.parametrize("text", [
    "Hello, World! 42 times", "", "  MiXeD-case_tokens and\ttabs\n", "café naïve 3d-print",
    "one,two;three", "ALL CAPS 007",
])
def test_tokenize_matches_reference(text):
    assert t_tokenize(text) == j_tokenize(text)


@pytest.mark.parametrize("payload", [
    {"title": "red shoes", "price": 59},
    {"a": {"b": ["x y", {"c": "z"}], "n": 3}, "t": ("p", "q")},
    {"n": 1, "f": 2.5, "flag": True},
    {},
])
def test_extract_text_matches_reference(payload):
    assert t_extract(payload) == j_extract(payload)


def _trigrams(cls):
    idx = cls()
    for slot, text in DOCS.items():
        idx.add_document(slot, text)
    return idx


# the reference's tests/test_text.py LIKE cases, with its own expectations
@pytest.mark.parametrize("pattern,ci,want", [
    ("%quick%", False, {0, 3, 5}),
    ("%QUICK%", True, {0, 3, 5}),
    ("%QUICK%", False, set()),
    ("the quick%", False, {0}),
    ("%j_mps%", False, {0}),
    ("%brown fox%", False, {0, 5}),
    ("%brown fox j%", False, {0}),
    ("%my%", False, {4}),
])
def test_like_mask_matches_reference(pattern, ci, want):
    t, j = _trigrams(TTrigram), _trigrams(JTrigram)
    got = t.match_mask(pattern, len(DOCS), case_insensitive=ci)
    np.testing.assert_array_equal(got, j.match_mask(pattern, len(DOCS), case_insensitive=ci))
    assert set(np.flatnonzero(got)) == want


def test_like_regex_escaping_and_trigram_remove():
    for rx in (t_like("50\\% off%", False), j_like("50\\% off%", False)):
        assert rx.match("50% off today") and not rx.match("500 off today")
    t, j = _trigrams(TTrigram), _trigrams(JTrigram)
    t.remove_document(0)
    j.remove_document(0)
    got = t.match_mask("%quick%", len(DOCS))
    np.testing.assert_array_equal(got, j.match_mask("%quick%", len(DOCS)))
    assert set(np.flatnonzero(got)) == {3, 5}


# -- BM25 ----------------------------------------------------------------------


def _templated(n, seed):
    """Templated texts (a few words from a small vocabulary): scores tie by
    the hundred, and common words' postings run over many 128-entry blocks."""
    rng = np.random.default_rng(seed)
    texts = {}
    for slot in range(n):
        w = rng.integers(0, len(WORDS), rng.integers(1, 5))
        texts[slot] = " ".join(WORDS[i] for i in w) + f" w{slot % 7}"
    return texts


def _pair(texts):
    j, t = JBm25(), TBm25(device="cpu")
    for slot, text in texts.items():
        j.add_document(slot, text)
        t.add_document(slot, text)
    return j, t


QUERIES = ["coffee", "coffee latte latte", "w3 guitar", "novel poem wool amp", "nothing here",
           "espresso espresso espresso screen", "w0 w1 w2 w3 w4 w5 w6"]


@pytest.mark.parametrize("n", [700, 2500])
def test_bm25_blocks_built_bit_for_bit(n):
    j, t = _pair(_templated(n, n))
    j.refresh(n)
    t.refresh(n)
    assert t.n_pad == j.n_pad
    assert t._vocab == j._vocab and list(t._vocab) == sorted(t._vocab)
    assert t._term_blocks == j._term_blocks
    assert max(c for _, c in t._term_blocks) > 1  # postings past one block
    np.testing.assert_array_equal(t._block_docs.numpy(), np.asarray(j._block_docs))
    assert np.array_equal(t._block_scores.numpy().view(np.uint32),
                          np.asarray(j._block_scores).view(np.uint32))
    np.testing.assert_array_equal(t._idf, j._idf)
    for jp, tp in zip(j.prep_batch(QUERIES, n), t.prep_batch(QUERIES, n)[:2]):
        np.testing.assert_array_equal(tp, jp)


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("k", [10, 200])
@pytest.mark.parametrize("masked", [False, True])
def test_bm25_scores_equal_reference_on_its_blocks(k, masked):
    """The reference's blocks carried over with ``bm25_state_from_jax``:
    ``bm25_score_blocks`` equals ``_bm25_score`` bit for bit, ties included."""
    n = 2500
    j, _ = _pair(_templated(n, 7))
    j.refresh(n)
    state = bm25_state_from_jax({
        "block_docs": np.asarray(j._block_docs), "block_scores": np.asarray(j._block_scores),
        "vocab": j._vocab, "term_blocks": j._term_blocks, "n_pad": j.n_pad,
    }, "cpu")
    t = TBm25(device="cpu")
    t.load_state(state)
    mask = np.random.default_rng(3).random(j.n_pad) > 0.4 if masked else None
    bid, wt = j.prep_batch(QUERIES, n)
    jv, ji = j_score(jnp.asarray(bid), jnp.asarray(wt), j._block_docs, j._block_scores,
                     None if mask is None else jnp.asarray(mask), n_pad=j.n_pad, k=k)
    tv, ti = bm25_score_blocks(*t.prep_batch(QUERIES, n), t._block_docs, t._block_scores,
                               None if mask is None else torch.from_numpy(mask),
                               n_pad=t.n_pad, k=k)
    assert _bits_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # ties: many equal scores, resolved to the lowest slot
    row = tv.numpy()[0]
    assert len(set(row[row > 0].tolist())) < (row > 0).sum()


def test_bm25_search_batch_equal_reference_with_mask_and_slices(monkeypatch):
    """``search_batch`` through both indexes' own builds, with a mask over the
    slots and the port's dense scores split into query slices."""
    import velesdb_tpu_torch.text.bm25 as tb

    n = 2500
    j, t = _pair(_templated(n, 11))
    mask = np.random.default_rng(4).random(n) > 0.5
    monkeypatch.setattr(tb, "DENSE_ELEMS", 3 * 4096)  # three queries a slice
    for m in (None, mask):
        jv, js = j.search_batch(QUERIES, 30, n, mask=m)
        tv, ts = t.search_batch(QUERIES, 30, n, mask=m)
        assert _bits_equal(tv, jv)
        np.testing.assert_array_equal(ts, js)
    got = dict(t.search("coffee latte", n, n, mask=mask))
    assert got and set(got) <= set(np.flatnonzero(mask))


def _host_bm25(docs, query):
    toks = {d: t_tokenize(t) for d, t in docs.items()}
    n = len(docs)
    avg = sum(len(t) for t in toks.values()) / n
    scores = {}
    for term, qtf in Counter(t_tokenize(query)).items():
        df = sum(1 for t in toks.values() if term in t)
        if df == 0:
            continue
        idf = math.log(1.0 + (n - df + 0.5) / (df + 0.5))
        for d, t in toks.items():
            tf = t.count(term)
            if tf:
                scores[d] = scores.get(d, 0.0) + qtf * idf * tf * (K1 + 1) / (
                    tf + K1 * (1 - B + B * len(t) / avg))
    return scores


@pytest.mark.parametrize("query", ["quick fox", "wizards", "five boxing quick",
                                   "the quick quick"])
def test_bm25_matches_host_formula(query):
    t = TBm25(device="cpu")
    for slot, text in DOCS.items():
        t.add_document(slot, text)
    want = _host_bm25(DOCS, query)
    got = dict(t.search(query, 10, len(DOCS)))
    assert set(got) == set(want)
    for d, s in want.items():
        assert got[d] == pytest.approx(s, rel=1e-5)


def test_bm25_remove_update_and_multiblock():
    j, t = _pair(dict(DOCS))
    for idx in (j, t):
        idx.remove_document(5)
    assert t.search("quick", 10, len(DOCS)) == j.search("quick", 10, len(DOCS))
    assert 5 not in dict(t.search("quick", 10, len(DOCS)))
    for idx in (j, t):
        idx.add_document(5, "entirely different words now")
    assert t.search("different words", 10, 6) == j.search("different words", 10, 6)
    assert 5 in dict(t.search("different words", 10, 6))
    assert t.search("zzz unknown", 5, 6) == [] and TBm25("cpu").search("any", 5, 1) == []
    long_j, long_t = _pair({s: f"common word{s % 7}" for s in range(300)})
    got = long_t.search("common", 300, 300)
    assert len(got) == 300 and got == long_j.search("common", 300, 300)
    assert long_t._term_blocks[long_t._vocab["common"]][1] == -(-300 // BLOCK)


# -- fusion ----------------------------------------------------------------------


def _lists(seed, n_lists=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_lists):
        ids = rng.integers(0, 25, rng.integers(0, 15))  # repeats and empties
        scores = np.round(rng.random(len(ids)), 1)  # equal scores
        out.append([(int(i), float(s)) for i, s in zip(ids, scores)])
    return out


@pytest.mark.parametrize("strategy", list(tfusion.FusionStrategy))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fusion_strategies_match_reference(strategy, seed):
    lists = _lists(seed)
    weights = [1.0, 0.5, 2.0]
    t = tfusion.FusionStrategy.parse(strategy.value)
    j = jfusion.FusionStrategy.parse(strategy.value)
    assert t.fuse(lists, 8, weights=weights) == j.fuse(lists, 8, weights=weights)
    assert t.fuse(lists, 8, rrf_k=10) == j.fuse(lists, 8, rrf_k=10)


@pytest.mark.parametrize("alias", ["avg", "max", "RRF", " weighted_avg ", "weighted_max"])
def test_fusion_parse_and_weighted_rrf(alias):
    assert tfusion.FusionStrategy.parse(alias).value == jfusion.FusionStrategy.parse(alias).value
    with pytest.raises(ValueError):
        tfusion.FusionStrategy.parse("median")
    a, b = _lists(5, 2)
    for w in (0.0, 0.3, 1.0):
        assert tfusion.weighted_rrf(a, b, 6, vector_weight=w) == jfusion.weighted_rrf(
            a, b, 6, vector_weight=w)
    assert tfusion.rrf_fuse([a, b], 6) == jfusion.rrf_fuse([a, b], 6)


@pytest.mark.parametrize("seed", range(6))
def test_rrf_fuse_topk_matches_reference(seed):
    """Random branch lists with duplicates across and within lists, empties
    (slot -1, non-finite vector scores, zero BM25 scores) and rank ties."""
    rng = np.random.default_rng(seed)
    b, f = 9, 20
    v_idx = rng.integers(-1, 30, (b, f)).astype(np.int32)
    t_idx = rng.integers(-1, 30, (b, f)).astype(np.int32)
    v_vals = rng.standard_normal((b, f)).astype(np.float32)
    v_vals[rng.random((b, f)) < 0.1] = np.inf
    t_vals = np.abs(rng.standard_normal((b, f))).astype(np.float32)
    t_vals[rng.random((b, f)) < 0.1] = 0.0
    t_idx[0] = -1  # a row with no text hits
    w = np.float32(rng.random())
    rk = None if seed % 2 else float(rng.integers(1, 100))
    jv, ji = j_rrf(jnp.asarray(v_vals), jnp.asarray(v_idx), jnp.asarray(t_vals),
                   jnp.asarray(t_idx), jnp.float32(w), jnp.float32(1.0 - w),
                   None if rk is None else jnp.float32(rk), k=10)
    tv, ti = t_rrf(torch.from_numpy(v_vals), torch.from_numpy(v_idx), torch.from_numpy(t_vals),
                   torch.from_numpy(t_idx), w, np.float32(1.0 - w), rk, k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-7)
    # the default text weight is 1 - w
    dv, di = t_rrf(torch.from_numpy(v_vals), torch.from_numpy(v_idx), torch.from_numpy(t_vals),
                   torch.from_numpy(t_idx), w, None, rk, k=10)
    np.testing.assert_array_equal(di.numpy(), ti.numpy())
