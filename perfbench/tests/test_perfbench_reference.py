"""The plain reference on hand-worked cases, and the data generator's
repeatability, on the CPU."""

import math

import numpy as np
import pytest
import torch

from perfbench import data
from perfbench.reference import bm25, exact, rrf
from perfbench.tests.test_perfbench_harness import small_spec


def test_exact_topk_l2_hand_worked():
    corpus = torch.tensor([[0.0, 0.0], [3.0, 4.0], [1.0, 0.0], [0.0, 2.0]])
    q = torch.tensor([[0.0, 0.0], [3.0, 3.0]])
    vals, rows = exact.topk(q, corpus, "euclidean", 3)
    assert rows.tolist() == [[0, 2, 3], [1, 3, 2]]
    assert vals[0].tolist() == pytest.approx([0.0, 1.0, 2.0])
    assert vals[1].tolist() == pytest.approx([1.0, math.sqrt(10.0), math.sqrt(13.0)])


def test_exact_topk_cosine_with_mask_and_short_list():
    corpus = torch.tensor([[1.0, 0.0], [0.0, 5.0], [2.0, 2.0], [-1.0, 0.0]])
    q = torch.tensor([[1.0, 1.0]])
    mask = torch.tensor([True, False, True, False])
    vals, rows = exact.topk(q, corpus, "cosine", 3, mask)
    assert rows.tolist() == [[2, 0, -1]]
    assert vals[0, :2].tolist() == pytest.approx([1.0, math.sqrt(0.5)])
    assert math.isnan(vals[0, 2].item())


def test_exact_topk_blocks_agree_with_one_block():
    g = torch.Generator().manual_seed(3)
    corpus, q = torch.randn(1000, 8, generator=g), torch.randn(37, 8, generator=g)
    one = exact.topk(q, corpus, "euclidean", 10)
    blocks = exact.topk(q, corpus, "euclidean", 10, row_block=96, query_block=5)
    assert torch.equal(one[1], blocks[1])
    assert torch.allclose(one[0], blocks[0])


def test_scores_of_pairs():
    corpus = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
    q = torch.tensor([[0.0, 0.0], [0.0, 1.0]])
    s = exact.scores_of(q, corpus, "euclidean", torch.tensor([0, 1, 1]), torch.tensor([1, 0, 1]))
    assert s.tolist() == pytest.approx([5.0, 1.0, math.sqrt(18.0)])
    c = exact.scores_of(q[1:], corpus, "cosine", torch.tensor([0]), torch.tensor([1]))
    assert c.item() == pytest.approx(0.8)


def test_bfloat16_control_rounds_its_scores():
    g = torch.Generator().manual_seed(5)
    corpus, q = torch.randn(500, 16, generator=g) * 3, torch.randn(4, 16, generator=g) * 3
    v64, _ = exact.topk(q, corpus, "cosine", 5)
    v16, _ = exact.topk(q, corpus, "cosine", 5, dtype=torch.bfloat16)
    assert torch.equal(v16, v16.to(torch.bfloat16).to(torch.float64))
    assert not torch.equal(v16, v64)


def test_tokenizer():
    assert bm25.tokenize("Hello, WORLD-42 x_y") == ["hello", "world", "42", "x", "y"]


def test_bm25_hand_worked_scores():
    texts = ["apple apple pie", "apple tart", "pie pie pie crust", None]
    idx = bm25.Bm25(texts)
    assert idx.n_docs == 3 and idx.avg_len == pytest.approx(3.0)
    n, df = 3, 2
    idf = math.log(1.0 + (n - df + 0.5) / (df + 0.5))

    def term(tf, dl):
        return idf * tf * 2.2 / (tf + 1.2 * (0.25 + 0.75 * dl / 3.0))

    s = idx.scores("apple")
    assert s.tolist() == pytest.approx([term(2, 3), term(1, 2), 0.0, 0.0])
    s2 = idx.scores("apple apple")  # a query term counts as often as it appears
    assert s2.tolist() == pytest.approx([2 * x for x in s.tolist()])
    vals, rows = idx.topk("pie", 4)
    assert rows.tolist() == [2, 0, -1, -1]
    vals, rows = idx.topk("pie", 4, mask=np.array([True, True, False, True]))
    assert rows.tolist() == [0, -1, -1, -1]


def test_bm25_ties_to_the_lower_row():
    idx = bm25.Bm25(["b a", "a b", "c", "a c"])
    _, rows = idx.topk("a", 3)
    assert rows.tolist() == [0, 1, 3]


def test_rrf_hand_worked():
    vec = torch.tensor([[5, 7, 9]])
    txt = torch.tensor([[9, 4, -1]])
    vals, rows = rrf.fuse(vec, txt, 4, 0.5)
    # 9: vector rank 2 and text rank 0; 5: vector rank 0; 7 (vector rank 1)
    # and 4 (text rank 1) tie at 0.5 / 62, the lower row first
    assert rows.tolist() == [[9, 5, 4, 7]]
    assert vals[0].tolist() == pytest.approx([0.5 / 63 + 0.5 / 61, 0.5 / 61, 0.5 / 62, 0.5 / 62])


def test_rrf_weights_empty_places_and_short_lists():
    vec = torch.tensor([[-1, -1], [3, -1]])
    txt = torch.tensor([[2, 1], [-1, -1]])
    vals, rows = rrf.fuse(vec, txt, 3, 0.75)
    assert rows.tolist() == [[2, 1, -1], [3, -1, -1]]
    assert vals[0].tolist() == pytest.approx([0.25 / 61, 0.25 / 62, 0.0])
    assert vals[1].tolist() == pytest.approx([0.75 / 61, 0.0, 0.0])


def test_rrf_in_bfloat16_rounds():
    vec = torch.tensor([[1, 2, 3]])
    txt = torch.tensor([[4, 5, 6]])
    v16, r16 = rrf.fuse(vec, txt, 6, 0.5, dtype=torch.bfloat16)
    v64, r64 = rrf.fuse(vec, txt, 6, 0.5)
    assert r16.tolist() == r64.tolist() == [[1, 4, 2, 5, 3, 6]]
    assert torch.equal(v16, v16.to(torch.bfloat16).to(torch.float64))
    assert not torch.allclose(v16, v64, rtol=1e-6, atol=0)


def _small(cell, rows=3000, queries=64):
    return small_spec(cell, rows=rows, queries=queries)


@pytest.mark.parametrize("cell", ["sift1m-exact-b256", "hybrid-1m-b256"])
def test_data_repeats_for_a_seed_and_differs_for_another(cell):
    spec = _small(cell)
    big = 2**31 + 12345

    def make(seed):
        ds = data.make_dataset(spec.cfg, seed, "cpu")
        return ds, data.make_pool(spec.cfg, spec.traffic, seed, ds, "cpu")

    (a, pa), (b, pb), (c, pc) = make(big), make(big), make(big + 1)
    assert torch.equal(a.rows, b.rows) and np.array_equal(a.ids, b.ids)
    assert torch.equal(pa.vectors, pb.vectors) and np.array_equal(pa.order, pb.order)
    assert pa.texts == pb.texts and a.payloads() == b.payloads()
    assert not torch.equal(a.rows, c.rows) and not np.array_equal(a.ids, c.ids)
    assert not torch.equal(pa.vectors, pc.vectors)
    if a.fields:
        pa_, pb_, pc_ = a.fields["price"], b.fields["price"], c.fields["price"]
        assert np.array_equal(pa_, pb_) and not np.array_equal(pa_, pc_)
        assert a.fields["text"] != c.fields["text"]
        assert all(len(bm25.tokenize(t)) == 4 for t in a.fields["text"][:50])
        assert ((pa_ >= 1.0) & (pa_ < 100.0)).all()
    assert sorted(a.ids.tolist()) == list(range(data.ID_BASE, data.ID_BASE + spec.cfg["rows"]))


def test_streams_are_independent_of_each_other_size():
    spec = _small("sift1m-exact-b256")
    ds = data.make_dataset(spec.cfg, 9, "cpu")
    p1 = data.make_pool(spec.cfg, spec.traffic, 9, ds, "cpu")
    spec.cfg["rows"] = 2000
    ds2 = data.make_dataset(spec.cfg, 9, "cpu")
    p2 = data.make_pool(spec.cfg, spec.traffic, 9, ds2, "cpu")
    assert torch.equal(ds.aux["centers"], ds2.aux["centers"])
    assert torch.equal(p1.vectors, p2.vectors) and np.array_equal(p1.order, p2.order)


def test_pool_batches_cycle_through_the_order():
    pool = data.QueryPool(None, None, np.arange(10))
    assert pool.batch(0, 4).tolist() == [0, 1, 2, 3]
    assert pool.batch(2, 4).tolist() == [8, 9, 0, 1]
    assert pool.batch(3, 4).tolist() == [2, 3, 4, 5]


def test_filter_mask_reads_the_generated_field():
    ds = data.Dataset(None, None, {"text": ["a"] * 3, "price": np.array([10.0, 50.0, 60.0])})
    assert data.filter_mask({"type": "lt", "field": "price", "value": 50.0}, ds).tolist() == [
        True, False, False]
    assert data.filter_mask(None, ds) is None
