"""The port's e-commerce example (``velesdb_tpu_torch.examples.ecommerce_demo``)
on the CPU: ``tests/test_ecommerce_demo.py``'s five cases by name against
it, then its four queries against the reference example's
(``examples/ecommerce_demo.py``, JAX on the CPU) on the same shop
(``n_products=800, n_users=150, seed=3``)."""

import sys
from pathlib import Path

import numpy as np
import pytest

from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.examples.ecommerce_demo import (
    build_shop,
    q1_vector,
    q2_vector_filtered,
    q3_graph,
    q4_combined,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@pytest.fixture(scope="module")
def shopdb(tmp_path_factory):
    db = Database.open(tmp_path_factory.mktemp("shop"), device="cpu")
    shop, vectors, n_edges = build_shop(db, n_products=800, n_users=150, seed=3)
    return db, shop, vectors, n_edges


def _anchor_with_edges(shop, n):
    for pid in range(n):
        if shop.neighbors(pid, "out", "bought_together"):
            return pid
    raise AssertionError("no product has bought_together edges")


def test_build_shape(shopdb):
    db, shop, vectors, n_edges = shopdb
    assert shop.count() == 800
    assert n_edges > 500
    _vec, pay = shop.get(0)
    # the reference's 11 metadata fields
    assert set(pay) == {
        "name", "category", "subcategory", "brand", "price", "rating",
        "review_count", "in_stock", "stock_quantity", "release_year",
        "discount_pct",
    }


def test_q1_vector_similarity(shopdb, rng):
    db, shop, vectors, _ = shopdb
    anchor = 123
    q = vectors[anchor] + 0.02 * rng.standard_normal(128).astype(np.float32)
    hits = q1_vector(shop, q)
    assert hits[0].id == anchor
    # same-shelf clustering: most top-10 share the anchor's subcategory
    sub = shop.get(anchor)[1]["subcategory"]
    same = sum(1 for h in hits if shop.get(h.id)[1]["subcategory"] == sub)
    assert same >= 7


def test_q2_filters_enforced(shopdb, rng):
    db, shop, vectors, _ = shopdb
    q = vectors[42] + 0.02 * rng.standard_normal(128).astype(np.float32)
    rows = q2_vector_filtered(db, q)
    assert rows, "filtered similarity returned nothing"
    for r in rows:
        pay = shop.get(r["id"])[1]
        assert pay["in_stock"] is True
        assert pay["price"] < 500
    sims = [r["sim"] for r in rows]
    assert sims == sorted(sims, reverse=True)


def test_q3_graph_traversal(shopdb):
    db, shop, vectors, _ = shopdb
    anchor = _anchor_with_edges(shop, 800)
    rows = q3_graph(shop, anchor)
    assert rows
    linked = set(shop.neighbors(anchor, "out", "bought_together"))
    assert {r["id"] for r in rows} <= linked


def test_q4_combined_business_rules(shopdb, rng):
    db, shop, vectors, _ = shopdb
    anchor = _anchor_with_edges(shop, 800)
    q = vectors[anchor] + 0.02 * rng.standard_normal(128).astype(np.float32)
    out = q4_combined(db, shop, q, anchor, k=10, price_cap=1000.0)
    assert out
    for r in out:
        pay = shop.get(r["id"])[1]
        assert pay["in_stock"] and pay["rating"] >= 4.0 and pay["price"] < 1000
    scores = [r["score"] for r in out]
    assert scores == sorted(scores, reverse=True)


# -- the same shop through the reference example --------------------------------


@pytest.fixture(scope="module")
def both_shops(shopdb, tmp_path_factory):
    from examples import ecommerce_demo as ref
    from velesdb_tpu.database import Database as RefDatabase

    rdb = RefDatabase.open(tmp_path_factory.mktemp("ref_shop"))
    rshop, rvectors, r_edges = ref.build_shop(rdb, n_products=800, n_users=150, seed=3)
    db, shop, vectors, n_edges = shopdb
    assert r_edges == n_edges and np.array_equal(rvectors, vectors)
    rng = np.random.default_rng(3)
    anchors = [_anchor_with_edges(shop, 800)] + rng.integers(0, 800, 7).tolist()
    queries = [vectors[a] + 0.02 * rng.standard_normal(128).astype(np.float32) for a in anchors]
    return ref, (rdb, rshop), (db, shop), anchors, queries


def _close(a, b, tol=1e-6):
    return len(a) == len(b) and all(abs(x - y) <= tol for x, y in zip(a, b))


@pytest.mark.parametrize("query", ["q1", "q2", "q3", "q4"])
def test_queries_equal_reference_example(both_shops, query):
    """Each query of the port's example returns the reference example's
    rows on the same shop: ids (and names) in order, scores within 1e-6."""
    ref, (rdb, rshop), (db, shop), anchors, queries = both_shops
    for a, q in zip(anchors, queries):
        if query == "q1":
            got, want = q1_vector(shop, q, k=20), ref.q1_vector(rshop, q, k=20)
            assert [h.id for h in got] == [h.id for h in want]
            assert [h.payload for h in got] == [h.payload for h in want]
            assert _close([h.score for h in got], [h.score for h in want])
        elif query == "q2":
            got, want = q2_vector_filtered(db, q), ref.q2_vector_filtered(rdb, q)
            assert [(r["id"], r["name"], r["price"]) for r in got] == [
                (r["id"], r["name"], r["price"]) for r in want]
            assert _close([r["sim"] for r in got], [r["sim"] for r in want])
        elif query == "q3":
            assert q3_graph(shop, a, k=50) == ref.q3_graph(rshop, a, k=50)
        else:
            got = q4_combined(db, shop, q, a, k=10)
            want = ref.q4_combined(rdb, rshop, q, a, k=10)
            assert [(r["id"], r["name"]) for r in got] == [(r["id"], r["name"]) for r in want]
            assert _close([r["score"] for r in got], [r["score"] for r in want])
