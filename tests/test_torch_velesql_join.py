"""The JAX package's VelesQL JOIN and subquery tests
(``tests/test_velesql_join.py``) on the port, each under the reference's
name, the database on the CPU."""

import numpy as np
import pytest

from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.velesql import QueryError


@pytest.fixture
def db(tmp_db_dir, rng):
    db = Database.open(tmp_db_dir, device="cpu")
    p = db.create_collection("products", dim=4)
    p.upsert_bulk(
        range(3),
        rng.standard_normal((3, 4)).astype(np.float32),
        [
            {"sku": "A", "title": "shoes", "price": 50},
            {"sku": "B", "title": "mug", "price": 9},
            {"sku": "C", "title": "tent", "price": 120},
        ],
    )
    o = db.create_collection("orders", dim=4)
    o.upsert_bulk(
        range(100, 105),
        rng.standard_normal((5, 4)).astype(np.float32),
        [
            {"sku": "A", "qty": 2},
            {"sku": "A", "qty": 1},
            {"sku": "B", "qty": 5},
            {"sku": "Z", "qty": 9},  # no matching product
            {"sku": "C", "qty": 1},
        ],
    )
    return db


def test_inner_join_on(db):
    rows = db.query(
        "SELECT p.title AS t, o.qty AS q FROM products AS p "
        "JOIN orders AS o ON p.sku = o.sku ORDER BY q DESC"
    )
    assert [(r["t"], r["q"]) for r in rows] == [
        ("mug", 5),
        ("shoes", 2),
        ("shoes", 1),
        ("tent", 1),
    ]


def test_join_using_and_pushdown(db):
    rows = db.query(
        "SELECT p.title AS t, o.qty AS q FROM products AS p "
        "LEFT JOIN orders AS o USING (sku) WHERE p.price < 100 AND o.qty > 1 "
        "ORDER BY q"
    )
    assert [(r["t"], r["q"]) for r in rows] == [("shoes", 2), ("mug", 5)]


def test_left_join_keeps_unmatched(db):
    db.get_collection("orders").delete(104)  # drop tent's order
    rows = db.query(
        "SELECT p.title AS t, o.qty AS q FROM products AS p "
        "LEFT JOIN orders AS o ON p.sku = o.sku ORDER BY t"
    )
    by_title = {}
    for r in rows:
        by_title.setdefault(r["t"], []).append(r["q"])
    assert by_title["tent"] == [None]
    assert sorted(by_title["shoes"]) == [1, 2]


def test_right_and_full_join(db):
    rows = db.query(
        "SELECT o.sku AS s, p.title AS t FROM products AS p "
        "RIGHT JOIN orders AS o ON p.sku = o.sku"
    )
    skus = {(r["s"], r["t"]) for r in rows}
    assert ("Z", None) in skus and ("A", "shoes") in skus
    rows = db.query(
        "SELECT p.title AS t, o.sku AS s FROM products AS p "
        "FULL JOIN orders AS o ON p.sku = o.sku WHERE p.price > 200 OR o.qty > 8"
    )
    assert {(r["t"], r["s"]) for r in rows} == {(None, "Z")}


def test_join_with_aggregation(db):
    rows = db.query(
        "SELECT p.title AS t, SUM(o.qty) AS total FROM products AS p "
        "JOIN orders AS o ON p.sku = o.sku GROUP BY p.title ORDER BY total DESC"
    )
    assert rows[0] == {"t": "mug", "total": 5}
    assert {r["t"]: r["total"] for r in rows} == {"mug": 5, "shoes": 3, "tent": 1}


def test_join_with_near(db, rng):
    p = db.get_collection("products")
    vec = p.get(0)[0]
    rows = db.query(
        "SELECT p.title AS t, o.qty AS q FROM products AS p "
        "JOIN orders AS o ON p.sku = o.sku WHERE v NEAR $q LIMIT 2",
        {"q": vec},
    )
    assert rows[0]["t"] == "shoes"


def test_in_subquery(db):
    rows = db.query(
        "SELECT title FROM products WHERE sku IN "
        "(SELECT sku FROM orders WHERE qty > 1) ORDER BY title"
    )
    assert [r["title"] for r in rows] == ["mug", "shoes"]
    rows = db.query(
        "SELECT title FROM products WHERE sku NOT IN "
        "(SELECT sku FROM orders WHERE qty > 1) ORDER BY title"
    )
    assert [r["title"] for r in rows] == ["tent"]


def test_join_unknown_collection(db):
    with pytest.raises(QueryError, match="unknown collection"):
        db.query("SELECT * FROM products AS p JOIN nope AS n ON p.sku = n.sku")
