"""The JAX package's correlated-subquery tests
(``tests/test_subquery_correlated.py``) on the port, each under the
reference's name, the database on the CPU."""

import numpy as np
import pytest

from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.velesql import QueryError
from velesdb_tpu_torch.velesql.parser import ParseError, parse


@pytest.fixture
def db(tmp_db_dir, rng):
    db = Database.open(tmp_db_dir, device="cpu")
    o = db.create_collection("orders", dim=4)
    o.upsert_bulk(
        range(1, 5),
        rng.standard_normal((4, 4)).astype(np.float32),
        [
            {"customer": "ann", "total": 100, "region": "west"},
            {"customer": "bob", "total": 20, "region": "east"},
            {"customer": "cat", "total": 300, "region": "west"},
            {"customer": "dan", "total": 50, "region": "east"},
        ],
    )
    it = db.create_collection("items", dim=4)
    it.upsert_bulk(
        range(10, 16),
        rng.standard_normal((6, 4)).astype(np.float32),
        [
            {"order_id": 1, "amount": 60},
            {"order_id": 1, "amount": 40},
            {"order_id": 3, "amount": 300},
            {"order_id": 4, "amount": 10},
            {"order_id": 4, "amount": 15},
            {"order_id": 99, "amount": 5},  # orphan
        ],
    )
    return db


# -- parser-level detection ---------------------------------------------------


def test_correlation_detected_on_exists():
    q = parse(
        "SELECT * FROM orders AS o WHERE EXISTS "
        "(SELECT * FROM items WHERE order_id = o.id)"
    )
    corr = q.root.filter["correlations"]
    assert len(corr) == 1
    assert corr[0]["op"] == "eq"
    assert corr[0]["inner"] == "order_id"
    assert corr[0]["outer"] == "o.id"


def test_same_table_shadowing_is_not_correlated():
    # the reference's test_correlated_subquery_detection_basic semantics
    q = parse(
        "SELECT * FROM orders WHERE total > (SELECT AVG(total) FROM orders)"
    )
    assert q.root.filter["correlations"] == []


def test_non_eq_correlation_direction_normalized():
    # outer ref on the LHS: o.total < amount  ==  amount > o.total
    q = parse(
        "SELECT * FROM orders AS o WHERE EXISTS "
        "(SELECT * FROM items WHERE o.total < amount)"
    )
    (c,) = q.root.filter["correlations"]
    assert (c["op"], c["inner"], c["outer"]) == ("gt", "amount", "o.total")


def test_both_sides_outer_rejected():
    with pytest.raises(ParseError):
        parse(
            "SELECT * FROM orders AS o WHERE EXISTS "
            "(SELECT * FROM items WHERE o.a = o.b)"
        )


# -- correlated EXISTS / NOT EXISTS (hash semi-join path) --------------------


def test_correlated_exists(db):
    rows = db.query(
        "SELECT id FROM orders AS o WHERE EXISTS "
        "(SELECT * FROM items WHERE order_id = o.id) ORDER BY id"
    )
    assert [r["id"] for r in rows] == [1, 3, 4]


def test_correlated_not_exists(db):
    rows = db.query(
        "SELECT id FROM orders AS o WHERE NOT EXISTS "
        "(SELECT * FROM items WHERE order_id = o.id)"
    )
    assert [r["id"] for r in rows] == [2]


def test_correlated_exists_with_inner_filter(db):
    rows = db.query(
        "SELECT id FROM orders AS o WHERE EXISTS "
        "(SELECT * FROM items WHERE order_id = o.id AND amount > 50) "
        "ORDER BY id"
    )
    assert [r["id"] for r in rows] == [1, 3]


# -- correlated IN ------------------------------------------------------------


def test_correlated_in(db):
    # orders whose id appears among items of amount > 30 (redundant shape,
    # but exercises IN + correlation via region equality)
    rows = db.query(
        "SELECT id FROM orders AS o WHERE id IN "
        "(SELECT order_id FROM items WHERE order_id = o.id AND amount >= 40) "
        "ORDER BY id"
    )
    assert [r["id"] for r in rows] == [1, 3]


# -- correlated scalar comparisons (per-group aggregates) --------------------


def test_correlated_scalar_avg(db):
    # orders whose total exceeds the average of their own items
    rows = db.query(
        "SELECT id FROM orders AS o WHERE total > "
        "(SELECT AVG(amount) FROM items WHERE order_id = o.id) ORDER BY id"
    )
    # order 1: avg 50 < 100 yes; order 3: avg 300 = 300 no; order 4: 12.5 < 50
    assert [r["id"] for r in rows] == [1, 4]


def test_correlated_count_zero(db):
    # COUNT over an empty correlated group is 0, not NULL
    rows = db.query(
        "SELECT id FROM orders AS o WHERE "
        "(SELECT COUNT(*) FROM items WHERE order_id = o.id) = 0"
    )
    assert [r["id"] for r in rows] == [2]


# -- PerRow strategy (non-equality / predicate correlations) -----------------


def test_per_row_non_eq_correlation(db):
    # items with amount greater than the order's total (non-equi)
    rows = db.query(
        "SELECT id FROM orders AS o WHERE EXISTS "
        "(SELECT * FROM items WHERE amount > o.total)"
    )
    # totals: 100, 20, 300, 50 — max amount 300 → orders with total < 300
    assert [r["id"] for r in sorted(rows, key=lambda r: r["id"])] == [1, 2, 4]


def test_per_row_pred_correlation(db):
    # o.region = 'west' is constant per outer row -> PerRow strategy
    rows = db.query(
        "SELECT id FROM orders AS o WHERE EXISTS "
        "(SELECT * FROM items WHERE order_id = o.id AND o.region = 'west') "
        "ORDER BY id"
    )
    assert [r["id"] for r in rows] == [1, 3]


def test_per_row_cap_raises(db, monkeypatch):
    import velesdb_tpu_torch.velesql.executor as ex

    monkeypatch.setattr(ex, "CORRELATED_PERROW_MAX", 2)
    with pytest.raises(QueryError, match="PerRow cap"):
        db.query(
            "SELECT id FROM orders AS o WHERE EXISTS "
            "(SELECT * FROM items WHERE amount > o.total)"
        )


# -- non-correlated scalar subquery ------------------------------------------


def test_scalar_subquery_non_correlated(db):
    rows = db.query(
        "SELECT id FROM orders WHERE total > "
        "(SELECT AVG(total) FROM orders) ORDER BY id"
    )
    # avg total = 117.5
    assert [r["id"] for r in rows] == [3]


def test_scalar_subquery_empty_matches_nothing(db):
    rows = db.query(
        "SELECT id FROM orders WHERE total > "
        "(SELECT AVG(amount) FROM items WHERE amount > 10000)"
    )
    assert rows == []


def test_non_correlated_exists_true_false(db):
    assert len(db.query(
        "SELECT id FROM orders WHERE EXISTS (SELECT * FROM items)"
    )) == 4
    assert db.query(
        "SELECT id FROM orders WHERE EXISTS "
        "(SELECT * FROM items WHERE amount > 10000)"
    ) == []


# -- field-to-field comparison + virtual id column ---------------------------


def test_local_field_cmp(db, rng):
    c = db.create_collection("budgeted", dim=4)
    c.upsert_bulk(
        range(3),
        rng.standard_normal((3, 4)).astype(np.float32),
        [
            {"price": 5, "budget": 10},
            {"price": 20, "budget": 10},
            {"price": 7, "budget": 7},
        ],
    )
    rows = db.query("SELECT id FROM budgeted WHERE price < budget")
    assert [r["id"] for r in rows] == [0]
    rows = db.query("SELECT id FROM budgeted WHERE price = budget")
    assert [r["id"] for r in rows] == [2]


def test_id_filter_pushdown(db):
    rows = db.query("SELECT id FROM orders WHERE id IN (1, 3) ORDER BY id")
    assert [r["id"] for r in rows] == [1, 3]
    rows = db.query("SELECT id FROM orders WHERE id >= 3 ORDER BY id")
    assert [r["id"] for r in rows] == [3, 4]


def test_correlated_exists_in_or_branch(db):
    rows = db.query(
        "SELECT id FROM orders AS o WHERE total > 250 OR EXISTS "
        "(SELECT * FROM items WHERE order_id = o.id AND amount < 20) "
        "ORDER BY id"
    )
    # total > 250: order 3; items < 20: orders 4 (10, 15)
    assert [r["id"] for r in rows] == [3, 4]
