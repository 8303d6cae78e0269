"""Filter DSL + ColumnStore tests (filter/ and column_store/ test analogs).

The reference's ``tests/test_filters.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made. The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""

import numpy as np
import pytest
import torch

from velesdb_tpu_torch.column.filter import (
    FilterError,
    like_to_regex,
    matches,
    normalize_filter,
)
from velesdb_tpu_torch.column.store import ColumnStore
from velesdb_tpu_torch.database import Database


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def F(**kw):
    return kw


def test_matches_basic_ops():
    p = {"category": "tech", "price": 99, "meta": {"rank": 3}, "tags": ["a", "b"]}
    assert matches(p, {"type": "eq", "field": "category", "value": "tech"})
    assert not matches(p, {"type": "eq", "field": "category", "value": "food"})
    assert matches(p, {"type": "neq", "field": "category", "value": "food"})
    assert matches(p, {"type": "gt", "field": "price", "value": 50})
    assert not matches(p, {"type": "gt", "field": "price", "value": 99})
    assert matches(p, {"type": "gte", "field": "price", "value": 99})
    assert matches(p, {"type": "lt", "field": "price", "value": 100})
    assert matches(p, {"type": "eq", "field": "meta.rank", "value": 3})  # nested
    assert matches(p, {"type": "in", "field": "category", "values": ["tech", "x"]})
    assert matches(p, {"type": "in", "field": "tags", "values": ["b"]})  # list field
    assert matches(p, {"type": "contains", "field": "category", "value": "ec"})
    assert matches(p, {"type": "is_null", "field": "nope"})
    assert matches(p, {"type": "is_not_null", "field": "price"})


def test_matches_boolean_combinators():
    p = {"a": 1, "b": 2}
    c = {
        "type": "and",
        "conditions": [
            {"type": "eq", "field": "a", "value": 1},
            {"type": "or", "conditions": [
                {"type": "eq", "field": "b", "value": 3},
                {"type": "gt", "field": "b", "value": 1},
            ]},
        ],
    }
    assert matches(p, c)
    assert not matches(p, {"type": "not", "condition": c})


def test_like_patterns():
    assert like_to_regex("te%").match("tech")
    assert like_to_regex("te_h").match("tech")
    assert not like_to_regex("te_h").match("teach")
    assert like_to_regex("100\\%").match("100%")
    assert not like_to_regex("TECH").match("tech")
    assert like_to_regex("TECH", case_insensitive=True).match("tech")
    assert matches({"s": "hello world"}, {"type": "like", "field": "s", "pattern": "hello%"})
    assert matches({"s": "Hello"}, {"type": "ilike", "field": "s", "pattern": "hello"})


def test_normalize_and_validation():
    c = normalize_filter({"condition": {"type": "eq", "field": "a", "value": 1}})
    assert c["type"] == "eq"
    with pytest.raises(FilterError):
        normalize_filter({"type": "frobnicate", "field": "a"})
    with pytest.raises(FilterError):
        normalize_filter({"type": "like", "field": "a"})  # missing pattern
    with pytest.raises(FilterError):
        normalize_filter({"field": "a"})  # no type


@pytest.fixture
def store():
    cs = ColumnStore()
    rows = [
        {"cat": "tech", "price": 10, "on_sale": True},
        {"cat": "tech", "price": 25, "on_sale": False},
        {"cat": "food", "price": 5.5, "on_sale": True},
        {"cat": "food", "price": 7, "meta": {"rank": 2}},
        None,
    ]
    for slot, p in enumerate(rows):
        cs.upsert_row(slot, p)
    return cs


def test_column_mask_eq_and_range(store):
    m = store.mask_for_filter({"type": "eq", "field": "cat", "value": "tech"}, 5)
    np.testing.assert_array_equal(m, [True, True, False, False, False])
    m = store.mask_for_filter({"type": "lt", "field": "price", "value": 10}, 5)
    np.testing.assert_array_equal(m, [False, False, True, True, False])
    m = store.mask_for_filter(
        {"type": "and", "conditions": [
            {"type": "eq", "field": "cat", "value": "food"},
            {"type": "gte", "field": "price", "value": 6},
        ]}, 5)
    np.testing.assert_array_equal(m, [False, False, False, True, False])


def test_column_mask_nested_in_null_like(store):
    m = store.mask_for_filter({"type": "eq", "field": "meta.rank", "value": 2}, 5)
    np.testing.assert_array_equal(m, [False, False, False, True, False])
    m = store.mask_for_filter({"type": "in", "field": "cat", "values": ["food", "zz"]}, 5)
    np.testing.assert_array_equal(m, [False, False, True, True, False])
    m = store.mask_for_filter({"type": "is_null", "field": "on_sale"}, 5)
    np.testing.assert_array_equal(m, [False, False, False, True, True])
    m = store.mask_for_filter({"type": "like", "field": "cat", "pattern": "te%"}, 5)
    np.testing.assert_array_equal(m, [True, True, False, False, False])
    m = store.mask_for_filter({"type": "eq", "field": "on_sale", "value": True}, 5)
    np.testing.assert_array_equal(m, [True, False, True, False, False])


def test_column_int_float_widening(store):
    # price column saw ints and floats -> float kind, comparisons still work
    m = store.mask_for_filter({"type": "eq", "field": "price", "value": 5.5}, 5)
    np.testing.assert_array_equal(m, [False, False, True, False, False])


def test_mask_matches_payload_semantics(store):
    """Vectorized masks agree with per-payload matching (same DSL)."""
    rows = [
        {"cat": "tech", "price": 10, "on_sale": True},
        {"cat": "tech", "price": 25, "on_sale": False},
        {"cat": "food", "price": 5.5, "on_sale": True},
        {"cat": "food", "price": 7, "meta": {"rank": 2}},
        None,
    ]
    conds = [
        {"type": "neq", "field": "cat", "value": "tech"},
        {"type": "not", "condition": {"type": "gt", "field": "price", "value": 9}},
        {"type": "or", "conditions": [
            {"type": "ilike", "field": "cat", "pattern": "TE%"},
            {"type": "is_null", "field": "price"},
        ]},
    ]
    for c in conds:
        m = store.mask_for_filter(c, 5)
        # neq on missing rows: column semantics treat null as no-match, while
        # payload matching on None payload says v != value -> True; align by
        # checking only non-null rows
        for slot, p in enumerate(rows):
            if p is not None:
                assert m[slot] == matches(p, c), (c, slot)


def test_unknown_column(store):
    m = store.mask_for_filter({"type": "eq", "field": "zzz", "value": 1}, 5)
    assert not m.any()
    m = store.mask_for_filter({"type": "is_null", "field": "zzz"}, 5)
    assert m.all()


def test_ttl_vacuum():
    cs = ColumnStore()
    cs.upsert_row(0, {"a": 1}, ttl=0.0)
    cs.upsert_row(1, {"a": 2})
    assert cs.vacuum() == 1
    m = cs.mask_for_filter({"type": "is_not_null", "field": "a"}, 2)
    np.testing.assert_array_equal(m, [False, True])


def test_collection_filtered_search(tmp_db_dir, rng):
    """End-to-end: filter pushdown into masked exact search."""
    db = Database.open(tmp_db_dir, device="cpu")
    col = db.create_collection("shop", 64)
    vecs = rng.standard_normal((500, 64)).astype(np.float32)
    col.upsert_bulk(
        range(500), vecs,
        [{"price": i % 100, "cat": "a" if i % 2 else "b"} for i in range(500)],
    )
    res = col.search(vecs[10], k=5, filter={"type": "eq", "field": "cat", "value": "a"})
    assert all(r["payload"]["cat"] == "a" for r in res)
    assert all(r["id"] % 2 == 1 for r in res)
    res = col.search(
        vecs[10], k=5,
        filter={"type": "and", "conditions": [
            {"type": "lt", "field": "price", "value": 20},
            {"type": "eq", "field": "cat", "value": "b"},
        ]},
    )
    assert res and all(r["payload"]["price"] < 20 and r["payload"]["cat"] == "b" for r in res)
    # filter that matches nothing
    res = col.search(vecs[0], k=5, filter={"type": "eq", "field": "cat", "value": "zz"})
    assert res == []
    db.close()


def test_collection_filter_after_reopen(tmp_db_dir, rng):
    db = Database.open(tmp_db_dir, device="cpu")
    col = db.create_collection("r", 16)
    vecs = rng.standard_normal((20, 16)).astype(np.float32)
    col.upsert_bulk(range(20), vecs, [{"v": i} for i in range(20)])
    col.flush()
    db.close()
    db2 = Database.open(tmp_db_dir, device="cpu")
    col2 = db2.get_collection("r")
    res = col2.search(vecs[3], k=3, filter={"type": "gte", "field": "v", "value": 10})
    assert all(r["payload"]["v"] >= 10 for r in res)
    db2.close()
