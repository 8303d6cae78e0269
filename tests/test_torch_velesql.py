"""The JAX package's VelesQL tests (``tests/test_velesql.py``) on the port:
parser, cache, executor, EXPLAIN and limits through ``velesdb_tpu_torch``,
each test under the reference's name, the database on the CPU."""

import numpy as np
import pytest

from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.velesql import ParseError, QueryCache, QueryError, explain, parse
from velesdb_tpu_torch.velesql.ast import Aggregate, SelectStatement, SetOp


# -- parser -------------------------------------------------------------------


def test_parse_basic_select():
    q = parse("SELECT * FROM docs")
    s = q.root
    assert isinstance(s, SelectStatement)
    assert s.collection == "docs"
    assert s.columns[0].expr == "*"
    assert s.limit is None and s.filter is None


def test_parse_near_with_filter_and_options():
    q = parse(
        "SELECT * FROM products WHERE vector NEAR $v AND price < 100 "
        "AND category = 'shoes' ORDER BY similarity(vector, $v) DESC "
        "LIMIT 5 OFFSET 2 WITH (ef_search=256)"
    )
    s = q.root
    assert s.near.field == "vector" and s.near.vectors == ["$v"]
    assert s.filter["type"] == "and"
    types = {c["type"] for c in s.filter["conditions"]}
    assert types == {"lt", "eq"}
    assert s.order_by[0].desc and s.order_by[0].expr[0] == "similarity"
    assert s.limit == 5 and s.offset == 2
    assert s.with_options.ef_search == 256


def test_parse_near_literal_vector():
    s = parse("SELECT * FROM t WHERE v NEAR [0.1, 0.2, 0.3]").root
    assert s.near.vectors == [[0.1, 0.2, 0.3]]


def test_parse_near_fused():
    s = parse(
        "SELECT * FROM t WHERE v NEAR_FUSED [$a, $b] USING FUSION rrf(k=30)"
    ).root
    assert s.near.fused and s.near.vectors == ["$a", "$b"]
    assert s.near.fusion.strategy == "rrf" and s.near.fusion.rrf_k == 30


def test_parse_similarity_threshold_and_match():
    s = parse(
        "SELECT * FROM t WHERE similarity(v, $q) >= 0.8 AND body MATCH 'fox jumps'"
    ).root
    assert s.similarity[0].op == "gte" and s.similarity[0].threshold == 0.8
    assert s.text_match.query == "fox jumps"


def test_parse_not_similarity():
    s = parse("SELECT * FROM t WHERE NOT similarity(v, $q) > 0.9 AND a = 1").root
    assert s.similarity[0].negated
    assert s.filter == {"type": "eq", "field": "a", "value": 1}


def test_parse_union_mode():
    s = parse("SELECT * FROM t WHERE similarity(v, $q) > 0.5 OR price < 10").root
    assert s.where_mode == "or"
    assert s.similarity and s.filter["type"] == "lt"


def test_parse_predicates_lower_to_filter_dsl():
    s = parse(
        "SELECT * FROM t WHERE a IN (1, 2) AND b BETWEEN 0 AND 5 AND "
        "name LIKE '%x%' AND c IS NOT NULL AND NOT (d = 3 OR e != 4)"
    ).root
    f = s.filter
    assert f["type"] == "and"
    kinds = [c["type"] for c in f["conditions"]]
    assert kinds == ["in", "and", "like", "is_not_null", "not"]


def test_parse_group_having_aggregates():
    s = parse(
        "SELECT category, COUNT(*) AS n, AVG(price) FROM t "
        "GROUP BY category HAVING COUNT(*) > 2 ORDER BY n DESC"
    ).root
    assert s.group_by == ["category"]
    assert isinstance(s.columns[1].expr, Aggregate)
    assert s.columns[1].alias == "n"
    assert s.having["op"] == "gt" and s.having["value"] == 2


def test_parse_set_ops():
    q = parse("SELECT * FROM a UNION SELECT * FROM b INTERSECT SELECT * FROM c")
    assert isinstance(q.root, SetOp)


def test_parse_quoted_ident_and_nested_path():
    s = parse('SELECT "weird name" FROM t WHERE meta.color = \'red\'').root
    assert s.columns[0].expr == "weird name"
    assert s.filter["field"] == "meta.color"


def test_parse_temporal_now_interval():
    s = parse("SELECT * FROM t WHERE created_at > NOW() - INTERVAL '7 days'").root
    from velesdb_tpu_torch.velesql.parser import _Now

    v = s.filter["value"]
    assert isinstance(v, _Now) and v.offset == -7 * 86400


def test_parse_string_escape():
    s = parse("SELECT * FROM t WHERE name = 'O''Brien'").root
    assert s.filter["value"] == "O'Brien"


@pytest.mark.parametrize(
    "bad",
    [
        "SELEKT * FROM t",
        "SELECT * FROM",
        "SELECT * FROM t WHERE v NEAR $a AND v NEAR $b",
        "SELECT * FROM t WHERE similarity(v) > 0.5",
        "SELECT * FROM t WHERE frobnicate(v, $q) > 0.5",
        "SELECT * FROM t WITH (bogus=1)",
        "SELECT * FROM t WHERE ts > INTERVAL 'banana days'",
    ],
)
def test_parse_errors(bad):
    with pytest.raises(ParseError):
        parse(bad)


def test_query_cache_hits():
    cache = QueryCache(capacity=2)
    q1 = cache.parse("SELECT * FROM a")
    assert cache.parse("SELECT * FROM a") is q1
    cache.parse("SELECT * FROM b")
    cache.parse("SELECT * FROM c")  # evicts a
    assert cache.parse("SELECT * FROM a") is not q1
    assert cache.stats()["hits"] == 1


# -- executor -------------------------------------------------------------------


@pytest.fixture
def db(tmp_db_dir, rng):
    db = Database.open(tmp_db_dir, device="cpu")
    c = db.create_collection("products", dim=8)
    cats = ["shoes", "mugs", "beans"]
    vecs = rng.standard_normal((9, 8)).astype(np.float32)
    payloads = [
        {
            "title": f"{cats[i % 3]} product {i}",
            "category": cats[i % 3],
            "price": 10 * (i + 1),
            "ts": 1000.0 + i,
        }
        for i in range(9)
    ]
    c.upsert_bulk(range(9), vecs, payloads)
    return db, vecs


def test_exec_near(db):
    d, vecs = db
    rows = d.query("SELECT * FROM products WHERE v NEAR $q LIMIT 3", {"q": vecs[4]})
    assert rows[0]["id"] == 4 and len(rows) == 3
    assert rows[0]["payload"]["price"] == 50


def test_exec_near_with_filter_pushdown(db):
    d, vecs = db
    rows = d.query(
        "SELECT * FROM products WHERE v NEAR $q AND price <= 30 LIMIT 5",
        {"q": vecs[4]},
    )
    ids = {r["id"] for r in rows}
    assert ids <= {0, 1, 2} and len(rows) == 3


def test_exec_pure_filter_scan(db):
    d, _ = db
    rows = d.query(
        "SELECT title, price FROM products WHERE category = 'mugs' ORDER BY price DESC"
    )
    assert [r["price"] for r in rows] == [80, 50, 20]
    assert set(rows[0]) == {"title", "price"}


def test_exec_match_text(db):
    d, _ = db
    rows = d.query("SELECT * FROM products WHERE body MATCH 'beans' LIMIT 5")
    assert {r["id"] for r in rows} == {2, 5, 8}


def test_exec_hybrid_near_and_match(db):
    d, vecs = db
    rows = d.query(
        "SELECT * FROM products WHERE v NEAR $q AND body MATCH 'shoes' LIMIT 4",
        {"q": vecs[3]},
    )
    ids = {r["id"] for r in rows}
    assert 3 in ids  # vector hit (also a shoes item)
    assert ids & {0, 6}  # text hits


def test_exec_union_mode(db):
    d, vecs = db
    rows = d.query(
        "SELECT * FROM products WHERE similarity(v, $q) > 0.99 OR price = 90 LIMIT 9",
        {"q": vecs[1]},
    )
    ids = {r["id"] for r in rows}
    assert ids == {1, 8}


def test_exec_similarity_threshold(db):
    d, vecs = db
    rows = d.query(
        "SELECT * FROM products WHERE v NEAR $q AND similarity(v, $q) > 0.99",
        {"q": vecs[6]},
    )
    assert [r["id"] for r in rows] == [6]


def test_exec_group_by_having(db):
    d, _ = db
    rows = d.query(
        "SELECT category, COUNT(*) AS n, SUM(price) AS total FROM products "
        "GROUP BY category HAVING SUM(price) > 100 ORDER BY total DESC"
    )
    assert all(r["total"] > 100 for r in rows)
    assert rows[0]["total"] >= rows[-1]["total"]
    assert all(r["n"] == 3 for r in rows)


def test_exec_aggregate_no_group(db):
    d, _ = db
    rows = d.query("SELECT COUNT(*), AVG(price), MAX(price) FROM products")
    assert rows == [{"count(*)": 9, "avg(price)": 50.0, "max(price)": 90}]


def test_exec_distinct(db):
    d, _ = db
    rows = d.query("SELECT DISTINCT category FROM products ORDER BY category")
    assert [r["category"] for r in rows] == ["beans", "mugs", "shoes"]


def test_exec_near_fused_multi_vector(db):
    d, vecs = db
    rows = d.query(
        "SELECT * FROM products WHERE v NEAR_FUSED [$a, $b] USING FUSION rrf LIMIT 4",
        {"a": vecs[0], "b": vecs[5]},
    )
    ids = {r["id"] for r in rows}
    assert {0, 5} <= ids


def test_exec_set_ops(db):
    d, _ = db
    rows = d.query(
        "SELECT * FROM products WHERE price < 40 "
        "EXCEPT SELECT * FROM products WHERE category = 'mugs'"
    )
    assert {r["id"] for r in rows} == {0, 2}
    rows = d.query(
        "SELECT * FROM products WHERE price < 30 "
        "UNION SELECT * FROM products WHERE price < 30"
    )
    assert len(rows) == 2


def test_exec_temporal(db):
    d, _ = db
    rows = d.query("SELECT * FROM products WHERE ts < NOW() - INTERVAL '1 hour'")
    assert len(rows) == 9  # all fixture ts are epoch ~1000


def test_exec_missing_param_and_collection(db):
    d, _ = db
    with pytest.raises(QueryError, match="missing parameter"):
        d.query("SELECT * FROM products WHERE v NEAR $nope")
    with pytest.raises(QueryError, match="unknown collection"):
        d.query("SELECT * FROM nothere")


def test_exec_offset_pagination(db):
    d, _ = db
    all_rows = d.query("SELECT id FROM products ORDER BY price LIMIT 9")
    page2 = d.query("SELECT id FROM products ORDER BY price LIMIT 3 OFFSET 3")
    assert [r["id"] for r in page2] == [r["id"] for r in all_rows[3:6]]


def test_explain_plan(db):
    d, _ = db
    plan = d.explain_query(
        "SELECT * FROM products WHERE v NEAR $q AND price < 50 LIMIT 3"
    )
    txt = plan.render()
    assert "VectorSearch" in txt and "mask pushdown" in txt and "Limit" in txt
    plan2 = d.explain_query("SELECT category, COUNT(*) FROM products GROUP BY category")
    assert "Aggregate" in plan2.render() and "Scan" in plan2.render()


def test_limits_validation(db):
    d, _ = db
    from velesdb_tpu_torch.velesql.validation import ValidationError, validate_vector
    from velesdb_tpu_torch.utils.config import LimitsConfig

    with pytest.raises(QueryError, match="max_k"):
        d.query("SELECT * FROM products LIMIT 999999")
    lim = LimitsConfig(max_dim=4)
    with pytest.raises(ValidationError, match="max_dim"):
        validate_vector(np.ones(8), lim)
    with pytest.raises(ValidationError, match="NaN"):
        validate_vector([1.0, float("nan")], lim)


def test_exec_hybrid_fused_matches_host_fusion(tmp_db_dir, rng):
    """The executor's single-readback device-fused NEAR+MATCH (r4) must rank
    like the host two-branch path (`_fuse_rows` over rrf_fuse)."""
    from velesdb_tpu_torch.fusion import rrf_fuse

    d = Database.open(tmp_db_dir, device="cpu")
    c = d.create_collection("items", dim=16, metric="cosine")
    n = 4000
    vecs = rng.standard_normal((n, 16)).astype(np.float32)
    words = ["shoes", "boots", "coffee", "laptop"]
    c.upsert_bulk(
        range(n), vecs,
        [{"body": words[i % 4], "price": float(i % 100)} for i in range(n)],
    )
    rows = d.query(
        "SELECT * FROM items WHERE v NEAR $q AND body MATCH 'shoes' "
        "AND price < 50 LIMIT 8",
        {"q": vecs[4]},
    )
    # host oracle over the same fetch window (executor: max(4*need, 32) = 32)
    fetch = 32
    vec_hits = c.search(vecs[4], fetch, filter={"type": "lt", "field": "price", "value": 50.0})
    txt_hits = c.text_search("shoes", fetch, filter={"type": "lt", "field": "price", "value": 50.0})
    # FULL host fused map (no top-8 cut): the 3/4 of docs sharing
    # body='shoes' have IDENTICAL BM25 scores, so rank ties are everywhere
    # (device breaks them by list position, host by smaller id) — the stable
    # invariants are (a) identical fused-score ladders at the cut and
    # (b) every returned (id, score) pair exists in the host fused map
    want_all = dict(rrf_fuse(
        [[(r.id, r.score) for r in vec_hits], [(r.id, r.score) for r in txt_hits]],
        10 ** 9,
    ))
    want_top = sorted(want_all.items(), key=lambda t: (-t[1], t[0]))[: len(rows)]
    got_ids = [r["id"] for r in rows]
    # exact id-for-id agreement: the device fusion sorts (-score, slot)
    # lexicographically (fused_rrf r4), matching the host (-score, id) rule
    # on this fresh bulk-loaded collection (slot order == id order)
    assert got_ids == [vid for vid, _ in want_top], (got_ids, want_top)
    np.testing.assert_allclose(
        [r["score"] for r in rows], [s for _, s in want_top], rtol=1e-6
    )
    for r in rows:
        assert r["payload"]["price"] < 50
    assert 4 in got_ids  # planted vector hit passes both filter and fusion
