"""The JAX package's end-to-end workflow (``tests/test_e2e_complete.py``) on
the port: create -> bulk ingest -> every search modality -> graph ->
VelesQL -> agent memory -> persistence/reopen -> TTL/vacuum -> delete, under
the reference's test name, the database on the CPU.
"""

import numpy as np
import pytest

from velesdb_tpu_torch.database import Database


def test_complete_workflow(tmp_db_dir, rng):
    # -- create + ingest -----------------------------------------------------
    db = Database.open(tmp_db_dir, device="cpu")
    shop = db.create_collection("shop", dim=32)
    n = 500
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    cats = ["boots", "mugs", "lamps", "desks"]
    shop.upsert_bulk(
        range(n),
        vecs,
        [
            {
                "title": f"{cats[i % 4]} model {i}",
                "category": cats[i % 4],
                "price": float(10 + i % 90),
                "stock": i % 7,
            }
            for i in range(n)
        ],
    )
    assert shop.count() == n

    # -- vector search + filters ---------------------------------------------
    hits = shop.search(vecs[123], k=5)
    assert hits[0].id == 123
    cheap = shop.search(
        vecs[123], k=5, filter={"type": "lt", "field": "price", "value": 30}
    )
    assert all(h.payload["price"] < 30 for h in cheap)

    # -- text / hybrid / multi-query ------------------------------------------
    txt = shop.text_search("boots model 123", k=3)
    assert txt and txt[0].id == 123
    hyb = shop.hybrid_search(vecs[123], "boots", k=5)
    assert 123 in {h.id for h in hyb}
    multi = shop.multi_query_search([vecs[3], vecs[7]], k=6)
    assert {3, 7} <= {h.id for h in multi}

    # -- rerank over a quantized sibling collection ----------------------------
    from velesdb_tpu_torch.ops import StorageMode

    bq = db.create_collection("shop_bin", dim=32, storage_mode=StorageMode.BINARY)
    bq.upsert_bulk(range(n), vecs)
    rr = bq.search_with_rerank(vecs[42], k=3, oversample=16)
    assert rr[0].id == 42

    # -- graph ------------------------------------------------------------------
    for i in range(0, 40, 2):
        shop.add_edge(i, i + 2, "also_bought", {"w": 1.0})
    got = shop.execute_match(
        "MATCH (a {title: 'boots model 0'})-[r:also_bought*1..2]->(b) "
        "RETURN b.title AS t ORDER BY t"
    )
    # 0 -> 2 ('lamps model 2') -> 4 ('boots model 4'... cats[4%4]='boots')
    assert sorted(r["t"] for r in got) == ["boots model 4", "lamps model 2"]
    assert shop.degree(2, "both") == 2
    reach = shop.traverse(0, max_depth=3)
    assert [x[0] for x in reach] == [0, 2, 4, 6]

    # -- VelesQL: filters, joins, aggregates, subqueries -----------------------
    rows = db.query(
        "SELECT category, COUNT(*) AS cnt, AVG(price) AS ap FROM shop "
        "GROUP BY category HAVING COUNT(*) > 10 ORDER BY category"
    )
    assert [r["category"] for r in rows] == sorted(cats)
    assert all(r["cnt"] == 125 for r in rows)
    near = db.query(
        "SELECT title FROM shop WHERE v NEAR $q AND category = 'desks' LIMIT 3",
        {"q": vecs[3]},
    )
    assert near[0]["title"] == "desks model 3"
    orders = db.create_collection("orders", dim=32)
    orders.upsert_bulk(
        range(1000, 1003),
        rng.standard_normal((3, 32)).astype(np.float32),
        [{"item": "boots model 0", "qty": q} for q in (1, 2, 3)],
    )
    joined = db.query(
        "SELECT s.title AS t, SUM(o.qty) AS q FROM shop AS s "
        "JOIN orders AS o ON s.title = o.item GROUP BY s.title"
    )
    assert joined == [{"t": "boots model 0", "q": 6}]
    plan = db.explain_query("SELECT * FROM shop WHERE v NEAR $q LIMIT 2")
    assert "VectorSearch" in plan.render()

    # -- agent memory -----------------------------------------------------------
    from velesdb_tpu_torch.agent import AgentMemory, MemoryKind

    mem = AgentMemory(db, dim=32, agent_id="clerk")
    fid = mem.remember_fact(vecs[1], "customer prefers boots", importance=0.9)
    recalled = mem.recall(MemoryKind.SEMANTIC, vecs[1], k=1)
    assert recalled[0]["id"] == fid
    snap = mem.snapshot("v1")
    mem.forget(MemoryKind.SEMANTIC, fid)
    mem.rollback(snap)
    assert mem.recall(MemoryKind.SEMANTIC, vecs[1], k=1)[0]["id"] == fid

    # -- persistence: flush, close, reopen --------------------------------------
    shop.flush()
    db.close()
    db2 = Database.open(tmp_db_dir, device="cpu")
    shop2 = db2.get_collection("shop")
    assert shop2.count() == n
    assert shop2.search(vecs[123], k=1)[0].id == 123
    assert shop2.text_search("lamps model 2", k=1)[0].payload["category"] == "lamps"
    got2 = shop2.execute_match(
        "MATCH (a)-[:also_bought]->(b {title: 'lamps model 2'}) RETURN a.title AS t"
    )
    assert [r["t"] for r in got2] == ["boots model 0"]

    # -- TTL + vacuum -------------------------------------------------------------
    shop2.upsert(9000, vecs[0], {"title": "flash sale"}, ttl=0.0)
    assert shop2.expire_rows() == 1
    for i in range(0, 200):
        shop2.delete(i)
    report = shop2.vacuum()
    assert report["reclaimed_slots"] >= 200
    assert shop2.count() == n - 200
    assert shop2.search(vecs[300], k=1)[0].id == 300
    db2.close()
