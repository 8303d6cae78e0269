"""E-commerce recommendation demo: vector + graph + columns combined.

Counterpart of the reference's flagship showcase
(``examples/ecommerce_recommendation/``): 5,000 products with 11 metadata
fields, ~1,000 simulated users whose behavior events (viewed / added to
cart / purchased) materialize ~20K BOUGHT_TOGETHER and VIEWED_ALSO edges,
and the four reference query types measured end-to-end through the public
query surfaces (reference numbers: vector 187µs / filtered 55µs / graph
88µs / combined 202µs per query on AVX-512):

1. pure vector similarity            (``Collection.search``)
2. vector + business filters         (VelesQL ``similarity() > t AND ...``)
3. graph traversal                   (``MATCH (p)-[:bought_together]->(o)``)
4. combined vector 60% + graph 40% + business rules

The port's copy of ``examples/ecommerce_demo.py``: ``build_shop`` and
``q1_vector`` ... ``q4_combined`` keep the reference's signatures and work
on any ``velesdb_tpu_torch`` database. Run:
``python -m velesdb_tpu_torch.examples.ecommerce_demo`` (on the card;
``--device cpu`` on the CPU; ``--iters`` sets the timed calls a query).
"""

import tempfile
import time

import numpy as np

from velesdb_tpu_torch import Database
from velesdb_tpu_torch.examples import device_args

CATEGORIES = {
    "Electronics": ["Smartphones", "Laptops", "Headphones", "Cameras"],
    "Home": ["Kitchen", "Furniture", "Garden", "Lighting"],
    "Sports": ["Fitness", "Outdoor", "Cycling", "Running"],
}
BRANDS = ["TechPro", "HomeStar", "PeakFit", "Luxa", "Nordic", "Apex"]


def build_shop(db, n_products=5000, n_users=1000, d=128, seed=1):
    """Create the products collection: 11 metadata fields per product,
    subcategory-clustered embeddings, and behavior-derived edges."""
    rng = np.random.default_rng(seed)
    shop = db.create_collection("products", dim=d)

    subcats = [(c, s) for c, subs in CATEGORIES.items() for s in subs]
    # one embedding mode per subcategory: similarity = "same shelf"
    modes = rng.standard_normal((len(subcats), d)).astype(np.float32) * 3
    assign = rng.integers(0, len(subcats), n_products)
    vectors = modes[assign] + 0.7 * rng.standard_normal(
        (n_products, d)
    ).astype(np.float32)

    payloads = []
    for i in range(n_products):
        cat, sub = subcats[assign[i]]
        brand = BRANDS[int(rng.integers(0, len(BRANDS)))]
        payloads.append(
            {
                "name": f"{brand} {sub} {i}",
                "category": cat,
                "subcategory": sub,
                "brand": brand,
                "price": round(float(rng.uniform(5, 1500)), 2),
                "rating": round(float(rng.uniform(2.0, 5.0)), 1),
                "review_count": int(rng.integers(0, 5000)),
                "in_stock": bool(rng.random() < 0.85),
                "stock_quantity": int(rng.integers(0, 200)),
                "release_year": int(rng.integers(2018, 2026)),
                "discount_pct": int(rng.integers(0, 40)),
            }
        )
    shop.upsert_bulk(range(n_products), vectors, payloads)

    # -- user behaviors -> co-purchase / co-view edges ----------------------
    # each user browses one subcategory shelf (realistic correlation), views
    # ~10 items, buys ~3: purchases in one session pair into
    # BOUGHT_TOGETHER; views pair into VIEWED_ALSO
    n_edges = 0
    for _u in range(n_users):
        shelf = int(rng.integers(0, len(subcats)))
        pool = np.flatnonzero(assign == shelf)
        if len(pool) < 4:
            continue
        viewed = rng.choice(pool, size=min(12, len(pool)), replace=False)
        bought = viewed[: max(2, len(viewed) // 3)]
        for ai in range(len(bought)):  # basket all-pairs, both directions
            for bi in range(ai + 1, len(bought)):
                shop.add_edge(int(bought[ai]), int(bought[bi]), "bought_together")
                shop.add_edge(int(bought[bi]), int(bought[ai]), "bought_together")
                n_edges += 2
        for a, b in zip(viewed[:-1], viewed[1:]):
            shop.add_edge(int(a), int(b), "viewed_also")
            n_edges += 1
    shop.flush()
    return shop, vectors, n_edges


# -- the four reference query types ------------------------------------------


def q1_vector(shop, qvec, k=10):
    """Pure semantic similarity (reference Query 1)."""
    return shop.search(qvec, k=k)


def q2_vector_filtered(db, qvec, k=10):
    """Vector + business filters through VelesQL (reference Query 2)."""
    return db.query(
        "SELECT id, name, price, similarity(embedding, $v) AS sim "
        "FROM products "
        "WHERE similarity(embedding, $v) > 0.1 AND in_stock = TRUE "
        "AND price < 500 ORDER BY sim DESC LIMIT " + str(k),
        params={"v": qvec.tolist()},
    )


def q3_graph(shop, product_id, k=10):
    """Frequently-bought-together lookup (reference Query 3)."""
    return shop.execute_match(
        "MATCH (p)-[:bought_together]->(other) WHERE p.id = "
        f"{product_id} RETURN other.name AS name, other.id AS id LIMIT {k}",
    )


def q4_combined(db, shop, qvec, product_id, k=10, price_cap=1000.0):
    """Combined recommendation (reference Query 4): vector score 60% +
    graph proximity 40%, then business rules (in stock, rating >= 4)."""
    scores: dict[int, float] = {}
    for hit in shop.search_batch(qvec[None, :], 50)[0]:
        scores[hit.id] = scores.get(hit.id, 0.0) + 0.6 * float(hit.score)
    for row in q3_graph(shop, product_id, 50):
        scores[row["id"]] = scores.get(row["id"], 0.0) + 0.4
    out = []
    for pid, s in sorted(scores.items(), key=lambda kv: -kv[1]):
        p = shop.get(pid)
        pay = p[1] if p else None
        if not pay or not pay["in_stock"]:
            continue
        if pay["rating"] < 4.0 or pay["price"] >= price_cap:
            continue
        out.append({"id": pid, "score": s, "name": pay["name"]})
        if len(out) >= k:
            break
    return out


def _timed(label, fn, warmups=3, iters=20):
    for _ in range(warmups):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters
    print(f"{label:38s} {dt * 1e6:10.0f} us")
    return dt


def main(argv=None) -> dict:
    """Build the shop, time the four queries and print the top combined
    recommendations; returns ``{"db", "shop", "vectors", "n_edges", "top"}``
    (the database left open)."""
    args = device_args(__doc__.splitlines()[0], argv,
                       path=(str, None, "data directory (default: a new temporary one)"),
                       iters=(int, 20, "timed calls a query, after 3 warm-ups"))
    db = Database.open(args.path or tempfile.mkdtemp(prefix="shop-"), device=args.device)
    iters = args.iters
    print("building 5,000 products / 1,000 users ...")
    shop, vectors, n_edges = build_shop(db)
    print(f"  products: {shop.count():,}; behavior edges: {n_edges:,}")

    rng = np.random.default_rng(7)
    anchor = 1234
    q = vectors[anchor] + 0.05 * rng.standard_normal(len(vectors[0])).astype(
        np.float32
    )

    print("reference per-query times: 187 / 55 / 88 / 202 us")
    _timed("Q1 vector similarity", lambda: q1_vector(shop, q), iters=iters)
    _timed("Q2 vector + filters (VelesQL)", lambda: q2_vector_filtered(db, q), iters=iters)
    _timed("Q3 graph bought-together (MATCH)", lambda: q3_graph(shop, anchor), iters=iters)
    _timed(
        "Q3b raw adjacency lookup",
        lambda: shop.neighbors(anchor, "out", "bought_together"),
        iters=iters,
    )
    _timed(
        "Q4 combined 60/40 + business rules",
        lambda: q4_combined(db, shop, q, anchor),
        iters=iters,
    )

    # batched throughput: where the device engine lives
    batch = q[None, :] + 0.01 * rng.standard_normal((256, len(q))).astype(
        np.float32
    )
    dt = _timed("BATCHED 256-query search", lambda: shop.search_batch(batch, k=10),
                iters=iters)
    print(f"{'-> throughput':38s} {256 / dt:10,.0f} qps")

    top = q4_combined(db, shop, q, anchor)
    print("\ntop combined recommendations:")
    for r in top[:5]:
        print(f"  {r['score']:.3f}  {r['name']}")
    return {"db": db, "shop": shop, "vectors": vectors, "n_edges": n_edges, "top": top}


if __name__ == "__main__":
    main()
