"""Quickstart: collections, search, filters, VelesQL, text, hybrid, graph.

The port's copy of ``examples/quickstart.py``. Run:
``python -m velesdb_tpu_torch.examples.quickstart`` (on the card;
``--device cpu`` on the CPU).
"""

import tempfile

import numpy as np

from velesdb_tpu_torch import Database
from velesdb_tpu_torch.examples import device_args


def main(argv=None) -> None:
    args = device_args(__doc__.splitlines()[0], argv,
                       path=(str, None, "data directory (default: a new temporary one)"))
    rng = np.random.default_rng(0)
    db = Database.open(args.path or tempfile.mkdtemp(prefix="velesdb-"), device=args.device)

    # -- vectors + payloads -----------------------------------------------------
    products = db.create_collection("products", dim=128)  # metric="cosine"
    n = 1000
    vectors = rng.standard_normal((n, 128)).astype(np.float32)
    categories = ["shoes", "mugs", "tents", "books"]
    products.upsert_bulk(
        range(n),
        vectors,
        [
            {
                "title": f"{categories[i % 4]} item {i}",
                "category": categories[i % 4],
                "price": round(float(rng.uniform(5, 200)), 2),
            }
            for i in range(n)
        ],
    )

    # vector search (exact scan below the ANN crossover)
    hits = products.search(vectors[42], k=3)
    print("vector:", [(h.id, round(h.score, 3)) for h in hits])

    # filter pushdown (the mask applied in the scan, not after it)
    hits = products.search(
        vectors[42], k=3, filter={"type": "lt", "field": "price", "value": 50}
    )
    print("filtered:", [(h.id, h.payload["price"]) for h in hits])

    # BM25 text + hybrid fusion
    print("text:", [h.id for h in products.text_search("shoes item 42", k=3)])
    print(
        "hybrid:",
        [h.id for h in products.hybrid_search(vectors[42], "shoes", k=3)],
    )

    # VelesQL: one language over all of it
    rows = db.query(
        "SELECT title, price FROM products "
        "WHERE v NEAR $q AND category = 'shoes' AND price BETWEEN 20 AND 150 "
        "ORDER BY similarity(v, $q) DESC LIMIT 3 WITH (ef_search=256)",
        {"q": vectors[42]},
    )
    print("velesql:", rows)
    print(db.explain_query("SELECT * FROM products WHERE v NEAR $q LIMIT 3").render())

    # knowledge graph over the same collection
    products.add_edge(42, 43, "also_bought")
    products.add_edge(43, 44, "also_bought")
    print(
        "match:",
        products.execute_match(
            "MATCH (a)-[:also_bought*1..2]->(b) WHERE a.price > 0 "
            "RETURN b.title AS t LIMIT 5"
        ),
    )

    products.flush()
    db.close()
    print("done")


if __name__ == "__main__":
    main()
