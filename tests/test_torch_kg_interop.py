"""The knowledge graph across the two packages: ``edges.npz`` written by
either package is read by the other and MATCH then returns the same rows,
and the port's vectorized ``EdgeStore.remove_node_edges`` leaves the same
alive edges and returns the same counts as the reference's Python walk."""

import numpy as np
import pytest

import velesdb_tpu
import velesdb_tpu_torch
from test_torch_velesql_slice import _same
from velesdb_tpu.graph import EdgeStore as RefEdgeStore
from velesdb_tpu_torch.graph import EdgeStore

N, D = 400, 8
MATCHES = [
    "MATCH (a:Item {shelf: 3})-[r:next*1..2]->(b) RETURN a.i AS ai, b.i AS bi, r "
    "ORDER BY bi LIMIT 50",
    "MATCH (a)<-[:rel]-(b:Item) WHERE b.i < 40 AND similarity(a, $v) > 0.2 "
    "RETURN a, b.i AS bi, similarity(a, $v) AS s ORDER BY s DESC LIMIT 20",
]


def _graph(col, seed):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    for i in range(N):
        col.add_node(i, ["Item"], {"i": i, "shelf": i % 7}, vecs[i])
    for i in range(N - 1):
        col.add_edge(i, i + 1, "next", {"w": float(i % 3)})
    for s, t in rng.integers(0, N, (600, 2)):
        col.add_edge(int(s), int(t), "rel")
    for vid in (5, 77, 310):  # the delete hook drops their edges
        col.delete(vid)
    return vecs


def _rows(db, name, vecs):
    return [db.match_query(name, m, {"v": vecs[9]}) for m in MATCHES]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_edges_npz_reads_back_in_the_other_package(tmp_path, writer):
    """A reopened store renumbers the edges it kept, in either package, so
    the rows of the writer's package after its own reopen are the ones the
    other package must return (similarity scores within 1e-5 relative)."""
    path = str(tmp_path / "db")
    open_ref = velesdb_tpu.Database.open
    open_port = lambda p: velesdb_tpu_torch.Database.open(p, device="cpu")  # noqa: E731
    first, second = (open_ref, open_port) if writer == "reference" else (open_port, open_ref)
    db = first(path)
    vecs = _graph(db.create_collection("g", D), seed=3)
    db.close()
    db = first(path)
    want = _rows(db, "g", vecs)
    want_edges = db.get_collection("g").get_edges(9, "out")
    want_reach = db.get_collection("g").traverse(0, max_depth=4)
    db.close()
    other = second(path)
    got = _rows(other, "g", vecs)
    assert all(w for w in want)
    _same(got, want)
    assert other.get_collection("g").get_edges(9, "out") == want_edges
    assert other.get_collection("g").traverse(0, max_depth=4) == want_reach
    other.close()


def test_remove_node_edges_matches_reference():
    rng = np.random.default_rng(8)
    ref, port = RefEdgeStore(), EdgeStore()
    edges = rng.integers(0, 300, (5000, 2))
    for s, t in edges:
        ref.add_edge(int(s), int(t), "e")
        port.add_edge(int(s), int(t), "e")
    for step, node in enumerate(rng.integers(0, 320, 150).tolist() + [7, 7, 999]):
        assert port.remove_node_edges(node) == ref.remove_node_edges(node)
        if step % 25 == 0:  # appends between deletes rebuild the endpoint arrays
            s, t = (int(x) for x in rng.integers(0, 300, 2))
            assert port.add_edge(s, t, "f") == ref.add_edge(s, t, "f")
            assert port.remove_edge(step) == ref.remove_edge(step)
    assert port._alive == ref._alive and len(port) == len(ref)
    for d in ("out", "in"):
        np.testing.assert_array_equal(port.csr(d).eids, ref.csr(d).eids)
        np.testing.assert_array_equal(port.csr(d).dst, ref.csr(d).dst)


FAN_MATCHES = {
    "plain": "MATCH (a:L)-[:F]->(b:R) RETURN a.i AS ai, b.j AS bj LIMIT 5000",
    "path": "MATCH (a:L)-[r:F]->(b:R) RETURN a.i AS ai, r, b LIMIT 5000",
    "path_2hop": "MATCH (a:L)-[r:F*1..2]->(b) RETURN a, r, b.j LIMIT 5000",
    "where": "MATCH (a:L)-[r:F]->(b:R) WHERE a.i < 12 AND b.j > 3 "
             "RETURN a.i AS ai, r, similarity(b, $v) AS s LIMIT 5000",
    "where_sim": "MATCH (a:L)-[:F]->(b:R) WHERE similarity(b, $v) > 0.1 "
                 "RETURN b.j AS bj, a LIMIT 5000",
    "cycle": "MATCH (a:L)-[:F]->(b:R)-[:B]->(a) RETURN a.i AS ai, b.j AS bj LIMIT 5000",
    "no_rows": "MATCH (a:L)-[:NONE]->(b) RETURN a.i AS ai LIMIT 10",
}


@pytest.mark.parametrize("query", sorted(FAN_MATCHES))
def test_match_join_rows_equal_reference_in_order(tmp_path, query):
    """The hop join and its projection run on columns of bindings, not one
    dict a row: on a fan-out small enough to compare in full (40 x 24, plus
    second hops and back edges), every join form returns the reference's
    rows in the reference's order, with no ORDER BY to reorder them."""
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((70, D)).astype(np.float32)
    out = []
    for pkg, kw in ((velesdb_tpu, {}), (velesdb_tpu_torch, {"device": "cpu"})):
        db = pkg.Database.open(str(tmp_path / pkg.__name__), **kw)
        col = db.create_collection("fan", D)
        for i in range(40):
            col.add_node(i, ["L"], {"i": i}, vecs[i])
        for j in range(24):
            col.add_node(100 + j, ["R"], {"j": j}, vecs[40 + j])
        for i in range(40):
            for j in range(24):
                if (i * 7 + j) % 3:
                    col.add_edge(i, 100 + j, "F")
        for j in range(24):
            col.add_edge(100 + j, j % 40, "B")
            col.add_edge(100 + j, 100 + (j + 1) % 24, "F")
        out.append(col.execute_match(FAN_MATCHES[query], {"v": vecs[50]}))
        db.close()
    want, got = out
    assert want or query == "no_rows"
    _same(got, want)
