"""The port's serving surfaces against the JAX package's, on the CPU.

- One seeded script of HTTP requests goes to the reference's ``make_server``
  and to the port's ``make_server(device="cpu")``, each over its own
  directory: every response has the same status and the same JSON, ids equal
  and floats to rtol 1e-5 (fp32 in a different summation order). The keys
  that differ by design: ``info()`` carries ``exact_serve`` in the reference
  and ``serve_engine``, ``device``, ``rerank_oversample`` and
  ``storage_recall`` in the port; ``/metrics`` has no demotion gauge in the
  port (neither package demotes a kernel here); ``/openapi.json`` names its
  package, so only its paths are compared; ``reindex_events`` carry the
  wall-clock time of the build.
- A directory written through one package's server, then reopened, answers
  the other package's server as it answers its own, both ways.
- The CLI's ``create`` / ``import`` / ``query`` / ``export`` print the same
  JSON in both packages (``create``'s info() but for the keys above).

Every HTTP call carries a timeout; every server is shut down and closed in
teardown.
"""

import contextlib
import json
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np

from velesdb_tpu.cli import main as ref_cli
from velesdb_tpu.server.app import make_server as ref_make_server
from velesdb_tpu_torch.cli import main as port_cli
from velesdb_tpu_torch.server.app import make_server as port_make_server

TIMEOUT = 60
RTOL = 1e-5
DIM = 16
N = 300
# info() keys of one package only (see the module docstring)
INFO_ONLY = {"exact_serve", "serve_engine", "device", "rerank_oversample", "storage_recall",
             "last_calibration_error", "kernel_demotions"}
WORDS = ["coffee", "laptop", "guitar", "jacket", "novel", "espresso", "keyboard"]


@contextlib.contextmanager
def serving(make, path, **kw):
    httpd = make(path, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        for bt in httpd.app._batchers.values():
            bt.stop()
        httpd.app.db.close()
        thread.join(timeout=TIMEOUT)


def _req(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        base + path, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            raw = resp.read().decode()
            ctype = resp.headers.get("Content-Type", "")
            return resp.status, json.loads(raw) if "json" in ctype else raw
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def same(got, want, where="$"):
    """``got`` (the port's) against ``want`` (the reference's): equal JSON but
    for floats (rtol 1e-5) and the info() keys of one package."""
    if isinstance(want, dict):
        assert isinstance(got, dict), where
        keys = set(want) | set(got)
        if "collection_type" in keys:  # a collection's info()
            keys -= INFO_ONLY
        for key in keys:
            assert key in got and key in want, f"{where}: key {key!r} in one package only"
            same(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), f"{where}: {got} != {want}"
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), where
        assert abs(got - want) <= RTOL * abs(want) + RTOL, f"{where}: {got} != {want}"
    else:
        assert got == want, f"{where}: {got!r} != {want!r}"


def _data():
    rng = np.random.default_rng(21)
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    words = np.array(WORDS)
    points = [
        {"id": i, "vector": vecs[i].tolist(),
         "payload": {"title": f"{words[i % 7]} {words[(3 * i) % 7]} item {i}",
                     "price": float(np.round(rng.uniform(1, 100), 2)), "grp": i % 4,
                     "_labels": ["Item"]}}
        for i in range(N)
    ]
    queries = (vecs[:8] + 0.1 * rng.standard_normal((8, DIM))).astype(np.float32)
    return vecs, points, queries


def write_script(vecs, points, queries):
    """``(method, path, body)`` requests that build the collection: create,
    the points, edges, a delete, index knobs."""
    reqs = [
        ("POST", "/collections", {"name": "items", "dim": DIM, "metric": "cosine"}),
        ("POST", "/collections", {"name": "items", "dim": DIM}),  # 409
        ("POST", "/collections", {"name": "x"}),  # 400: no dim
    ]
    for s in range(0, N, 100):
        reqs.append(("PUT", "/collections/items/points", {"points": points[s : s + 100]}))
    reqs.append(("PUT", "/collections/items/points", {"points": []}))  # 400
    for i in range(0, 40, 2):
        reqs.append(("POST", "/collections/items/edges",
                     {"src": i, "dst": i + 2, "label": "next", "properties": {"w": i}}))
    reqs += [
        ("POST", "/collections/items/edges", {"src": 0, "dst": 5, "label": "alt"}),
        ("DELETE", "/collections/items/points/299", None),
        ("DELETE", "/collections/items/points/299", None),  # 404
        ("PATCH", "/collections/items/index", {"delta_rebuild_fraction": 0.2}),
        ("PATCH", "/collections/items/index", {"index_kind": "warp"}),  # 400
        ("PATCH", "/collections/items/index", {"delta_rebuild_fraction": 0}),  # 400
    ]
    return reqs


def read_script(vecs, queries):
    """Requests that only read: every search route, VelesQL, MATCH, the
    graph routes, the index and the errors."""
    q = [v.tolist() for v in queries]
    filt = {"type": "lt", "field": "price", "value": 50.0}
    reqs = [
        ("GET", "/health", None),
        ("GET", "/collections", None),
        ("GET", "/collections/items", None),
        ("GET", "/collections/items/points/7", None),
        ("GET", "/collections/items/points/299", None),  # 404
        ("POST", "/collections/items/search", {"vector": q[0], "k": 10}),
        ("POST", "/collections/items/search", {"vector": q[1], "k": 5, "filter": filt}),
        ("POST", "/collections/items/search", {"vector": q[2], "limit": 3}),
        ("POST", "/collections/items/search", {"vector": q[3][:4], "k": 3}),  # 400
        ("POST", "/collections/items/search/batch", {"vectors": q, "k": 10}),
        ("POST", "/collections/items/search/batch", {"vectors": q[:3], "k": 4, "filter": filt}),
        ("POST", "/collections/items/search/multi",
         {"vectors": q[:3], "k": 6, "strategy": "rrf"}),
        ("POST", "/collections/items/search/multi",
         {"vectors": q[:2], "k": 6, "strategy": "weighted_average", "weights": [2.0, 1.0]}),
        ("POST", "/collections/items/search/text", {"query": "espresso item", "k": 8}),
        ("POST", "/collections/items/search/text",
         {"query": "guitar", "k": 5, "filter": {"type": "eq", "field": "grp", "value": 1}}),
        ("POST", "/collections/items/search/hybrid",
         {"vector": q[4], "query": "coffee laptop", "k": 10}),
        ("POST", "/collections/items/search/hybrid",
         {"vector": q[5], "query": "novel", "k": 6, "vector_weight": 0.7, "filter": filt}),
        ("POST", "/query", {"query": "SELECT * FROM items WHERE vector NEAR $v LIMIT 10",
                            "params": {"v": q[6]}}),
        ("POST", "/query", {"query": "SELECT title, price FROM items WHERE vector NEAR $v "
                                     "AND price < 50 LIMIT 5", "params": {"v": q[7]}}),
        ("POST", "/query", {"query": "SELECT grp, COUNT(*) AS n FROM items GROUP BY grp "
                                     "ORDER BY grp"}),
        ("POST", "/collections/items/query",
         {"query": "SELECT title FROM items WHERE grp = 2 ORDER BY price LIMIT 4"}),
        ("POST", "/query", {"query": "SELEKT"}),  # 400
        ("POST", "/collections/nope/query", {"query": "SELECT * FROM items"}),  # 404
        ("POST", "/collections/items/match",
         {"query": "MATCH (a:Item)-[:next]->(b:Item) WHERE b.grp = 2 "
                   "RETURN b.title AS t ORDER BY t"}),
        ("POST", "/collections/items/match", {"query": "MATCH (a"}),  # 400
        ("GET", "/collections/items/edges/0?direction=out", None),
        ("GET", "/collections/items/edges/2?direction=both&label=next", None),
        ("POST", "/collections/items/traverse", {"start": 0, "max_depth": 3}),
        ("POST", "/collections/items/traverse",
         {"start": 10, "max_depth": 2, "direction": "in", "label": "next"}),
        ("GET", "/collections/items/degree/2?direction=both", None),
        ("GET", "/collections/items/index", None),
        ("POST", "/collections/items/explain",
         {"query": "SELECT * FROM items WHERE vector NEAR $v AND price < 50 LIMIT 5"}),
        ("POST", "/collections/items/explain", {"query": "SELEKT"}),  # 400
        ("GET", "/collections/nope", None),  # 404
        ("DELETE", "/health", None),  # 405
        ("GET", "/definitely/not/a/route", None),  # 404
    ]
    return reqs


def _play(base, reqs):
    return [_req(base, m, p, b) for m, p, b in reqs]


def _same_responses(got, want, reqs):
    for (g_status, g_body), (w_status, w_body), (m, p, _) in zip(got, want, reqs):
        assert g_status == w_status, f"{m} {p}: {g_status} != {w_status} ({g_body})"
        if w_status != 200:  # error bodies: {"error": message}
            assert set(g_body) == set(w_body) == {"error"}, f"{m} {p}"
            continue
        same(g_body, w_body, f"{m} {p}")


def _prom(text):
    """``/metrics`` lines without the latency values and the uptime."""
    out = []
    for line in text.splitlines():
        if "uptime_seconds" in line or "kernel_demoted" in line:
            continue
        if line.startswith("#"):
            out.append(line)
        elif "_seconds" in line:
            out.append(line.split(" ")[0] if "_count" not in line else line)
        else:
            out.append(line)
    return out


def test_request_script_same_responses(tmp_path):
    vecs, points, queries = _data()
    writes, reads = write_script(vecs, points, queries), read_script(vecs, queries)
    with serving(ref_make_server, str(tmp_path / "ref")) as ref, \
            serving(port_make_server, str(tmp_path / "port"), device="cpu") as port:
        _same_responses(_play(port, writes), _play(ref, writes), writes)
        want, got = _play(ref, reads), _play(port, reads)
        _same_responses(got, want, reads)
        assert all(status == 200 for status, _ in got[5:8])
        # the index engines: a graph rebuilt through the route, searched pinned
        idx = [("POST", "/collections/items/index/rebuild", {"kind": "graph"}),
               ("POST", "/collections/items/index/rebuild", {"kind": "warp"}),  # 400
               ("PATCH", "/collections/items/index", {"index_kind": "exact"}),
               ("POST", "/collections/items/search", {"vector": queries[0].tolist(), "k": 5})]
        want, got = _play(ref, idx), _play(port, idx)
        for body in (want[0][1], got[0][1]):
            assert body["graph_built"] is True
            for event in body["reindex_events"]:
                event.pop("at")
        _same_responses(got, want, idx)
        (gs, g_open), (ws, w_open) = _req(port, "GET", "/openapi.json"), _req(ref, "GET",
                                                                               "/openapi.json")
        assert gs == ws == 200 and g_open["paths"] == w_open["paths"]
        assert sum(len(ops) for ops in g_open["paths"].values()) == 27
        (gs, g_prom), (ws, w_prom) = _req(port, "GET", "/metrics"), _req(ref, "GET", "/metrics")
        assert gs == ws == 200 and "velesdb_http_requests_total" in g_prom
        assert _prom(g_prom) == _prom(w_prom)


def _cross(tmp_path, writer, reader, writer_kw, reader_kw):
    """Write through ``writer``'s server and close it; then the writer's and
    the reader's servers each reopen a copy of the directory and answer the
    read script: ``(reader's, writer's, script)``."""
    vecs, points, queries = _data()
    path = str(tmp_path / "db")
    reads = read_script(vecs, queries)
    with serving(writer, path, **writer_kw) as base:
        _play(base, write_script(vecs, points, queries))
    shutil.copytree(path, str(tmp_path / "copy"))
    with serving(writer, str(tmp_path / "copy"), **writer_kw) as base:
        want = _play(base, reads)
    with serving(reader, path, **reader_kw) as base:
        got = _play(base, reads)
    return got, want, reads


def test_reference_written_directory_answers_the_port_alike(tmp_path):
    got, want, reads = _cross(tmp_path, ref_make_server, port_make_server, {},
                              {"device": "cpu"})
    _same_responses(got, want, reads)


def test_port_written_directory_answers_the_reference_alike(tmp_path):
    ref_read, port_read, reads = _cross(tmp_path, port_make_server, ref_make_server,
                                        {"device": "cpu"}, {})
    _same_responses(port_read, ref_read, reads)


def test_cli_prints_the_same_json(tmp_path, capsys):
    rng = np.random.default_rng(4)
    jsonl = tmp_path / "in.jsonl"
    with open(jsonl, "w") as f:
        for i in range(40):
            f.write(json.dumps({"id": i, "vector": rng.standard_normal(8).tolist(),
                                "payload": {"n": i, "tag": WORDS[i % 7]}}) + "\n")
    out = {}
    for tag, cli, extra in (("ref", ref_cli, []), ("port", port_cli, ["--device", "cpu"])):
        db = str(tmp_path / tag)
        run = [*extra, "--path", db]
        printed = []
        for argv in (["create", "c1", "--dim", "8", "--metric", "euclidean"],
                     ["import", "c1", str(jsonl), "--batch", "16"],
                     ["query", "SELECT n, tag FROM c1 WHERE n < 12 ORDER BY n DESC"],
                     ["query", "SELECT * FROM c1 WHERE vector NEAR $v LIMIT 5",
                      "--params", json.dumps({"v": [0.1] * 8}), "--json"],
                     ["export", "c1", str(tmp_path / f"{tag}.jsonl")],
                     ["show", "c1", "3", "--vector"]):
            assert cli([*run, *argv]) == 0, (tag, argv)
            printed.append(capsys.readouterr().out)
        out[tag] = printed
    ref, port = out["ref"], out["port"]
    same(json.loads(port[0]), json.loads(ref[0]))
    assert port[1] == ref[1] == "imported 40 points into c1\n"
    assert [json.loads(l) for l in port[2].splitlines()] == \
        [json.loads(l) for l in ref[2].splitlines()]
    same(json.loads(port[3]), json.loads(ref[3]))
    same([json.loads(l) for l in (tmp_path / "port.jsonl").read_text().splitlines()],
         [json.loads(l) for l in (tmp_path / "ref.jsonl").read_text().splitlines()])
    same(json.loads(port[5]), json.loads(ref[5]))
