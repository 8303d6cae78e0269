"""REST server + CLI + config + metrics tests, against the port.

``tests/test_server_cli.py`` case for case, by name, on
``velesdb_tpu_torch`` with the database on the CPU (``device="cpu"``,
``--device cpu``): a real ThreadingHTTPServer on an ephemeral port, driven
over actual HTTP. Every HTTP call carries a timeout and every server is shut
down and closed in teardown.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from velesdb_tpu_torch.cli import main as _cli_main
from velesdb_tpu_torch.utils.config import ConfigError, VelesConfig
from velesdb_tpu_torch.utils.metrics import (
    LatencyStats,
    OperationalMetrics,
    mrr,
    ndcg_at_k,
    precision_at_k,
    recall_at_k,
)

TIMEOUT = 60


def cli_main(argv):
    """The port's CLI with the database on the CPU."""
    return _cli_main(["--device", "cpu", *argv])


# -- metrics -------------------------------------------------------------------


def test_ir_metrics():
    retrieved = [3, 1, 4, 1, 5]
    relevant = [1, 9, 4]
    assert recall_at_k(retrieved, relevant, 3) == pytest.approx(2 / 3)
    assert precision_at_k(retrieved, relevant, 3) == pytest.approx(2 / 3)
    assert mrr(retrieved, relevant) == pytest.approx(1 / 2)
    assert ndcg_at_k(retrieved, relevant, 5) > 0
    assert recall_at_k(retrieved, [], 3) == 0.0
    assert mrr([7, 8], relevant) == 0.0


def test_latency_stats_and_prometheus():
    m = OperationalMetrics()
    m.inc("queries_total", route="/search")
    m.inc("queries_total", route="/search")
    m.set_gauge("points", 42)
    with m.latency("search").timer():
        pass
    text = m.prometheus_text()
    assert 'velesdb_queries_total{route="/search"} 2' in text
    assert "velesdb_points 42" in text
    assert "velesdb_search_seconds_count 1" in text
    s = LatencyStats()
    for v in [0.01, 0.02, 0.03]:
        s.record(v)
    p = s.percentiles()
    assert 0.01 <= p["p50"] <= 0.03 and s.count == 3


# -- config --------------------------------------------------------------------


def test_config_defaults_and_env():
    cfg = VelesConfig.load(env={})
    assert cfg.server.port == 7333
    cfg = VelesConfig.load(
        env={"VELESDB_SERVER_PORT": "9000", "VELESDB_SEARCH_EF_SEARCH": "256"}
    )
    assert cfg.server.port == 9000 and cfg.search.ef_search == 256


def test_config_toml_and_validation(tmp_path):
    f = tmp_path / "veles.toml"
    f.write_text("[search]\ndefault_quality = 'accurate'\n[server]\nport = 8080\n")
    cfg = VelesConfig.load(str(f), env={})
    assert cfg.search.default_quality == "accurate" and cfg.server.port == 8080
    bad = tmp_path / "bad.toml"
    bad.write_text("[search]\ndefault_quality = 'warp'\n")
    with pytest.raises(ConfigError):
        VelesConfig.load(str(bad), env={})
    with pytest.raises(ConfigError):
        VelesConfig.load(env={"VELESDB_SERVER_PORT": "banana"})
    unknown = tmp_path / "unk.toml"
    unknown.write_text("[searhc]\nx = 1\n")
    with pytest.raises(ConfigError):
        VelesConfig.load(str(unknown), env={})


# -- REST server ------------------------------------------------------------------


@pytest.fixture
def server(tmp_db_dir):
    from velesdb_tpu_torch.server.app import make_server

    httpd = make_server(tmp_db_dir, host="127.0.0.1", port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        yield base
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


def test_rest_end_to_end(server, rng):
    base = server
    status, body = _req(base, "GET", "/health")
    assert status == 200 and body["status"] == "ok"

    status, body = _req(
        base, "POST", "/collections", {"name": "items", "dim": 8, "metric": "cosine"}
    )
    assert status == 200 and body["created"]["name"] == "items"
    # duplicate -> 409
    status, _ = _req(base, "POST", "/collections", {"name": "items", "dim": 8})
    assert status == 409

    vecs = rng.standard_normal((20, 8)).astype(np.float32)
    points = [
        {"id": i, "vector": vecs[i].tolist(), "payload": {"i": i, "grp": i % 2}}
        for i in range(20)
    ]
    status, body = _req(base, "PUT", "/collections/items/points", {"points": points})
    assert status == 200 and body["upserted"] == 20

    status, body = _req(
        base, "POST", "/collections/items/search", {"vector": vecs[7].tolist(), "k": 3}
    )
    assert status == 200 and body["results"][0]["id"] == 7

    status, body = _req(
        base,
        "POST",
        "/collections/items/search",
        {
            "vector": vecs[7].tolist(),
            "k": 5,
            "filter": {"type": "eq", "field": "grp", "value": 0},
        },
    )
    assert all(r["payload"]["grp"] == 0 for r in body["results"])

    status, body = _req(base, "GET", "/collections/items/points/7")
    assert status == 200 and body["payload"]["i"] == 7
    status, body = _req(base, "DELETE", "/collections/items/points/19")
    assert status == 200
    status, _ = _req(base, "GET", "/collections/items/points/19")
    assert status == 404

    status, body = _req(
        base,
        "POST",
        "/query",
        {"query": "SELECT i FROM items WHERE grp = 1 ORDER BY i LIMIT 3"},
    )
    assert status == 200 and [r["i"] for r in body["rows"]] == [1, 3, 5]

    status, body = _req(base, "GET", "/metrics")
    assert status == 200 and "velesdb_http_requests_total" in body


def test_rest_graph_routes(server, rng):
    base = server
    _req(base, "POST", "/collections", {"name": "g", "dim": 4})
    pts = [
        {"id": i, "vector": rng.standard_normal(4).tolist(), "payload": {"_labels": ["N"], "rank": i}}
        for i in range(5)
    ]
    _req(base, "PUT", "/collections/g/points", {"points": pts})
    for i in range(4):
        status, body = _req(
            base, "POST", "/collections/g/edges", {"src": i, "dst": i + 1, "label": "next"}
        )
        assert status == 200
    status, body = _req(base, "GET", "/collections/g/edges/0?direction=out")
    assert status == 200 and body["edges"][0]["dst"] == 1
    status, body = _req(
        base, "POST", "/collections/g/traverse", {"start": 0, "max_depth": 2}
    )
    assert [n["id"] for n in body["nodes"]] == [0, 1, 2]
    status, body = _req(base, "GET", "/collections/g/degree/1?direction=both")
    assert body["degree"] == 2
    status, body = _req(
        base,
        "POST",
        "/collections/g/match",
        {"query": "MATCH (a:N)-[:next]->(b:N) WHERE b.rank > 2 RETURN b.rank AS r"},
    )
    assert status == 200 and sorted(r["r"] for r in body["rows"]) == [3, 4]


def test_rest_errors(server):
    base = server
    status, body = _req(base, "GET", "/collections/nope")
    assert status == 404 and "not found" in body["error"]
    status, body = _req(base, "POST", "/collections", {"name": "x"})
    assert status == 400 and "dim" in body["error"]
    status, body = _req(base, "POST", "/query", {"query": "SELEKT"})
    assert status == 400
    status, body = _req(base, "DELETE", "/health")
    assert status == 405
    status, body = _req(base, "GET", "/definitely/not/a/route")
    assert status == 404


# -- CLI ----------------------------------------------------------------------------


def test_cli_create_import_query_export(tmp_db_dir, tmp_path, capsys, rng):
    assert cli_main(["--path", tmp_db_dir, "create", "c1", "--dim", "4"]) == 0
    capsys.readouterr()
    jsonl = tmp_path / "in.jsonl"
    with open(jsonl, "w") as f:
        for i in range(6):
            f.write(
                json.dumps(
                    {
                        "id": i,
                        "vector": rng.standard_normal(4).tolist(),
                        "payload": {"n": i},
                    }
                )
                + "\n"
            )
    assert cli_main(["--path", tmp_db_dir, "import", "c1", str(jsonl)]) == 0
    assert "imported 6" in capsys.readouterr().out

    assert cli_main(["--path", tmp_db_dir, "list"]) == 0
    assert "c1" in capsys.readouterr().out

    assert (
        cli_main(
            ["--path", tmp_db_dir, "query", "SELECT n FROM c1 WHERE n < 2 ORDER BY n"]
        )
        == 0
    )
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(l)["n"] for l in out] == [0, 1]

    exp = tmp_path / "out.jsonl"
    assert cli_main(["--path", tmp_db_dir, "export", "c1", str(exp)]) == 0
    lines = [json.loads(l) for l in exp.read_text().splitlines()]
    assert len(lines) == 6 and all("vector" in l for l in lines)

    assert cli_main(["--path", tmp_db_dir, "show", "c1", "3"]) == 0
    assert json.loads(capsys.readouterr().out)["payload"] == {"n": 3}


def test_cli_graph_and_errors(tmp_db_dir, capsys, rng):
    cli_main(["--path", tmp_db_dir, "create", "g", "--dim", "2"])
    capsys.readouterr()
    import velesdb_tpu_torch.database as d

    db = d.Database.open(tmp_db_dir, device="cpu")
    for i in range(3):
        db.get_collection("g").add_node(i, ["X"], {"i": i}, rng.standard_normal(2))
    db.get_collection("g").flush()
    db.close()
    assert cli_main(["--path", tmp_db_dir, "edge", "g", "0", "1", "rel"]) == 0
    assert cli_main(["--path", tmp_db_dir, "edge", "g", "1", "2", "rel"]) == 0
    capsys.readouterr()
    assert cli_main(["--path", tmp_db_dir, "traverse", "g", "0", "--depth", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(l)["id"] for l in out] == [0, 1, 2]
    assert (
        cli_main(
            [
                "--path",
                tmp_db_dir,
                "query",
                "MATCH (a:X)-[:rel]->(b) RETURN b.i AS i",
                "--collection",
                "g",
            ]
        )
        == 0
    )
    out = capsys.readouterr().out.strip().splitlines()
    assert sorted(json.loads(l)["i"] for l in out) == [1, 2]

    assert cli_main(["--path", tmp_db_dir, "info", "missing"]) == 1
    assert "error" in capsys.readouterr().err


def test_rest_search_multi(server, rng):
    base = server
    _req(base, "POST", "/collections", {"name": "multi", "dim": 8})
    vecs = rng.standard_normal((30, 8)).astype(np.float32)
    pts = [{"id": i, "vector": vecs[i].tolist()} for i in range(30)]
    _req(base, "PUT", "/collections/multi/points", {"points": pts})
    status, body = _req(
        base,
        "POST",
        "/collections/multi/search/multi",
        {"vectors": [vecs[3].tolist(), vecs[20].tolist()], "k": 6, "strategy": "rrf"},
    )
    assert status == 200
    ids = {r["id"] for r in body["results"]}
    assert {3, 20} <= ids


def test_rest_index_management(server, rng):
    """r2: PATCH/GET /index + POST /index/rebuild drive the planner-
    selectable engines and the incremental-delta config remotely."""
    base = server
    _req(base, "POST", "/collections", {"name": "idx", "dim": 8})
    vecs = rng.standard_normal((600, 8)).astype(np.float32)
    pts = [{"id": i, "vector": vecs[i].tolist()} for i in range(600)]
    _req(base, "PUT", "/collections/idx/points", {"points": pts})

    status, info = _req(base, "GET", "/collections/idx/index")
    assert status == 200 and info["index_kind"] == "auto"
    assert info["graph_built"] is False

    status, info = _req(
        base, "PATCH", "/collections/idx/index",
        {"index_kind": "graph", "delta_rebuild_fraction": 0.2},
    )
    assert status == 200 and info["index_kind"] == "graph"
    assert info["delta_rebuild_fraction"] == 0.2

    status, info = _req(base, "POST", "/collections/idx/index/rebuild",
                        {"kind": "graph"})
    assert status == 200 and info["graph_built"] is True

    # searches now route through the (freshly built) graph engine
    status, res = _req(
        base, "POST", "/collections/idx/search",
        {"vector": vecs[7].tolist(), "k": 3},
    )
    assert status == 200 and res["results"][0]["id"] == 7

    # invalid knobs rejected
    status, _ = _req(base, "PATCH", "/collections/idx/index",
                     {"index_kind": "warp"})
    assert status == 400
    status, _ = _req(base, "PATCH", "/collections/idx/index",
                     {"delta_rebuild_fraction": 0})
    assert status == 400


def test_cli_index_command(tmp_db_dir, rng, capsys, monkeypatch):
    from velesdb_tpu_torch.cli import main as cli_main
    from velesdb_tpu_torch.database import Database

    db = Database.open(tmp_db_dir, device="cpu")
    c = db.create_collection("idxc", dim=8)
    c.upsert_bulk(range(200), rng.standard_normal((200, 8)).astype(np.float32))
    db.close()

    import sys as _sys

    monkeypatch.setattr(_sys, "argv", ["velesdb-torch", "--device", "cpu", "--path",
                                       tmp_db_dir, "index", "idxc"])
    assert cli_main() == 0
    out = json.loads(capsys.readouterr().out)
    assert out["index_kind"] == "auto" and out["graph_built"] is False

    monkeypatch.setattr(_sys, "argv", ["velesdb-torch", "--device", "cpu", "--path",
                                       tmp_db_dir, "index", "idxc", "--kind", "graph",
                                       "--rebuild", "graph"])
    assert cli_main() == 0
    out = json.loads(capsys.readouterr().out)
    assert out["index_kind"] == "graph" and out["graph_built"] is True

    monkeypatch.setattr(_sys, "argv", ["velesdb-torch", "--device", "cpu", "--path",
                                       tmp_db_dir, "index", "idxc", "--kind", "warp"])
    assert cli_main() == 1  # invalid kind -> error exit
