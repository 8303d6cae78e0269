"""REST server: 27 routes mirroring the reference's axum surface.

The port of ``velesdb_tpu/server/app.py`` (counterpart of ``velesdb-server``,
``main.rs:77-131``, ``handlers/``): health, collections CRUD, points
upsert/get/delete, search (vector / batch / multi / text / hybrid),
``/query`` (VelesQL), ``/collections/{n}/match`` (graph), edges / traverse /
degree, index management, EXPLAIN, Prometheus ``/metrics``, OpenAPI. The
routes, JSON bodies and status codes are the reference's; the database opens
on ``device`` ("cuda" unless the caller asks for the CPU). ``/metrics`` has no
kernel-demotion gauge: the port has no demotion registry (a kernel fault
raises, and the request answers 500).

Built on stdlib ``ThreadingHTTPServer`` (zero-dependency is also the
reference's local-first ethos): one handler thread a connection, all
launching on the default stream. JSON in/out; errors as ``{"error": msg}``
with proper status codes.
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.utils.config import VelesConfig
from velesdb_tpu_torch.utils.metrics import OperationalMetrics
from velesdb_tpu_torch.velesql import ParseError, QueryError

__all__ = ["VelesServer", "make_server"]


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class VelesServer:
    """Routing + handlers bound to one Database (AppState analog)."""

    def __init__(self, db: Database, config: VelesConfig | None = None):
        from velesdb_tpu_torch.utils.guardrails import CircuitBreaker, RateLimiter

        self.db = db
        self.config = config or VelesConfig()
        self.metrics = OperationalMetrics()
        lim = self.config.limits
        self.rate_limiter = (
            RateLimiter(lim.rate_per_s) if lim.rate_per_s else None
        )
        self.breaker = CircuitBreaker()
        # micro-batching coalescer (utils/batcher.py): >0 ms window makes
        # concurrent single-query /search requests share device dispatches
        self.batch_window_ms = float(os.environ.get("VELESDB_BATCH_WINDOW_MS", "0"))
        self._batchers: dict[str, object] = {}
        self._batchers_lock = threading.Lock()
        self._routes: list[tuple[str, re.Pattern, object]] = []
        r = self._route
        r("GET", r"/health", self.health)
        r("GET", r"/collections", self.list_collections)
        r("POST", r"/collections", self.create_collection)
        r("GET", r"/collections/(?P<name>[^/]+)", self.collection_info)
        r("DELETE", r"/collections/(?P<name>[^/]+)", self.delete_collection)
        r("PUT", r"/collections/(?P<name>[^/]+)/points", self.upsert_points)
        r("GET", r"/collections/(?P<name>[^/]+)/points/(?P<id>-?\d+)", self.get_point)
        r(
            "DELETE",
            r"/collections/(?P<name>[^/]+)/points/(?P<id>-?\d+)",
            self.delete_point,
        )
        r("POST", r"/collections/(?P<name>[^/]+)/search", self.search)
        r("POST", r"/collections/(?P<name>[^/]+)/search/batch", self.search_batch)
        r("POST", r"/collections/(?P<name>[^/]+)/search/multi", self.search_multi)
        r("POST", r"/collections/(?P<name>[^/]+)/search/text", self.search_text)
        r("POST", r"/collections/(?P<name>[^/]+)/search/hybrid", self.search_hybrid)
        r("POST", r"/query", self.query)
        r("POST", r"/collections/(?P<name>[^/]+)/query", self.collection_query)
        r("POST", r"/collections/(?P<name>[^/]+)/match", self.match)
        r("POST", r"/collections/(?P<name>[^/]+)/edges", self.add_edge)
        r(
            "GET",
            r"/collections/(?P<name>[^/]+)/edges/(?P<node>-?\d+)",
            self.get_edges,
        )
        r(
            "DELETE",
            r"/collections/(?P<name>[^/]+)/edges/(?P<eid>\d+)",
            self.delete_edge,
        )
        r("POST", r"/collections/(?P<name>[^/]+)/traverse", self.traverse)
        r(
            "GET",
            r"/collections/(?P<name>[^/]+)/degree/(?P<node>-?\d+)",
            self.degree,
        )
        r("PATCH", r"/collections/(?P<name>[^/]+)/index", self.configure_index)
        r("GET", r"/collections/(?P<name>[^/]+)/index", self.index_info)
        r(
            "POST",
            r"/collections/(?P<name>[^/]+)/index/rebuild",
            self.rebuild_index,
        )
        r("POST", r"/collections/(?P<name>[^/]+)/explain", self.explain)
        r("GET", r"/metrics", self.prometheus)
        r("GET", r"/openapi.json", self.openapi)

    def _route(self, method: str, pattern: str, handler) -> None:
        self._routes.append((method, re.compile("^" + pattern + "$"), handler))

    # -- dispatch -------------------------------------------------------------

    def dispatch(self, method: str, path: str, query: dict, body, client: str = "-"):
        from velesdb_tpu_torch.utils.guardrails import GuardrailExceeded

        if self.rate_limiter is not None and path != "/health":
            try:
                self.rate_limiter.acquire(client)
            except GuardrailExceeded as e:
                self.metrics.inc("http_rate_limited_total")
                raise HttpError(429, str(e))
        matched_path = False
        for m, pattern, handler in self._routes:
            match = pattern.match(path)
            if match:
                matched_path = True
                if m == method:
                    self.metrics.inc("http_requests_total", route=pattern.pattern)
                    if not self.breaker.allow():
                        self.metrics.inc("http_shed_total")
                        raise HttpError(503, "circuit open: shedding load")
                    try:
                        with self.metrics.latency("http_request").timer():
                            result = handler(
                                body=body, query=query, **match.groupdict()
                            )
                    except HttpError:
                        raise  # client errors don't trip the breaker
                    except Exception:
                        self.breaker.record(False)
                        raise
                    self.breaker.record(True)
                    return result
        if matched_path:
            raise HttpError(405, f"method {method} not allowed on {path}")
        raise HttpError(404, f"no route for {path}")

    def _coll(self, name: str):
        try:
            return self.db.get_collection(name)
        except KeyError:
            raise HttpError(404, f"collection {name!r} not found")

    # -- handlers ----------------------------------------------------------------

    def health(self, **_):
        return {
            "status": "ok",
            "collections": len(self.db.list_collections()),
            "version": _version(),
        }

    def list_collections(self, **_):
        out = []
        for name in self.db.list_collections():
            out.append(self.db.get_collection(name).info())
        return {"collections": out}

    def create_collection(self, body, **_):
        b = _require(body, "name", "dim")
        try:
            col = self.db.create_collection(
                b["name"],
                int(b["dim"]),
                metric=b.get("metric", "cosine"),
                storage_mode=b.get("storage_mode", "full"),
            )
        except ValueError as e:
            raise HttpError(409 if "exists" in str(e) else 400, str(e))
        return {"created": col.info()}

    def collection_info(self, name, **_):
        return self._coll(name).info()

    # -- index management (round-2: planner-selectable engines + delta) ------

    def index_info(self, name, **_):
        col = self._coll(name)
        return {
            "index_kind": col.index_kind,
            "ann_min_rows": col.ann_min_rows,
            "delta_rebuild_fraction": col.delta_rebuild_fraction,
            "graph_built": col.ann is not None and not col.ann.dirty
            and col.ann.n_pad > 0,
            "ivf_built": col.ivf is not None and not col.ivf.dirty,
            "delta_rows": {k: len(v) for k, v in col._stale.items()},
            "reindex_events": col.reindex_events[-10:],
            # post-build calibration probes (r3 honesty gate): measured
            # recall@10 vs the exact oracle; engines below the active
            # quality profile's bar are demoted to exact
            "calibrated_recall": {
                e: col.planner.engine_recall(e)
                for e in ("graph", "ivf")
                if col.planner.engine_recall(e) is not None
            },
            # quantized-storage TRUE recall vs a host f32 oracle (r3b:
            # the engine probes above use the brute path as oracle, which
            # on SQ8/binary storage is itself quantized — this closes that
            # blind spot; None = full-precision collection)
            "storage_recall": col.calibrate_storage(),
        }

    def configure_index(self, name, body, **_):
        col = self._coll(name)
        body = body or {}
        kind = body.get("index_kind")
        if kind is not None:
            if kind not in ("auto", "exact", "graph", "ivf"):
                raise HttpError(400, f"unknown index_kind {kind!r}")
            col.index_kind = kind
        if "ann_min_rows" in body:
            col.ann_min_rows = int(body["ann_min_rows"])
        if "delta_rebuild_fraction" in body:
            f = float(body["delta_rebuild_fraction"])
            if not 0.0 < f <= 1.0:
                raise HttpError(400, "delta_rebuild_fraction must be in (0, 1]")
            col.delta_rebuild_fraction = f
        return self.index_info(name)

    def rebuild_index(self, name, body, **_):
        col = self._coll(name)
        kind = (body or {}).get("kind", "graph")
        col.refresh_device()
        if kind == "graph":
            if col.ann is None:
                raise HttpError(400, "collection does not support a graph index")
            col.ann.invalidate()
            if not col._ensure_ann(force=True):
                raise HttpError(409, "graph index unavailable for this collection")
        elif kind == "ivf":
            if col.ivf is not None:
                col.ivf.invalidate()
            if not col._ensure_ivf():
                raise HttpError(409, "ivf index unavailable for this collection")
        else:
            raise HttpError(400, f"unknown index kind {kind!r}")
        return self.index_info(name)

    def delete_collection(self, name, **_):
        if not self.db.delete_collection(name):
            raise HttpError(404, f"collection {name!r} not found")
        return {"deleted": name}

    def upsert_points(self, name, body, **_):
        col = self._coll(name)
        points = _require(body, "points")["points"]
        if not isinstance(points, list) or not points:
            raise HttpError(400, "points must be a non-empty list")
        ids, vecs, payloads = [], [], []
        for p in points:
            if "id" not in p or "vector" not in p:
                raise HttpError(400, "each point needs id and vector")
            ids.append(int(p["id"]))
            vecs.append(p["vector"])
            payloads.append(p.get("payload"))
        try:
            col.upsert_bulk(ids, np.asarray(vecs, np.float32), payloads)
        except ValueError as e:
            raise HttpError(400, str(e))
        self.metrics.inc("points_upserted_total", value=len(ids))
        return {"upserted": len(ids)}

    def get_point(self, name, id, **_):
        got = self._coll(name).get(int(id))
        if got is None:
            raise HttpError(404, f"point {id} not found")
        vec, payload = got
        return {"id": int(id), "vector": np.asarray(vec).tolist(), "payload": payload}

    def delete_point(self, name, id, **_):
        if not self._coll(name).delete(int(id)):
            raise HttpError(404, f"point {id} not found")
        return {"deleted": int(id)}

    def _batcher(self, name, col):
        from velesdb_tpu_torch.utils.batcher import MicroBatcher

        # double-checked under a lock: concurrent first requests from
        # ThreadingHTTPServer handler threads must not each construct (and
        # leak) a coalescer worker for the same collection (advisor r2)
        bt = self._batchers.get(name)
        if bt is None or bt.collection is not col:
            with self._batchers_lock:
                bt = self._batchers.get(name)
                if bt is None or bt.collection is not col:
                    old = bt
                    bt = MicroBatcher(col, window_ms=self.batch_window_ms,
                                      metrics=self.metrics)
                    self._batchers[name] = bt
                    if old is not None:
                        old.stop()
        return bt

    def search(self, name, body, **_):
        col = self._coll(name)
        b = _require(body, "vector")
        k = int(b.get("k", b.get("limit", 10)))
        try:
            with self.metrics.latency("search").timer():
                if (
                    self.batch_window_ms > 0
                    and b.get("filter") is None
                    and b.get("quality") is None
                ):
                    hits = self._batcher(name, col).search(
                        np.asarray(b["vector"], np.float32), k, ef=b.get("ef")
                    )
                else:
                    hits = col.search(
                        np.asarray(b["vector"], np.float32),
                        k,
                        filter=b.get("filter"),
                        ef=b.get("ef"),
                        quality=b.get("quality"),
                    )
        except ValueError as e:
            raise HttpError(400, str(e))
        return {"results": [dict(h) for h in hits]}

    def search_batch(self, name, body, **_):
        col = self._coll(name)
        b = _require(body, "vectors")
        k = int(b.get("k", 10))
        try:
            with self.metrics.latency("search_batch").timer():
                res = col.search_batch(
                    np.asarray(b["vectors"], np.float32),
                    k,
                    filter=b.get("filter"),
                    ef=b.get("ef"),
                    quality=b.get("quality"),
                )
        except ValueError as e:
            raise HttpError(400, str(e))
        return {"results": [[dict(h) for h in row] for row in res]}

    def search_multi(self, name, body, **_):
        """Fuse several query vectors into ONE ranked list
        (``/search/multi``, ``multi_query_search`` with FusionStrategy)."""
        col = self._coll(name)
        b = _require(body, "vectors")
        try:
            hits = col.multi_query_search(
                np.asarray(b["vectors"], np.float32),
                int(b.get("k", 10)),
                strategy=b.get("strategy", "rrf"),
                weights=b.get("weights"),
                filter=b.get("filter"),
                ef=b.get("ef"),
            )
        except ValueError as e:
            raise HttpError(400, str(e))
        return {"results": [dict(h) for h in hits]}

    def search_text(self, name, body, **_):
        col = self._coll(name)
        b = _require(body, "query")
        hits = col.text_search(
            str(b["query"]), int(b.get("k", 10)), filter=b.get("filter")
        )
        return {"results": [dict(h) for h in hits]}

    def search_hybrid(self, name, body, **_):
        col = self._coll(name)
        b = _require(body, "vector", "query")
        hits = col.hybrid_search(
            np.asarray(b["vector"], np.float32),
            str(b["query"]),
            int(b.get("k", 10)),
            vector_weight=float(b.get("vector_weight", 0.5)),
            filter=b.get("filter"),
        )
        return {"results": [dict(h) for h in hits]}

    def query(self, body, **_):
        b = _require(body, "query")
        try:
            with self.metrics.latency("velesql").timer():
                rows = self.db.query(str(b["query"]), b.get("params"))
        except (ParseError, QueryError) as e:
            raise HttpError(400, str(e))
        return {"rows": rows}

    def collection_query(self, name, body, **_):
        self._coll(name)  # 404 check; VelesQL names the collection in FROM
        return self.query(body)

    def match(self, name, body, **_):
        from velesdb_tpu_torch.graph import MatchError

        col = self._coll(name)
        b = _require(body, "query")
        try:
            rows = col.execute_match(str(b["query"]), b.get("params"))
        except (ParseError, MatchError) as e:
            raise HttpError(400, str(e))
        return {"rows": rows}

    def add_edge(self, name, body, **_):
        col = self._coll(name)
        b = _require(body, "src", "dst", "label")
        try:
            eid = col.add_edge(
                int(b["src"]), int(b["dst"]), str(b["label"]), b.get("properties")
            )
        except KeyError as e:
            raise HttpError(404, str(e))
        return {"edge_id": eid}

    def get_edges(self, name, node, query, **_):
        col = self._coll(name)
        direction = query.get("direction", ["out"])[0]
        label = query.get("label", [None])[0]
        edges = col.get_edges(int(node), direction=direction, label=label)
        return {"edges": [dict(e) for e in edges]}

    def delete_edge(self, name, eid, **_):
        col = self._coll(name)
        if not col.ensure_graph().edges.remove_edge(int(eid)):
            raise HttpError(404, f"edge {eid} not found")
        return {"deleted": int(eid)}

    def traverse(self, name, body, **_):
        col = self._coll(name)
        b = _require(body, "start")
        results = col.traverse(
            int(b["start"]),
            max_depth=int(b.get("max_depth", 3)),
            direction=b.get("direction", "out"),
            label=b.get("label"),
        )
        return {
            "nodes": [
                {"id": n, "depth": d, "path_edges": p} for n, d, p in results
            ]
        }

    def degree(self, name, node, query, **_):
        col = self._coll(name)
        direction = query.get("direction", ["out"])[0]
        return {"node": int(node), "degree": col.degree(int(node), direction)}

    def explain(self, name, body, **_):
        self._coll(name)
        b = _require(body, "query")
        try:
            plan = self.db.explain_query(str(b["query"]))
        except ParseError as e:
            raise HttpError(400, str(e))
        return {"plan": plan.to_dict(), "rendered": plan.render()}

    def prometheus(self, **_):
        if not self.config.server.enable_metrics:
            raise HttpError(404, "metrics disabled")
        return self.metrics.prometheus_text()

    def openapi(self, **_):
        """OpenAPI 3 document generated from the route table (the
        reference ships Swagger via utoipa, ``velesdb-server``)."""
        paths: dict = {}
        for method, pattern, handler in self._routes:
            # regex -> /path/{param} template
            tpl = pattern.pattern.strip("^$")
            import re as _re

            tpl = _re.sub(r"\(\?P<(\w+)>[^)]*\)", r"{\1}", tpl)
            params = _re.findall(r"\{(\w+)\}", tpl)
            op = {
                "summary": (handler.__doc__ or handler.__name__).strip().splitlines()[0],
                "parameters": [
                    {
                        "name": p,
                        "in": "path",
                        "required": True,
                        "schema": {"type": "string"},
                    }
                    for p in params
                ],
                "responses": {
                    "200": {"description": "OK"},
                    "400": {"description": "bad request"},
                    "404": {"description": "not found"},
                },
            }
            if method in ("POST", "PUT"):
                op["requestBody"] = {
                    "content": {"application/json": {"schema": {"type": "object"}}}
                }
            paths.setdefault(tpl, {})[method.lower()] = op
        return {
            "openapi": "3.0.3",
            "info": {
                "title": "velesdb-tpu-torch REST API",
                "version": _version(),
                "description": "vector + graph + columnar database (PyTorch / CUDA port)",
            },
            "paths": paths,
        }


def _require(body, *keys):
    if not isinstance(body, dict):
        raise HttpError(400, "JSON object body required")
    for k in keys:
        if k not in body:
            raise HttpError(400, f"missing field {k!r}")
    return body


def _version() -> str:
    from velesdb_tpu_torch import __version__

    return __version__


# -- stdlib HTTP plumbing -------------------------------------------------------


def make_server(
    db_path: str,
    host: str | None = None,
    port: int | None = None,
    config: VelesConfig | None = None,
    device="cuda",
) -> ThreadingHTTPServer:
    """Build (not start) a ThreadingHTTPServer bound to a Database opened on
    ``device``."""
    config = config or VelesConfig()
    app = VelesServer(Database.open(db_path, device=device), config)
    host = host if host is not None else config.server.host
    port = port if port is not None else config.server.port

    class Handler(BaseHTTPRequestHandler):
        server_version = "velesdb-tpu-torch"
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass  # quiet; operational metrics cover observability

        def _respond(self, status: int, payload, content_type="application/json"):
            data = (
                payload.encode()
                if isinstance(payload, str)
                else json.dumps(payload, default=_json_default).encode()
            )
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            if config.server.cors:
                self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(data)

        def _handle(self, method: str):
            parsed = urlparse(self.path)
            body = None
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                raw = self.rfile.read(length)
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError:
                    self._respond(400, {"error": "invalid JSON body"})
                    return
            try:
                result = app.dispatch(
                    method,
                    parsed.path,
                    parse_qs(parsed.query),
                    body,
                    client=self.client_address[0],
                )
            except HttpError as e:
                self._respond(e.status, {"error": e.message})
                return
            except Exception as e:  # internal error
                self._respond(500, {"error": f"internal error: {e}"})
                return
            if isinstance(result, str):  # e.g. Prometheus text
                self._respond(200, result, content_type="text/plain; version=0.0.4")
            else:
                self._respond(200, result)

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_PUT(self):
            self._handle("PUT")

        def do_DELETE(self):
            self._handle("DELETE")

        def do_PATCH(self):
            self._handle("PATCH")

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.app = app  # exposed for tests/CLI
    return httpd


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def serve(db_path: str, host: str | None = None, port: int | None = None,
          device="cuda") -> None:
    httpd = make_server(db_path, host, port, device=device)
    host_, port_ = httpd.server_address[:2]
    print(f"velesdb-tpu-torch REST server on http://{host_}:{port_} "
          f"(device {httpd.app.db.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.app.db.close()
