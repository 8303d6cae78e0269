"""Migration source connectors.

A copy of ``velesdb_tpu/migrate/connectors.py``. Counterpart of ``velesdb-migrate/src/connectors/`` (12 connectors, 8,569 LoC
— Qdrant/Pinecone/ChromaDB/Milvus/Weaviate/pgvector/Redis/Elasticsearch/
MongoDB/CSV/JSON). Each connector yields ``{"id", "vector", "payload"}``
records. File connectors (JSONL/JSON/CSV/NumPy) parse locally; service
connectors speak the services' REST pagination APIs via stdlib urllib
(driver SDKs are not in the image; REST is the lowest common denominator
and is what the reference's connectors wrap too). Database-protocol sources
(pgvector/Redis/Mongo/Milvus gRPC) raise a clear error if their client
library is absent — the wiring is present, the dependency is optional.
"""

from __future__ import annotations

import csv
import json
import urllib.request
from typing import Iterator

import numpy as np

__all__ = [
    "JsonlConnector",
    "JsonConnector",
    "CsvConnector",
    "NumpyConnector",
    "QdrantConnector",
    "ChromaConnector",
    "PgvectorConnector",
    "ConnectorError",
    "CONNECTORS",
]


class ConnectorError(RuntimeError):
    pass


class JsonlConnector:
    """One JSON object per line: ``{"id", "vector", "payload"}`` (JSON export
    format of the reference's CLI)."""

    def __init__(self, path: str, id_field="id", vector_field="vector",
                 payload_field="payload"):
        self.path = path
        self.id_field, self.vector_field, self.payload_field = (
            id_field, vector_field, payload_field,
        )

    def records(self) -> Iterator[dict]:
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ConnectorError(f"{self.path}:{lineno}: bad JSON: {e}")
                yield self._convert(rec, lineno)

    def _convert(self, rec, where) -> dict:
        if self.id_field not in rec or self.vector_field not in rec:
            raise ConnectorError(
                f"{self.path}:{where}: missing {self.id_field!r}/"
                f"{self.vector_field!r}"
            )
        payload = rec.get(self.payload_field)
        if payload is None:  # flat records: everything else is payload
            payload = {
                k: v
                for k, v in rec.items()
                if k not in (self.id_field, self.vector_field)
            } or None
        return {
            "id": int(rec[self.id_field]),
            "vector": rec[self.vector_field],
            "payload": payload,
        }


class JsonConnector(JsonlConnector):
    """A single JSON array of records."""

    def records(self) -> Iterator[dict]:
        with open(self.path) as f:
            data = json.load(f)
        if not isinstance(data, list):
            raise ConnectorError(f"{self.path}: expected a JSON array")
        for i, rec in enumerate(data):
            yield self._convert(rec, i)


class CsvConnector:
    """CSV with an id column and either one JSON-array vector column or
    per-dimension numeric columns (``v0..vN`` or explicit list)."""

    def __init__(self, path: str, id_column="id", vector_column="vector",
                 dim_columns=None):
        self.path = path
        self.id_column = id_column
        self.vector_column = vector_column
        self.dim_columns = dim_columns

    def records(self) -> Iterator[dict]:
        with open(self.path, newline="") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None:
                raise ConnectorError(f"{self.path}: empty CSV")
            dim_cols = self.dim_columns
            if dim_cols is None and self.vector_column not in reader.fieldnames:
                dim_cols = sorted(
                    (c for c in reader.fieldnames if c.startswith("v")
                     and c[1:].isdigit()),
                    key=lambda c: int(c[1:]),
                )
                if not dim_cols:
                    raise ConnectorError(
                        f"{self.path}: no {self.vector_column!r} column and no "
                        "v0..vN dimension columns"
                    )
            for lineno, row in enumerate(reader, 2):
                if self.id_column not in row:
                    raise ConnectorError(f"{self.path}:{lineno}: no id column")
                if dim_cols is not None:
                    vector = [float(row[c]) for c in dim_cols]
                    skip = {self.id_column, *dim_cols}
                else:
                    vector = json.loads(row[self.vector_column])
                    skip = {self.id_column, self.vector_column}
                payload = {
                    k: _coerce_csv(v) for k, v in row.items() if k not in skip
                } or None
                yield {"id": int(row[self.id_column]), "vector": vector,
                       "payload": payload}


def _coerce_csv(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except (ValueError, TypeError):
            pass
    return v


class NumpyConnector:
    """``.npz`` with ``vectors [N, D]`` (+ optional ``ids [N]``) or raw ``.npy``."""

    def __init__(self, path: str, payloads_path: str | None = None):
        self.path = path
        self.payloads_path = payloads_path

    def records(self) -> Iterator[dict]:
        if self.path.endswith(".npz"):
            data = np.load(self.path)
            if "vectors" not in data:
                raise ConnectorError(f"{self.path}: missing 'vectors' array")
            vectors = data["vectors"]
            ids = data["ids"] if "ids" in data else np.arange(len(vectors))
        else:
            vectors = np.load(self.path)
            ids = np.arange(len(vectors))
        payloads = None
        if self.payloads_path:
            with open(self.payloads_path) as f:
                payloads = [json.loads(l) for l in f if l.strip()]
            if len(payloads) != len(vectors):
                raise ConnectorError("payloads/vectors length mismatch")
        for i in range(len(vectors)):
            yield {
                "id": int(ids[i]),
                "vector": np.asarray(vectors[i], np.float32),
                "payload": payloads[i] if payloads else None,
            }


class _RestConnector:
    """Shared REST pagination plumbing (urllib, zero extra deps)."""

    def __init__(self, base_url: str, batch: int = 256, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.batch = batch
        self.timeout = timeout

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except Exception as e:
            raise ConnectorError(f"REST call {path} failed: {e}") from e


class QdrantConnector(_RestConnector):
    """Qdrant scroll API: ``POST /collections/{name}/points/scroll``."""

    def __init__(self, base_url: str, collection: str, **kw):
        super().__init__(base_url, **kw)
        self.collection = collection

    def records(self) -> Iterator[dict]:
        offset = None
        while True:
            body = {"limit": self.batch, "with_payload": True, "with_vector": True}
            if offset is not None:
                body["offset"] = offset
            out = self._post(
                f"/collections/{self.collection}/points/scroll", body
            )
            result = out.get("result") or {}
            for p in result.get("points", []):
                yield {
                    "id": int(p["id"]),
                    "vector": p.get("vector"),
                    "payload": p.get("payload"),
                }
            offset = result.get("next_page_offset")
            if offset is None:
                return


class ChromaConnector(_RestConnector):
    """Chroma API: ``POST /api/v1/collections/{id}/get`` with offset paging."""

    def __init__(self, base_url: str, collection_id: str, **kw):
        super().__init__(base_url, **kw)
        self.collection_id = collection_id

    def records(self) -> Iterator[dict]:
        offset = 0
        while True:
            out = self._post(
                f"/api/v1/collections/{self.collection_id}/get",
                {
                    "limit": self.batch,
                    "offset": offset,
                    "include": ["embeddings", "metadatas"],
                },
            )
            ids = out.get("ids") or []
            if not ids:
                return
            embeds = out.get("embeddings") or []
            metas = out.get("metadatas") or [None] * len(ids)
            for i, vid in enumerate(ids):
                yield {
                    "id": int(vid),
                    "vector": embeds[i],
                    "payload": metas[i],
                }
            offset += len(ids)


class PgvectorConnector:
    """pgvector via psycopg (optional dependency; clear error if absent)."""

    def __init__(self, dsn: str, table: str, id_column="id",
                 vector_column="embedding", batch: int = 1000):
        self.dsn, self.table = dsn, table
        self.id_column, self.vector_column = id_column, vector_column
        self.batch = batch

    def records(self) -> Iterator[dict]:
        try:
            import psycopg  # noqa: F401
        except ImportError as e:
            raise ConnectorError(
                "pgvector migration needs the 'psycopg' package"
            ) from e
        import psycopg

        with psycopg.connect(self.dsn) as conn, conn.cursor() as cur:
            cur.execute(
                f"SELECT {self.id_column}, {self.vector_column}, "
                f"to_jsonb(t) FROM {self.table} t"
            )
            while rows := cur.fetchmany(self.batch):
                for vid, vec, payload in rows:
                    if isinstance(vec, str):
                        vec = json.loads(vec)
                    payload = dict(payload or {})
                    payload.pop(self.vector_column, None)
                    yield {"id": int(vid), "vector": vec, "payload": payload or None}


class ElasticsearchConnector(_RestConnector):
    """Elasticsearch/OpenSearch: ``_search`` with ``search_after`` paging
    over a ``dense_vector`` field."""

    def __init__(self, base_url: str, index: str, vector_field="embedding",
                 id_field=None, **kw):
        super().__init__(base_url, **kw)
        self.index = index
        self.vector_field = vector_field
        self.id_field = id_field  # None = numeric _id

    def records(self) -> Iterator[dict]:
        search_after = None
        while True:
            body = {
                "size": self.batch,
                "sort": [{"_doc": "asc"}],
                "_source": True,
            }
            if search_after is not None:
                body["search_after"] = search_after
            out = self._post(f"/{self.index}/_search", body)
            hits = (out.get("hits") or {}).get("hits") or []
            if not hits:
                return
            for h in hits:
                src = h.get("_source") or {}
                vec = src.pop(self.vector_field, None)
                if vec is None:
                    continue
                rid = src.get(self.id_field) if self.id_field else h.get("_id")
                yield {"id": int(rid), "vector": vec, "payload": src or None}
            search_after = hits[-1].get("sort")
            if search_after is None:
                return


class WeaviateConnector(_RestConnector):
    """Weaviate: ``GET /v1/objects`` cursor pagination with vectors."""

    def __init__(self, base_url: str, class_name: str, id_field="_veles_id", **kw):
        super().__init__(base_url, **kw)
        self.class_name = class_name
        self.id_field = id_field

    def _get(self, path: str) -> dict:
        req = urllib.request.Request(self.base_url + path, method="GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except Exception as e:
            raise ConnectorError(f"REST call {path} failed: {e}") from e

    def records(self) -> Iterator[dict]:
        after = None
        i = 0
        while True:
            path = (
                f"/v1/objects?class={self.class_name}&include=vector"
                f"&limit={self.batch}"
            )
            if after:
                path += f"&after={after}"
            out = self._get(path)
            objs = out.get("objects") or []
            if not objs:
                return
            for o in objs:
                props = dict(o.get("properties") or {})
                rid = props.pop(self.id_field, None)
                yield {
                    "id": int(rid) if rid is not None else i,
                    "vector": o.get("vector"),
                    "payload": props or None,
                }
                i += 1
            after = objs[-1].get("id")


class MilvusConnector(_RestConnector):
    """Milvus RESTful v2: ``/v2/vectordb/entities/query`` with offset paging."""

    def __init__(self, base_url: str, collection: str, vector_field="vector",
                 id_field="id", **kw):
        super().__init__(base_url, **kw)
        self.collection = collection
        self.vector_field = vector_field
        self.id_field = id_field

    def records(self) -> Iterator[dict]:
        offset = 0
        while True:
            out = self._post(
                "/v2/vectordb/entities/query",
                {
                    "collectionName": self.collection,
                    "filter": "",
                    "outputFields": ["*"],
                    "limit": self.batch,
                    "offset": offset,
                },
            )
            rows = out.get("data") or []
            if not rows:
                return
            for r in rows:
                r = dict(r)
                vec = r.pop(self.vector_field, None)
                rid = r.pop(self.id_field)
                yield {"id": int(rid), "vector": vec, "payload": r or None}
            offset += len(rows)


class PineconeConnector(_RestConnector):
    """Pinecone: ``GET /vectors/list`` pagination + ``GET /vectors/fetch``."""

    def __init__(self, base_url: str, namespace: str = "", api_key: str = "", **kw):
        super().__init__(base_url, **kw)
        self.namespace = namespace
        self.api_key = api_key

    def _get(self, path: str) -> dict:
        req = urllib.request.Request(self.base_url + path, method="GET")
        if self.api_key:
            req.add_header("Api-Key", self.api_key)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except Exception as e:
            raise ConnectorError(f"REST call {path} failed: {e}") from e

    def records(self) -> Iterator[dict]:
        token = None
        while True:
            path = f"/vectors/list?limit={self.batch}"
            if self.namespace:
                path += f"&namespace={self.namespace}"
            if token:
                path += f"&paginationToken={token}"
            page = self._get(path)
            ids = [v["id"] for v in page.get("vectors") or []]
            if not ids:
                return
            fetch_path = "/vectors/fetch?" + "&".join(f"ids={i}" for i in ids)
            if self.namespace:
                fetch_path += f"&namespace={self.namespace}"
            got = self._get(fetch_path).get("vectors") or {}
            for vid in ids:
                rec = got.get(vid)
                if rec is None:
                    continue
                yield {
                    "id": int(vid),
                    "vector": rec.get("values"),
                    "payload": rec.get("metadata"),
                }
            token = (page.get("pagination") or {}).get("next")
            if not token:
                return


class RedisConnector:
    """Redis (RediSearch vector fields) via the optional ``redis`` package."""

    def __init__(self, url: str, index: str, vector_field="embedding",
                 batch: int = 500):
        self.url, self.index = url, index
        self.vector_field = vector_field
        self.batch = batch

    def records(self) -> Iterator[dict]:
        try:
            import redis  # noqa: F401
        except ImportError as e:
            raise ConnectorError("Redis migration needs the 'redis' package") from e
        import redis as _redis

        r = _redis.from_url(self.url)
        cursor = 0
        while True:
            cursor, keys = r.scan(cursor, match=f"{self.index}:*", count=self.batch)
            for key in keys:
                doc = r.hgetall(key)
                vec = doc.pop(self.vector_field.encode(), None)
                if vec is None:
                    continue
                payload = {
                    k.decode(): v.decode(errors="replace") for k, v in doc.items()
                }
                rid = int(key.decode().rsplit(":", 1)[-1])
                yield {
                    "id": rid,
                    "vector": np.frombuffer(vec, np.float32),
                    "payload": payload or None,
                }
            if cursor == 0:
                return


class MongoConnector:
    """MongoDB (Atlas vector fields) via the optional ``pymongo`` package."""

    def __init__(self, uri: str, database: str, collection: str,
                 vector_field="embedding", id_field="_veles_id", batch: int = 500):
        self.uri, self.database, self.collection = uri, database, collection
        self.vector_field = vector_field
        self.id_field = id_field
        self.batch = batch

    def records(self) -> Iterator[dict]:
        try:
            import pymongo  # noqa: F401
        except ImportError as e:
            raise ConnectorError("MongoDB migration needs the 'pymongo' package") from e
        import pymongo as _pymongo

        client = _pymongo.MongoClient(self.uri)
        coll = client[self.database][self.collection]
        for i, doc in enumerate(coll.find({}, batch_size=self.batch)):
            vec = doc.pop(self.vector_field, None)
            if vec is None:
                continue
            rid = doc.pop(self.id_field, i)
            doc.pop("_id", None)
            yield {"id": int(rid), "vector": vec, "payload": doc or None}


CONNECTORS = {
    "jsonl": JsonlConnector,
    "json": JsonConnector,
    "csv": CsvConnector,
    "numpy": NumpyConnector,
    "qdrant": QdrantConnector,
    "chroma": ChromaConnector,
    "pgvector": PgvectorConnector,
    "elasticsearch": ElasticsearchConnector,
    "weaviate": WeaviateConnector,
    "milvus": MilvusConnector,
    "pinecone": PineconeConnector,
    "redis": RedisConnector,
    "mongodb": MongoConnector,
}
