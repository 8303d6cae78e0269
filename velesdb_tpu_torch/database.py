"""Database: the collection registry over a data directory.

Counterpart of ``velesdb_tpu/database.py`` (``Database::open /
create_collection / get_collection / list_collections / delete_collection /
load_collections``). Each collection is a subdirectory with its own
``config.json`` and storage files, in the reference package's format, so a
directory written by either package opens in the other. Every collection of
a database lives on the database's ``device``. VelesQL (``query``,
``explain_query``) and MATCH (``match_query``) run on its collections.
"""

from __future__ import annotations

import os
import shutil
import threading

from velesdb_tpu_torch.collection import Collection, CollectionType
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.quantization import StorageMode
from velesdb_tpu_torch.velesql import QueryCache, execute, explain

__all__ = ["Database"]


class Database:
    """Registry of named collections rooted at a data directory."""

    def __init__(self, path: str, device="cuda"):
        self.path = os.path.abspath(path)
        self.device = device
        os.makedirs(self.path, exist_ok=True)
        self._collections: dict[str, Collection] = {}
        self._lock = threading.RLock()
        self._query_cache = None  # VelesQL parse cache, made at the first query

    @classmethod
    def open(cls, path: str, device="cuda") -> "Database":
        """Open (creating if needed) and eagerly load existing collections."""
        db = cls(path, device=device)
        db.load_collections()
        return db

    def create_collection(
        self,
        name: str,
        dim: int,
        metric: DistanceMetric | str = DistanceMetric.COSINE,
        storage_mode: StorageMode | str = StorageMode.FULL,
        collection_type: str = CollectionType.VECTOR,
        index_kind: str = "auto",
    ) -> Collection:
        """Create a collection; ``index_kind`` ("auto", "exact", "ivf" or
        "graph") pins its engine, as setting ``Collection.index_kind`` does
        (the choice is not persisted: a reopened collection starts at
        "auto")."""
        _validate_name(name)
        with self._lock:
            if name in self._collections:
                raise ValueError(f"collection {name!r} already exists")
            cdir = self._collection_dir(name)
            if os.path.exists(os.path.join(cdir, "config.json")):
                raise ValueError(f"collection {name!r} already exists on disk")
            col = Collection(
                cdir,
                name,
                dim,
                metric=metric,
                storage_mode=storage_mode,
                collection_type=collection_type,
                create=True,
                device=self.device,
            )
            col.index_kind = index_kind
            self._collections[name] = col
            return col

    def get_collection(self, name: str) -> Collection:
        _validate_name(name)
        with self._lock:
            if name not in self._collections:
                cdir = self._collection_dir(name)
                if os.path.exists(os.path.join(cdir, "config.json")):
                    self._collections[name] = Collection.open(cdir, device=self.device)
                else:
                    raise KeyError(f"collection {name!r} not found")
            return self._collections[name]

    def get_or_create_collection(self, name: str, dim: int, **kwargs) -> Collection:
        try:
            return self.get_collection(name)
        except KeyError:
            return self.create_collection(name, dim, **kwargs)

    def list_collections(self) -> list[str]:
        with self._lock:
            names = set(self._collections)
            if os.path.isdir(self.path):
                for entry in os.listdir(self.path):
                    if os.path.exists(os.path.join(self.path, entry, "config.json")):
                        names.add(entry)
            return sorted(names)

    def delete_collection(self, name: str) -> bool:
        _validate_name(name)
        with self._lock:
            col = self._collections.pop(name, None)
            if col is not None:
                col.close()
            cdir = self._collection_dir(name)
            if os.path.exists(cdir):
                shutil.rmtree(cdir)
                return True
            return col is not None

    def _collection_dir(self, name: str) -> str:
        """Resolve a collection's directory, refusing anything that escapes
        the data root."""
        cdir = os.path.join(self.path, name)
        root = os.path.realpath(self.path)
        resolved = os.path.realpath(cdir)
        if resolved == root or not resolved.startswith(root + os.sep):
            raise ValueError(f"invalid collection name: {name!r}")
        return cdir

    def load_collections(self) -> list[str]:
        loaded = []
        for name in self.list_collections():
            self.get_collection(name)
            loaded.append(name)
        return loaded

    # -- VelesQL and MATCH --------------------------------------------------------

    @property
    def query_cache(self) -> QueryCache:
        if self._query_cache is None:
            self._query_cache = QueryCache()
        return self._query_cache

    def query(self, velesql: str, params: dict | None = None) -> list[dict]:
        """Parse (cached) and execute a VelesQL query; rows as dicts."""
        return execute(self, self.query_cache.parse(velesql), params)

    def match_query(self, collection: str, match_text: str,
                    params: dict | None = None) -> list[dict]:
        """MATCH graph query against one collection."""
        return self.get_collection(collection).execute_match(match_text, params)

    def explain_query(self, velesql: str):
        """Query plan tree (:func:`~velesdb_tpu_torch.velesql.explain`)."""
        return explain(self.query_cache.parse(velesql), db=self)

    def close(self) -> None:
        with self._lock:
            for col in self._collections.values():
                col.close()
            self._collections.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _validate_name(name: str) -> None:
    if not name or any(c in name for c in "/\\\0") or name in (".", ".."):
        raise ValueError(f"invalid collection name: {name!r}")
