"""Async wrappers: non-blocking collection ops for asyncio servers.

A copy of ``velesdb_tpu/aio.py`` over the port's ``Database`` and
``Collection``. Counterpart of ``collection/async_ops.rs`` (tokio ``spawn_blocking`` wrappers
for bulk insert / search). asyncio's ``to_thread`` plays the same role: the
engine's work (device dispatch + host IO) leaves the event loop.
"""

from __future__ import annotations

import asyncio
from typing import Iterable

__all__ = ["AsyncCollection", "AsyncDatabase"]


class AsyncCollection:
    """asyncio facade over a Collection (thread-offloaded)."""

    def __init__(self, collection):
        self._c = collection

    @property
    def name(self) -> str:
        return self._c.name

    async def upsert(self, vid, vector, payload=None) -> None:
        await asyncio.to_thread(self._c.upsert, vid, vector, payload)

    async def upsert_bulk(self, ids: Iterable[int], vectors, payloads=None) -> None:
        await asyncio.to_thread(self._c.upsert_bulk, ids, vectors, payloads)

    async def get(self, vid: int):
        return await asyncio.to_thread(self._c.get, vid)

    async def delete(self, vid: int) -> bool:
        return await asyncio.to_thread(self._c.delete, vid)

    async def search(self, query, k=10, **kw):
        return await asyncio.to_thread(self._c.search, query, k, **kw)

    async def search_batch(self, queries, k=10, **kw):
        return await asyncio.to_thread(self._c.search_batch, queries, k, **kw)

    async def text_search(self, query, k=10, **kw):
        return await asyncio.to_thread(self._c.text_search, query, k, **kw)

    async def hybrid_search(self, vector, text, k=10, **kw):
        return await asyncio.to_thread(self._c.hybrid_search, vector, text, k, **kw)

    async def execute_match(self, match_text, params=None):
        return await asyncio.to_thread(self._c.execute_match, match_text, params)

    async def flush(self) -> None:
        await asyncio.to_thread(self._c.flush)


class AsyncDatabase:
    """asyncio facade over a Database."""

    def __init__(self, db):
        self._db = db

    def collection(self, name: str) -> AsyncCollection:
        return AsyncCollection(self._db.get_collection(name))

    async def query(self, velesql: str, params=None):
        return await asyncio.to_thread(self._db.query, velesql, params)

    async def match_query(self, collection: str, text: str, params=None):
        return await asyncio.to_thread(self._db.match_query, collection, text, params)
