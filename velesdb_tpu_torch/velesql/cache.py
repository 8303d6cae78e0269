"""Parsed-query LRU cache.

Counterpart of ``QueryCache`` (``velesql/cache.rs:56`` — LRU keyed by a hash
of the query text; the reference hits in 84ns). Python dict lookups land in
the same "skip the parser entirely" regime, which is what matters: lark
parses in ~100µs, a cache hit is ~100ns.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from velesdb_tpu_torch.velesql.ast import Query
from velesdb_tpu_torch.velesql.parser import parse

__all__ = ["QueryCache"]


class QueryCache:
    """Thread-safe LRU of parsed queries keyed by the exact query text."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._lru: OrderedDict[str, Query] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def parse(self, text: str) -> Query:
        with self._lock:
            q = self._lru.get(text)
            if q is not None:
                self._lru.move_to_end(text)
                self.hits += 1
                return q
        q = parse(text)
        with self._lock:
            self.misses += 1
            self._lru[text] = q
            if len(self._lru) > self.capacity:
                self._lru.popitem(last=False)
        return q

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._lru),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
            }
