"""Caching primitives: thread-safe LRU + Bloom filter + search-result cache.

Counterpart of ``velesdb-core/src/cache/`` (LRU cache, lock-free LRU, bloom
filter — 645 LoC with a documented lock hierarchy ``cache/mod.rs:8-16``).
Python's GIL removes the lock-hierarchy problem; one RLock per structure is
the whole concurrency story here.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["LruCache", "BloomFilter", "SearchResultCache"]


class LruCache:
    """Bounded thread-safe LRU map."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._map: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        with self._lock:
            if key in self._map:
                self._map.move_to_end(key)
                self.hits += 1
                return self._map[key]
            self.misses += 1
            return default

    def put(self, key, value) -> None:
        with self._lock:
            self._map[key] = value
            self._map.move_to_end(key)
            if len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def invalidate(self, key=None) -> None:
        with self._lock:
            if key is None:
                self._map.clear()
            else:
                self._map.pop(key, None)

    def __len__(self) -> int:
        return len(self._map)

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._map),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
            }


class BloomFilter:
    """Numpy-bitset Bloom filter (``cache/`` bloom analog).

    Double hashing (Kirsch–Mitzenmacher): h_i = h1 + i*h2 over blake2b halves.
    """

    def __init__(self, capacity: int = 10_000, fp_rate: float = 0.01):
        if not 0 < fp_rate < 1:
            raise ValueError("fp_rate must be in (0, 1)")
        m = int(-capacity * np.log(fp_rate) / (np.log(2) ** 2))
        self.n_bits = max(64, m)
        self.n_hashes = max(1, round(self.n_bits / capacity * np.log(2)))
        self._bits = np.zeros((self.n_bits + 63) // 64, np.uint64)
        self._lock = threading.Lock()
        self.count = 0

    def _hashes(self, item) -> np.ndarray:
        raw = item if isinstance(item, bytes) else str(item).encode()
        digest = hashlib.blake2b(raw, digest_size=16).digest()
        h1 = int.from_bytes(digest[:8], "little")
        h2 = int.from_bytes(digest[8:], "little") | 1
        return (h1 + np.arange(self.n_hashes, dtype=np.uint64) * np.uint64(h2)) % np.uint64(self.n_bits)

    def add(self, item) -> None:
        idx = self._hashes(item)
        with self._lock:
            np.bitwise_or.at(
                self._bits, (idx // 64).astype(np.int64), np.uint64(1) << (idx % 64)
            )
            self.count += 1

    def __contains__(self, item) -> bool:
        idx = self._hashes(item)
        words = self._bits[(idx // 64).astype(np.int64)]
        return bool(np.all(words & (np.uint64(1) << (idx % 64)) != 0))


class SearchResultCache:
    """LRU over search results keyed by (query bytes, k, filter, ef, quality).

    Any collection mutation invalidates the whole cache (same policy as the
    reference's query cache on data change).
    """

    def __init__(self, capacity: int = 512):
        self._lru = LruCache(capacity)

    @staticmethod
    def key(query: np.ndarray, k: int, filt, ef, quality) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(query, np.float32).tobytes())
        h.update(
            json.dumps(
                [k, filt, ef, str(quality) if quality is not None else None],
                sort_keys=True,
                default=str,
            ).encode()
        )
        return h.digest()

    def get(self, key: bytes):
        return self._lru.get(key)

    def put(self, key: bytes, results) -> None:
        self._lru.put(key, results)

    def invalidate(self) -> None:
        self._lru.invalidate()

    def stats(self) -> dict:
        return self._lru.stats()
