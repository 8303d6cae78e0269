"""Collection: one named dataset = durable host storage + device search state.

Counterpart of ``velesdb_tpu/collection.py``, exact search only. The
canonical store is host-side and append-oriented (memmap vectors + CRC WAL,
payload log; the on-disk format is the reference package's, byte for byte);
the device holds a padded snapshot refreshed lazily after mutations, and
every search runs the exact :class:`~velesdb_tpu_torch.index.brute.BruteForceIndex`.

The reference's planner also serves exact below ``ANN_MIN_ROWS`` (2M) rows,
so at those sizes both packages serve the same engine; above it this package
still serves exact (ROADMAP.md). Graph/IVF indexes, quantized storage,
``quality="perfect"``, text, hybrid, VelesQL and graph methods raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Iterable

import numpy as np

from velesdb_tpu_torch.column.store import ColumnStore
from velesdb_tpu_torch.index.brute import BruteForceIndex, not_in_slice
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.quantization import StorageMode
from velesdb_tpu_torch.storage.payload_log import PayloadLog
from velesdb_tpu_torch.storage.vector_store import VectorStore

__all__ = ["Collection", "SearchResult", "CollectionType"]


class CollectionType:
    """Parity with ``CollectionType`` (``collection/types.rs:32``)."""

    VECTOR = "vector"
    METADATA_ONLY = "metadata_only"
    GRAPH = "graph"


class SearchResult(dict):
    """A search hit: ``{"id", "score", "payload"}`` (dict for JSON surfaces)."""

    @property
    def id(self) -> int:
        return self["id"]

    @property
    def score(self) -> float:
        return self["score"]

    @property
    def payload(self):
        return self["payload"]


def _later(name: str, area: str):
    """A method of the reference that this package does not serve yet."""

    def method(self, *args, **kwargs):
        raise not_in_slice(f"Collection.{name} ({area})")

    method.__name__ = name
    return method


class Collection:
    """A named vector collection with durable storage and exact device search."""

    def __init__(
        self,
        path: str,
        name: str,
        dim: int,
        metric: DistanceMetric = DistanceMetric.COSINE,
        storage_mode: StorageMode = StorageMode.FULL,
        collection_type: str = CollectionType.VECTOR,
        create: bool = False,
        device="cuda",
    ):
        self.path = path
        self.name = name
        self.dim = int(dim)
        self.metric = DistanceMetric.parse(metric)
        self.storage_mode = StorageMode.parse(storage_mode)
        self.collection_type = collection_type
        # refuse what the slice does not serve before touching the disk
        self._brute = BruteForceIndex(self.dim, self.metric, self.storage_mode, device)
        self.device = self._brute.device
        self._lock = threading.RLock()
        if create:
            os.makedirs(path, exist_ok=True)
            self._save_config()
        self.vectors = VectorStore(path, self.dim, create=create)
        self.payloads = PayloadLog(path)
        self._device_dirty = True
        self._slot_ids: np.ndarray | None = None  # [used] int64, -1 = tombstone
        self._index_kind = "auto"
        self.columns = ColumnStore()
        self.columns.set_id_source(self.vectors.occupancy)
        self._columns_built = False
        # TTL rows, durable in ttl.json; writes are batched behind a dirty
        # flag and flushed once per bulk op / flush() / close()
        self._ttl: dict[int, float] = self._load_ttl()  # vid -> unix expiry
        self._ttl_dirty = False
        self._last_ttl_flush = 0.0

    @property
    def index_kind(self) -> str:
        return self._index_kind

    @index_kind.setter
    def index_kind(self, kind: str) -> None:
        if kind not in ("auto", "exact"):
            raise not_in_slice(f"index_kind={kind!r}")
        self._index_kind = kind

    # -- config ------------------------------------------------------------

    def _save_config(self) -> None:
        cfg = {
            "name": self.name,
            "dim": self.dim,
            "metric": self.metric.value,
            "storage_mode": self.storage_mode.value,
            "collection_type": self.collection_type,
            "version": 1,
        }
        tmp = os.path.join(self.path, "config.json.tmp")
        with open(tmp, "w") as f:
            json.dump(cfg, f, indent=2)
        os.replace(tmp, os.path.join(self.path, "config.json"))

    def _load_ttl(self) -> dict[int, float]:
        p = os.path.join(self.path, "ttl.json")
        try:
            with open(p) as f:
                return {int(k): float(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            return {}

    _TTL_FLUSH_DEBOUNCE_S = 2.0

    def _flush_ttl(self, debounce: bool = False) -> None:
        """``debounce=True`` (single-row path) flushes at most once per
        debounce window."""
        if not self._ttl_dirty:
            return
        if debounce and (
            time.monotonic() - self._last_ttl_flush < self._TTL_FLUSH_DEBOUNCE_S
        ):
            return
        self._save_ttl()
        self._ttl_dirty = False
        self._last_ttl_flush = time.monotonic()

    def _save_ttl(self) -> None:
        p = os.path.join(self.path, "ttl.json")
        if not self._ttl:
            if os.path.exists(p):
                os.remove(p)
            return
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self._ttl.items()}, f)
        os.replace(tmp, p)

    @classmethod
    def open(cls, path: str, device="cuda") -> "Collection":
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        return cls(
            path,
            cfg["name"],
            cfg["dim"],
            metric=cfg.get("metric", "cosine"),
            storage_mode=cfg.get("storage_mode", "full"),
            collection_type=cfg.get("collection_type", CollectionType.VECTOR),
            device=device,
        )

    # -- CRUD ----------------------------------------------------------------

    def upsert(
        self, vid: int, vector, payload: dict | None = None, ttl: float | None = None
    ) -> None:
        """Store one vector (and payload); ``ttl`` seconds marks it for expiry."""
        vec = np.asarray(vector, dtype=np.float32)
        if vec.shape != (self.dim,):
            raise ValueError(
                f"dimension mismatch: expected {self.dim}, got {vec.shape}"
            )
        with self._lock:
            slot = self.vectors.store(int(vid), vec)
            if payload is not None:
                self.payloads.store(int(vid), payload)
            if self._columns_built:
                self.columns.upsert_row(slot, payload)
            if ttl is not None:
                self._ttl[int(vid)] = time.time() + ttl
                self._ttl_dirty = True
            elif self._ttl.pop(int(vid), None) is not None:
                self._ttl_dirty = True
            self._flush_ttl(debounce=True)
            self._on_mutation([int(vid)])

    def upsert_bulk(
        self,
        ids: Iterable[int],
        vectors,
        payloads: Iterable[dict] | None = None,
        ttl: float | None = None,
    ) -> None:
        """Bulk variant; ``ttl`` applies to every row."""
        vecs = np.asarray(vectors, dtype=np.float32)
        ids = [int(i) for i in ids]
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"dimension mismatch: expected [N, {self.dim}], got {vecs.shape}"
            )
        if len(ids) != vecs.shape[0]:
            raise ValueError("ids and vectors length mismatch")
        with self._lock:
            slots = self.vectors.store_batch(ids, vecs)
            payloads = list(payloads) if payloads is not None else None
            if payloads is not None:
                for vid, payload in zip(ids, payloads):
                    if payload is not None:
                        self.payloads.store(vid, payload)
            if self._columns_built:
                for i, slot in enumerate(slots):
                    self.columns.upsert_row(
                        slot, payloads[i] if payloads is not None else None
                    )
            if ttl is not None:
                expiry = time.time() + ttl
                for vid in ids:
                    self._ttl[vid] = expiry
                self._ttl_dirty = True
            elif any(self._ttl.pop(vid, None) is not None for vid in ids):
                # a re-upsert without ttl clears any stale deadline
                self._ttl_dirty = True
            self._flush_ttl()  # one write per bulk call
            self._on_mutation(ids)

    def get(self, vid: int):
        """Fetch ``(vector, payload)`` or None."""
        vec = self.vectors.retrieve(vid)
        if vec is None:
            return None
        return vec, self.payloads.retrieve(vid)

    def delete(self, vid: int) -> bool:
        with self._lock:
            slot = self.vectors.id_to_slot.get(int(vid))
            existed = self.vectors.delete(vid)
            self.payloads.delete(vid)
            if existed:
                if self._columns_built and slot is not None:
                    self.columns.remove_row(slot)
                self._on_mutation([int(vid)])
            return existed

    def count(self) -> int:
        return len(self.vectors)

    def __len__(self) -> int:
        return self.count()

    def _on_mutation(self, ids: list[int]) -> None:
        self._device_dirty = True
        self.columns.invalidate(ids)

    # -- device state ------------------------------------------------------

    def refresh_device(self) -> None:
        """Upload the current host slot array as padded device state."""
        with self._lock:
            if not self._device_dirty:
                return
            used = self.vectors.used_slots
            slots = self.vectors.slot_view()[: max(used, 1)]
            slot_ids, valid = self.vectors.occupancy()
            if used == 0:
                slots = np.zeros((1, self.dim), np.float32)
                slot_ids = np.full(1, -1, np.int64)
                valid = np.zeros(1, bool)
            self._slot_ids = slot_ids
            self._brute.rebuild(slots, valid)
            self._device_dirty = False

    # -- search ------------------------------------------------------------

    def search(self, query, k: int = 10, filter: dict | None = None,
               ef: int | None = None, quality=None):
        """Single-query search; returns hydrated results best-first."""
        return self.search_batch([query], k, filter=filter, ef=ef, quality=quality)[0]

    def search_batch(self, queries, k: int = 10, filter: dict | None = None,
                     ef: int | None = None, quality=None):
        """Batched exact search: one device pass for the whole batch.

        ``ef`` is accepted for API parity and unused (exact search has no
        beam); ``quality="perfect"`` (the reference's host-f32 rerank pass)
        is not ported yet."""
        if quality is not None and str(getattr(quality, "value", quality)).lower() == "perfect":
            raise not_in_slice('quality="perfect"')
        self.refresh_device()
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if q.shape[1] != self.dim:
            raise ValueError(
                f"dimension mismatch: expected {self.dim}, got {q.shape[1]}"
            )
        mask = self._filter_mask(filter)
        vals, idx = self._search_device(q, k, mask)
        return self._hydrate(vals.cpu().numpy(), idx.cpu().numpy(), k)

    def _search_device(self, q, k, mask):
        """Device ``(vals, slot ids)`` of the exact engine."""
        return self._brute.search(q, k, mask=mask)

    # -- filters -----------------------------------------------------------

    def _ensure_columns(self) -> None:
        """Lazily populate the column store from the payload log (cold open)."""
        if self._columns_built:
            return
        for vid, payload in self.payloads.payloads.items():
            slot = self.vectors.id_to_slot.get(vid)
            if slot is not None:
                self.columns.upsert_row(slot, payload)
        self._columns_built = True

    def _filter_mask(self, filt):
        mask = self._raw_filter_mask(filt)
        if mask is None:
            return None
        used = max(self.vectors.used_slots, 1)
        return _pad_mask(mask, self._brute.n_pad or used)

    def _raw_filter_mask(self, filt):
        """``[used_slots] bool`` mask for a filter dict (unpadded)."""
        if filt is None:
            return None
        self._ensure_columns()
        used = max(self.vectors.used_slots, 1)
        return self.columns.mask_for_filter(filt, used)

    def _hydrate(self, vals: np.ndarray, idx: np.ndarray, k: int):
        """Map device slot indices back to user ids + payloads."""
        out = []
        slot_ids = self._slot_ids
        for b in range(vals.shape[0]):
            row = []
            for j in range(vals.shape[1]):
                slot = int(idx[b, j])
                if slot < 0 or slot >= slot_ids.shape[0]:
                    continue
                vid = int(slot_ids[slot])
                if vid < 0 or not np.isfinite(vals[b, j]):
                    continue
                row.append(
                    SearchResult(
                        id=vid,
                        score=float(vals[b, j]),
                        payload=self.payloads.retrieve(vid),
                    )
                )
                if len(row) == k:
                    break
            out.append(row)
        return out

    # -- not in this slice (ROADMAP.md) -------------------------------------

    search_with_rerank = _later("search_with_rerank", "quantized rerank")
    search_batch_with_rerank = _later("search_batch_with_rerank", "quantized rerank")
    text_search = _later("text_search", "text search")
    text_search_batch = _later("text_search_batch", "text search")
    hybrid_search = _later("hybrid_search", "hybrid search")
    hybrid_search_batch = _later("hybrid_search_batch", "hybrid search")
    like_mask = _later("like_mask", "text search")
    ensure_graph = _later("ensure_graph", "knowledge graph")
    add_node = _later("add_node", "knowledge graph")
    add_edge = _later("add_edge", "knowledge graph")
    get_edges = _later("get_edges", "knowledge graph")
    neighbors = _later("neighbors", "knowledge graph")
    degree = _later("degree", "knowledge graph")
    traverse = _later("traverse", "knowledge graph")
    execute_match = _later("execute_match", "knowledge graph")

    # -- durability --------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            self.vectors.flush()
            self.payloads.flush()
            self._flush_ttl()

    def close(self) -> None:
        with self._lock:
            self._flush_ttl()
            self.vectors.close()
            self.payloads.close()

    def info(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "dim": self.dim,
            "metric": self.metric.value,
            "storage_mode": self.storage_mode.value,
            "collection_type": self.collection_type,
            "count": self.count(),
            "device": str(self.device),
            # the exact core a plain search dispatches to right now
            "serve_engine": self._brute.serve_engine(),
        }


def _pad_mask(mask: np.ndarray, n_pad: int) -> np.ndarray:
    if mask.shape[0] >= n_pad:
        return mask[:n_pad]
    return np.pad(mask, (0, n_pad - mask.shape[0]))
