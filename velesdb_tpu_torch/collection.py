"""Collection: one named dataset = durable host storage + device search state.

Counterpart of ``velesdb_tpu/collection.py``, exact search only. The
canonical store is host-side and append-oriented (memmap vectors + CRC WAL,
payload log; the on-disk format is the reference package's, byte for byte);
the device holds a padded snapshot refreshed lazily after mutations, and
every search runs the exact :class:`~velesdb_tpu_torch.index.brute.BruteForceIndex`
on FULL, F16, BF16, SQ8 or BINARY storage.

Quantized collections (SQ8, BINARY) rerank by default (:attr:`auto_rerank`):
the device pass fetches ``oversample * k`` candidates and the host rescores
them in f32 from the stored vectors. A storage recall gate measures that
serve path against a host f32 oracle once per row count and widens the
oversample until it clears the quality profile's bar. ``quality="perfect"``
reranks on any storage. Half-precision collections (F16, BF16) serve their
own scores with no auto-rerank, as in the reference (``collection.py:777``).

The reference's planner also serves exact below ``ANN_MIN_ROWS`` (2M) rows,
so at those sizes both packages serve the same engine; above it this package
still serves exact (ROADMAP.md). Graph/IVF indexes, text, hybrid, VelesQL and
graph methods raise ``NotImplementedError``.
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
from velesdb_tpu_torch.index.params import SearchQuality
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
        # Quantized collections rerank plain searches in host f32 (the
        # reference's dual-precision default); False serves raw coarse scores.
        self.auto_rerank = True
        # serving oversample of that rerank; the storage recall gate widens it
        # while the calibrated recall misses the profile's bar
        self._rerank_oversample = 4.0
        self._storage_gate_used = None  # row count the gate last ran at
        self._storage_recall = None  # (used, recall) of the last calibration
        self._storage_probe = None  # (used, version, queries, oracle ids)
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

    def search_with_rerank(self, query, k: int = 10, oversample: float = 4.0,
                           filter: dict | None = None, ef: int | None = None):
        """Quantized first pass + exact f32 rerank (dual-precision search):
        fetch ``oversample * k`` candidates with the collection's storage
        mode, rescore them in f32 on the host, keep the exact top-k."""
        return self.search_batch_with_rerank(
            [query], k, oversample=oversample, filter=filter, ef=ef
        )[0]

    def search_batch_with_rerank(self, queries, k: int = 10, oversample: float = 4.0,
                                 filter: dict | None = None, ef: int | None = None,
                                 quality=None):
        """Batched :meth:`search_with_rerank`: one device pass for the
        candidates, one vectorized fetch of their stored vectors, numpy
        rescoring per query."""
        self.refresh_device()
        q = np.atleast_2d(np.asarray(queries, np.float32))
        m = max(k, int(round(oversample * k)))
        coarse = self.search_batch(q, m, filter=filter, ef=ef, quality=quality, _raw=True)
        all_ids = [[r.id for r in row] for row in coarse]
        vecs, found = self.vectors.retrieve_batch([vid for ids in all_ids for vid in ids])
        out = []
        pos = 0
        hib = self.metric.higher_is_better
        for b, row in enumerate(coarse):
            ids = all_ids[b]
            v = vecs[pos : pos + len(ids)]
            f = np.asarray(found[pos : pos + len(ids)], bool)
            pos += len(ids)
            # an id deleted between the coarse pass and the fetch comes back
            # as a zero vector, which could outrank real candidates: drop it
            keep = np.flatnonzero(f)
            if keep.size == 0:
                out.append([])
                continue
            scores = _host_scores(q[b], v[keep], self.metric)
            order = np.argsort(-scores if hib else scores)
            out.append([
                SearchResult(id=ids[keep[j]], score=float(scores[j]),
                             payload=row[keep[j]]["payload"])
                for j in order[:k]
            ])
        return out

    # -- storage recall gate -------------------------------------------------

    def _ensure_storage_gate(self, quality=None) -> None:
        """Calibrate the quantized serve path and widen the rerank oversample
        until its measured recall clears the profile bar (or the 32x cap).
        Runs again only after the row count drifts by 10%."""
        used = self.vectors.used_slots
        if used < 4096:  # toy collections: the probe costs more than it informs
            return
        prev = self._storage_gate_used
        if prev is not None and abs(used - prev) < 0.1 * prev:
            return
        self._storage_gate_used = used  # set first: calibration re-enters search
        bar = SearchQuality.parse(quality or SearchQuality.BALANCED).min_recall
        r = self.calibrate_storage()
        while r is not None and r < bar and self._rerank_oversample < 32:
            self._rerank_oversample *= 2.0
            self._storage_recall = None  # force a fresh probe
            r = self.calibrate_storage()

    def calibrate_storage(self, sample: int = 128):
        """True recall@10 of the quantized serve path (auto-rerank included)
        against a host f32 exact oracle over the stored vectors, on ``sample``
        probe queries: stored rows perturbed by their nearest-neighbour
        distance. Cached per row count and reported by :meth:`info`; ``None``
        for FULL storage.

        The reference ranks with ``argsort`` of per-row f32 scores; this copy
        ranks with ``argpartition`` on euclidean ``|c|^2 - 2 q.c`` and cosine
        dots over precomputed norms (the same order up to ties), and keeps
        the probe set and its oracle ids for the row count and store version,
        so the gate's later rounds rerun only the serve path. It does not
        record the recall with a planner: the port has none yet (ROADMAP.md)."""
        if self.storage_mode not in (StorageMode.SQ8, StorageMode.BINARY):
            return None
        used = self.vectors.used_slots
        if used < 32:
            return None
        if self._storage_recall is not None and self._storage_recall[0] == used:
            return self._storage_recall[1]
        k = 10
        probe = self._storage_probe
        if probe is None or probe[:2] != (used, self.vectors.version):
            probe = (used, self.vectors.version, *self._storage_oracle(sample, used, k))
            self._storage_probe = probe
        _, _, q, gt_ids = probe
        res = self.search_batch(q, k)
        hits = sum(len({r.id for r in row} & set(gt.tolist())) for row, gt in zip(res, gt_ids))
        r = hits / float(len(res) * k)
        self._storage_recall = (used, r)
        return r

    def _storage_oracle(self, sample: int, used: int, k: int):
        """Probe queries and their exact top-``k`` stored ids (host f32)."""
        take = min(sample, used)
        slots = np.linspace(0, used - 1, take).astype(np.int64)
        corpus = np.asarray(self.vectors.slot_view()[:used], np.float32)
        base = corpus[slots]
        noise = np.random.default_rng(0).standard_normal(base.shape).astype(np.float32)
        noise /= np.maximum(np.linalg.norm(noise, axis=1, keepdims=True), 1e-9)
        slot_ids, live = self.vectors.occupancy()
        norms = np.einsum("nd,nd->n", corpus, corpus)
        if self.metric is DistanceMetric.COSINE:
            norms = np.sqrt(norms)

        def oracle(qs, kk):
            out = np.empty((len(qs), kk), np.int64)
            for i, qv in enumerate(qs):  # host BLAS row passes
                dots = corpus @ qv
                if self.metric is DistanceMetric.EUCLIDEAN:
                    s = norms - 2.0 * dots  # |c - q|^2 - |q|^2
                elif self.metric is DistanceMetric.COSINE:
                    s = -np.where(norms > 1e-30, dots / np.maximum(norms, 1e-30), 0.0)
                else:
                    s = -dots
                s = np.where(live, s, np.inf)
                top = np.argpartition(s, kk - 1)[:kk]
                out[i] = top[np.argsort(s[top], kind="stable")]
            return out

        nn2 = oracle(base, 2)
        d1 = np.linalg.norm(base - corpus[nn2[:, 1]], axis=1, keepdims=True)
        q = base + noise * d1
        return q, slot_ids[oracle(q, k)]

    def search_batch(self, queries, k: int = 10, filter: dict | None = None,
                     ef: int | None = None, quality=None, _raw: bool = False):
        """Batched exact search: one device pass for the whole batch.

        ``ef`` is accepted for API parity and unused (exact search has no
        beam). Quantized collections route through the host f32 rerank
        (:attr:`auto_rerank`, behind the storage recall gate), and
        ``quality="perfect"`` reranks on any storage; ``_raw=True`` is the
        coarse-pass escape hatch."""
        wants_perfect = (
            quality is not None and SearchQuality.parse(quality) is SearchQuality.PERFECT
        )
        if not _raw and (
            wants_perfect
            or (self.auto_rerank
                and self.storage_mode in (StorageMode.SQ8, StorageMode.BINARY))
        ):
            if not wants_perfect:
                self._ensure_storage_gate(quality)
            return self.search_batch_with_rerank(
                queries, k, filter=filter, ef=ef, quality=quality,
                oversample=self._rerank_oversample,
            )
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
            "rerank_oversample": self._rerank_oversample,
            "storage_recall": None if self._storage_recall is None else self._storage_recall[1],
        }


def _host_scores(q: np.ndarray, vecs: np.ndarray, metric: DistanceMetric):
    """Exact f32 scores of one query against a few candidate rows, in numpy
    (reference ``collection.py:1775``, the three float metrics)."""
    dots = vecs @ q
    if metric is DistanceMetric.DOT_PRODUCT:
        return dots
    if metric is DistanceMetric.COSINE:
        denom = np.linalg.norm(vecs, axis=1) * max(np.linalg.norm(q), 1e-30)
        return np.where(denom > 1e-30, dots / np.maximum(denom, 1e-30), 0.0)
    return np.linalg.norm(vecs - q[None, :], axis=1)


def _pad_mask(mask: np.ndarray, n_pad: int) -> np.ndarray:
    if mask.shape[0] >= n_pad:
        return mask[:n_pad]
    return np.pad(mask, (0, n_pad - mask.shape[0]))
