"""Collection: one named dataset = durable host storage + device search state.

Counterpart of ``velesdb_tpu/collection.py``: exact, IVF and graph search. The
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

The ANN engines serve when pinned (``index_kind = "ivf"`` or ``"graph"``),
and through the planner
(:class:`~velesdb_tpu_torch.velesql.planner.QueryPlanner`) in ``"auto"``
once the collection holds ``ann_min_rows`` (2M) rows or a fresh index:
:class:`~velesdb_tpu_torch.index.ivf.IvfIndex` (kernel #10) on every float
metric and storage but BINARY, and the beam-search
:class:`~velesdb_tpu_torch.index.graph_index.GraphIndex` (whose entry IVF
launches #10) on FULL, F16 and BF16 storage. A post-build recall probe
records each engine's recall per ef with the planner: an unpinned engine
below the quality profile's bar demotes to exact, and a smaller calibrated ef
that clears it is served instead. Mutations after a build land in a
per-engine delta that is searched exactly beside the index, until it
outgrows ``delta_rebuild_fraction`` of the rows.

Text search builds a BM25 index (:class:`~velesdb_tpu_torch.text.bm25.Bm25Index`,
its blocks on the collection's device) from the payloads' strings at the
first text query, and keeps it in step with mutations; the trigram LIKE
index builds at the first :meth:`Collection.like_mask`. Hybrid search fuses
the vector branch (the engine a search would take) and BM25 with weighted
RRF on the device (:func:`~velesdb_tpu_torch.ops.fused_rrf.rrf_fuse_topk`),
except on quantized collections with the auto-rerank, which fuse the two
reranked host lists. VelesQL (:mod:`velesdb_tpu_torch.velesql`) runs
on these searches.

The knowledge graph (:attr:`Collection.graph`, a
:class:`~velesdb_tpu_torch.graph.CollectionGraph`) is separate from the ANN
graph (:attr:`Collection.ann`): typed edges between row ids and label and
property indexes over the payloads, built at the first graph call from the
payload log and ``edges.npz`` and kept in step with every upsert and delete
from then on; MATCH queries and BFS traversals run on it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Iterable

import numpy as np
import torch

from velesdb_tpu_torch import graph as kg
from velesdb_tpu_torch.cache import SearchResultCache
from velesdb_tpu_torch.column.store import ColumnStore
from velesdb_tpu_torch.fusion import FusionStrategy, weighted_rrf
from velesdb_tpu_torch.index.brute import BruteForceIndex
from velesdb_tpu_torch.index.graph_index import GraphIndex
from velesdb_tpu_torch.index.ivf import IvfIndex
from velesdb_tpu_torch.index.ivf import stage_mark as _mark
from velesdb_tpu_torch.index.params import GraphParams, SearchQuality
from velesdb_tpu_torch.ops.distance import (
    SET_METRICS,
    DistanceMetric,
    host_bit_scores,
    host_bits,
    host_set_scores,
)
from velesdb_tpu_torch.ops.fused_rrf import rrf_fuse_topk
from velesdb_tpu_torch.ops.quantization import SQ8Vectors, StorageMode
from velesdb_tpu_torch.ops.streamed import streamed_topk
from velesdb_tpu_torch.ops.topk import pad_mask
from velesdb_tpu_torch.storage.payload_log import PayloadLog
from velesdb_tpu_torch.storage.vector_store import VectorStore
from velesdb_tpu_torch.text.bm25 import Bm25Index
from velesdb_tpu_torch.text.tokenizer import extract_text
from velesdb_tpu_torch.text.trigram import TrigramIndex
from velesdb_tpu_torch.velesql.planner import QueryPlanner

__all__ = ["Collection", "SearchResult", "CollectionType"]

# ANN engines are auto-built by the planner only past this many rows; an
# index built or pinned before keeps serving at any size.
ANN_MIN_ROWS = 2_000_000
_ANN_METRICS = (DistanceMetric.COSINE, DistanceMetric.EUCLIDEAN, DistanceMetric.DOT_PRODUCT)
_ANN_MODES = (StorageMode.FULL, StorageMode.F16, StorageMode.BF16)


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
        self._index_kind = "auto"  # auto | exact | graph | ivf
        self.ann: GraphIndex | None = None  # the graph engine, built on demand
        if self.metric in _ANN_METRICS and self.storage_mode in _ANN_MODES:
            self.ann = GraphIndex(self.dim, self.metric, device=self.device)
        self.ivf: IvfIndex | None = None  # built on demand (pinned or planner-selected)
        self.ann_min_rows = ANN_MIN_ROWS
        self.reindex_events: list[dict] = []  # graph rebuilds with wider params
        self._planner: QueryPlanner | None = None
        # incremental ANN maintenance, per engine: slots mutated since the
        # build are excluded from the index and searched exactly from a
        # compact device snapshot; a rebuild only triggers past
        # ``delta_rebuild_fraction``
        self._stale: dict[str, set[int]] = {"graph": set(), "ivf": set()}
        self._mut_counter = 0
        self.delta_rebuild_fraction = 0.10
        # engine -> (mutation counter, vecs, slots, alive)
        self._delta_cache: dict[str, tuple] = {}
        # (engine, batch bucket, k_fetch, ef) classes already timed: the first
        # call of a class is a warm-up and stays out of the latency EMA
        self._timed_sigs: set[tuple] = set()
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
        # text indexes build lazily from the payload log: BM25 at the first
        # text or hybrid query, the trigram index at the first like_mask
        self.text_index: Bm25Index | None = None
        self.trigram_index: TrigramIndex | None = None
        self._text_built = False
        self._result_cache: SearchResultCache | None = None  # when enabled
        # TTL rows, durable in ttl.json; writes are batched behind a dirty
        # flag and flushed once per bulk op / flush() / close()
        self._ttl: dict[int, float] = self._load_ttl()  # vid -> unix expiry
        self._ttl_dirty = False
        self._last_ttl_flush = 0.0
        self._auto_vacuum: dict | None = None
        self._last_auto_vacuum = 0.0
        # the knowledge graph, built at the first graph call (ensure_graph)
        self.graph = None

    @property
    def index_kind(self) -> str:
        return self._index_kind

    @index_kind.setter
    def index_kind(self, kind: str) -> None:
        if kind not in ("auto", "exact", "ivf", "graph"):
            raise ValueError(f"unknown index_kind {kind!r}: auto, exact, ivf or graph")
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
            if self._text_built:
                self._index_text(slot, payload)
            if self.graph is not None:
                self.graph.index_node(int(vid), payload)
            if ttl is not None:
                self._ttl[int(vid)] = time.time() + ttl
                self._ttl_dirty = True
            elif self._ttl.pop(int(vid), None) is not None:
                self._ttl_dirty = True
            self._flush_ttl(debounce=True)
            self._on_mutation([int(vid)], slots=[slot])

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
            if self._text_built:
                for i, slot in enumerate(slots):
                    self._index_text(slot, payloads[i] if payloads is not None else None)
            if self.graph is not None:
                for i, vid in enumerate(ids):
                    self.graph.index_node(vid, payloads[i] if payloads is not None else None)
            if ttl is not None:
                expiry = time.time() + ttl
                for vid in ids:
                    self._ttl[vid] = expiry
                self._ttl_dirty = True
            elif any(self._ttl.pop(vid, None) is not None for vid in ids):
                # a re-upsert without ttl clears any stale deadline
                self._ttl_dirty = True
            self._flush_ttl()  # one write per bulk call
            self._on_mutation(ids, slots=slots)

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
                if self._text_built and slot is not None:
                    self.text_index.remove_document(slot)
                    if self.trigram_index is not None:
                        self.trigram_index.remove_document(slot)
                if self.graph is not None:
                    self.graph.remove_node(int(vid))
                self._on_mutation([int(vid)], slots=[slot])
            return existed

    def count(self) -> int:
        return len(self.vectors)

    def __len__(self) -> int:
        return self.count()

    def _on_mutation(self, ids: list[int], slots=None) -> None:
        self._device_dirty = True
        self._mut_counter += 1
        self.columns.invalidate(ids)
        if self.text_index is not None:
            self.text_index.invalidate(ids)
        if self._result_cache is not None:
            self._result_cache.invalidate()
        # live ANN indexes absorb mutations through their deltas; before the
        # first build (or once dirty) the coming full build covers every row
        track = {"graph": self.ann is not None and not self.ann.dirty and self.ann.n_pad > 0,
                 "ivf": self.ivf is not None and not self.ivf.dirty}
        if any(track.values()):
            if slots is None:
                slots = [self.vectors.id_to_slot.get(int(v)) for v in ids]
            live = [int(s) for s in slots if s is not None]
            budget = max(1024, int(self.delta_rebuild_fraction * max(self.count(), 1)))
            for engine, index in (("graph", self.ann), ("ivf", self.ivf)):
                if track[engine]:
                    self._stale[engine].update(live)
                    if len(self._stale[engine]) > budget:
                        index.invalidate(ids)

    def _delta_snapshot(self, engine: str):
        """Compact device snapshot ``(counter, vecs, slots, alive)`` of the
        engine's stale rows (current vectors + liveness), cached per mutation
        counter; None while the delta is empty."""
        stale = self._stale[engine]
        if not stale:
            return None
        cached = self._delta_cache.get(engine)
        if cached is not None and cached[0] == self._mut_counter:
            return cached
        slots = np.fromiter(stale, np.int64, len(stale))
        free = set(self.vectors._free_slots)
        alive = np.fromiter((s not in free for s in slots), bool, len(slots))
        n_pad = 1 << max(8, int(len(slots) - 1).bit_length())
        vecs = np.pad(np.asarray(self.vectors.slot_view()[slots], np.float32),
                      ((0, n_pad - len(slots)), (0, 0)))
        self._delta_cache[engine] = (
            self._mut_counter,
            torch.from_numpy(vecs).to(self.device),
            np.pad(slots, (0, n_pad - len(slots)), constant_values=-1),
            np.pad(alive, (0, n_pad - len(slots))),
        )
        return self._delta_cache[engine]

    def _ann_delta_search(self, engine: str, q: np.ndarray, k_fetch: int, ef: int | None,
                          mask, ivf_nprobe: int | None = None):
        """ANN search with incremental-delta semantics: stale slots are
        excluded from the (possibly stale) index and searched exactly from the
        compact delta snapshot; the two top-k lists merge with a stable sort
        (index hits first among equal scores, as the reference's host merge).

        Both engines take the stale slots as ``exclude``: an unfiltered
        search keeps its probe kernel (#10: the graph's entry scan, IVF's
        scan on a small batch), the slots dead in a copy of its state; a
        filtered one folds them into the mask. The reference masks them
        always, which moves both to their plain probing paths."""
        used = max(self.vectors.used_slots, 1)
        delta = self._delta_snapshot(engine)
        base_mask = None if mask is None else np.asarray(mask)[:used]
        stale = None
        if delta is not None:
            dslots = delta[2]
            stale = dslots[(dslots >= 0) & (dslots < used)]
        if engine == "graph":
            vals, idx = self.ann.search(
                q, k_fetch, ef=ef, exclude=stale,
                mask=None if base_mask is None else pad_mask(base_mask, self.ann.n_pad, "cpu"))
        else:
            vals, idx = self.ivf.search(q, k_fetch, ef=ef, mask=base_mask, nprobe=ivf_nprobe,
                                        exclude=stale)
        if delta is None:
            return vals, idx
        _, dvecs, dslots, dalive = delta
        dval = dalive
        if base_mask is not None:
            in_range = (dslots >= 0) & (dslots < used)
            dval = dval & np.where(in_range, base_mask[np.maximum(dslots, 0)], False)
        dv, di = streamed_topk(q, dvecs, valid=torch.from_numpy(dval).to(self.device),
                               k=min(k_fetch, dvecs.shape[0]), metric=self.metric)
        dsl = torch.from_numpy(dslots).to(self.device)
        di = torch.where(di >= 0, dsl[di.clamp_min(0)], -1)
        allv, alli = torch.cat([vals, dv], dim=1), torch.cat([idx, di], dim=1)
        order = torch.sort(allv, dim=1, descending=self.metric.higher_is_better,
                           stable=True).indices[:, :k_fetch]
        return torch.gather(allv, 1, order), torch.gather(alli, 1, order)

    # -- device state ------------------------------------------------------

    def refresh_device(self) -> None:
        """Upload the current host slot array as padded device state (after
        the auto-vacuum, when one is configured and due). A clean state is
        read without the lock (the flag clears only after a whole rebuild), so
        a search does not wait behind another thread's lazy build."""
        self._maybe_auto_vacuum()
        if not self._device_dirty:
            return
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

    # -- IVF engine and planner ----------------------------------------------

    @property
    def planner(self) -> QueryPlanner:
        if self._planner is None:
            self._planner = QueryPlanner()
        return self._planner

    def _choose_engine(self, batch: int, quality=None, ef: int | None = None) -> str:
        """Cost-based engine pick: a pinned ``index_kind`` wins; otherwise the
        planner compares exact streaming, IVF probing and the graph's beam
        search at this batch size. An ANN engine is a candidate when its index
        is already built or the corpus is past ``ann_min_rows``; measured
        latency EMAs override the static model as they accrue, and a
        calibrated recall below the quality profile's bar disqualifies it."""
        if self.index_kind in ("graph", "ivf"):
            return self.index_kind
        big = self.count() >= self.ann_min_rows
        have_ivf = big or (self.ivf is not None and not self.ivf.dirty)
        have_graph = self.ann is not None and (
            big or (self.ann.n_pad > 0 and not self.ann.dirty))
        if not (have_ivf or have_graph):
            return "exact"
        built = self.ivf is not None and self.ivf.part_len
        gp = self.ann.params if self.ann is not None else None
        _, expansions = gp.beam_for_ef(128, 10) if gp is not None else (128, 64)
        choice = self.planner.choose(
            max(self.vectors.used_slots, 1), self.dim, batch,
            have_ivf=have_ivf,
            # the true serving nprobe (coverage-calibrated, spill-scaled)
            ivf_nprobe=self.ivf.nprobe_for(ef) if built else 32,
            ivf_part_len=self.ivf.part_len if built else 512,
            have_graph=have_graph,
            graph_expansions=expansions,
            graph_degree=gp.degree if gp is not None else 48,
            min_recall=SearchQuality.parse(quality or SearchQuality.BALANCED).min_recall,
            ef=ef,
        )
        return choice.engine

    def _ensure_ann(self, force: bool = False, profile: dict | None = None) -> bool:
        """Build (or restore from ``ann.npz``) the graph index, then calibrate
        it. Below ``ann_min_rows`` a dirty index is built only when ``force``
        (``index_kind = "graph"``). A restored graph whose degree is under
        ``GraphParams.auto``'s for the row count is rebuilt with the auto
        parameters, and the rebuild is recorded in :attr:`reindex_events`.
        The entry-scan knobs and the expansion width are raised to the auto
        sizing first (the reference raises the entry knobs only, so a graph
        it reopens at 1M rows expands 4 candidates a step where its build
        expanded 16). ``profile`` collects the seconds of each stage (build
        stages, ``ann.load`` or ``ann.save``, ``ann.calibrate``)."""
        if self.ann is None:
            return False
        if not force and self.ann.dirty and self.count() < self.ann_min_rows:
            return False
        if self.ann.dirty:
            # one build; a concurrent search waits for it
            with self._lock:
                if self.ann.dirty:
                    self.refresh_device()
                    used = self.vectors.used_slots
                    slots = np.array(self.vectors.slot_view()[:used])
                    _, valid = self.vectors.occupancy()
                    path = os.path.join(self.path, "ann.npz")
                    version = self.vectors.version
                    want = GraphParams.auto(self.dim, used)
                    cur = self.ann.params
                    self.ann.params = dataclasses.replace(
                        cur, entry_probes=max(cur.entry_probes, want.entry_probes),
                        entry_points=max(cur.entry_points, want.entry_points),
                        expand_width=max(cur.expand_width, want.expand_width))
                    t = time.perf_counter()
                    if (self.ann.load(path, slots, valid, version=version)
                            and self.ann.params.degree >= want.degree):
                        t = _mark(profile, "ann.load", t, self.device)
                    else:
                        old = self.ann.params
                        self.ann.params = want
                        # the resident device rows (cosine rows pre-normalized, which
                        # cosine scores do not see)
                        self.ann.build(slots, valid, corpus_dev=self._brute._full, profile=profile)
                        t = time.perf_counter()
                        self.ann.save(path, version=version)
                        t = _mark(profile, "ann.save", t, self.device)
                        self.reindex_events.append({"at": time.time(), "rows": used,
                                                    "from_degree": old.degree,
                                                    "to_degree": want.degree})
                    # a fresh build or restore covers every row: the delta drains
                    self._stale["graph"].clear()
                    self._delta_cache.pop("graph", None)
                    self._calibrate_engine("graph")
                    _mark(profile, "ann.calibrate", t, self.device)
        return True

    def _ensure_ivf(self, profile: dict | None = None) -> bool:
        """Build (or restore from ``ivf.npz``) the IVF index, then calibrate
        it. spill=2 (each row in its two nearest partitions) whenever the
        doubled f32 partition memory stays under 8 GiB. ``profile``, when
        given, collects the seconds of each stage (build stages, ``ivf.load``
        or ``ivf.save``, ``ivf.calibrate``)."""
        if self.metric not in _ANN_METRICS:
            return False
        with self._lock:  # one build; a concurrent search waits for it
            if self.ivf is None:
                used = max(self.vectors.used_slots, 1)
                spill = 2 if used * self.dim * 4 * 2 < 8 << 30 else 1
                self.ivf = IvfIndex(self.dim, self.metric, spill=spill, device=self.device)
            if self.ivf.dirty:
                self.refresh_device()
                used = self.vectors.used_slots
                _, valid = self.vectors.occupancy()
                path = os.path.join(self.path, "ivf.npz")
                version = self.vectors.version
                brute = self._brute
                if self.storage_mode in _ANN_MODES:
                    src = brute._full[:used]  # the resident device rows
                elif self.storage_mode is StorageMode.SQ8:
                    # quantized-storage IVF: partitions stay one byte a dim
                    src = SQ8Vectors(*(a[:used] for a in brute._sq8))
                else:
                    src = np.asarray(self.vectors.slot_view()[:used], np.float32)
                t = time.perf_counter()
                if self.ivf.load(path, src, valid, version=version):
                    t = self.ivf._mark(profile, "ivf.load", t)
                else:
                    self.ivf.build(src, valid, profile=profile)
                    t = time.perf_counter()
                    self.ivf.save(path, version=version)
                    t = self.ivf._mark(profile, "ivf.save", t)
                # a fresh build or restore covers every row: the delta drains
                self._stale["ivf"].clear()
                self._delta_cache.pop("ivf", None)
                self._calibrate_engine("ivf")
                self.ivf._mark(profile, "ivf.calibrate", t)
        return True

    def _calibrate_engine(self, engine: str, sample: int = 128) -> None:
        """Measured recall probe after an index build (``engine`` "ivf" or
        "graph"), recorded with the planner per ef (16 to 256). Probe queries
        are sampled stored rows perturbed by their nearest-neighbour
        distance; a hit is a returned
        row scoring within 0.1% of the host f32 k-th best (eps-recall), or,
        past 4 GiB of rows, an id of the exact engine's top-k.

        The reference scores every probe query against every row in numpy
        (``_host_scores``); this copy takes each query's 4k best rows from one
        matrix product over precomputed norms and rescores those with
        ``_host_scores``, so the k-th best is the same. A failing probe
        raises; the reference keeps the error and serves uncalibrated."""
        used = self.vectors.used_slots
        if used < 32:
            return
        self.refresh_device()
        take = min(sample, used)
        k = 10
        slots = np.linspace(0, used - 1, take).astype(np.int64)
        view = self.vectors.slot_view()
        base = np.array(view[slots])
        _, nn = self._brute.search(base, 2)
        nn = nn.cpu().numpy()
        other = np.where(nn[:, 1] >= 0, nn[:, 1], np.maximum(nn[:, 0], 0))
        d1 = np.linalg.norm(base - np.asarray(view[other]), axis=1, keepdims=True)
        noise = np.random.default_rng(0).standard_normal(base.shape).astype(np.float32)
        noise /= np.maximum(np.linalg.norm(noise, axis=1, keepdims=True), 1e-9)
        q = base + noise * d1
        hib = self.metric.higher_is_better
        host_basis = used * self.dim * 4 <= 4 << 30
        if host_basis:
            corpus = np.asarray(view[:used], np.float32)
            _, live = self.vectors.occupancy()
            kth = np.empty(take, np.float32)
            for i, cand in enumerate(_host_topk(corpus, live[:used], q, 4 * k, self.metric)):
                s = np.sort(_host_scores(q[i], corpus[cand], self.metric))
                kth[i] = s[::-1][k - 1] if hib else s[k - 1]
        else:
            ei = self._brute.search(q, k)[1].cpu().numpy()
        index = self.ivf if engine == "ivf" else self.ann
        for ef_probe in (16, 32, 64, 128, 256):
            ai = index.search(q, k, ef=ef_probe)[1].cpu().numpy()
            hits = 0
            for i in range(take):
                ids = ai[i][ai[i] >= 0]
                if host_basis and len(ids):
                    s = _host_scores(q[i], corpus[ids], self.metric)
                    hits += int(np.sum(s >= kth[i] - 1e-3 * abs(kth[i]) - 1e-9) if hib
                                else np.sum(s <= kth[i] * 1.001 + 1e-9))
                elif not host_basis:
                    hits += len(set(ids) & set(ei[i][ei[i] >= 0]))
            self.planner.record_recall(engine, min(hits / float(take * k), 1.0), ef=ef_probe)

    # -- search ------------------------------------------------------------

    def search(self, query, k: int = 10, filter: dict | None = None,
               ef: int | None = None, quality=None):
        """Single-query search; returns hydrated results best-first. With the
        result cache on, a repeated (query, k, filter, ef, quality) is served
        from it until the next mutation."""
        if self._result_cache is None:
            return self.search_batch([query], k, filter=filter, ef=ef, quality=quality)[0]
        key = self._result_cache.key(np.asarray(query, np.float32), k, filter, ef, quality)
        hit = self._result_cache.get(key)
        if hit is not None:
            return hit
        res = self.search_batch([query], k, filter=filter, ef=ef, quality=quality)[0]
        self._result_cache.put(key, res)
        return res

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
        Runs again only after the row count drifts by 10%, under the
        collection's lock: a concurrent search waits for the oversample the
        gate settles on instead of serving at the one it is widening."""
        used = self.vectors.used_slots
        if used < 4096:  # toy collections: the probe costs more than it informs
            return
        prev = self._storage_gate_used
        if prev is not None and abs(used - prev) < 0.1 * prev:
            return
        with self._lock:
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
        distance. Cached per row count, recorded with the planner under
        ``"storage"`` and reported by :meth:`info`; ``None`` for FULL storage.

        The reference ranks with ``argsort`` of per-row f32 scores; this copy
        ranks with ``argpartition`` on euclidean ``|c|^2 - 2 q.c`` and cosine
        dots over precomputed norms (the same order up to ties), hamming and
        jaccard as the reference does (:func:`_host_topk`), and keeps
        the probe set and its oracle ids for the row count and store version,
        so the gate's later rounds rerun only the serve path."""
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
        self.planner.record_recall("storage", r)
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
        nn2 = _host_topk(corpus, live, base, 2, self.metric)
        d1 = np.linalg.norm(base - corpus[nn2[:, 1]], axis=1, keepdims=True)
        q = base + noise * d1
        return q, slot_ids[_host_topk(corpus, live, q, k, self.metric)]

    def search_batch(self, queries, k: int = 10, filter: dict | None = None,
                     ef: int | None = None, quality=None, _raw: bool = False):
        """Batched search: one device pass for the whole batch, on the engine
        :meth:`_choose_engine` picks (exact, IVF or graph).

        ``quality`` maps to ef through the profiles (fast 64, balanced 128,
        accurate 256, perfect exact); an explicit ``ef`` wins. Quantized
        collections route through the host f32 rerank (:attr:`auto_rerank`,
        behind the storage recall gate), and ``quality="perfect"`` reranks on
        any storage; ``_raw=True`` is the coarse-pass escape hatch. After its
        warm-up call, each (engine, batch bucket, k_fetch, ef) class feeds the
        planner's latency EMA."""
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
        # the kernels take row-major queries whatever the caller's layout (the
        # micro-batcher's padded batch comes out column-major from numpy)
        q = np.ascontiguousarray(np.atleast_2d(np.asarray(queries, dtype=np.float32)))
        if q.shape[1] != self.dim:
            raise ValueError(
                f"dimension mismatch: expected {self.dim}, got {q.shape[1]}"
            )
        mask = self._filter_mask(filter)
        plan = self._plan_search(q, k, mask, ef, quality)
        t0 = time.perf_counter()
        vals, idx = self._run_search(q, k, mask, plan)
        out = self._hydrate(vals.cpu().numpy(), idx.cpu().numpy(), k)
        engine, k_fetch, ef, _ = plan
        sig = (engine, self.planner._bucket(q.shape[0]), k_fetch, ef)
        if sig in self._timed_sigs:
            self.planner.record_latency(engine, q.shape[0], time.perf_counter() - t0)
        else:
            self._timed_sigs.add(sig)  # warm-up call: untimed
        return out

    def search_batch_with_filters(self, queries, k: int = 10, filters=None,
                                  ef: int | None = None, quality=None):
        """Batched search with a filter per query: queries that share a
        filter run as one device batch, each distinct filter as its own."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if filters is None:
            return self.search_batch(q, k, ef=ef, quality=quality)
        if len(filters) != q.shape[0]:
            raise ValueError("filters/queries length mismatch")
        groups: dict[str, list[int]] = {}
        for i, f in enumerate(filters):
            groups.setdefault(json.dumps(f, sort_keys=True, default=str), []).append(i)
        out: list = [None] * q.shape[0]
        for idxs in groups.values():
            res = self.search_batch(q[idxs], k, filter=filters[idxs[0]], ef=ef, quality=quality)
            for i, row in zip(idxs, res):
                out[i] = row
        return out

    def multi_query_search(self, queries, k: int = 10, strategy="rrf", weights=None,
                           filter: dict | None = None, ef: int | None = None):
        """Fuse several query vectors into one result list: ``2k`` hits a
        query from one batched search, then ``FusionStrategy.fuse``."""
        strategy = FusionStrategy.parse(strategy)
        per_query = self.search_batch(queries, max(2 * k, k), filter=filter, ef=ef)
        fused = strategy.fuse([[(r.id, r.score) for r in row] for row in per_query], k,
                              weights=weights)
        return [SearchResult(id=vid, score=score, payload=self.payloads.retrieve(vid))
                for vid, score in fused]

    def _search_device(self, q, k, mask, ef=None, quality=None):
        """Device ``(vals, slot ids)`` of the engine a search would take."""
        return self._run_search(q, k, mask, self._plan_search(q, k, mask, ef, quality))

    def _run_search(self, q, k, mask, plan):
        engine, k_fetch, ef, ivf_nprobe = plan
        if engine in ("ivf", "graph"):
            return self._ann_delta_search(engine, q, k_fetch, ef, mask, ivf_nprobe=ivf_nprobe)
        return self._brute.search(q, k, mask=mask)

    def _plan_search(self, q, k, mask, ef=None, quality=None):
        """``(engine, k_fetch, ef, ivf_nprobe)`` of a search, with any index
        build done first (a first-call build stays out of the timing).

        The honesty gate demotes an unpinned ANN engine whose calibrated
        recall misses the profile's bar to exact; a smaller calibrated ef
        that clears the bar is served when the ef came from the profile.
        Under a filter (the starvation guards): IVF bumps nprobe so that
        ~nprobe*L*selectivity candidates survive the in-scan mask (quantized
        to a multiple of 8), or falls back to exact once that nears a
        half-corpus scan; the graph bumps ef so that ~ef*selectivity pool
        rows pass (capped at the beam's 512 where its entry IVF seeds the
        beam from masked rows, else falling back to exact past it)."""
        quality = SearchQuality.parse(quality) if quality is not None else None
        ef_from_profile = ef is None
        if ef is None:
            ef = (quality or SearchQuality.BALANCED).ef
        engine = "exact"
        if (quality is not SearchQuality.PERFECT and self.index_kind != "exact"
                and self.metric in _ANN_METRICS):
            engine = self._choose_engine(q.shape[0], quality, ef)
        k_fetch = max(min(4 * k, ef), k) if mask is not None else k
        if engine == "ivf" and not self._ensure_ivf():
            engine = "exact"
        if engine == "graph" and not self._ensure_ann(force=self.index_kind == "graph"):
            engine = "exact"
        bar = (quality or SearchQuality.BALANCED).min_recall
        if engine in ("ivf", "graph") and self.index_kind != engine:
            r = self.planner.engine_recall(engine, ef)
            if r is not None and r < bar:
                engine = "exact"
        if engine in ("ivf", "graph") and ef_from_profile:
            ef2 = self.planner.downshift_ef(engine, ef, bar)
            if ef2 != ef:
                ef = ef2
                k_fetch = max(min(4 * k, ef), k) if mask is not None else k
        ivf_nprobe = None
        if engine == "graph" and mask is not None:
            used = max(self.vectors.used_slots, 1)
            sel = float(np.count_nonzero(np.asarray(mask)[:used])) / used
            need = int(np.ceil(1.5 * k_fetch / max(sel, 1e-9)))
            if self.ann._entry_ivf is not None:
                # the entry IVF seeds the beam from the best masked rows and
                # the accumulator keeps every passing row: bump ef, capped
                if sel <= 0.0:
                    engine = "exact"
                elif need > ef:
                    ef = min(((need + 7) // 8) * 8, 512)
            elif sel <= 0.0 or need > 512:
                engine = "exact"
            elif need > ef:
                ef = ((need + 7) // 8) * 8
        if engine == "ivf" and mask is not None and self.ivf.part_len:
            used = max(self.vectors.used_slots, 1)
            sel = float(np.count_nonzero(np.asarray(mask)[:used])) / used
            L = self.ivf.part_len
            need_np = int(np.ceil(1.5 * k_fetch / (max(sel, 1e-9) * L)))
            if sel <= 0.0:
                engine = "exact"
            elif need_np > self.ivf.nprobe_for(ef):
                need_np = ((need_np + 7) // 8) * 8
                if need_np > (self.ivf.c_real or self.ivf.c) or need_np * L * 2 >= used:
                    engine = "exact"
                else:
                    ivf_nprobe = need_np
        return engine, k_fetch, ef, ivf_nprobe

    # -- filters -----------------------------------------------------------

    def _ensure_columns(self) -> None:
        """Lazily populate the column store from the payload log (cold open),
        under the collection's lock: a concurrent caller waits for the build
        instead of filtering on a half-filled store."""
        if self._columns_built:
            return
        with self._lock:
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
        return pad_mask(mask, self._brute.n_pad or used, "cpu")

    def _raw_filter_mask(self, filt):
        """``[used_slots] bool`` mask for a filter dict (unpadded)."""
        if filt is None:
            return None
        self._ensure_columns()
        # the column store's mask cache is an LRU that concurrent readers
        # would reorder under each other; upserts write the columns under
        # the same lock
        with self._lock:
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

    # -- result cache ----------------------------------------------------------

    def enable_result_cache(self, capacity: int = 512) -> None:
        """Cache :meth:`search` results (LRU, cleared by every mutation)."""
        self._result_cache = SearchResultCache(capacity)

    def cache_stats(self) -> dict | None:
        return self._result_cache.stats() if self._result_cache else None

    # -- maintenance ---------------------------------------------------------

    def expire_rows(self, now: float | None = None) -> int:
        """Delete the rows whose TTL has passed; returns how many."""
        now = time.time() if now is None else now
        dead = [vid for vid, exp in self._ttl.items() if exp <= now]
        for vid in dead:
            self._ttl.pop(vid, None)
            self.delete(vid)
        if dead:
            self._ttl_dirty = True
        self._flush_ttl()
        return len(dead)

    def configure_auto_vacuum(self, interval_s: float = 60.0,
                              fragmentation_threshold: float = 0.3,
                              enabled: bool = True) -> None:
        """Auto-vacuum policy: at a device refresh, at most every
        ``interval_s``, expire TTL rows and compact once the free-slot share
        passes ``fragmentation_threshold``."""
        self._auto_vacuum = (
            {"interval_s": interval_s, "threshold": fragmentation_threshold}
            if enabled else None
        )

    def _maybe_auto_vacuum(self) -> None:
        if self._auto_vacuum is None:
            return
        now = time.time()
        if now - self._last_auto_vacuum < self._auto_vacuum["interval_s"]:
            return
        self._last_auto_vacuum = now
        self.expire_rows(now)
        if self.vectors.fragmentation_ratio > self._auto_vacuum["threshold"]:
            self.vacuum()

    def vacuum(self) -> dict:
        """Compact tombstoned slots. Slot numbers change, so every slot-keyed
        structure restarts: the columns, the text and trigram indexes, the
        ANN deltas, and the IVF and graph indexes (rebuilt at their next
        use)."""
        with self._lock:
            reclaimed = self.vectors.vacuum()
            if reclaimed:
                self.columns = ColumnStore()
                self.columns.set_id_source(self.vectors.occupancy)
                self._columns_built = False
                self.text_index = None
                self.trigram_index = None
                self._text_built = False
                for stale in self._stale.values():
                    stale.clear()
                self._delta_cache.clear()
                if self.ann is not None:
                    self.ann.invalidate()
                if self.ivf is not None:
                    self.ivf.invalidate()
                self._on_mutation([])
            return {"reclaimed_slots": reclaimed,
                    "fragmentation": self.vectors.fragmentation_ratio}

    # -- text and hybrid search ------------------------------------------------

    def _index_text(self, slot: int, payload) -> None:
        text = extract_text(payload) if payload is not None else ""
        if text:
            self.text_index.add_document(slot, text)
            if self.trigram_index is not None:
                self.trigram_index.add_document(slot, text)
        else:
            self.text_index.remove_document(slot)
            if self.trigram_index is not None:
                self.trigram_index.remove_document(slot)

    def _ensure_text(self) -> None:
        """Build the BM25 index from the payload log at the first text query;
        mutations keep it in step from then on. The build runs under the
        collection's lock and is published when whole, so a concurrent first
        query waits for it instead of scoring a half-built index."""
        if self._text_built:
            return
        with self._lock:
            if self._text_built:
                return
            self.text_index = Bm25Index(self.device)
            for vid, payload in self.payloads.payloads.items():
                slot = self.vectors.id_to_slot.get(vid)
                if slot is not None:
                    self._index_text(slot, payload)
            self._text_built = True

    def _ensure_trigram(self) -> None:
        """Build the trigram index at the first :meth:`like_mask` (the
        reference builds it beside BM25; at 1M rows it costs more than the
        BM25 build, and only LIKE reads it)."""
        self._ensure_text()
        if self.trigram_index is not None:
            return
        with self._lock:
            if self.trigram_index is not None:
                return
            trigram = TrigramIndex()
            for vid, payload in self.payloads.payloads.items():
                slot = self.vectors.id_to_slot.get(vid)
                text = extract_text(payload) if payload is not None else ""
                if slot is not None and text:
                    trigram.add_document(slot, text)
            self.trigram_index = trigram

    def text_search(self, query: str, k: int = 10, filter: dict | None = None):
        """BM25 full-text search."""
        return self.text_search_batch([query], k, filter=filter)[0]

    def text_search_batch(self, queries, k: int = 10, filter: dict | None = None):
        """Batched BM25 search, the filter pushed down as a slot mask."""
        self._ensure_text()
        used = max(self.vectors.used_slots, 1)
        mask = self._raw_filter_mask(filter)
        vals, slots = self.text_index.search_batch(list(queries), k, used, mask=mask)
        slot_ids, _ = self.vectors.occupancy()
        out = []
        for b in range(vals.shape[0]):
            row = []
            for v, s in zip(vals[b], slots[b]):
                if s < 0 or v <= 0 or s >= slot_ids.shape[0]:
                    continue
                vid = int(slot_ids[s])
                if vid < 0:
                    continue
                row.append(SearchResult(id=vid, score=float(v),
                                        payload=self.payloads.retrieve(vid)))
            out.append(row)
        return out

    def hybrid_search(self, query_vector, query_text: str, k: int = 10,
                      vector_weight: float = 0.5, filter: dict | None = None):
        """Vector + BM25 fusion by weighted RRF (k = 60), ``2k`` fetched from
        each branch."""
        return self.hybrid_search_batch([query_vector], [query_text], k,
                                        vector_weight=vector_weight, filter=filter)[0]

    def hybrid_search_batch(self, query_vectors, query_texts, k: int = 10,
                            vector_weight: float = 0.5, filter: dict | None = None):
        """Batched hybrid search. Both branches and the fusion stay on the
        device and the batch reads back once; quantized collections with
        :attr:`auto_rerank` fuse on the host instead (their vector branch is
        the host f32 rerank)."""
        if not self._hybrid_fused_ok:
            return self._hybrid_host_fused(query_vectors, query_texts, k, vector_weight,
                                           filter)
        return self._hybrid_fused_batch(query_vectors, query_texts, k, w_vec=vector_weight,
                                        w_txt=1.0 - vector_weight, filter=filter)

    @property
    def _hybrid_fused_ok(self) -> bool:
        return not (self.auto_rerank
                    and self.storage_mode in (StorageMode.SQ8, StorageMode.BINARY))

    def _hybrid_fused_batch(self, query_vectors, query_texts, k, *, w_vec, w_txt, filter,
                            ef=None, quality=None, rrf_k=None, fetch=None):
        """The device-fused hybrid (:meth:`_hybrid_device`), read back once
        and hydrated. ``rrf_k=None`` is the reference's 60."""
        if fetch is None:
            fetch = max(2 * k, k)
        self.refresh_device()
        self._ensure_text()
        q = np.ascontiguousarray(np.atleast_2d(np.asarray(query_vectors, dtype=np.float32)))
        if q.shape[1] != self.dim:
            raise ValueError(f"dimension mismatch: expected {self.dim}, got {q.shape[1]}")
        vals, slots = self._hybrid_device(q, query_texts, k, max(fetch, k),
                                          self._raw_filter_mask(filter), w_vec=w_vec,
                                          w_txt=w_txt, rrf_k=rrf_k, ef=ef, quality=quality)
        slot_ids, _ = self.vectors.occupancy()
        self._slot_ids = slot_ids
        return self._hydrate(vals.cpu().numpy(), slots.cpu().numpy(), k)

    def _hybrid_device(self, q, query_texts, k, fetch, raw_mask, *, w_vec, w_txt, rrf_k=None,
                       ef=None, quality=None):
        """Device ``(fused [B, k], slots [B, k])`` of a hybrid batch: the
        vector branch from the engine :meth:`_search_device` picks (on the
        exact FULL serve the filter reaches each core as the reference's
        mono program applies it), the BM25 branch from
        :meth:`Bm25Index.search_batch_dev`, both ``fetch`` deep and fused by
        :func:`rrf_fuse_topk`. Nothing is read back. A failure raises."""
        mask = None
        if raw_mask is not None:
            mask = pad_mask(raw_mask, self._brute.n_pad or max(self.vectors.used_slots, 1),
                            "cpu")
        v_vals, v_idx = self._search_device(q, fetch, mask, ef, quality)
        txt = self.text_index.search_batch_dev(list(query_texts), fetch,
                                               max(self.vectors.used_slots, 1), mask=raw_mask)
        if txt is None:  # no query term in the vocabulary: the vector ranks alone
            t_vals = torch.zeros((q.shape[0], fetch), dtype=torch.float32, device=self.device)
            t_idx = torch.full((q.shape[0], fetch), -1, dtype=torch.int64, device=self.device)
        else:
            t_vals, t_idx = txt
        return rrf_fuse_topk(v_vals, v_idx, t_vals, t_idx, np.float32(w_vec),
                             None if w_txt is None else np.float32(w_txt), rrf_k, k=k)

    def _hybrid_host_fused(self, query_vectors, query_texts, k, vector_weight, filter):
        """Two-branch host-fused hybrid, for quantized collections whose
        vector branch is the host rerank pass."""
        fetch = max(2 * k, k)
        vec_rows = self.search_batch(query_vectors, fetch, filter=filter)
        txt_rows = self.text_search_batch(list(query_texts), fetch, filter=filter)
        out = []
        for vec_hits, txt_hits in zip(vec_rows, txt_rows):
            fused = weighted_rrf([(r.id, r.score) for r in vec_hits],
                                 [(r.id, r.score) for r in txt_hits], k,
                                 vector_weight=vector_weight)
            out.append([SearchResult(id=vid, score=score, payload=self.payloads.retrieve(vid))
                        for vid, score in fused])
        return out

    def like_mask(self, pattern: str, case_insensitive: bool = False):
        """``[used_slots] bool`` mask of the slots whose payload text matches
        the LIKE ``pattern`` (trigram-pruned, then verified)."""
        self._ensure_trigram()
        used = max(self.vectors.used_slots, 1)
        return self.trigram_index.match_mask(pattern, used, case_insensitive=case_insensitive)

    # -- knowledge graph ---------------------------------------------------------

    def ensure_graph(self):
        """The knowledge graph, built at the first call: node indexes from the
        payloads of the live rows, edges from ``edges.npz``. Built under the
        collection's lock, so concurrent first calls share one graph."""
        if self.graph is None:
            with self._lock:
                if self.graph is None:
                    g = kg.CollectionGraph()
                    g.load_edges(self.path)
                    for vid, payload in self.payloads.payloads.items():
                        if vid in self.vectors.id_to_slot:
                            g.index_node(vid, payload)
                    self.graph = g
        return self.graph

    def add_node(self, node_id: int, labels=(), properties: dict | None = None,
                 vector=None) -> None:
        """Insert a graph node: payload = properties + reserved ``_labels``;
        the vector defaults to zeros (graph-only nodes still hold a slot)."""
        payload = dict(properties or {})
        payload[kg.LABELS_KEY] = list(labels)
        vec = np.zeros(self.dim, np.float32) if vector is None else np.asarray(vector, np.float32)
        self.upsert(node_id, vec, payload)

    def add_edge(self, src: int, dst: int, label: str, properties: dict | None = None) -> int:
        g = self.ensure_graph()
        for node in (src, dst):
            if int(node) not in self.vectors.id_to_slot:
                raise KeyError(f"node {node} not found")
        return g.edges.add_edge(src, dst, label, properties)

    def get_edges(self, node: int, direction: str = "out", label: str | None = None):
        return self.ensure_graph().edges.edges_of(node, direction, label)

    def neighbors(self, node: int, direction: str = "out", label: str | None = None):
        return self.ensure_graph().edges.neighbors(node, direction, label)

    def degree(self, node: int, direction: str = "out") -> int:
        return self.ensure_graph().edges.degree(node, direction)

    def traverse(self, start: int, max_depth: int = 3, direction: str = "out",
                 label: str | None = None):
        """BFS from ``start``: ``[(node, depth, path_edge_ids)]`` in BFS order,
        within the traversal guardrails."""
        return kg.traverse(self.ensure_graph().edges, start, direction=direction, label=label,
                         max_depth=max_depth)

    def execute_match(self, match_text: str, params: dict | None = None):
        """Cypher-ish MATCH over this collection."""
        return kg.execute_match(self, match_text, params)

    # -- durability --------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            self.vectors.flush()
            self.payloads.flush()
            self._flush_ttl()
            if self.graph is not None:
                self.graph.save(self.path)

    def close(self) -> None:
        with self._lock:
            self._flush_ttl()
            if self.graph is not None:
                self.graph.save(self.path)
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


def _host_topk(corpus: np.ndarray, live: np.ndarray, q: np.ndarray, kk: int,
               metric: DistanceMetric) -> np.ndarray:
    """Each query's ``kk`` best live rows, best first, ``[B, kk]`` slots.

    Float metrics: one f32 matrix product per block of 131,072 rows, ranked
    by ``|c|^2 - 2 q.c`` (euclidean), ``q.c / |c|`` (cosine) or ``q.c`` (the
    same order as the exact scores, up to ties and rounding). Set metrics:
    the exact scores of every row (:func:`host_set_scores`, equal to the
    reference's), dead rows at the worst score, and the reference oracle's
    own ranking, ``np.argsort`` of each full row (``collection.py:701-708``):
    integer distances tie often, and the gate's recall counts ids, so the
    ties must fall as the reference's do."""
    kk = min(kk, len(corpus))
    if metric in SET_METRICS:
        hib = metric.higher_is_better
        cb = host_bits(corpus)
        nb = cb.sum(axis=1, dtype=np.float32)
        out = np.empty((len(q), kk), np.int64)
        for r0 in range(0, len(q), 16):
            s = host_bit_scores(host_bits(q[r0 : r0 + 16]), cb, nb, metric)
            s = np.where(live[None, :], s, -np.inf if hib else np.inf)
            for i, row in enumerate(s):
                out[r0 + i] = np.argsort(-row if hib else row)[:kk]
        return out
    best_s = np.zeros((len(q), 0), np.float32)
    best_i = np.zeros((len(q), 0), np.int64)
    for c0 in range(0, len(corpus), 1 << 17):
        blk = corpus[c0 : c0 + (1 << 17)]
        dots = q @ blk.T
        norms = np.einsum("nd,nd->n", blk, blk)
        if metric is DistanceMetric.EUCLIDEAN:
            s = norms[None, :] - 2.0 * dots
        elif metric is DistanceMetric.COSINE:
            rn = np.sqrt(norms)
            s = -np.where(rn > 1e-30, dots / np.maximum(rn, 1e-30), 0.0)
        else:
            s = -dots
        s = np.where(live[None, c0 : c0 + len(blk)], s, np.inf).astype(np.float32)
        best_s = np.concatenate([best_s, s], axis=1)
        best_i = np.concatenate([best_i, np.broadcast_to(np.arange(c0, c0 + len(blk)), s.shape)],
                                axis=1)
        keep = np.argpartition(best_s, kk - 1, axis=1)[:, :kk]
        best_s = np.take_along_axis(best_s, keep, axis=1)
        best_i = np.take_along_axis(best_i, keep, axis=1)
    order = np.argsort(best_s, axis=1, kind="stable")
    return np.take_along_axis(best_i, order, axis=1)


def _host_scores(q: np.ndarray, vecs: np.ndarray, metric: DistanceMetric):
    """Exact f32 scores of one query against a few candidate rows, in numpy
    (reference ``collection.py:1775-1793``): hamming and jaccard by
    :func:`host_set_scores`, whose f32 values equal the reference's."""
    if metric in SET_METRICS:
        return host_set_scores(q[None, :], vecs, metric)[0]
    dots = vecs @ q
    if metric is DistanceMetric.DOT_PRODUCT:
        return dots
    if metric is DistanceMetric.COSINE:
        denom = np.linalg.norm(vecs, axis=1) * max(np.linalg.norm(q), 1e-30)
        return np.where(denom > 1e-30, dots / np.maximum(denom, 1e-30), 0.0)
    return np.linalg.norm(vecs - q[None, :], axis=1)
