"""Micro-batching request coalescer for the serving path.

A copy of ``velesdb_tpu/utils/batcher.py``, pointed at the port's
``Collection``. An exact search reads the whole resident corpus once for
the whole batch, and every call pays its launches and its readback once, so
concurrent single-query requests should ride ONE device dispatch. The reference's own engine parallelizes independent searches
across CPU cores (rayon, ``search_batch_parallel``); on an accelerator the
equivalent is coalescing them into one batch. This is the same pattern
serving stacks use for model inference (dynamic batching), applied to
search.

Mechanics: callers block on :meth:`search`; a worker thread drains the
queue, waits up to ``window_ms`` for stragglers (bounded by ``max_batch``),
groups compatible requests (same ef/quality, no filter — filtered or
otherwise non-uniform requests execute individually), runs ONE
``search_batch`` per group, and distributes per-request slices. ``k``
differences batch fine: the group runs at max(k) and trims. The worker
launches on the default stream, as the handler threads do, so a result is
read back behind every kernel it depends on.

Enabled in the REST server via ``VELESDB_BATCH_WINDOW_MS`` (>0 enables).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["MicroBatcher"]


@dataclass
class _Pending:
    vector: Any
    k: int
    ef: int | None
    filter: dict | None
    done: threading.Event = field(default_factory=threading.Event)
    result: list | None = None
    error: Exception | None = None


class MicroBatcher:
    """Per-collection coalescer. Thread-safe; start lazily, stop idempotent."""

    def __init__(self, collection, window_ms: float = 2.0, max_batch: int = 256,
                 metrics=None):
        self.collection = collection
        self.metrics = metrics  # optional OperationalMetrics for gauges
        self.window_s = max(window_ms, 0.0) / 1e3
        self.max_batch = int(max_batch)
        self._q: queue.Queue[_Pending] = queue.Queue()
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.batches = 0  # observability: dispatches issued
        self.coalesced = 0  # requests served through a shared batch

    # -- public -----------------------------------------------------------

    def search(self, vector, k: int = 10, ef: int | None = None,
               filter: dict | None = None, timeout: float = 30.0):
        """Blocking single search; may be served inside a shared batch."""
        self._ensure_worker()
        p = _Pending(vector=vector, k=int(k), ef=ef, filter=filter)
        self._q.put(p)
        if not p.done.wait(timeout):
            raise TimeoutError("batched search timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def stop(self) -> None:
        self._stop.set()
        w = self._worker
        if w is not None:
            self._q.put(None)  # wake
            w.join(timeout=5)
            self._worker = None

    # -- worker -----------------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._stop.clear()
                self._worker = threading.Thread(
                    target=self._run, name="veles-microbatch", daemon=True
                )
                self._worker.start()

    def _drain(self, first: _Pending) -> list[_Pending]:
        items = [first]
        deadline = time.monotonic() + self.window_s
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if first is None:
                continue
            items = self._drain(first)
            # group: (ef, filter is None) — filtered/odd requests go solo
            groups: dict[tuple, list[_Pending]] = {}
            solo: list[_Pending] = []
            for p in items:
                if p.filter is not None:
                    solo.append(p)
                else:
                    groups.setdefault((p.ef,), []).append(p)
            for key, grp in groups.items():
                self._exec_group(grp)
            for p in solo:
                self._exec_group([p])

    def _exec_group(self, grp: list[_Pending]) -> None:
        try:
            kmax = max(p.k for p in grp)
            vecs = np.stack([np.asarray(p.vector, np.float32) for p in grp])
            # pad the coalesced batch to a power-of-two shape class (>=8)
            # with copies of the first query, as the reference does: the
            # padded rows change no result, the planner keeps its latency
            # EMAs and warm-up signatures per batch bucket, and the kernels
            # see a few batch shapes instead of every size up to max_batch
            b = vecs.shape[0]
            b_pad = 1 << max(3, (b - 1).bit_length())
            if b_pad != b:
                vecs = np.concatenate(
                    [vecs, np.broadcast_to(vecs[0], (b_pad - b, vecs.shape[1]))]
                )
            res = self.collection.search_batch(
                vecs, k=kmax, ef=grp[0].ef, filter=grp[0].filter
            )
            self.batches += 1
            if len(grp) > 1:
                self.coalesced += len(grp)
            if self.metrics is not None:
                self.metrics.set_gauge("microbatch_batches", self.batches)
                self.metrics.set_gauge("microbatch_coalesced", self.coalesced)
            for p, row in zip(grp, res):
                p.result = row[: p.k]
                p.done.set()
        except Exception as e:  # deliver the error to every waiter
            for p in grp:
                p.error = e
                p.done.set()
