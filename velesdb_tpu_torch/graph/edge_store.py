"""EdgeStore: typed directed edges with properties and CSR adjacency.

Counterpart of ``velesdb_tpu/graph/edge_store.py`` (the same ``edges.npz``
format, so a directory written by either package opens in the other) and of
the reference's edge family (``GraphEdge``/``EdgeStore``
``collection/graph/edge.rs:36,120``, ``ConcurrentEdgeStore`` 256-way sharded
locks, degree-aware router / C-ART / clustered index ``degree_router.rs``,
``cart.rs``, ``clustered_index.rs``, label interning ``label_table.rs``).

The TPU re-architecture collapses that zoo into one representation: a flat
append-only edge table (``src/dst/label`` int arrays + property list) with
**lazily rebuilt CSR views** per direction. The reference needs per-node
adaptive containers because it chases pointers edge-by-edge under locks; we
expand whole BFS frontiers as vectorized segment gathers over CSR arrays, so
one cache-friendly layout serves every degree profile. Label interning is
kept (``_labels`` table).
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["EdgeStore", "Edge", "CsrView"]


class Edge(dict):
    """``{"id", "src", "dst", "label", "properties"}`` (dict for JSON surfaces)."""

    @property
    def id(self) -> int:
        return self["id"]

    @property
    def src(self) -> int:
        return self["src"]

    @property
    def dst(self) -> int:
        return self["dst"]

    @property
    def label(self) -> str:
        return self["label"]

    @property
    def properties(self) -> dict:
        return self["properties"]


class CsrView:
    """Compressed adjacency for one direction (+ optional label filter).

    ``neighbors_of(frontier)`` is the BFS hot path: a fully vectorized
    segment gather (np.repeat + cumsum arithmetic), the host-side analog of
    the device segment ops the match executor batches over.
    """

    def __init__(self, keys: np.ndarray, offsets: np.ndarray, dst: np.ndarray,
                 labels: np.ndarray, eids: np.ndarray):
        self.keys = keys  # [U] sorted unique source ids
        self.offsets = offsets  # [U+1]
        self.dst = dst  # [E] neighbor ids (sorted by src)
        self.labels = labels  # [E] label ids
        self.eids = eids  # [E] edge ids

    def degree(self, node: int) -> int:
        i = np.searchsorted(self.keys, node)
        if i == len(self.keys) or self.keys[i] != node:
            return 0
        return int(self.offsets[i + 1] - self.offsets[i])

    def neighbors_of(self, frontier: np.ndarray):
        """Expand a frontier: returns ``(edge_src, edge_dst, edge_label,
        edge_ids)`` flat arrays over every out-edge of the frontier."""
        if len(self.keys) == 0 or frontier.size == 0:
            z = np.empty(0, np.int64)
            return z, z, z.astype(np.int32), z
        pos = np.searchsorted(self.keys, frontier)
        pos = np.clip(pos, 0, len(self.keys) - 1)
        found = self.keys[pos] == frontier
        starts = np.where(found, self.offsets[pos], 0)
        ends = np.where(found, self.offsets[pos + 1], 0)
        counts = ends - starts
        total = int(counts.sum())
        if total == 0:
            z = np.empty(0, np.int64)
            return z, z, z.astype(np.int32), z
        # flat indices: for each frontier node f, range(starts[f], ends[f])
        reps = np.repeat(np.arange(len(frontier)), counts)
        base = np.repeat(starts, counts)
        offset_within = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        idx = base + offset_within
        return (
            frontier[reps],
            self.dst[idx],
            self.labels[idx],
            self.eids[idx],
        )


class EdgeStore:
    """Append-oriented typed edge table with lazily rebuilt CSR views."""

    def __init__(self):
        self._lock = threading.RLock()
        self._src: list[int] = []
        self._dst: list[int] = []
        self._label: list[int] = []
        self._props: list[dict | None] = []
        self._alive: list[bool] = []
        self._labels: list[str] = []  # label id -> name (interning)
        self._label_ids: dict[str, int] = {}
        self._n_alive = 0
        self._csr: dict[str, CsrView] = {}  # "out" | "in"
        self._dirty = True
        self._ends: tuple[np.ndarray, np.ndarray] | None = None

    # -- mutation -------------------------------------------------------------

    def intern_label(self, label: str) -> int:
        lid = self._label_ids.get(label)
        if lid is None:
            lid = len(self._labels)
            self._labels.append(label)
            self._label_ids[label] = lid
        return lid

    def add_edge(
        self, src: int, dst: int, label: str, properties: dict | None = None
    ) -> int:
        with self._lock:
            eid = len(self._src)
            self._src.append(int(src))
            self._dst.append(int(dst))
            self._label.append(self.intern_label(label))
            self._props.append(properties)
            self._alive.append(True)
            self._n_alive += 1
            self._dirty = True
            return eid

    def remove_edge(self, eid: int) -> bool:
        with self._lock:
            if 0 <= eid < len(self._alive) and self._alive[eid]:
                self._alive[eid] = False
                self._n_alive -= 1
                self._dirty = True
                return True
            return False

    def _endpoint_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """``(src, dst)`` of every edge id as int64 arrays, rebuilt after
        appends."""
        if self._ends is None or len(self._ends[0]) != len(self._src):
            self._ends = (np.asarray(self._src, np.int64), np.asarray(self._dst, np.int64))
        return self._ends

    def remove_node_edges(self, node: int) -> int:
        """Drop every edge touching ``node`` (collection delete hook). The
        reference walks every edge in Python; here one vectorized compare
        finds the candidate ids, with the same alive set and count after."""
        with self._lock:
            src, dst = self._endpoint_arrays()
            n = 0
            for eid in np.flatnonzero((src == node) | (dst == node)).tolist():
                if self._alive[eid]:
                    self._alive[eid] = False
                    n += 1
            if n:
                self._n_alive -= n
                self._dirty = True
            return n

    def __len__(self) -> int:
        return self._n_alive

    @property
    def labels(self) -> list[str]:
        return list(self._labels)

    def label_id(self, label: str) -> int | None:
        return self._label_ids.get(label)

    # -- views ------------------------------------------------------------------

    def _rebuild(self) -> None:
        alive = np.asarray(self._alive, bool)
        src = np.asarray(self._src, np.int64)[alive]
        dst = np.asarray(self._dst, np.int64)[alive]
        lab = np.asarray(self._label, np.int32)[alive]
        eid = np.flatnonzero(alive).astype(np.int64)
        self._csr = {
            "out": _build_csr(src, dst, lab, eid),
            "in": _build_csr(dst, src, lab, eid),
        }
        self._dirty = False

    def csr(self, direction: str = "out") -> CsrView:
        with self._lock:
            if self._dirty:
                self._rebuild()
            return self._csr[direction]

    # -- queries ------------------------------------------------------------------

    def edge(self, eid: int) -> Edge | None:
        if 0 <= eid < len(self._src) and self._alive[eid]:
            return Edge(
                id=eid,
                src=self._src[eid],
                dst=self._dst[eid],
                label=self._labels[self._label[eid]],
                properties=self._props[eid] or {},
            )
        return None

    def edges_of(
        self, node: int, direction: str = "out", label: str | None = None
    ) -> list[Edge]:
        """Edges incident to ``node`` (``EdgeStore`` adjacency-by-label)."""
        out: list[Edge] = []
        directions = ("out", "in") if direction == "both" else (direction,)
        want = self._label_ids.get(label) if label is not None else None
        if label is not None and want is None:
            return []
        for d in directions:
            view = self.csr(d)
            s, t, lab, eids = view.neighbors_of(np.asarray([node], np.int64))
            for j in range(len(eids)):
                if want is not None and lab[j] != want:
                    continue
                out.append(self.edge(int(eids[j])))
        return out

    def neighbors(
        self, node: int, direction: str = "out", label: str | None = None
    ) -> list[int]:
        return [
            e["dst"] if e["src"] == node else e["src"]
            for e in self.edges_of(node, direction, label)
        ]

    def degree(self, node: int, direction: str = "out") -> int:
        if direction == "both":
            return self.csr("out").degree(node) + self.csr("in").degree(node)
        return self.csr(direction).degree(node)

    # -- persistence ------------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist as pure numeric arrays + JSON-encoded uint8 blobs so
        ``load`` never needs ``allow_pickle`` (no unpickling gadget surface
        from a tampered data directory)."""
        with self._lock:
            alive = np.asarray(self._alive, bool)
            import json

            meta = {
                "labels": [str(x) for x in self._labels],
                "props": [
                    p for p, a in zip(self._props, self._alive) if a
                ],
            }
            blob = np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8
            )
            np.savez_compressed(
                path,
                src=np.asarray(self._src, np.int64)[alive],
                dst=np.asarray(self._dst, np.int64)[alive],
                label=np.asarray(self._label, np.int32)[alive],
                meta_json=blob,
            )

    @classmethod
    def load(cls, path: str) -> "EdgeStore":
        import json

        data = np.load(path, allow_pickle=False)
        if "meta_json" not in data:
            raise ValueError(
                f"{path}: legacy pickle-format edge store; re-save with the "
                "current version (refusing allow_pickle load)"
            )
        meta = json.loads(bytes(data["meta_json"]).decode("utf-8"))
        store = cls()
        store._labels = [str(x) for x in meta["labels"]]
        store._label_ids = {l: i for i, l in enumerate(store._labels)}
        store._src = [int(x) for x in data["src"]]
        store._dst = [int(x) for x in data["dst"]]
        store._label = [int(x) for x in data["label"]]
        store._props = list(meta["props"])
        store._alive = [True] * len(store._src)
        store._n_alive = len(store._src)
        store._dirty = True
        return store


def _build_csr(key: np.ndarray, val: np.ndarray, lab: np.ndarray, eid: np.ndarray) -> CsrView:
    order = np.argsort(key, kind="stable")
    key_s, val_s, lab_s, eid_s = key[order], val[order], lab[order], eid[order]
    uniq, starts = np.unique(key_s, return_index=True)
    offsets = np.concatenate([starts, [len(key_s)]]).astype(np.int64)
    return CsrView(uniq, offsets, val_s, lab_s, eid_s)
