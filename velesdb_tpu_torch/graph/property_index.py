"""Property indexes over graph node properties.

Counterpart of ``collection/graph/property_index.rs`` (O(1) equality) and
``range_index.rs`` (O(log n) BTree range). The TPU build uses a hash index
for equality and **sorted numpy arrays + searchsorted** for ranges — the
array layout also vectorizes multi-node lookups, which the BTree can't.
"""

from __future__ import annotations

import bisect
import threading

import numpy as np

__all__ = ["PropertyIndex", "RangeIndex"]


class PropertyIndex:
    """field -> value -> set of node ids (equality lookups)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._idx: dict[str, dict] = {}
        self._node_props: dict[int, dict] = {}

    def index_node(self, node: int, properties: dict | None) -> None:
        with self._lock:
            self.remove_node(node)
            if not properties:
                return
            flat = _flatten(properties)
            self._node_props[node] = flat
            for field, value in flat.items():
                if _hashable(value):
                    self._idx.setdefault(field, {}).setdefault(value, set()).add(node)

    def remove_node(self, node: int) -> None:
        with self._lock:
            old = self._node_props.pop(node, None)
            if not old:
                return
            for field, value in old.items():
                if _hashable(value):
                    bucket = self._idx.get(field, {}).get(value)
                    if bucket is not None:
                        bucket.discard(node)

    def lookup(self, field: str, value) -> set[int]:
        with self._lock:
            return set(self._idx.get(field, {}).get(value, ()))

    def fields(self) -> list[str]:
        return sorted(self._idx)


class RangeIndex:
    """field -> sorted (value, node) pairs for range scans.

    Rebuilt lazily from pending mutations; scans are ``searchsorted`` slices.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._pending: dict[int, dict] = {}
        self._removed: set[int] = set()
        self._sorted: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._dirty = False

    def index_node(self, node: int, properties: dict | None) -> None:
        with self._lock:
            self._removed.discard(node)
            self._pending[node] = {
                f: v
                for f, v in _flatten(properties or {}).items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
            self._dirty = True

    def remove_node(self, node: int) -> None:
        with self._lock:
            self._pending.pop(node, None)
            self._removed.add(node)
            self._dirty = True

    def _rebuild(self) -> None:
        per_field: dict[str, list[tuple[float, int]]] = {}
        for node, props in self._pending.items():
            for f, v in props.items():
                per_field.setdefault(f, []).append((float(v), node))
        self._sorted = {}
        for f, pairs in per_field.items():
            pairs.sort()
            vals = np.asarray([p[0] for p in pairs], np.float64)
            nodes = np.asarray([p[1] for p in pairs], np.int64)
            self._sorted[f] = (vals, nodes)
        self._dirty = False

    def range(
        self,
        field: str,
        lo: float | None = None,
        hi: float | None = None,
        include_lo: bool = True,
        include_hi: bool = True,
    ) -> set[int]:
        with self._lock:
            if self._dirty:
                self._rebuild()
            entry = self._sorted.get(field)
            if entry is None:
                return set()
            vals, nodes = entry
            a = 0
            b = len(vals)
            if lo is not None:
                a = np.searchsorted(vals, lo, side="left" if include_lo else "right")
            if hi is not None:
                b = np.searchsorted(vals, hi, side="right" if include_hi else "left")
            return set(int(n) for n in nodes[a:b])


def _flatten(props: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in props.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _hashable(v) -> bool:
    return isinstance(v, (str, int, float, bool, type(None)))
