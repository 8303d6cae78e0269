"""Knowledge-graph layer: typed nodes/edges, BFS, property indexes, MATCH.

Counterpart of ``velesdb_tpu/graph/`` and of ``collection/graph/``
(SURVEY.md §2.2: EdgeStore family, PropertyIndex/RangeIndex) and the MATCH
executor (§2.3). Host code: the only device work is ``similarity()``, scored
on the collection's device.
"""

from __future__ import annotations

import os

from velesdb_tpu_torch.graph.edge_store import Edge, EdgeStore
from velesdb_tpu_torch.graph.match_exec import MatchError, execute_match
from velesdb_tpu_torch.graph.match_parser import MatchStatement, parse_match
from velesdb_tpu_torch.graph.property_index import PropertyIndex, RangeIndex
from velesdb_tpu_torch.graph.traverse import Guardrails, GuardrailError, bfs, traverse

__all__ = [
    "CollectionGraph",
    "EdgeStore",
    "Edge",
    "PropertyIndex",
    "RangeIndex",
    "Guardrails",
    "GuardrailError",
    "bfs",
    "traverse",
    "parse_match",
    "MatchStatement",
    "execute_match",
    "MatchError",
    "LABELS_KEY",
]

LABELS_KEY = "_labels"  # reserved payload key carrying node labels


class CollectionGraph:
    """Per-collection graph state: edges + node indexes + label buckets."""

    def __init__(self):
        self.edges = EdgeStore()
        self.property_index = PropertyIndex()
        self.range_index = RangeIndex()
        self.label_nodes: dict[str, set[int]] = {}
        self._node_labels: dict[int, list[str]] = {}

    def index_node(self, node: int, payload: dict | None) -> None:
        self.remove_node_indexes(node)
        payload = payload or {}
        labels = payload.get(LABELS_KEY) or []
        props = {k: v for k, v in payload.items() if k != LABELS_KEY}
        self._node_labels[node] = list(labels)
        for label in labels:
            self.label_nodes.setdefault(label, set()).add(node)
        self.property_index.index_node(node, props)
        self.range_index.index_node(node, props)

    def remove_node_indexes(self, node: int) -> None:
        for label in self._node_labels.pop(node, ()):  # stale label buckets
            bucket = self.label_nodes.get(label)
            if bucket is not None:
                bucket.discard(node)
        self.property_index.remove_node(node)
        self.range_index.remove_node(node)

    def remove_node(self, node: int) -> int:
        self.remove_node_indexes(node)
        return self.edges.remove_node_edges(node)

    def labels_of(self, node: int) -> list[str]:
        return list(self._node_labels.get(node, ()))

    # -- persistence ---------------------------------------------------------

    def save(self, dirpath: str) -> None:
        self.edges.save(os.path.join(dirpath, "edges.npz"))

    def load_edges(self, dirpath: str) -> bool:
        path = os.path.join(dirpath, "edges.npz")
        if os.path.exists(path):
            self.edges = EdgeStore.load(path)
            return True
        return False
