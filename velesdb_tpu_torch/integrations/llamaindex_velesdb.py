"""LlamaIndex vector-store adapter over the port's ``Database``.

The port's copy of the repo's ``integrations/llamaindex_velesdb.py`` (the
reference's ``integrations/llamaindex``). LlamaIndex is an optional
dependency; without it the adapter exposes the same ``add`` / ``delete`` /
``query`` surface on plain dataclasses. The store opens its database on
``device`` (``"cuda"`` unless the caller asks for the CPU); rows keep the
reference adapter's payload (``text``, ``metadata``, ``_node_id``) and ids.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.integrations.langchain_velesdb import _stable_id

__all__ = ["VectorStoreQueryResult", "VelesDBLlamaStore"]


@dataclasses.dataclass
class VectorStoreQueryResult:
    ids: list[str]
    similarities: list[float]
    payloads: list[dict]


class VelesDBLlamaStore:
    """Minimal LlamaIndex-style vector store (stores_text=True)."""

    stores_text = True

    def __init__(
        self,
        path: str = "./velesdb_data",
        collection_name: str = "llamaindex",
        dim: int | None = None,
        metric: str = "cosine",
        device="cuda",
    ):
        self.db = Database.open(path, device=device)
        self.collection_name = collection_name
        self.metric = metric
        self._coll = (
            self.db.get_or_create_collection(collection_name, dim, metric=metric)
            if dim
            else None
        )

    def _collection(self, dim: int):
        if self._coll is None:
            self._coll = self.db.get_or_create_collection(
                self.collection_name, dim, metric=self.metric
            )
        return self._coll

    def add(self, nodes: Sequence[Any], **_: Any) -> list[str]:
        """``nodes``: objects with ``node_id``, ``get_embedding()``,
        ``get_content()``, ``metadata`` (LlamaIndex BaseNode surface), or
        plain dicts with the same keys."""
        ids, vecs, payloads = [], [], []
        for node in nodes:
            if isinstance(node, dict):
                nid = node["node_id"]
                emb = node["embedding"]
                text = node.get("text", "")
                meta = node.get("metadata", {})
            else:
                nid = node.node_id
                emb = node.get_embedding()
                text = node.get_content()
                meta = dict(getattr(node, "metadata", {}) or {})
            ids.append(_stable_id(nid))
            vecs.append(np.asarray(emb, np.float32))
            payloads.append({"text": text, "metadata": meta, "_node_id": nid})
        if not ids:
            return []
        vecs = np.stack(vecs)
        self._collection(vecs.shape[1]).upsert_bulk(ids, vecs, payloads)
        return [p["_node_id"] for p in payloads]

    def delete(self, node_id: str, **_: Any) -> None:
        if self._coll is not None:
            self._coll.delete(_stable_id(node_id))

    def query(
        self,
        query_embedding,
        similarity_top_k: int = 5,
        filters: dict | None = None,
        **_: Any,
    ) -> VectorStoreQueryResult:
        vec = np.asarray(query_embedding, np.float32)
        coll = self._collection(vec.shape[0])
        hits = coll.search(vec, similarity_top_k, filter=filters)
        return VectorStoreQueryResult(
            ids=[(h.payload or {}).get("_node_id", str(h.id)) for h in hits],
            similarities=[float(h.score) for h in hits],
            payloads=[h.payload or {} for h in hits],
        )
