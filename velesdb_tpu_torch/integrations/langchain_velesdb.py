"""LangChain VectorStore adapter over the port's ``Database``.

The port's copy of the repo's ``integrations/langchain_velesdb.py`` (the
reference's ``integrations/langchain`` Python adapter). LangChain is an
optional dependency: when it is installed the class registers as a real
``VectorStore``; without it, the same class works standalone with the
identical method surface (``add_texts`` / ``similarity_search`` /
``similarity_search_with_score`` / ``max_marginal_relevance_search`` /
``delete`` / ``from_texts``).

The store opens its database on ``device`` (``"cuda"`` unless the caller
asks for the CPU), so every search runs the collection's device path. Rows
keep the reference adapter's payload (``text``, ``metadata``, ``_lc_id``)
and integer ids (:func:`_stable_id`), so a directory written by either
package's adapter reads back through the other's.
"""

from __future__ import annotations

import hashlib
import uuid
from typing import Any, Iterable

import numpy as np

from velesdb_tpu_torch.database import Database

try:  # optional dependency
    from langchain_core.documents import Document  # type: ignore
    from langchain_core.vectorstores import VectorStore as _LCBase  # type: ignore

    _HAVE_LANGCHAIN = True
except ImportError:  # standalone stand-ins with the same surface
    _HAVE_LANGCHAIN = False

    class Document(dict):  # type: ignore[no-redef]
        def __init__(self, page_content: str, metadata: dict | None = None):
            super().__init__(page_content=page_content, metadata=metadata or {})

        @property
        def page_content(self) -> str:
            return self["page_content"]

        @property
        def metadata(self) -> dict:
            return self["metadata"]

    class _LCBase:  # type: ignore[no-redef]
        pass


__all__ = ["Document", "VelesDBVectorStore"]


class VelesDBVectorStore(_LCBase):
    """LangChain-compatible vector store over one collection of the port."""

    def __init__(
        self,
        embedding: Any,
        path: str = "./velesdb_data",
        collection_name: str = "langchain",
        metric: str = "cosine",
        device="cuda",
    ):
        self._embedding = embedding
        self.db = Database.open(path, device=device)
        self.collection_name = collection_name
        self.metric = metric
        self._coll = None

    # embedding may be a LangChain Embeddings object or a plain callable
    def _embed_docs(self, texts: list[str]) -> np.ndarray:
        e = self._embedding
        if hasattr(e, "embed_documents"):
            return np.asarray(e.embed_documents(texts), np.float32)
        return np.asarray([e(t) for t in texts], np.float32)

    def _embed_query(self, text: str) -> np.ndarray:
        e = self._embedding
        if hasattr(e, "embed_query"):
            return np.asarray(e.embed_query(text), np.float32)
        return np.asarray(e(text), np.float32)

    def _collection(self, dim: int):
        if self._coll is None:
            self._coll = self.db.get_or_create_collection(
                self.collection_name, dim, metric=self.metric
            )
        return self._coll

    @property
    def embeddings(self):  # LangChain surface
        return self._embedding

    # -- writes ---------------------------------------------------------------

    def add_texts(
        self,
        texts: Iterable[str],
        metadatas: list[dict] | None = None,
        ids: list[str] | None = None,
        **_: Any,
    ) -> list[str]:
        texts = list(texts)
        if not texts:
            return []
        vecs = self._embed_docs(texts)
        coll = self._collection(vecs.shape[1])
        out_ids = ids or [str(uuid.uuid4()) for _ in texts]
        int_ids = [_stable_id(s) for s in out_ids]
        payloads = [
            {"text": t, "metadata": (metadatas[i] if metadatas else {}), "_lc_id": out_ids[i]}
            for i, t in enumerate(texts)
        ]
        coll.upsert_bulk(int_ids, vecs, payloads)
        return out_ids

    def delete(self, ids: list[str] | None = None, **_: Any) -> bool:
        if not ids or self._coll is None:
            return False
        ok = True
        for s in ids:
            ok &= self._coll.delete(_stable_id(s))
        return ok

    # -- reads ----------------------------------------------------------------

    def similarity_search_with_score(
        self, query: str, k: int = 4, filter: dict | None = None, **_: Any
    ) -> list[tuple[Document, float]]:
        vec = self._embed_query(query)
        coll = self._collection(vec.shape[0])
        hits = coll.search(vec, k, filter=filter)
        return [(_document(h), float(h.score)) for h in hits]

    def similarity_search(self, query: str, k: int = 4, **kw: Any) -> list[Document]:
        return [d for d, _ in self.similarity_search_with_score(query, k, **kw)]

    def max_marginal_relevance_search(
        self, query: str, k: int = 4, fetch_k: int = 20, lambda_mult: float = 0.5,
        **_: Any,
    ) -> list[Document]:
        """MMR re-ranking over an over-fetched candidate set."""
        vec = self._embed_query(query)
        coll = self._collection(vec.shape[0])
        hits = coll.search(vec, max(fetch_k, k))
        if not hits:
            return []
        cand = np.stack([coll.vectors.retrieve(h.id) for h in hits])
        return [_document(hits[i]) for i in mmr_select(vec, cand, k, lambda_mult)]

    @classmethod
    def from_texts(
        cls,
        texts: list[str],
        embedding: Any,
        metadatas: list[dict] | None = None,
        **kwargs: Any,
    ) -> "VelesDBVectorStore":
        store = cls(embedding, **kwargs)
        store.add_texts(texts, metadatas)
        return store


def mmr_select(query: np.ndarray, cand: np.ndarray, k: int, lambda_mult: float) -> list[int]:
    """Maximal marginal relevance over candidate rows ``cand [m, D]``: the
    positions of up to ``k`` rows, each chosen to maximise ``lambda_mult *
    cos(q, c) - (1 - lambda_mult) * max cos(c, chosen)`` (the reference
    adapter's rule)."""
    cn = cand / np.maximum(np.linalg.norm(cand, axis=1, keepdims=True), 1e-30)
    qn = query / max(np.linalg.norm(query), 1e-30)
    rel = cn @ qn
    chosen: list[int] = []
    while len(chosen) < min(k, len(cand)):
        if chosen:
            div = (cn @ cn[chosen].T).max(axis=1)
        else:
            div = np.zeros(len(cand))
        mmr = lambda_mult * rel - (1 - lambda_mult) * div
        mmr[chosen] = -np.inf
        chosen.append(int(np.argmax(mmr)))
    return chosen


def _document(hit) -> Document:
    payload = hit.payload or {}
    return Document(page_content=payload.get("text", ""), metadata=payload.get("metadata", {}))


def _stable_id(s: str) -> int:
    """The row id of a string id: the first 7 bytes of its blake2b digest
    (the reference adapters' ids, so their directories interoperate)."""
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=7).digest(), "big")
