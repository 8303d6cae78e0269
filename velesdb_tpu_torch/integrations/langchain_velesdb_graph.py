"""LangChain graph retriever + agent-memory adapters over the port.

The port's copy of the repo's ``integrations/langchain_velesdb_graph.py``
(the reference's ``integrations/langchain/src/langchain_velesdb/
{graph_retriever.py, memory.py}``), re-designed for this engine: the
reference's retriever talks to a REST server per hop; here retrieval runs
against the EMBEDDED library (one process, no per-hop HTTP), using the
collection's device search for seeds and the CSR edge store for expansion.
The retriever works on any ``velesdb_tpu_torch.Collection``, on its
database's device; the memories open their own database on ``device``
(``"cuda"`` unless the caller asks for the CPU).

LangChain is optional: with it installed the classes register as real
``BaseRetriever``/memory components; without it the same classes work
standalone with the identical method surface (the pattern of
``langchain_velesdb.py``).

Surface:

- :class:`VelesGraphRetriever` — seed-and-expand RAG retrieval: vector
  search finds seed documents, bounded BFS over typed edges pulls in
  related context, results dedupe and rank by (depth, seed score).
- :class:`VelesChatMemory` — conversation memory over
  ``agent.AgentMemory`` episodic events (temporal recall window).
- :class:`VelesSemanticMemory` — fact memory over semantic recall
  (similarity x importance x recency re-ranking).
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np

from velesdb_tpu_torch.agent import AgentMemory
from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.integrations.langchain_velesdb import _HAVE_LANGCHAIN, Document

if _HAVE_LANGCHAIN:  # optional dependency
    from langchain_core.retrievers import BaseRetriever  # type: ignore
else:  # standalone stand-in with the same surface

    class BaseRetriever:  # type: ignore[no-redef]
        def get_relevant_documents(self, query: str):
            return self._get_relevant_documents(query, run_manager=None)

        def invoke(self, query: str, config=None):
            return self._get_relevant_documents(query, run_manager=None)


def _embed(embedding: Any, text: str) -> np.ndarray:
    if hasattr(embedding, "embed_query"):
        return np.asarray(embedding.embed_query(text), np.float32)
    return np.asarray(embedding(text), np.float32)


class VelesGraphRetriever(BaseRetriever):
    """Seed-and-expand retriever over a collection's graph.

    1. vector search -> ``seed_k`` seed documents (one device batch)
    2. bounded BFS from each seed over ``rel_types`` edges up to
       ``max_depth`` (CSR edge store, in-process)
    3. dedupe, rank seeds first (by score) then expansions (by hop depth),
       cap at ``expand_k`` documents.

    ``text_field`` selects the payload key used as page content.
    """

    # declared for the pydantic BaseRetriever; harmless standalone
    vector_store: Any = None
    embedding: Any = None

    def __init__(
        self,
        collection,
        embedding: Any,
        seed_k: int = 3,
        expand_k: int = 10,
        max_depth: int = 2,
        rel_types: Sequence[str] | None = None,
        score_threshold: float = 0.0,
        direction: str = "out",
        text_field: str = "text",
        low_latency: bool = False,
    ):
        if _HAVE_LANGCHAIN:
            try:  # BaseRetriever is a pydantic model in langchain-core
                super().__init__()
            except Exception:
                pass
        object.__setattr__(self, "_coll", collection)
        object.__setattr__(self, "_embedding", embedding)
        object.__setattr__(self, "seed_k", int(seed_k))
        object.__setattr__(self, "expand_k", int(expand_k))
        object.__setattr__(self, "max_depth", int(max_depth))
        object.__setattr__(self, "rel_types", list(rel_types) if rel_types else None)
        object.__setattr__(self, "score_threshold", float(score_threshold))
        object.__setattr__(self, "direction", direction)
        object.__setattr__(self, "text_field", text_field)
        object.__setattr__(self, "low_latency", bool(low_latency))

    # -- retrieval ---------------------------------------------------------

    def _get_relevant_documents(self, query: str, *, run_manager=None):
        vec = _embed(self._embedding, query)
        seeds = self._coll.search(vec, k=self.seed_k)
        seeds = [s for s in seeds if s["score"] >= self.score_threshold]
        ranked: list[tuple[int, float, int]] = [
            (s["id"], float(s["score"]), 0) for s in seeds
        ]
        if not self.low_latency and self.max_depth > 0:
            seen = {s["id"] for s in seeds}
            labels = self.rel_types or [None]
            for sid, score, _ in list(ranked):
                for label in labels:
                    try:
                        hops = self._coll.traverse(
                            sid,
                            max_depth=self.max_depth,
                            direction=self.direction,
                            label=label,
                        )
                    except KeyError:
                        continue
                    for node, depth, _path in hops:
                        if node in seen or depth == 0:
                            continue
                        seen.add(node)
                        # expansions inherit a depth-discounted seed score
                        ranked.append((node, score * (0.5 ** depth), depth))
        ranked.sort(key=lambda t: (t[2], -t[1]))
        docs = []
        for node, score, depth in ranked[: self.expand_k]:
            got = self._coll.get(node)
            payload = (got[1] if got else None) or {}
            docs.append(
                Document(
                    page_content=str(payload.get(self.text_field, "")),
                    metadata={
                        **{k: v for k, v in payload.items() if k != self.text_field},
                        "id": node,
                        "score": score,
                        "hop_depth": depth,
                    },
                )
            )
        return docs

    async def _aget_relevant_documents(self, query: str, *, run_manager=None):
        return self._get_relevant_documents(query, run_manager=run_manager)


class VelesChatMemory:
    """Conversation memory backed by ``AgentMemory`` episodic events.

    LangChain-compatible surface: ``save_context`` / ``load_memory_variables``
    / ``clear`` / ``memory_variables`` (duck-typed rather than subclassing —
    BaseChatMemory's pydantic machinery adds nothing here).
    """

    def __init__(
        self,
        path: str = "./veles_agent",
        embedding: Any | None = None,
        dimension: int = 384,
        memory_key: str = "history",
        human_prefix: str = "Human",
        ai_prefix: str = "AI",
        window: int = 20,
        device="cuda",
    ):
        self.memory = AgentMemory(Database(path, device=device), dim=dimension)
        self._embedding = embedding
        self.dimension = dimension
        self.memory_key = memory_key
        self.human_prefix = human_prefix
        self.ai_prefix = ai_prefix
        self.window = int(window)

    @property
    def memory_variables(self) -> list[str]:
        return [self.memory_key]

    def _vec(self, text: str) -> np.ndarray:
        if self._embedding is not None:
            return _embed(self._embedding, text)
        # deterministic hashing embedding (no-model default): stable enough
        # for temporal-window recall, which orders by time not similarity
        rng = np.random.default_rng(abs(hash(text)) % (2**32))
        return rng.standard_normal(self.dimension).astype(np.float32)

    def save_context(self, inputs: dict, outputs: dict) -> None:
        human = str(next(iter(inputs.values()))) if inputs else ""
        ai = str(next(iter(outputs.values()))) if outputs else ""
        now = time.time()
        self.memory.remember_event(
            self._vec(human), {"role": "human", "text": human, "at": now}
        )
        self.memory.remember_event(
            self._vec(ai), {"role": "ai", "text": ai, "at": now}
        )

    def load_memory_variables(self, inputs: dict | None = None) -> dict:
        # recall_window returns {"id", "content", "created_at"}, time-sorted
        events = self.memory.recall_window(since=0.0, k=self.window)
        lines = []
        for e in events:
            p = e.get("content") or {}
            prefix = self.human_prefix if p.get("role") == "human" else self.ai_prefix
            lines.append(f"{prefix}: {p.get('text', '')}")
        return {self.memory_key: "\n".join(lines)}

    def clear(self) -> None:
        coll = self.memory._coll("episodic")
        for vid in list(coll.vectors.id_to_slot):
            coll.delete(vid)


class VelesSemanticMemory:
    """Fact memory for RAG: store facts, recall by similarity x importance
    x recency (``AgentMemory.recall`` semantics)."""

    def __init__(
        self,
        path: str = "./veles_agent",
        embedding: Any | None = None,
        dimension: int = 384,
        memory_key: str = "facts",
        k: int = 5,
        device="cuda",
    ):
        self.memory = AgentMemory(Database(path, device=device), dim=dimension)
        self._embedding = embedding
        self.dimension = dimension
        self.memory_key = memory_key
        self.k = int(k)

    @property
    def memory_variables(self) -> list[str]:
        return [self.memory_key]

    def _vec(self, text: str) -> np.ndarray:
        if self._embedding is None:
            raise ValueError("VelesSemanticMemory requires an embedding")
        return _embed(self._embedding, text)

    def remember(self, text: str, importance: float = 0.5, **metadata) -> int:
        return self.memory.remember_fact(
            self._vec(text), {"text": text, **metadata}, importance=importance
        )

    def save_context(self, inputs: dict, outputs: dict) -> None:
        for v in list(inputs.values()) + list(outputs.values()):
            self.remember(str(v))

    def load_memory_variables(self, inputs: dict) -> dict:
        query = str(next(iter(inputs.values()))) if inputs else ""
        hits = self.memory.recall("semantic", self._vec(query), k=self.k)
        facts = [(h.get("content") or {}).get("text", "") for h in hits]
        return {self.memory_key: "\n".join(f for f in facts if f)}

    def clear(self) -> None:
        coll = self.memory._coll("semantic")
        for vid in list(coll.vectors.id_to_slot):
            coll.delete(vid)


__all__ = [
    "VelesGraphRetriever",
    "VelesChatMemory",
    "VelesSemanticMemory",
    "Document",
]
