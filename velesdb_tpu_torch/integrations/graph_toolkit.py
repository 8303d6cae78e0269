"""Knowledge-graph construction toolkit: chunk -> extract -> load.

The port's copy of the repo's ``integrations/graph_toolkit.py`` (numpy and
the standard library only), so that a user of ``velesdb_tpu_torch`` needs
nothing of the JAX package. The reference's ``langchain_velesdb/
graph_toolkit/`` (chunker.py / extractor.py / loader.py), re-designed for
this engine: extraction is pluggable (heuristic extractor built in, any LLM
callable slots in), and loading targets the embedded collection graph
directly (typed nodes + edges + MENTIONS links from chunk documents).

Pipeline:

    chunks   = SemanticChunker().chunk(text)
    ents, rels = HeuristicExtractor().extract(chunk.text)   # or LLM-backed
    GraphLoader(coll, embed).load(chunks, entities, relations)

The result is a collection holding chunk documents (vector-searchable) and
entity nodes wired with typed relation edges: what
``langchain_velesdb_graph.VelesGraphRetriever`` traverses for graph-RAG. The
collection is any ``velesdb_tpu_torch.Collection``, on the device its
database was opened on.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np

__all__ = [
    "Chunk",
    "Entity",
    "Relation",
    "SemanticChunker",
    "HeuristicExtractor",
    "LLMExtractor",
    "GraphLoader",
]


@dataclass
class Chunk:
    text: str
    start: int
    end: int

    @property
    def length(self) -> int:
        return len(self.text)


@dataclass
class Entity:
    name: str
    entity_type: str = "Entity"
    properties: dict = field(default_factory=dict)


@dataclass
class Relation:
    source: str
    target: str
    relation_type: str = "RELATED_TO"
    properties: dict = field(default_factory=dict)


class SemanticChunker:
    """Recursive splitting with overlap, preferring paragraph then sentence
    then word boundaries (separator ladder)."""

    def __init__(self, chunk_size: int = 1000, chunk_overlap: int = 200,
                 separators: list[str] | None = None):
        if chunk_overlap >= chunk_size:
            raise ValueError("overlap must be smaller than chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = separators or ["\n\n", "\n", ". ", " "]

    def chunk(self, text: str) -> list[Chunk]:
        if not text:
            return []
        out: list[Chunk] = []
        start = 0
        n = len(text)
        while start < n:
            end = min(start + self.chunk_size, n)
            if end < n:
                # pull the cut back to the best separator inside the window
                window = text[start:end]
                for sep in self.separators:
                    cut = window.rfind(sep)
                    if cut > self.chunk_size // 2:
                        end = start + cut + len(sep)
                        break
            out.append(Chunk(text[start:end].strip(), start, end))
            if end >= n:
                break
            start = max(end - self.chunk_overlap, start + 1)
        return [c for c in out if c.text]


class HeuristicExtractor:
    """Dependency-free entity/relation extraction.

    Entities: capitalized multi-word spans (skipping sentence starts and
    stop words). Relations: co-occurrence within a sentence, typed by the
    connecting verb phrase when one of a known set appears.
    """

    _VERBS = {
        "works at": "WORKS_AT",
        "works for": "WORKS_AT",
        "founded": "FOUNDED",
        "acquired": "ACQUIRED",
        "owns": "OWNS",
        "leads": "LEADS",
        "created": "CREATED",
        "located in": "LOCATED_IN",
        "based in": "LOCATED_IN",
        "part of": "PART_OF",
        "married to": "MARRIED_TO",
    }
    _STOP = {"The", "A", "An", "This", "That", "It", "He", "She", "They",
             "We", "You", "I", "In", "On", "At", "And", "But", "Or", "If"}
    _SPAN = re.compile(r"\b([A-Z][\w&.-]*(?:\s+[A-Z][\w&.-]*)*)\b")

    def extract(self, text: str) -> tuple[list[Entity], list[Relation]]:
        entities: dict[str, Entity] = {}
        relations: list[Relation] = []
        for sentence in re.split(r"(?<=[.!?])\s+", text):
            spans = []
            for m in self._SPAN.finditer(sentence):
                name = m.group(1).strip()
                if name in self._STOP or len(name) < 2:
                    continue
                # drop leading stop word picked up at sentence start
                head = name.split()[0]
                if head in self._STOP and " " in name:
                    name = name.split(None, 1)[1]
                spans.append((name, m.start()))
                if name not in entities:
                    entities[name] = Entity(name)
            lower = sentence.lower()
            for i, (a, pa) in enumerate(spans):
                for b, pb in spans[i + 1 :]:
                    if a == b:
                        continue
                    between = lower[pa + len(a) : pb] if pb > pa else ""
                    rtype = "RELATED_TO"
                    for verb, vt in self._VERBS.items():
                        if verb in between:
                            rtype = vt
                            break
                    relations.append(Relation(a, b, rtype))
        return list(entities.values()), relations


class LLMExtractor:
    """Extraction through any callable LLM: ``llm(prompt) -> str`` returning
    JSON ``{"entities": [{"name", "type"}], "relations": [{"source",
    "target", "type"}]}`` (the reference's Ollama extractor contract)."""

    PROMPT = (
        "Extract entities and relations from the text as JSON with keys "
        '"entities" (name, type) and "relations" (source, target, type).\n'
        "Text:\n{text}\nJSON:"
    )

    def __init__(self, llm: Callable[[str], str]):
        self.llm = llm

    def extract(self, text: str) -> tuple[list[Entity], list[Relation]]:
        import json

        raw = self.llm(self.PROMPT.format(text=text))
        m = re.search(r"\{.*\}", raw, re.DOTALL)
        if not m:
            return [], []
        try:
            data = json.loads(m.group(0))
        except ValueError:
            return [], []
        ents = [
            Entity(e["name"], e.get("type", "Entity"),
                   {k: v for k, v in e.items() if k not in ("name", "type")})
            for e in data.get("entities", [])
            if isinstance(e, dict) and e.get("name")
        ]
        rels = [
            Relation(r["source"], r["target"], r.get("type", "RELATED_TO"))
            for r in data.get("relations", [])
            if isinstance(r, dict) and r.get("source") and r.get("target")
        ]
        return ents, rels


def _entity_id(name: str, entity_type: str) -> int:
    """Deterministic 60-bit id from (type, name) — re-loading is idempotent."""
    h = hashlib.sha256(f"{entity_type}:{name}".encode()).hexdigest()
    return int(h[:15], 16)


class GraphLoader:
    """Load chunks + extracted entities/relations into one collection.

    - chunk documents -> vector rows (payload ``{"text", "kind": "chunk"}``)
    - entities -> labeled graph nodes (deterministic ids, idempotent)
    - relations -> typed edges between entity nodes
    - MENTIONS edges from each chunk to the entities extracted from it
    """

    def __init__(self, collection, embedding: Callable[[str], Any] | None = None,
                 chunk_id_base: int = 1 << 61):
        self.coll = collection
        self.embedding = embedding
        self.chunk_id_base = chunk_id_base
        self._next_chunk = 0

    def _vec(self, text: str) -> np.ndarray:
        if self.embedding is not None:
            return np.asarray(self.embedding(text), np.float32)
        rng = np.random.default_rng(abs(hash(text)) % (2**32))
        return rng.standard_normal(self.coll.dim).astype(np.float32)

    def load(self, chunks: Iterable[Chunk], entities: Iterable[Entity],
             relations: Iterable[Relation],
             chunk_entities: dict[int, list[str]] | None = None) -> dict:
        ent_ids: dict[str, int] = {}
        for e in entities:
            nid = _entity_id(e.name, e.entity_type)
            ent_ids[e.name] = nid
            self.coll.add_node(
                nid, labels=[e.entity_type],
                properties={"name": e.name, **e.properties},
                vector=self._vec(e.name),
            )
        n_rel = 0
        for r in relations:
            src, dst = ent_ids.get(r.source), ent_ids.get(r.target)
            if src is None or dst is None:
                continue
            self.coll.add_edge(src, dst, r.relation_type, r.properties or None)
            n_rel += 1
        chunk_ids = []
        for i, c in enumerate(chunks):
            cid = self.chunk_id_base + self._next_chunk
            self._next_chunk += 1
            self.coll.upsert(cid, self._vec(c.text),
                             {"text": c.text, "kind": "chunk"})
            chunk_ids.append(cid)
            for name in (chunk_entities or {}).get(i, []):
                if name in ent_ids:
                    self.coll.add_edge(cid, ent_ids[name], "MENTIONS")
        return {"entities": len(ent_ids), "relations": n_rel,
                "chunks": len(chunk_ids), "chunk_ids": chunk_ids}

    def load_document(self, text: str, chunker: SemanticChunker | None = None,
                      extractor=None) -> dict:
        """One-call pipeline: chunk the document, extract per chunk, load."""
        chunker = chunker or SemanticChunker()
        extractor = extractor or HeuristicExtractor()
        chunks = chunker.chunk(text)
        all_ents: dict[str, Entity] = {}
        all_rels: list[Relation] = []
        chunk_entities: dict[int, list[str]] = {}
        for i, c in enumerate(chunks):
            ents, rels = extractor.extract(c.text)
            chunk_entities[i] = [e.name for e in ents]
            for e in ents:
                all_ents.setdefault(e.name, e)
            all_rels.extend(rels)
        return self.load(chunks, all_ents.values(), all_rels, chunk_entities)
