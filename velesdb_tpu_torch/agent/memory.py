"""Agent memory SDK: semantic / episodic / procedural memories.

Counterpart of ``velesdb-core/src/agent/`` (2,872 LoC — ``AgentMemory``
``agent/memory.rs:44``, ``semantic_memory.rs:16``, ``episodic_memory.rs:20``,
``procedural_memory.rs:27``, TTL+eviction ``ttl.rs``, versioned snapshots
with rollback ``snapshot.rs``, ``temporal_index.rs``, reinforcement
strategies), ported from ``velesdb_tpu/agent/memory.py`` onto the port's
``Database``. Memories live in dedicated collections, so recall is the same
device search as any other query; the SDK adds the memory semantics:

- **semantic**: facts with importance scores; recall = vector search
  re-weighted by importance and recency.
- **episodic**: time-stamped events; temporal-window recall via a sorted
  timestamp index + similarity.
- **procedural**: named skills/procedures with success statistics;
  reinforcement updates (success/failure) adjust retrieval priority.
- TTL + capacity eviction (lowest-priority-first), versioned snapshots with
  rollback.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any

import numpy as np

from velesdb_tpu_torch.database import Database

__all__ = ["AgentMemory", "MemoryKind"]


class MemoryKind:
    SEMANTIC = "semantic"
    EPISODIC = "episodic"
    PROCEDURAL = "procedural"

    ALL = (SEMANTIC, EPISODIC, PROCEDURAL)


_K = "_memory"  # reserved payload key for memory bookkeeping


class AgentMemory:
    """Three-kind agent memory over one Database.

    ``now`` is injectable for tests (the reference threads clocks through
    ``ttl.rs`` the same way).
    """

    def __init__(
        self,
        db: Database,
        dim: int,
        agent_id: str = "agent",
        capacity: int = 10_000,
        default_ttl_s: float | None = None,
        now=time.time,
    ):
        self.db = db
        self.dim = dim
        self.agent_id = agent_id
        self.capacity = capacity
        self.default_ttl_s = default_ttl_s
        self.now = now
        self._next_id: dict[str, int] = {}
        self._colls = {}
        for kind in MemoryKind.ALL:
            name = f"{agent_id}__{kind}"
            self._colls[kind] = db.get_or_create_collection(name, dim)
            ids = list(self._colls[kind].payloads.payloads)
            self._next_id[kind] = (max(ids) + 1) if ids else 0

    def _coll(self, kind: str):
        if kind not in self._colls:
            raise ValueError(f"unknown memory kind {kind!r}")
        return self._colls[kind]

    # -- store ------------------------------------------------------------------

    def remember(
        self,
        kind: str,
        vector,
        content: Any,
        importance: float = 0.5,
        ttl_s: float | None = None,
        metadata: dict | None = None,
    ) -> int:
        """Store one memory; returns its id. Evicts if over capacity."""
        coll = self._coll(kind)
        mid = self._next_id[kind]
        self._next_id[kind] += 1
        ts = self.now()
        ttl = ttl_s if ttl_s is not None else self.default_ttl_s
        payload = {
            "content": content,
            **(metadata or {}),
            _K: {
                "kind": kind,
                "importance": float(importance),
                "created_at": ts,
                "last_access": ts,
                "access_count": 0,
                "expires_at": (ts + ttl) if ttl is not None else None,
                "successes": 0,
                "failures": 0,
            },
        }
        vec = np.asarray(vector, np.float32)
        coll.upsert(mid, vec, payload)
        self._evict_if_needed(kind)
        return mid

    def remember_fact(self, vector, content, importance=0.5, **kw) -> int:
        return self.remember(MemoryKind.SEMANTIC, vector, content, importance, **kw)

    def remember_event(self, vector, content, importance=0.5, **kw) -> int:
        return self.remember(MemoryKind.EPISODIC, vector, content, importance, **kw)

    def remember_procedure(self, vector, content, importance=0.5, **kw) -> int:
        return self.remember(MemoryKind.PROCEDURAL, vector, content, importance, **kw)

    # -- recall ----------------------------------------------------------------

    def recall(
        self,
        kind: str,
        query_vector,
        k: int = 5,
        since: float | None = None,
        until: float | None = None,
        min_importance: float = 0.0,
        half_life_s: float = 7 * 86400.0,
    ) -> list[dict]:
        """Similarity recall re-ranked by importance x recency (+ success rate
        for procedural). Expired memories never surface."""
        coll = self._coll(kind)
        self.expire(kind)
        fetch = max(4 * k, 16)
        hits = coll.search(np.asarray(query_vector, np.float32), fetch)
        ts_now = self.now()
        scored = []
        for h in hits:
            meta = (h.payload or {}).get(_K) or {}
            if since is not None and meta.get("created_at", 0) < since:
                continue
            if until is not None and meta.get("created_at", 0) > until:
                continue
            imp = meta.get("importance", 0.5)
            if imp < min_importance:
                continue
            age = max(ts_now - meta.get("created_at", ts_now), 0.0)
            recency = math.exp(-age * math.log(2) / half_life_s)
            priority = h.score * (0.5 + imp) * (0.5 + 0.5 * recency)
            if kind == MemoryKind.PROCEDURAL:
                s, f = meta.get("successes", 0), meta.get("failures", 0)
                rate = (s + 1.0) / (s + f + 2.0)  # Laplace-smoothed
                priority *= 0.5 + rate
            scored.append((priority, h))
        scored.sort(key=lambda t: -t[0])
        out = []
        for priority, h in scored[:k]:
            # snapshot metadata BEFORE touch: payloads are shared references
            out.append(
                {
                    "id": h.id,
                    "content": (h.payload or {}).get("content"),
                    "similarity": h.score,
                    "priority": priority,
                    "memory": dict((h.payload or {}).get(_K) or {}),
                }
            )
            self._touch(coll, h.id)
        return out

    def recall_window(self, since: float, until: float | None = None, k: int = 50):
        """Pure temporal recall of episodic memories (``temporal_index.rs``)."""
        coll = self._coll(MemoryKind.EPISODIC)
        self.expire(MemoryKind.EPISODIC)
        until = until if until is not None else float("inf")
        out = []
        for mid, payload in coll.payloads.payloads.items():
            meta = (payload or {}).get(_K) or {}
            ts = meta.get("created_at", 0)
            if since <= ts <= until:
                out.append(
                    {"id": mid, "content": payload.get("content"), "created_at": ts}
                )
        out.sort(key=lambda r: r["created_at"])
        return out[:k]

    def _touch(self, coll, mid: int) -> None:
        got = coll.get(mid)
        if got is None:
            return
        vec, payload = got
        meta = payload.get(_K) or {}
        meta["last_access"] = self.now()
        meta["access_count"] = meta.get("access_count", 0) + 1
        payload[_K] = meta
        coll.upsert(mid, vec, payload)

    # -- reinforcement (procedural) ------------------------------------------------

    def reinforce(self, mid: int, success: bool, boost: float = 0.05) -> None:
        """Success/failure feedback; nudges importance (reinforcement
        strategies of ``procedural_memory.rs``)."""
        coll = self._coll(MemoryKind.PROCEDURAL)
        got = coll.get(mid)
        if got is None:
            raise KeyError(f"procedural memory {mid} not found")
        vec, payload = got
        meta = payload.get(_K) or {}
        key = "successes" if success else "failures"
        meta[key] = meta.get(key, 0) + 1
        imp = meta.get("importance", 0.5)
        meta["importance"] = float(
            min(1.0, imp + boost) if success else max(0.0, imp - boost)
        )
        payload[_K] = meta
        coll.upsert(mid, vec, payload)

    # -- TTL / eviction -------------------------------------------------------------

    def expire(self, kind: str | None = None) -> int:
        """Drop expired memories; returns count (``ttl.rs``)."""
        kinds = [kind] if kind else list(MemoryKind.ALL)
        ts = self.now()
        dropped = 0
        for kd in kinds:
            coll = self._coll(kd)
            dead = [
                mid
                for mid, payload in list(coll.payloads.payloads.items())
                if ((payload or {}).get(_K) or {}).get("expires_at") is not None
                and payload[_K]["expires_at"] <= ts
            ]
            for mid in dead:
                coll.delete(mid)
            dropped += len(dead)
        return dropped

    def _priority_for_eviction(self, payload) -> float:
        meta = (payload or {}).get(_K) or {}
        age = max(self.now() - meta.get("last_access", 0), 1.0)
        return meta.get("importance", 0.5) * (
            1.0 + math.log1p(meta.get("access_count", 0))
        ) / age

    def _evict_if_needed(self, kind: str) -> int:
        coll = self._coll(kind)
        excess = coll.count() - self.capacity
        if excess <= 0:
            return 0
        ranked = sorted(
            coll.payloads.payloads.items(),
            key=lambda kv: self._priority_for_eviction(kv[1]),
        )
        for mid, _ in ranked[:excess]:
            coll.delete(mid)
        return excess

    def forget(self, kind: str, mid: int) -> bool:
        return self._coll(kind).delete(mid)

    def stats(self) -> dict:
        return {
            kind: {"count": self._coll(kind).count()} for kind in MemoryKind.ALL
        }

    # -- snapshots with rollback (snapshot.rs) --------------------------------------

    def _snapshot_dir(self) -> str:
        d = os.path.join(self.db.path, f"{self.agent_id}__snapshots")
        os.makedirs(d, exist_ok=True)
        return d

    def snapshot(self, tag: str | None = None) -> str:
        """Versioned snapshot of all three memory kinds; returns snapshot id."""
        ts = self.now()
        sid = tag or f"snap-{int(ts * 1000)}"
        state = {"created_at": ts, "kinds": {}}
        blobs = {}
        for kind in MemoryKind.ALL:
            coll = self._coll(kind)
            entries = []
            for mid, payload in coll.payloads.payloads.items():
                got = coll.get(mid)
                if got is None:
                    continue
                entries.append(
                    {"id": mid, "payload": payload, "vector_key": f"{kind}:{mid}"}
                )
                blobs[f"{kind}:{mid}"] = np.asarray(got[0], np.float32)
            state["kinds"][kind] = entries
        path = os.path.join(self._snapshot_dir(), sid)
        np.savez_compressed(path + ".npz", **blobs)
        with open(path + ".json", "w") as f:
            json.dump(state, f)
        return sid

    def list_snapshots(self) -> list[str]:
        d = self._snapshot_dir()
        return sorted(
            f[:-5] for f in os.listdir(d) if f.endswith(".json")
        )

    def rollback(self, snapshot_id: str) -> None:
        """Restore all memories to a snapshot (destructive for newer state)."""
        path = os.path.join(self._snapshot_dir(), snapshot_id)
        if not os.path.exists(path + ".json"):
            raise KeyError(f"snapshot {snapshot_id!r} not found")
        with open(path + ".json") as f:
            state = json.load(f)
        blobs = np.load(path + ".npz")
        for kind in MemoryKind.ALL:
            coll = self._coll(kind)
            for mid in list(coll.payloads.payloads):
                coll.delete(mid)
            max_id = -1
            for entry in state["kinds"].get(kind, []):
                vec = blobs[entry["vector_key"]]
                coll.upsert(entry["id"], vec, entry["payload"])
                max_id = max(max_id, entry["id"])
            self._next_id[kind] = max_id + 1
