"""Agent memory SDK tests against the port (``agent/`` test modules analog,
SURVEY.md §4).

``tests/test_agent_memory.py`` case for case, by name, on
``velesdb_tpu_torch`` with the database on the CPU; then the same memories
with the same clock in both packages recall the same ids, in the same order,
with similarities and priorities to rtol 1e-5 (fp32 scores in a different
summation order).
"""

import numpy as np
import pytest

import velesdb_tpu
import velesdb_tpu.agent
from velesdb_tpu_torch.agent import AgentMemory, MemoryKind
from velesdb_tpu_torch.database import Database as _Database

RTOL = 1e-5


class Database(_Database):
    """The port's database, on the CPU."""

    @classmethod
    def open(cls, path, device="cpu"):
        return super().open(path, device=device)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture
def mem(tmp_db_dir, rng):
    db = Database.open(tmp_db_dir)
    clock = Clock()
    m = AgentMemory(db, dim=8, capacity=100, now=clock)
    return m, clock, rng


def _vec(rng):
    return rng.standard_normal(8).astype(np.float32)


def test_remember_and_recall_semantic(mem):
    m, clock, rng = mem
    v1, v2 = _vec(rng), _vec(rng)
    a = m.remember_fact(v1, "the sky is blue", importance=0.9)
    m.remember_fact(v2, "grass is green", importance=0.1)
    out = m.recall(MemoryKind.SEMANTIC, v1, k=1)
    assert out[0]["id"] == a and out[0]["content"] == "the sky is blue"
    assert out[0]["memory"]["access_count"] == 0  # touched after read
    out2 = m.recall(MemoryKind.SEMANTIC, v1, k=1)
    assert out2[0]["memory"]["access_count"] == 1


def test_importance_reranks(mem):
    m, clock, rng = mem
    base = _vec(rng)
    near = base + 0.01 * _vec(rng)
    m.remember_fact(near, "low importance twin", importance=0.0)
    b = m.remember_fact(near + 0.01 * _vec(rng), "high importance twin", importance=1.0)
    out = m.recall(MemoryKind.SEMANTIC, base, k=2)
    assert out[0]["id"] == b  # importance outweighs tiny similarity gap


def test_ttl_expiry(mem):
    m, clock, rng = mem
    m.remember_event(_vec(rng), "ephemeral", ttl_s=60)
    keep = m.remember_event(_vec(rng), "durable")
    clock.t += 120
    assert m.expire() == 1
    ids = {r["id"] for r in m.recall_window(0)}
    assert ids == {keep}


def test_recall_window_temporal_order(mem):
    m, clock, rng = mem
    ids = []
    for i in range(5):
        clock.t = 1000.0 + i * 10
        ids.append(m.remember_event(_vec(rng), f"event {i}"))
    rows = m.recall_window(since=1015.0, until=1035.0)
    assert [r["content"] for r in rows] == ["event 2", "event 3"]


def test_procedural_reinforcement(mem):
    m, clock, rng = mem
    base = _vec(rng)
    good = m.remember_procedure(base + 0.01 * _vec(rng), "good skill", 0.5)
    bad = m.remember_procedure(base + 0.01 * _vec(rng), "bad skill", 0.5)
    for _ in range(5):
        m.reinforce(good, True)
        m.reinforce(bad, False)
    out = m.recall(MemoryKind.PROCEDURAL, base, k=2)
    assert out[0]["id"] == good
    with pytest.raises(KeyError):
        m.reinforce(999, True)


def test_capacity_eviction(tmp_db_dir, rng):
    db = Database.open(tmp_db_dir)
    clock = Clock()
    m = AgentMemory(db, dim=8, capacity=5, now=clock)
    keep = m.remember_fact(rng.standard_normal(8), "vital", importance=1.0)
    for i in range(7):
        clock.t += 1
        m.remember_fact(rng.standard_normal(8), f"noise {i}", importance=0.01)
    assert m.stats()[MemoryKind.SEMANTIC]["count"] == 5
    assert m._coll(MemoryKind.SEMANTIC).get(keep) is not None


def test_snapshot_rollback(mem):
    m, clock, rng = mem
    a = m.remember_fact(_vec(rng), "before snapshot", importance=0.8)
    sid = m.snapshot("v1")
    m.remember_fact(_vec(rng), "after snapshot")
    m.forget(MemoryKind.SEMANTIC, a)
    assert m.stats()[MemoryKind.SEMANTIC]["count"] == 1
    assert sid in m.list_snapshots()
    m.rollback(sid)
    coll = m._coll(MemoryKind.SEMANTIC)
    assert coll.count() == 1
    assert coll.get(a)[1]["content"] == "before snapshot"
    # ids after rollback continue without collision
    new = m.remember_fact(_vec(rng), "post rollback")
    assert new != a
    with pytest.raises(KeyError):
        m.rollback("missing")


def test_memory_persists_across_reopen(tmp_db_dir, rng):
    db = Database.open(tmp_db_dir)
    m = AgentMemory(db, dim=8, now=Clock())
    a = m.remember_fact(rng.standard_normal(8).astype(np.float32), "persisted")
    for kind in MemoryKind.ALL:
        m._coll(kind).flush()
    db.close()
    db2 = Database.open(tmp_db_dir)
    m2 = AgentMemory(db2, dim=8, now=Clock())
    got = m2._coll(MemoryKind.SEMANTIC).get(a)
    assert got is not None and got[1]["content"] == "persisted"
    assert m2.remember_fact(rng.standard_normal(8), "new") == a + 1


def _drive(mem_cls, db, clock):
    """One seeded script of memories and recalls; returns what it recalled."""
    rng = np.random.default_rng(11)
    m = mem_cls(db, dim=8, capacity=40, now=clock)
    base = rng.standard_normal(8).astype(np.float32)
    for i in range(30):
        clock.t = 1000.0 + 37.0 * i
        v = (base + 0.3 * rng.standard_normal(8)).astype(np.float32)
        m.remember_fact(v, f"fact {i}", importance=(i % 5) / 4)
        m.remember_event(v, f"event {i}", ttl_s=500.0 if i % 3 == 0 else None)
        m.remember_procedure(v, f"skill {i}", importance=0.5)
    for i in range(0, 30, 4):
        m.reinforce(i, success=i % 8 == 0)
    clock.t = 2500.0
    out = [m.expire()]
    for kind in MemoryKind.ALL:
        for half_life in (600.0, 7 * 86400.0):
            out.append(m.recall(kind, base, k=6, half_life_s=half_life, min_importance=0.2))
    out.append(m.recall_window(since=1200.0, until=1800.0))
    out.append(m.stats())
    return out


def test_recall_equals_reference_with_a_fixed_clock(tmp_path):
    ref_db = velesdb_tpu.Database.open(str(tmp_path / "ref"))
    port_db = Database.open(str(tmp_path / "port"))
    ref = _drive(velesdb_tpu.agent.AgentMemory, ref_db, Clock())
    got = _drive(AgentMemory, port_db, Clock())
    assert got[0] == ref[0] and got[-2:] == ref[-2:]  # expiry, the window, stats
    for g_rows, r_rows in zip(got[1:-2], ref[1:-2]):
        assert [r["id"] for r in g_rows] == [r["id"] for r in r_rows]
        for g, r in zip(g_rows, r_rows):
            assert g["content"] == r["content"] and g["memory"] == r["memory"]
            for key in ("similarity", "priority"):
                assert g[key] == pytest.approx(r[key], rel=RTOL, abs=RTOL)
    ref_db.close()
    port_db.close()
