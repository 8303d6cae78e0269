"""Storage layer tests: memmap store, WAL replay, payload log + snapshots.

Mirrors the reference's storage tests + ``tests/crash_recovery`` suite
(SURVEY.md §4): mutations survive reopen, torn WAL tails are dropped,
snapshots are CRC-validated.

The reference's ``tests/test_storage.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made. The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""

import os

import numpy as np
import pytest

from velesdb_tpu_torch.storage.payload_log import PayloadLog
from velesdb_tpu_torch.storage.vector_store import VectorStore


def test_store_retrieve_roundtrip(tmp_path, rng):
    store = VectorStore(str(tmp_path), 32, create=True)
    v = rng.standard_normal(32).astype(np.float32)
    store.store(7, v)
    np.testing.assert_array_equal(store.retrieve(7), v)
    assert store.retrieve(8) is None
    assert len(store) == 1
    store.close()


def test_wal_replay_without_flush(tmp_path, rng):
    """Mutations not flushed to the index survive via WAL replay."""
    store = VectorStore(str(tmp_path), 16, create=True)
    store.flush()  # checkpoint empty state
    vecs = rng.standard_normal((5, 16)).astype(np.float32)
    for i, v in enumerate(vecs):
        store.store(i, v)
    store.delete(3)
    # simulate crash: no flush/close — drop the handle
    store._wal_file.close()
    del store._mmap

    store2 = VectorStore(str(tmp_path), 16)
    assert len(store2) == 4
    np.testing.assert_array_equal(store2.retrieve(0), vecs[0])
    assert store2.retrieve(3) is None
    store2.close()


def test_wal_torn_tail_dropped(tmp_path, rng):
    store = VectorStore(str(tmp_path), 8, create=True)
    store.flush()
    store.store(1, np.ones(8, np.float32))
    store.store(2, np.full(8, 2.0, np.float32))
    store._wal_file.close()
    del store._mmap
    # corrupt: truncate the WAL mid-record
    wal = os.path.join(str(tmp_path), "vectors.wal")
    size = os.path.getsize(wal)
    with open(wal, "r+b") as f:
        f.truncate(size - 7)
    store2 = VectorStore(str(tmp_path), 8)
    assert 1 in store2 and 2 not in store2
    store2.close()


def test_slot_reuse_after_delete(tmp_path, rng):
    store = VectorStore(str(tmp_path), 4, create=True)
    store.store(1, np.ones(4, np.float32))
    slot1 = store.id_to_slot[1]
    store.delete(1)
    store.store(2, np.full(4, 2.0, np.float32))
    assert store.id_to_slot[2] == slot1
    store.close()


def test_growth_beyond_initial_capacity(tmp_path, rng):
    store = VectorStore(str(tmp_path), 768, create=True)
    cap0 = store.capacity
    n = cap0 + 10
    ids = np.arange(n)
    vecs = rng.standard_normal((n, 768)).astype(np.float32)
    store.store_batch(ids, vecs)
    assert store.capacity > cap0
    np.testing.assert_array_equal(store.retrieve(n - 1), vecs[-1])
    store.flush()
    store.close()
    store2 = VectorStore(str(tmp_path), 768)
    np.testing.assert_array_equal(store2.retrieve(cap0 + 5), vecs[cap0 + 5])
    store2.close()


def test_dim_mismatch_rejected(tmp_path):
    store = VectorStore(str(tmp_path), 8, create=True)
    with pytest.raises(ValueError):
        store.store(1, np.ones(9, np.float32))
    store.close()
    with pytest.raises(ValueError):
        VectorStore(str(tmp_path), 16)


def test_payload_log_roundtrip(tmp_path):
    log = PayloadLog(str(tmp_path))
    log.store(1, {"title": "hello", "price": 10})
    log.store(2, {"title": "world"})
    log.delete(1)
    log.close()
    log2 = PayloadLog(str(tmp_path))
    assert log2.retrieve(1) is None
    assert log2.retrieve(2) == {"title": "world"}
    log2.close()


def test_payload_snapshot_and_tail_replay(tmp_path):
    log = PayloadLog(str(tmp_path))
    log.store(1, {"a": 1})
    log.snapshot()
    log.store(2, {"b": 2})  # after snapshot -> replayed from log tail
    log._log.close()  # crash without close()
    log2 = PayloadLog(str(tmp_path))
    assert log2.retrieve(1) == {"a": 1}
    assert log2.retrieve(2) == {"b": 2}
    log2.close()


def test_payload_corrupt_snapshot_falls_back_to_log(tmp_path):
    log = PayloadLog(str(tmp_path))
    log.store(1, {"a": 1})
    log.close()  # writes snapshot
    snap = os.path.join(str(tmp_path), "payloads.snapshot")
    with open(snap, "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff\xff")  # corrupt body -> CRC mismatch
    log2 = PayloadLog(str(tmp_path))
    assert log2.retrieve(1) == {"a": 1}  # recovered from full log replay
    log2.close()


def test_payload_compact(tmp_path):
    log = PayloadLog(str(tmp_path))
    for i in range(100):
        log.store(i, {"v": i})
    log.compact()
    assert os.path.getsize(os.path.join(str(tmp_path), "payloads.log")) == 0
    log.close()
    log2 = PayloadLog(str(tmp_path))
    assert len(log2) == 100
    log2.close()


def test_id_range_validated_at_boundary(tmp_path, rng):
    """Ids must fit int64 (occupancy's -1 sentinel, the native codec's
    int64 column, the npz id-index are all int64): out-of-range ids fail
    FAST with ValueError at store time, not deep in a later flush with
    OverflowError (code-review r4)."""
    import pytest

    from velesdb_tpu_torch.storage.vector_store import VectorStore

    store = VectorStore(str(tmp_path), 8, create=True)
    v = rng.standard_normal(8).astype(np.float32)
    with pytest.raises(ValueError, match="out of range"):
        store.store(1 << 63, v)
    with pytest.raises(ValueError, match="out of range"):
        store.store(-1, v)
    with pytest.raises(ValueError, match="out of range"):
        store.store_batch([1, 1 << 63], np.stack([v, v]))
    with pytest.raises(ValueError, match="out of range"):
        store.delete(1 << 63)
    # the max legal id round-trips through flush + reopen (npz int64)
    big = (1 << 63) - 1
    store.store(big, v)
    store.flush()
    store.close()
    store2 = VectorStore(str(tmp_path), 8)
    got = store2.retrieve(big)
    np.testing.assert_allclose(got, v)
    store2.close()
