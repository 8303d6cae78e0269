"""Durable vector storage: memmap data file + write-ahead log.

Copied from ``velesdb_tpu/storage/vector_store.py`` (same on-disk format);
counterpart of ``velesdb-core/src/storage/mmap.rs`` (``MmapStorage``,
``mmap.rs:44``): vectors live in a ``np.memmap``-backed ``vectors.bin`` with an
id->slot index and a binary WAL (``vectors.wal``) replayed on open. Durability
is host-side by design — the device only ever sees read-only snapshots of the
slot array (SURVEY.md §7 hard part (f)).

Layout on disk (per collection directory):

- ``vectors.bin``   — ``[capacity, dim] float32`` slots (16MB initial /
  2x growth, mirroring ``mmap.rs`` prealloc policy)
- ``vectors.idx``   — JSON: id->slot map, free slots, count, capacity
- ``vectors.wal``   — CRC32-framed binary records of mutations since the last
  flush (replayed on open; truncated after flush)
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

__all__ = ["VectorStore"]

_MAGIC = 0x56
_OP_UPSERT = 1
_OP_DELETE = 2
# record header: magic u8, op u8, id u64, dim u32, crc u32
_HDR = struct.Struct("<BBQII")

_INITIAL_SLOTS_BYTES = 16 * 1024 * 1024  # 16MB initial file, like mmap.rs

_MAX_ID = (1 << 63) - 1


def _check_id(vid: int) -> None:
    """Ids must fit int64 AND the WAL's u64 field: every array path
    (occupancy's -1 sentinel, the native codec's int64 column, the npz
    id-index) is int64, so ids in [2**63, 2**64) would crash deep in a
    later flush/checkpoint instead of at the API boundary, and negative
    ids would corrupt the u64 WAL field (code-review r4)."""
    if not 0 <= vid <= _MAX_ID:
        raise ValueError(
            f"vector id {vid} out of range: ids must be in [0, 2**63)"
        )


def _native_codec():
    """The C++ WAL codec, or None (pure-Python fallback paths)."""
    try:
        from velesdb_tpu_torch.native import wal_codec

        c = wal_codec()
        return c if c.available else None
    except Exception:
        return None


class VectorStore:
    """Append-mostly slot store of f32 vectors keyed by u64 ids.

    Per-operation latency stats live in :data:`metrics` (``storage/metrics.rs``
    analog) — store/retrieve/flush record into named LatencyStats.
    """

    def __init__(self, directory: str, dim: int, create: bool = False):
        from velesdb_tpu_torch.utils.metrics import LatencyStats

        self.metrics = {
            "store": LatencyStats(),
            "retrieve": LatencyStats(),
            "flush": LatencyStats(),
        }
        self.dir = directory
        self.dim = int(dim)
        self._bin_path = os.path.join(directory, "vectors.bin")
        self._idx_path = os.path.join(directory, "vectors.idx")
        self._wal_path = os.path.join(directory, "vectors.wal")
        self.id_to_slot: dict[int, int] = {}
        self._free_slots: list[int] = []
        self._next_slot = 0  # high-water mark
        self.version = 0  # monotone mutation counter (index staleness checks)
        self._occ_cache = None  # (version, slot_ids, valid) — see occupancy()
        self._capacity = 0
        self._mmap: np.memmap | None = None
        if create and not os.path.exists(self._bin_path):
            os.makedirs(directory, exist_ok=True)
            initial = max(1024, _INITIAL_SLOTS_BYTES // (4 * self.dim))
            self._allocate(initial)
            self._save_index()
        else:
            self._load_index()
            self._open_mmap()
            self._replay_wal()
        self._wal_file = open(self._wal_path, "ab")

    # -- file plumbing -----------------------------------------------------

    def _allocate(self, capacity: int) -> None:
        self._capacity = capacity
        self._mmap = np.memmap(
            self._bin_path, dtype=np.float32, mode="w+", shape=(capacity, self.dim)
        )

    def _open_mmap(self) -> None:
        self._mmap = np.memmap(
            self._bin_path,
            dtype=np.float32,
            mode="r+",
            shape=(self._capacity, self.dim),
        )

    def _grow(self, needed: int) -> None:
        new_cap = max(self._capacity * 2, needed, 1024)
        # no msync here: dirty pages stay coherent in the page cache across
        # truncate + re-mmap; crash durability mid-grow is the WAL's job
        # (flush() still syncs at the explicit durability points)
        del self._mmap
        # truncate EXTENDS the file in place — the existing bytes never
        # leave the page cache (the old read-into-RAM + write-back copied
        # the whole store on every doubling: 6.4s of a 1M x 128D chunked
        # ingest, r4 profile)
        with open(self._bin_path, "r+b") as f:
            f.truncate(new_cap * 4 * self.dim)
        self._mmap = np.memmap(
            self._bin_path, dtype=np.float32, mode="r+", shape=(new_cap, self.dim)
        )
        self._capacity = new_cap

    def _save_index(self) -> None:
        """Atomic id-index snapshot, BINARY (npz): the JSON encoding of a
        1M-entry id map was 5.5s per flush (4M iterencode calls, r4
        profile); two int64 columns serialize in ~50ms. Legacy JSON
        artifacts still load (see _load_index)."""
        tmp = self._idx_path + ".tmp"
        ids = np.fromiter(self.id_to_slot.keys(), np.int64,
                          len(self.id_to_slot))
        slots = np.fromiter(self.id_to_slot.values(), np.int64,
                            len(self.id_to_slot))
        with open(tmp, "wb") as f:
            np.savez(
                f,
                dim=np.int64(self.dim),
                capacity=np.int64(self._capacity),
                ids=ids,
                slots=slots,
                free=np.asarray(self._free_slots, np.int64),
                next_slot=np.int64(self._next_slot),
                version=np.int64(self.version),
            )
        os.replace(tmp, self._idx_path)

    def _load_index(self) -> None:
        with open(self._idx_path, "rb") as f:
            magic = f.read(4)
        if magic[:2] == b"PK":  # npz (zip) — current format
            idx = np.load(self._idx_path)
            if int(idx["dim"]) != self.dim:
                raise ValueError(
                    f"dimension mismatch: store has {int(idx['dim'])}, "
                    f"expected {self.dim}"
                )
            self._capacity = int(idx["capacity"])
            self.id_to_slot = dict(
                zip(idx["ids"].tolist(), idx["slots"].tolist())
            )
            self._free_slots = idx["free"].tolist()
            self._next_slot = int(idx["next_slot"])
            self.version = int(idx["version"])
            return
        with open(self._idx_path) as f:  # legacy JSON artifact
            idx = json.load(f)
        if idx["dim"] != self.dim:
            raise ValueError(
                f"dimension mismatch: store has {idx['dim']}, expected {self.dim}"
            )
        self._capacity = idx["capacity"]
        self.id_to_slot = {int(k): v for k, v in idx["ids"].items()}
        self._free_slots = list(idx["free"])
        self._next_slot = idx.get("next_slot", len(self.id_to_slot) + len(self._free_slots))
        self.version = idx.get("version", 0)

    # -- WAL ---------------------------------------------------------------

    def _wal_append(self, op: int, vid: int, vec: np.ndarray | None) -> None:
        body = b"" if vec is None else vec.tobytes()
        dim = 0 if vec is None else vec.shape[0]
        crc = zlib.crc32(body)
        self._wal_file.write(_HDR.pack(_MAGIC, op, vid, dim, crc))
        self._wal_file.write(body)
        self._wal_file.flush()

    def _replay_wal(self) -> None:
        """Replay mutations recorded after the last flush. Torn/corrupt tail
        records are dropped (crash-recovery semantics of ``mmap.rs`` WAL)."""
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, "rb") as f:
            data = f.read()
        codec = _native_codec()
        if codec is not None:
            # native validated scan (CRC + framing in C++), python apply
            ids, ops, offs, dims, consumed = codec.scan(data)
            n = len(ids)
            if (
                n > 1
                and not self.id_to_slot
                and not self._free_slots
                and np.all(ops == _OP_UPSERT)
                and np.all(dims == self.dim)
                and len(np.unique(ids)) == n
            ):
                # bulk-load recovery: uniform records -> one strided view,
                # one contiguous memmap write (the per-record apply loop
                # costs ~10s per million rows)
                vecs = codec.extract_bodies(data, n, self.dim)
                if n > self._capacity:
                    self._grow(n)
                self._mmap[:n] = vecs
                self.id_to_slot.update(
                    zip((int(v) for v in ids), range(n))
                )
                self._next_slot = n
                self.version += n
                return
            for vid, op, off, dim in zip(ids, ops, offs, dims):
                if op == _OP_UPSERT and dim == self.dim:
                    vec = np.frombuffer(
                        data, np.float32, count=int(dim), offset=int(off)
                    )
                    self._apply_upsert(int(vid), vec)
                elif op == _OP_DELETE:
                    self._apply_delete(int(vid))
            return
        pos = 0
        while pos + _HDR.size <= len(data):
            magic, op, vid, dim, crc = _HDR.unpack_from(data, pos)
            if magic != _MAGIC:
                break
            body = data[pos + _HDR.size : pos + _HDR.size + dim * 4]
            if len(body) != dim * 4 or zlib.crc32(body) != crc:
                break  # torn write at tail
            pos += _HDR.size + dim * 4
            if op == _OP_UPSERT:
                vec = np.frombuffer(body, dtype=np.float32)
                self._apply_upsert(vid, vec)
            elif op == _OP_DELETE:
                self._apply_delete(vid)

    # -- mutations ---------------------------------------------------------

    def _apply_upsert(self, vid: int, vec: np.ndarray) -> int:
        self.version += 1
        slot = self.id_to_slot.get(vid)
        if slot is None:
            if self._free_slots:
                slot = self._free_slots.pop()
            else:
                slot = self._next_slot
                self._next_slot += 1
                if slot >= self._capacity:
                    self._grow(slot + 1)
            self.id_to_slot[vid] = slot
        self._mmap[slot] = vec
        return slot

    def _apply_delete(self, vid: int) -> bool:
        slot = self.id_to_slot.pop(vid, None)
        if slot is None:
            return False
        self.version += 1
        self._free_slots.append(slot)
        return True

    def store(self, vid: int, vec: np.ndarray) -> int:
        vec = np.asarray(vec, dtype=np.float32)
        if vec.shape != (self.dim,):
            raise ValueError(f"expected dim {self.dim}, got {vec.shape}")
        _check_id(vid)
        with self.metrics["store"].timer():
            self._wal_append(_OP_UPSERT, vid, vec)
            return self._apply_upsert(vid, vec)

    def store_batch(self, ids, vecs: np.ndarray) -> list[int]:
        vecs = np.asarray(vecs, dtype=np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}], got {vecs.shape}")
        ids = [int(v) for v in ids]
        if ids:
            _check_id(min(ids))
            _check_id(max(ids))
        codec = _native_codec()
        if codec is not None and len(ids) > 1:
            # native batch framing: one buffer, one write, one flush —
            # replaces len(ids) python header/CRC round trips
            framed = codec.frame_batch(np.asarray(ids, np.int64), vecs)
            self._wal_file.write(framed)
            self._wal_file.flush()
            # vectorized apply for the bulk-load shape (all-new unique ids,
            # no freelist): one contiguous memmap write instead of N row
            # copies + N dict/python round trips
            if (
                not self._free_slots
                and len(set(ids)) == len(ids)
                and not any(v in self.id_to_slot for v in ids)
            ):
                start = self._next_slot
                end = start + len(ids)
                if end > self._capacity:
                    self._grow(end)
                self._mmap[start:end] = vecs
                self.id_to_slot.update(zip(ids, range(start, end)))
                self._next_slot = end
                self.version += len(ids)
                return list(range(start, end))
            return [self._apply_upsert(vid, vec) for vid, vec in zip(ids, vecs)]
        slots = []
        for vid, vec in zip(ids, vecs):
            self._wal_append(_OP_UPSERT, vid, vec)
            slots.append(self._apply_upsert(vid, vec))
        return slots

    def delete(self, vid: int) -> bool:
        _check_id(int(vid))
        self._wal_append(_OP_DELETE, int(vid), None)
        return self._apply_delete(int(vid))

    # -- reads -------------------------------------------------------------

    def retrieve(self, vid: int) -> np.ndarray | None:
        with self.metrics["retrieve"].timer():
            slot = self.id_to_slot.get(int(vid))
            if slot is None:
                return None
            return np.array(self._mmap[slot])

    def retrieve_batch(self, vids) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized fetch: ``(vectors [len, D], found mask)``. One fancy
        -index gather from the memmap instead of a per-id ``retrieve`` loop
        (the rerank hot path hydrates ~k*oversample rows per query)."""
        slots = np.fromiter(
            (self.id_to_slot.get(int(v), -1) for v in vids),
            dtype=np.int64,
            count=len(vids),
        )
        found = slots >= 0
        out = np.array(self._mmap[np.maximum(slots, 0)])
        out[~found] = 0.0
        return out, found

    def __contains__(self, vid) -> bool:
        return int(vid) in self.id_to_slot

    def __len__(self) -> int:
        return len(self.id_to_slot)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def used_slots(self) -> int:
        """High-water slot count (device arrays only need this many rows)."""
        return self._next_slot

    def slot_view(self) -> np.ndarray:
        """Zero-copy view of all slots ``[capacity, dim]`` (device upload
        source; parity with ``VectorSliceGuard`` zero-copy reads)."""
        return self._mmap

    def occupancy(self) -> tuple[np.ndarray, np.ndarray]:
        """(slot ids int64[used_slots] with -1 for empty, valid mask bool).

        Cached on ``version`` (every ``id_to_slot`` mutation bumps it):
        the dict walk costs ~6ms at 100K rows and sits in EVERY serve
        path's per-call hot loop (hydration, columnar id source — hybrid
        stage profile r5). Returned arrays are shared read-only views —
        every consumer only indexes them."""
        cached = self._occ_cache
        if cached is not None and cached[0] == self.version:
            return cached[1], cached[2]
        ids = np.full(self._next_slot, -1, dtype=np.int64)
        for vid, slot in self.id_to_slot.items():
            ids[slot] = vid
        valid = ids >= 0
        ids.setflags(write=False)
        valid.setflags(write=False)
        self._occ_cache = (self.version, ids, valid)
        return ids, valid

    def vacuum(self) -> int:
        """Compact the slot space: live rows migrate below the new high-water
        mark, free slots vanish (``compaction.rs:50,251`` / ``vacuum.rs``
        analog). Returns slots reclaimed. Slot numbers CHANGE — slot-keyed
        indexes must rebuild afterwards.
        """
        live = sorted(self.id_to_slot.items(), key=lambda kv: kv[1])
        reclaimed = self._next_slot - len(live)
        if reclaimed <= 0:
            self._free_slots = []
            return 0
        for new_slot, (vid, old_slot) in enumerate(live):
            if old_slot != new_slot:
                self._mmap[new_slot] = self._mmap[old_slot]
                self.id_to_slot[vid] = new_slot
        self._next_slot = len(live)
        self._free_slots = []
        self.version += 1
        self.flush()
        return reclaimed

    @property
    def fragmentation_ratio(self) -> float:
        """Free-slot fraction below the high-water mark (``compaction.rs:341``)."""
        if self._next_slot == 0:
            return 0.0
        return len(self._free_slots) / self._next_slot

    # -- durability --------------------------------------------------------

    def flush(self) -> None:
        """Flush memmap + index, then truncate the WAL (checkpoint)."""
        with self.metrics["flush"].timer():
            self._mmap.flush()
            self._save_index()
            self._wal_file.truncate(0)
            self._wal_file.seek(0)
            self._wal_file.flush()

    def close(self) -> None:
        self.flush()
        self._wal_file.close()
        del self._mmap
        self._mmap = None
