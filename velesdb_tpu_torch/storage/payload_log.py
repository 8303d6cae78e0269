"""Append-only payload storage: WAL + CRC-validated snapshots.

Counterpart of ``velesdb-core/src/storage/log_payload.rs`` (``LogPayloadStorage``,
``log_payload.rs:83``): JSON payloads are appended to ``payloads.log`` and
periodically checkpointed into ``payloads.snapshot`` (magic ``VSNP``, version,
WAL position, entry count, CRC32 — ``log_payload.rs:17-50``). On open the
snapshot is loaded and the log tail after the recorded position is replayed;
torn tail records are dropped.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

__all__ = ["PayloadLog"]

_SNAP_MAGIC = b"VSNP"
_SNAP_VERSION = 2  # v2 = dictionary-compressed body; v1 (plain) still readable
_REC = struct.Struct("<BQII")  # op u8, id u64, len u32, crc u32
_OP_UPSERT = 1
_OP_DELETE = 2
_SNAPSHOT_DELTA_BYTES = 10 * 1024 * 1024  # snapshot every 10MB of log growth


class PayloadLog:
    """id -> JSON payload store with WAL durability and snapshots."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._log_path = os.path.join(directory, "payloads.log")
        self._snap_path = os.path.join(directory, "payloads.snapshot")
        self.payloads: dict[int, dict] = {}
        self._snap_log_pos = 0
        self._load()
        self._log = open(self._log_path, "ab")

    # -- recovery ----------------------------------------------------------

    def _load(self) -> None:
        if os.path.exists(self._snap_path):
            try:
                self._load_snapshot()
            except (ValueError, OSError, json.JSONDecodeError):
                # corrupt snapshot: fall back to full log replay
                self.payloads = {}
                self._snap_log_pos = 0
        self._replay_log(self._snap_log_pos)

    def _load_snapshot(self) -> None:
        with open(self._snap_path, "rb") as f:
            raw = f.read()
        if raw[:4] != _SNAP_MAGIC:
            raise ValueError("bad snapshot magic")
        version, log_pos, n_entries, crc = struct.unpack_from("<IQII", raw, 4)
        if version not in (1, _SNAP_VERSION):
            raise ValueError(f"unsupported snapshot version {version}")
        body = raw[4 + 20 :]
        if zlib.crc32(body) != crc:
            raise ValueError("snapshot CRC mismatch")
        if version >= 2:
            from velesdb_tpu_torch.compression import decompress

            (dict_len,) = struct.unpack_from("<I", body, 0)
            zdict = body[4 : 4 + dict_len]
            body = decompress(body[4 + dict_len :], zdict)
        entries = json.loads(body.decode("utf-8"))
        if len(entries) != n_entries:
            raise ValueError("snapshot entry count mismatch")
        self.payloads = {int(k): v for k, v in entries.items()}
        self._snap_log_pos = log_pos

    def _replay_log(self, start: int) -> None:
        if not os.path.exists(self._log_path):
            return
        with open(self._log_path, "rb") as f:
            f.seek(start)
            data = f.read()
        pos = 0
        while pos + _REC.size <= len(data):
            op, pid, length, crc = _REC.unpack_from(data, pos)
            body = data[pos + _REC.size : pos + _REC.size + length]
            if len(body) != length or zlib.crc32(body) != crc:
                break  # torn tail
            pos += _REC.size + length
            if op == _OP_UPSERT:
                self.payloads[pid] = json.loads(body.decode("utf-8"))
            elif op == _OP_DELETE:
                self.payloads.pop(pid, None)

    # -- mutations ---------------------------------------------------------

    def _append(self, op: int, pid: int, payload) -> None:
        body = b"" if payload is None else json.dumps(payload).encode("utf-8")
        self._log.write(_REC.pack(op, pid, len(body), zlib.crc32(body)))
        self._log.write(body)
        self._log.flush()
        if self._log.tell() - self._snap_log_pos > _SNAPSHOT_DELTA_BYTES:
            self.snapshot()

    def store(self, pid: int, payload: dict) -> None:
        pid = int(pid)
        self._append(_OP_UPSERT, pid, payload)
        self.payloads[pid] = payload

    def delete(self, pid: int) -> bool:
        pid = int(pid)
        if pid not in self.payloads:
            return False
        self._append(_OP_DELETE, pid, None)
        del self.payloads[pid]
        return True

    def retrieve(self, pid: int):
        return self.payloads.get(int(pid))

    def __len__(self) -> int:
        return len(self.payloads)

    # -- durability --------------------------------------------------------

    def snapshot(self) -> None:
        """Write a CRC32-validated, dictionary-compressed full snapshot
        (``log_payload.rs:17-50`` + ``compression/`` dictionary coding)."""
        from velesdb_tpu_torch.compression import compress, train_dictionary

        log_pos = self._log.tell() if not self._log.closed else 0
        plain = json.dumps({str(k): v for k, v in self.payloads.items()}).encode()
        samples = [
            json.dumps(v).encode() for _, v in list(self.payloads.items())[:256]
        ]
        zdict = train_dictionary(samples)
        body = struct.pack("<I", len(zdict)) + zdict + compress(plain, zdict)
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_SNAP_MAGIC)
            f.write(
                struct.pack(
                    "<IQII", _SNAP_VERSION, log_pos, len(self.payloads), zlib.crc32(body)
                )
            )
            f.write(body)
        os.replace(tmp, self._snap_path)
        self._snap_log_pos = log_pos

    def compact(self) -> None:
        """Snapshot then truncate the log (``storage/compaction.rs`` analog)."""
        self._log.truncate(0)
        self._log.seek(0)
        self._snap_log_pos = 0
        self.snapshot()

    def flush(self) -> None:
        self._log.flush()

    def close(self) -> None:
        self.snapshot()
        self._log.close()
