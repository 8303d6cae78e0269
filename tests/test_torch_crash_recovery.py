"""Crash recovery against the port: kill a writer mid-stream, validate WAL
replay.

``tests/test_crash_recovery.py`` case for case, by name, on
``velesdb_tpu_torch`` (the database on the CPU): a subprocess that imports
only the port writes continuously, gets SIGKILLed, and the reopened store
must contain a prefix-consistent state; torn/corrupt WAL tails must be
dropped quietly. This is the durability behind the REST server's ``PUT`` and
``DELETE`` acknowledgements. One more case: a WAL cut by a SIGKILL in the
reference's writer replays in the port to the same rows the reference
replays.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np

import velesdb_tpu
from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.storage.payload_log import PayloadLog
from velesdb_tpu_torch.storage.vector_store import VectorStore

_WRITE_LOOP = r"""
c = db.create_collection("c", dim=8)
rng = np.random.default_rng(0)
i = 0
print("READY", flush=True)
while True:
    c.upsert(i, rng.standard_normal(8).astype(np.float32), {{"i": i}})
    print(i, flush=True)
    i += 1
"""

# the port's writer, with jax, lark and the reference blocked from import
WRITER = r"""
import sys
class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "lark", "velesdb_tpu"):
            raise ImportError(f"{{name}} is blocked")
sys.meta_path.insert(0, Blocked())
import numpy as np
sys.path.insert(0, {repo!r})
from velesdb_tpu_torch.database import Database

db = Database.open({path!r}, device="cpu")
""" + _WRITE_LOOP

# tests/test_crash_recovery.py's writer, on the reference
REF_WRITER = r"""
import sys, numpy as np
sys.path.insert(0, {repo!r})
from velesdb_tpu.database import Database

db = Database.open({path!r})
""" + _WRITE_LOOP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kill_writer(script, dbdir):
    """Run a writer until it acks 50 upserts, SIGKILL it; returns the last
    acked id."""
    proc = subprocess.Popen(
        [sys.executable, "-c", script.format(repo=REPO, path=dbdir)],
        stdout=subprocess.PIPE,
        text=True,
    )
    acked = -1
    deadline = time.time() + 120
    try:
        assert proc.stdout.readline().strip() == "READY"
        while acked < 50 and time.time() < deadline:
            line = proc.stdout.readline().strip()
            if line:
                acked = int(line)
    finally:
        proc.kill()
        proc.wait(timeout=60)
        proc.stdout.close()
    assert acked >= 50, "writer too slow"
    return acked


def test_sigkill_mid_write_replays_prefix(tmp_path):
    dbdir = str(tmp_path / "db")
    acked = _kill_writer(WRITER, dbdir)

    # reopen: WAL replay must restore at least every acked write
    db = Database.open(dbdir, device="cpu")
    c = db.get_collection("c")
    assert c.count() >= acked + 1
    for i in range(acked + 1):
        got = c.get(i)
        assert got is not None, f"acked write {i} lost"
        assert got[1] == {"i": i}
    # and the store must be fully usable after recovery
    hits = c.search(c.get(acked)[0], 1)
    assert hits[0].id == acked
    db.close()


def test_torn_vector_wal_tail_dropped(tmp_path):
    d = str(tmp_path / "s")
    os.makedirs(d)
    vs = VectorStore(d, 4, create=True)
    vs.store(1, np.ones(4, np.float32))
    vs.flush()  # checkpoint: id 1 durable in the bin/index
    vs.store(2, np.full(4, 2.0, np.float32))  # lives only in the WAL
    vs._wal_file.flush()
    vs._wal_file.close()  # skip clean close/flush: simulate crash
    del vs._mmap

    # truncate the WAL mid-record (torn write)
    wal = os.path.join(d, "vectors.wal")
    size = os.path.getsize(wal)
    with open(wal, "r+b") as f:
        f.truncate(size - 3)

    vs2 = VectorStore(d, 4)
    assert 1 in vs2 and 2 not in vs2  # torn record dropped, prefix intact
    vs2.store(3, np.full(4, 3.0, np.float32))
    assert 3 in vs2
    vs2.close()


def test_corrupt_wal_crc_dropped(tmp_path):
    d = str(tmp_path / "s")
    os.makedirs(d)
    vs = VectorStore(d, 4, create=True)
    vs.flush()
    vs.store(7, np.full(4, 7.0, np.float32))
    vs._wal_file.flush()
    vs._wal_file.close()
    del vs._mmap

    wal = os.path.join(d, "vectors.wal")
    with open(wal, "r+b") as f:
        f.seek(-2, os.SEEK_END)  # flip a byte in the record body
        b = f.read(1)
        f.seek(-2, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))

    vs2 = VectorStore(d, 4)
    assert 7 not in vs2  # CRC mismatch -> record rejected
    vs2.close()


def test_payload_log_recovery(tmp_path):
    d = str(tmp_path / "p")
    os.makedirs(d)
    log = PayloadLog(d)
    for i in range(20):
        log.store(i, {"v": i})
    log.flush()
    log.store(20, {"v": 20})  # post-snapshot WAL entry
    # abandon without close (crash)
    log2 = PayloadLog(d)
    assert log2.retrieve(13) == {"v": 13}
    assert log2.retrieve(20) == {"v": 20}


def test_delete_survives_crash(tmp_path):
    d = str(tmp_path / "s")
    os.makedirs(d)
    vs = VectorStore(d, 4, create=True)
    vs.store(1, np.ones(4, np.float32))
    vs.store(2, np.full(4, 2.0, np.float32))
    vs.flush()
    vs.delete(1)  # only in WAL
    vs._wal_file.flush()
    del vs._mmap

    vs2 = VectorStore(d, 4)
    assert 1 not in vs2 and 2 in vs2
    vs2.close()


def _replayed(col):
    slot_ids, valid = col.vectors.occupancy()
    out = {}
    for vid in sorted(int(v) for v in slot_ids[valid]):
        vec, payload = col.get(vid)
        out[vid] = (np.asarray(vec, np.float32).tobytes(), payload)
    return out


def test_reference_writer_killed_replays_same_prefix_in_port(tmp_path):
    dbdir = str(tmp_path / "db")
    acked = _kill_writer(REF_WRITER, dbdir)
    # each package opens its own copy of the crashed directory
    shutil.copytree(dbdir, str(tmp_path / "port"))
    ref_db = velesdb_tpu.Database.open(dbdir)
    port_db = Database.open(str(tmp_path / "port"), device="cpu")
    want = _replayed(ref_db.get_collection("c"))
    got = _replayed(port_db.get_collection("c"))
    assert got == want
    assert len(got) >= acked + 1 and all(got[i][1] == {"i": i} for i in range(acked + 1))
    c = port_db.get_collection("c")
    assert c.search(c.get(acked)[0], 1)[0].id == acked
    ref_db.close()
    port_db.close()
