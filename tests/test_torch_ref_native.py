"""Native C++ WAL codec: byte-compat with the python framing, torn-tail and
corruption semantics, and the VectorStore fast paths it unlocks.

Counterpart of the reference's native storage-layer tests (mmap.rs WAL
co-located tests). If no compiler is available the codec reports
unavailable and every caller falls back — that fallback is exercised too.

The reference's ``tests/test_native.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made. The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""

import struct
import zlib

import numpy as np
import pytest

from velesdb_tpu_torch.native import wal_codec

HDR = struct.Struct("<BBQII")


@pytest.fixture(scope="module")
def codec():
    c = wal_codec()
    if not c.available:
        pytest.skip("no C++ compiler available")
    return c


def _py_frames(ids, vecs):
    out = b""
    for vid, vec in zip(ids, vecs):
        body = vec.tobytes()
        out += HDR.pack(0x56, 1, int(vid), vec.shape[0], zlib.crc32(body)) + body
    return out


def test_frame_batch_matches_python_bytes(codec):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1 << 48, 17)
    vecs = rng.standard_normal((17, 33)).astype(np.float32)
    assert codec.frame_batch(ids, vecs) == _py_frames(ids, vecs)


def test_scan_roundtrip_torn_and_corrupt(codec):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1 << 40, 9)
    vecs = rng.standard_normal((9, 8)).astype(np.float32)
    framed = codec.frame_batch(ids, vecs)
    sids, ops, offs, dims, consumed = codec.scan(framed)
    assert list(sids) == [int(v) for v in ids]
    assert consumed == len(framed) and np.all(ops == 1) and np.all(dims == 8)
    # bodies recoverable from offsets
    v3 = np.frombuffer(framed, np.float32, count=8, offset=int(offs[3]))
    np.testing.assert_array_equal(v3, vecs[3])
    # torn tail: mid-record cut keeps only complete records
    sids2, *_, cons2 = codec.scan(framed[:-3])
    assert len(sids2) == 8
    # corrupt byte in record 5's body stops the scan there
    rec = 18 + 32
    bad = bytearray(framed)
    bad[5 * rec + 20] ^= 0xFF
    sids3, *_ = codec.scan(bytes(bad))
    assert len(sids3) == 5


def test_extract_bodies(codec):
    rng = np.random.default_rng(2)
    ids = np.arange(50)
    vecs = rng.standard_normal((50, 16)).astype(np.float32)
    framed = codec.frame_batch(ids, vecs)
    out = codec.extract_bodies(framed, 50, 16)
    np.testing.assert_array_equal(out, vecs)


def test_store_batch_native_equals_python(tmp_path):
    """The WAL written through the native path replays identically through
    the python path (and vice versa)."""
    import velesdb_tpu_torch.storage.vector_store as m

    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((500, 24)).astype(np.float32)

    d1 = str(tmp_path / "native")
    vs = m.VectorStore(d1, 24, create=True)
    vs.store_batch(range(500), vecs)
    vs.delete(7)
    # replay with the python scanner
    saved = m._native_codec
    m._native_codec = lambda: None
    try:
        vs2 = m.VectorStore(d1, 24)
        assert len(vs2) == 499 and 7 not in vs2
        np.testing.assert_allclose(vs2.retrieve(123), vecs[123])
    finally:
        m._native_codec = saved
        vs.close()
        vs2.close()

    # python-written WAL replays through the native scanner
    d2 = str(tmp_path / "python")
    m._native_codec = lambda: None
    try:
        vs3 = m.VectorStore(d2, 24, create=True)
        vs3.store_batch(range(300), vecs[:300])
    finally:
        m._native_codec = saved
    vs4 = m.VectorStore(d2, 24)
    assert len(vs4) == 300
    np.testing.assert_allclose(vs4.retrieve(10), vecs[10])
    vs3.close()
    vs4.close()


def test_bulk_load_recovery_fast_path(tmp_path):
    """All-new unique upserts recover via the vectorized path with
    identical results."""
    from velesdb_tpu_torch.storage.vector_store import VectorStore

    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((2000, 12)).astype(np.float32)
    d = str(tmp_path / "bulk")
    vs = VectorStore(d, 12, create=True)
    vs.store_batch(range(1000, 3000), vecs)
    vs2 = VectorStore(d, 12)
    assert len(vs2) == 2000
    np.testing.assert_allclose(vs2.retrieve(1500), vecs[500])
    vs.close()
    vs2.close()
