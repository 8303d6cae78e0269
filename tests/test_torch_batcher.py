"""Micro-batching coalescer in the port: concurrent single searches share
dispatches.

The first three tests are ``tests/test_batcher.py`` case for case, by name,
on ``velesdb_tpu_torch`` with the database on the CPU. The rest hold the
port's batcher and the reference's to the same behaviour on the same seeded
data: coalesced rows equal the direct ``search_batch`` rows (ids equal,
scores to rtol 1e-5 across the packages: fp32 in a different summation
order), mixed ``k`` is trimmed alike, and an error reaches every waiter.
Every wait carries a timeout.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import velesdb_tpu
from velesdb_tpu.utils.batcher import MicroBatcher as RefBatcher
from velesdb_tpu_torch import Database
from velesdb_tpu_torch.utils.batcher import MicroBatcher

TIMEOUT = 60
RTOL = 1e-5


@pytest.fixture
def coll(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    c = db.create_collection("c", dim=16)
    rng = np.random.default_rng(0)
    c.upsert_bulk(range(500), rng.standard_normal((500, 16)).astype(np.float32))
    yield c
    db.close()


def _run_threads(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_searches_coalesce_and_match_direct(coll):
    vecs = np.array(coll.vectors.slot_view()[:64])
    bt = MicroBatcher(coll, window_ms=25.0, max_batch=64)
    results = [None] * 32
    # park the worker on a first request so the rest land in one window
    barrier = threading.Barrier(32)

    def go(i):
        barrier.wait(timeout=TIMEOUT)
        results[i] = bt.search(vecs[i], k=3, timeout=TIMEOUT)

    _run_threads(go, 32)
    bt.stop()
    for i in range(32):
        assert results[i][0]["id"] == i  # self is nearest
        assert len(results[i]) == 3
    # at least some coalescing happened (timing-dependent, so be lenient)
    assert bt.batches < 32
    assert bt.coalesced > 0


def test_mixed_k_and_errors(coll):
    bt = MicroBatcher(coll, window_ms=5.0)
    v = np.array(coll.vectors.slot_view()[7])
    r5 = bt.search(v, k=5, timeout=TIMEOUT)
    r1 = bt.search(v, k=1, timeout=TIMEOUT)
    assert len(r5) == 5 and len(r1) == 1 and r1[0]["id"] == 7
    with pytest.raises(ValueError):
        bt.search(np.zeros(3, np.float32), k=2, timeout=TIMEOUT)  # dim mismatch propagates
    # the worker survives errors
    assert bt.search(v, k=2, timeout=TIMEOUT)[0]["id"] == 7
    bt.stop()


def test_server_route_uses_batcher(tmp_path, monkeypatch):
    monkeypatch.setenv("VELESDB_BATCH_WINDOW_MS", "10")
    from velesdb_tpu_torch.server.app import make_server

    httpd = make_server(str(tmp_path / "srv"), host="127.0.0.1", port=0, device="cpu")
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    app = httpd.app

    def req(method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(
            base + path, data=data, method=method,
            headers={"Content-Type": "application/json"} if data else {},
        )
        with urllib.request.urlopen(r, timeout=TIMEOUT) as resp:
            return json.loads(resp.read().decode())

    try:
        req("POST", "/collections", {"name": "c", "dim": 8})
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((100, 8)).astype(np.float32)
        req("PUT", "/collections/c/points",
            {"points": [{"id": i, "vector": vecs[i].tolist()} for i in range(100)]})

        out = [None] * 8

        def go(i):
            out[i] = req("POST", "/collections/c/search",
                         {"vector": vecs[i].tolist(), "k": 2})

        _run_threads(go, 8)
        for i in range(8):
            assert out[i]["results"][0]["id"] == i
        assert app.batch_window_ms == 10.0 and app._batchers  # engaged
    finally:
        httpd.shutdown()
        httpd.server_close()
        for bt in app._batchers.values():
            bt.stop()
        app.db.close()
        serving.join(timeout=TIMEOUT)


# -- the port's batcher against the reference's ---------------------------------


@pytest.fixture
def pair(tmp_path):
    """The same seeded 300 x 16 cosine collection in both packages, and 24
    queries: 16 near stored rows, 8 random."""
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    qs = np.concatenate([vecs[:16] + 0.05 * rng.standard_normal((16, 16)),
                         rng.standard_normal((8, 16))]).astype(np.float32)
    ref_db = velesdb_tpu.Database.open(str(tmp_path / "ref"))
    port_db = Database.open(str(tmp_path / "port"), device="cpu")
    cols = {}
    for tag, db in (("ref", ref_db), ("port", port_db)):
        c = db.create_collection("c", 16)
        c.upsert_bulk(range(300), vecs, [{"i": i} for i in range(300)])
        cols[tag] = c
    yield cols, qs
    ref_db.close()
    port_db.close()


def _coalesce(bt, qs, ks):
    """Every query from its own thread behind one barrier; returns the rows."""
    out = [None] * len(qs)
    barrier = threading.Barrier(len(qs))

    def go(i):
        barrier.wait(timeout=TIMEOUT)
        out[i] = bt.search(qs[i], k=ks[i], timeout=TIMEOUT)

    _run_threads(go, len(qs))
    bt.stop()
    return out


def _same_rows(got, want):
    assert [h["id"] for h in got] == [h["id"] for h in want]
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= RTOL * abs(w["score"]) + RTOL
        assert g["payload"] == w["payload"]


def test_coalesced_rows_equal_search_batch_in_both_packages(pair):
    cols, qs = pair
    got = {}
    for tag, cls in (("ref", RefBatcher), ("port", MicroBatcher)):
        bt = cls(cols[tag], window_ms=200.0, max_batch=64)
        rows = _coalesce(bt, qs, [10] * len(qs))
        assert bt.batches < len(qs) and bt.coalesced > 0, tag
        direct = cols[tag].search_batch(qs, k=10)
        for i in range(len(qs)):
            # the same package: the coalesced row is the direct row
            assert [(h["id"], h["score"]) for h in rows[i]] == \
                [(h["id"], h["score"]) for h in direct[i]], (tag, i)
        got[tag] = rows
    for r, p in zip(got["ref"], got["port"]):
        _same_rows(p, r)


def test_mixed_k_trimmed_alike_in_both_packages(pair):
    cols, qs = pair
    ks = [(1, 3, 5, 10)[i % 4] for i in range(len(qs))]
    got = {}
    for tag, cls in (("ref", RefBatcher), ("port", MicroBatcher)):
        rows = _coalesce(cls(cols[tag], window_ms=200.0, max_batch=64), qs, ks)
        direct = cols[tag].search_batch(qs, k=10)
        for i, row in enumerate(rows):
            assert len(row) == ks[i]
            assert [h["id"] for h in row] == [h["id"] for h in direct[i][: ks[i]]], (tag, i)
        got[tag] = rows
    for r, p in zip(got["ref"], got["port"]):
        _same_rows(p, r)


class _Failing:
    """A collection whose ``search_batch`` raises, counting its calls."""

    def __init__(self):
        self.calls = 0

    def search_batch(self, *a, **kw):
        self.calls += 1
        raise RuntimeError("device fault")


@pytest.mark.parametrize("cls", [RefBatcher, MicroBatcher], ids=["ref", "port"])
def test_error_reaches_every_waiter(cls):
    col = _Failing()
    bt = cls(col, window_ms=200.0, max_batch=64)
    errors = [None] * 12
    barrier = threading.Barrier(12)

    def go(i):
        barrier.wait(timeout=TIMEOUT)
        try:
            bt.search(np.zeros(4, np.float32), k=3, timeout=TIMEOUT)
        except RuntimeError as e:
            errors[i] = e

    _run_threads(go, 12)
    bt.stop()
    assert all(isinstance(e, RuntimeError) and "device fault" in str(e) for e in errors)
    assert col.calls < 12  # delivered from shared dispatches, not one call each


def test_lone_request_padded_batch_reaches_the_pd_core(tmp_path):
    """A lone request pads to b 8 with copies of itself, and numpy lays that
    batch out column-major; the pd core's kernel takes row-major queries, so
    the collection hands it a row-major copy (the CPU route checks the layout
    as the card's does). At D 128 no width padding makes the copy by
    chance."""
    db = Database.open(str(tmp_path / "pd"), device="cpu")
    c = db.create_collection("pd", dim=128)
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((131_072, 128)).astype(np.float32)
    c.upsert_bulk(range(len(vecs)), vecs)
    try:
        c.refresh_device()
        assert c._brute.serve_engine(3) == "int8-assist-pd"
        bt = MicroBatcher(c, window_ms=1.0)
        got = bt.search(vecs[11], k=3, timeout=TIMEOUT)
        bt.stop()
        # the batcher's dispatch: the query and seven copies of it
        assert got == c.search_batch(np.repeat(vecs[11:12], 8, axis=0), k=3)[0]
        assert got[0]["id"] == 11
        assert c.search_batch(np.asfortranarray(vecs[:8]), k=3) == c.search_batch(vecs[:8], k=3)
    finally:
        db.close()
