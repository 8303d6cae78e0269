"""The slice as a whole on the CPU: ``Database`` -> ``Collection`` -> exact
search in the port, against the JAX package on the same data and directories.

Results agree id for id except at exact score ties, with scores to rtol 1e-5
(fp32 on both sides, different summation order). The on-disk format is
shared: a directory written by either package opens in the other.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import velesdb_tpu
import velesdb_tpu_torch

RTOL = 1e-5
N, DIM = 2000, 24
CAT3 = {"type": "eq", "field": "cat", "value": 3}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    queries = rng.standard_normal((8, DIM)).astype(np.float32)
    payloads = [{"cat": i % 4, "title": f"doc {i}"} for i in range(N)]
    return vecs, queries, payloads


def _same(port_rows, ref_rows):
    assert len(port_rows) == len(ref_rows)
    for got, want in zip(port_rows, ref_rows):
        gs, ws = [h.score for h in got], [h.score for h in want]
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=RTOL)
        for g, w, score in zip(got, want, ws):
            # a different id at a rank is only allowed where scores tie
            assert g.id == w.id or abs(g.score - score) <= RTOL * abs(score) + RTOL
        for h in got:
            assert h.payload == {"cat": h.id % 4, "title": f"doc {h.id}"}


def _fill(db, metric, data):
    vecs, _, payloads = data
    col = db.create_collection("docs", DIM, metric=metric)
    col.upsert_bulk(range(N), vecs, payloads)
    col.upsert(N + 7, vecs[0] * 0.5, {"cat": (N + 7) % 4, "title": f"doc {N + 7}"})
    return col


def _searches(col, queries):
    out = [col.search_batch(queries, k=10), [col.search(queries[0], k=5)]]
    filtered = col.search_batch(queries, k=10, filter=CAT3)
    assert all(h.payload["cat"] == 3 for row in filtered for h in row)
    return out + [filtered]


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot_product"])
def test_slice_matches_reference(tmp_path, data, metric):
    _, queries, _ = data
    ref_db = velesdb_tpu.Database.open(str(tmp_path / "ref"))
    db = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu")
    ref, col = _fill(ref_db, metric, data), _fill(db, metric, data)
    for a, b in zip(_searches(col, queries), _searches(ref, queries)):
        _same(a, b)
    assert col.info()["serve_engine"] == "streamed-scan"
    for vid in (0, 11, 500, N + 7):
        assert col.delete(vid) == ref.delete(vid) is True
    assert col.count() == ref.count() == N - 3
    assert col.get(11) is None and col.get(12)[1] == ref.get(12)[1]
    got = col.search_batch(queries, k=10)
    _same(got, ref.search_batch(queries, k=10))
    assert not {0, 11, 500, N + 7} & {h.id for row in got for h in row}
    db.close()
    ref_db.close()
    ref = velesdb_tpu.Database.open(str(tmp_path / "ref")).get_collection("docs")
    col = velesdb_tpu_torch.Database.open(str(tmp_path / "port"), device="cpu").get_collection(
        "docs"
    )
    for a, b in zip(_searches(col, queries), _searches(ref, queries)):
        _same(a, b)


def test_port_opens_reference_directory_and_back(tmp_path, data):
    vecs, queries, _ = data
    path = str(tmp_path / "shared")
    with velesdb_tpu.Database.open(path) as ref_db:
        _fill(ref_db, "euclidean", data)
        ref_db.get_collection("docs").delete(42)
        want = ref_db.get_collection("docs").search_batch(queries, k=10, filter=CAT3)
    with velesdb_tpu_torch.Database.open(path, device="cpu") as db:
        assert db.list_collections() == ["docs"]
        col = db.get_collection("docs")
        assert col.count() == N
        np.testing.assert_array_equal(col.get(5)[0], vecs[5])
        _same(col.search_batch(queries, k=10, filter=CAT3), want)
        col.upsert(N + 100, vecs[3], {"cat": (N + 100) % 4, "title": f"doc {N + 100}"})
    with velesdb_tpu.Database.open(path) as ref_db:
        back = ref_db.get_collection("docs")
        assert back.count() == N + 1
        np.testing.assert_array_equal(back.get(N + 100)[0], vecs[3])


def test_port_never_imports_jax(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(
        f"""
        import sys
        import numpy as np
        sys.path.insert(0, {repo!r})
        import velesdb_tpu_torch
        db = velesdb_tpu_torch.Database.open({str(tmp_path)!r}, device="cpu")
        col = db.create_collection("c", 8, metric="euclidean")
        col.upsert_bulk(range(100), np.eye(100, 8, dtype=np.float32))
        assert col.search(np.eye(1, 8, dtype=np.float32)[0], k=1)[0].id == 0
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        print("no-jax-ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    assert "no-jax-ok" in out.stdout


def test_default_device_is_cuda(tmp_path):
    db = velesdb_tpu_torch.Database(str(tmp_path))
    assert db.device == "cuda"
    col = db.create_collection("c", 4)
    assert col.device.type == "cuda"  # never switched to the CPU on its own


@pytest.mark.parametrize(
    "action",
    [
        "storage_sq8",
        "storage_binary",
        "index_graph",
        "index_ivf",
        "quality_perfect",
        "text_search",
        "hybrid_search",
        "add_edge",
        "velesql",
    ],
)
def test_unported_surfaces_raise(tmp_path, action):
    db = velesdb_tpu_torch.Database.open(str(tmp_path), device="cpu")
    col = db.create_collection("c", 4)
    col.upsert(1, np.ones(4, np.float32))
    calls = {
        "storage_sq8": lambda: db.create_collection("q", 4, storage_mode="sq8"),
        "storage_binary": lambda: db.create_collection("b", 4, storage_mode="binary"),
        "index_graph": lambda: setattr(col, "index_kind", "graph"),
        "index_ivf": lambda: setattr(col, "index_kind", "ivf"),
        "quality_perfect": lambda: col.search(np.ones(4), k=1, quality="perfect"),
        "text_search": lambda: col.text_search("shoes"),
        "hybrid_search": lambda: col.hybrid_search(np.ones(4), "shoes"),
        "add_edge": lambda: col.add_edge(1, 1, "self"),
        "velesql": lambda: db.query("SELECT * FROM c LIMIT 1"),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        calls[action]()
    assert not os.path.exists(os.path.join(str(tmp_path), "q", "config.json"))
