"""Planner, engine selection, TTL expiry, auto-vacuum, compression tests.

The reference's ``tests/test_planner_ttl.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made. The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""


def test_snapshot_v2_roundtrip_and_v1_compat(tmp_path):
    from velesdb_tpu_torch.storage.payload_log import PayloadLog

    d = str(tmp_path / "p")
    log = PayloadLog(d)
    for i in range(50):
        log.store(i, {"name": f"item {i}", "tags": ["a", "b"], "n": i})
    log.close()
    log2 = PayloadLog(d)
    assert len(log2) == 50 and log2.retrieve(17)["n"] == 17
    log2.close()
