"""Fuzz-style invariant tests.

Counterpart of the reference's cargo-fuzz targets (``fuzz_velesql_parser``,
``fuzz_distance_metrics``, ``fuzz_snapshot_parser`` — invariants in
``docs/FUZZING.md:34-60``: no panic, NaN-safe, roundtrip). Deterministic
pseudo-random mutation instead of libFuzzer, same contracts:

- the VelesQL parser either parses or raises ParseError — never anything else
- distance kernels never emit NaN for finite inputs
- payload snapshots roundtrip through mutation-corrupted files (reject or
  recover, never crash or return wrong data silently)

The reference's ``tests/test_fuzz.py`` held against the port: each test
here is the reference test of the same name, its body with
``velesdb_tpu_torch`` for ``velesdb_tpu`` and an explicit ``device="cpu"``
wherever a database or an index is made. The file's other tests
are defined by name in another ``tests/test_torch_*.py`` and are not
repeated here. Bounds and data are the reference's.
"""

import os
import random

import numpy as np
import pytest
import torch

from velesdb_tpu_torch.ops import DistanceMetric, pairwise_scores


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def test_distance_kernels_nan_safe(rng):
    """Zero vectors, denormals, huge values — finite in, finite out."""
    specials = np.stack(
        [
            np.zeros(16, np.float32),
            np.full(16, 1e-38, np.float32),
            np.full(16, 1e18, np.float32),
            np.ones(16, np.float32),
            -np.ones(16, np.float32),
            rng.standard_normal(16).astype(np.float32),
        ]
    )
    for metric in DistanceMetric:
        s = np.asarray(pairwise_scores(specials, specials, metric))
        assert not np.isnan(s).any(), f"{metric} produced NaN"


def test_snapshot_fuzz_corruption(tmp_path):
    from velesdb_tpu_torch.storage.payload_log import PayloadLog

    rng = random.Random(7)
    d = str(tmp_path / "p")
    log = PayloadLog(d)
    for i in range(30):
        log.store(i, {"n": i, "s": "x" * (i % 7)})
    log.close()
    snap = os.path.join(d, "payloads.snapshot")
    original = open(snap, "rb").read()

    for trial in range(25):
        blob = bytearray(original)
        for _ in range(rng.randrange(1, 5)):
            pos = rng.randrange(len(blob))
            blob[pos] ^= 1 << rng.randrange(8)
        with open(snap, "wb") as f:
            f.write(bytes(blob))
        # corrupt snapshot must be rejected (falls back to log replay) or,
        # if the flipped bits dodge the CRC (1 in 2^32), still parse clean —
        # never crash, and every surviving value must be self-consistent
        log2 = PayloadLog(d)
        for k, v in log2.payloads.items():
            assert isinstance(v, dict)
        log2._log.close()
    # restore intact snapshot: full recovery
    with open(snap, "wb") as f:
        f.write(original)
    log3 = PayloadLog(d)
    assert len(log3) == 30 and log3.retrieve(29)["n"] == 29
    log3.close()
