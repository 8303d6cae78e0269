#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 13 (``serve-1m-128d``) alone, on one NVIDIA GPU.

    python3 velesdb_tpu_torch/tools/serve_phase.py      # from the root of a checkout

Builds ``hybrid-1m-128d`` as phase 11 leaves it (``hybrid_data``'s 1,000,000
x 128 cosine rows with their payloads, 10,000 TTL rows upserted and expired,
``vacuum``), closes it, takes the float64 oracle of the phase's 1,024
held-out queries, builds the one kernel library the phase launches
(``sq8i_bucket``: #1) and runs ``chip_smoke.serve_phase`` on the directory:
the REST server reopening it on the card, its checks and its numbers, read
before any earlier phase's profile. About four minutes of command; the
numbers go to standard output.
"""

from __future__ import annotations

import importlib.util
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch


def main() -> None:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))  # this checkout's velesdb_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        cs.fail("this tool needs an NVIDIA GPU")
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(cs.CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from velesdb_tpu_torch import Database
    from velesdb_tpu_torch.ops import _cuda, bucket_kernel as bk

    t0 = time.perf_counter()
    _cuda.build_all(("sq8i_bucket",))
    cs.say(f"build sq8i_bucket {time.perf_counter() - t0:.2f} s")
    n = cs.HYB_N
    t0 = time.perf_counter()
    corpus, payloads, qv, qt = cs.hybrid_data(n, cs.HYB_D, cs.HYB_QUERIES)
    tmp = tempfile.mkdtemp(prefix="velesdb_serve_")
    try:
        db = Database.open(tmp)
        col = db.create_collection("hybrid-1m-128d", cs.HYB_D, metric="cosine")
        for s in range(0, n, 50_000):
            col.upsert_bulk(range(s, min(s + 50_000, n)), corpus[s : s + 50_000],
                            payloads[s : s + 50_000])
        del payloads
        col.upsert_bulk(range(n, n + 10_000), -corpus[:10_000],
                        [{"text": "ephemeral", "price": 1.0}] * 10_000, ttl=3600.0)
        cs.check(col.expire_rows(now=time.time() + 3601.0) == 10_000, "expire_rows")
        col.vacuum()
        cs.say(f"hybrid-1m-128d as phase 11 leaves it: {time.perf_counter() - t0:.2f} s")
        n_serve = cs.SERVE_THREADS * cs.SERVE_PER_THREAD
        o_ids = cs.oracle_topk(torch, cs.unit64(torch, corpus, "cuda"),
                               qv[cs.SERVE_Q0 : cs.SERVE_Q0 + n_serve], "cosine", cs.K)[1]
        del col
        db.close()
        torch.cuda.empty_cache()
        launches, errs = {"sq8pd_bucket": 0}, {"sq8pd_bucket": 0.0}
        cs.serve_phase(torch, (bk.LAUNCHES,), launches, errs, tmp, qv, qt, o_ids)
        print(f"#1 launches {launches['sq8pd_bucket']}, each equal to its plain version",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
