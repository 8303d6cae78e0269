#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 6b (``hamming-1m-256b``) alone, on one NVIDIA GPU.

    python3 velesdb_tpu_torch/tools/hamming256_phase.py      # from the root of a checkout

Builds the three kernel libraries the phase launches (``sq8i_bucket``: #5;
``hamming_bucket``: #4; ``hamming_topk``: #9), opens a ``Database`` on the
card and runs ``chip_smoke.hamming256_phase``: BINARY collections of
1,048,576 x 256 sign codes under hamming and 100,000 of them under jaccard,
every launch held against its plain version, the answers against the
float64 oracles, and #5, #4 and #9 at W 8 timed against their bounds. About
three minutes of command; the numbers go to standard output.
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
    from velesdb_tpu_torch.ops import _cuda, bucket_kernel as bk, pallas_kernels as pk

    t0 = time.perf_counter()
    _cuda.build_all(("sq8i_bucket", "hamming_bucket", "hamming_topk"))
    cs.say(f"build sq8i_bucket, hamming_bucket, hamming_topk {time.perf_counter() - t0:.2f} s")
    # the popcount issue ceiling main() derives: 16 per SM per clock
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    popc_rate = 16 * torch.cuda.get_device_properties(0).multi_processor_count * sm_mhz * 1e6

    def device_only(col, k):
        return lambda b: col._search_device(b, k, None)[1].cpu()

    launches = {"hamming_mxu_bucket": 0, "hamming_bucket": 0, "hamming_topk": 0}
    errs = {name: 0.0 for name in launches}
    tmp = tempfile.mkdtemp(prefix="velesdb_ham256_")
    try:
        db = Database.open(tmp, device="cuda")
        cs.hamming256_phase(torch, torch.device("cuda"), (bk.LAUNCHES, pk.LAUNCHES), launches,
                            errs, db, popc_rate, device_only)
        db.close()
        print(f"launches {launches}, each equal to its plain version", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
