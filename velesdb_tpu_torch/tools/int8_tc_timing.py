#!/usr/bin/env python3
"""Time the int8 bucket scans (#7, #12's v2 / v2h / v3 epilogues, #5) of the
checkout this runs from, on one NVIDIA GPU.

    python3 velesdb_tpu_torch/tools/int8_tc_timing.py    # from a checkout's root

It imports ``velesdb_tpu_torch`` from the current directory, so run from
another checkout's root (``cd build/parent && python3
<repo>/velesdb_tpu_torch/tools/int8_tc_timing.py``) it builds and times that
checkout's kernels: two checkouts compared in one call. Random operands made
on the card from seed 0 at the shapes of ``chip_smoke.py``'s cells: N
1,048,576 (#5: 1,310,720), D_pad 128, chunk 8,192, B_pad 256 and 16; 15% of
rows knocked out. Each kernel's first launch is held against its plain
version bit for bit (``torch.equal`` on gm and gi), then 20 launches are
timed with CUDA events. Prints the card's name and power limit, the ptxas
lines of ``sq8i_bucket``, and one line per (kernel, B_pad).
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

N7, N5, D, CHUNK = 1_048_576, 1_310_720, 128, 8192


def _time(fn, iters=20) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def main() -> None:
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        sys.exit("int8_tc_timing: needs an NVIDIA GPU")
    from velesdb_tpu_torch.experiments import kernels as xk
    from velesdb_tpu_torch.ops import _cuda, bucket_kernel as bk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"checkout {os.getcwd()}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows8 = torch.randint(-128, 128, (N7, D), dtype=torch.int8, device=dev, generator=g)
    scale = torch.rand(N7, device=dev, generator=g) * 0.02 + 0.005
    am = torch.rand(N7, device=dev, generator=g) * 2 - 1
    pen = torch.rand(N7, device=dev, generator=g) * 50
    pen[torch.rand(N7, device=dev, generator=g) < 0.15] = torch.inf
    bits = (torch.rand((N5, D), device=dev, generator=g) < 0.5).to(torch.int8)
    knocked = torch.rand(N5, device=dev, generator=g) < 0.15
    aux5 = (bits.to(torch.int32).sum(1) + bk._HAM_BIG * knocked).to(torch.int32)
    lines = []
    for b in (256, 16):
        qi = torch.randint(-127, 128, (b, D), dtype=torch.int8, device=dev, generator=g)
        sqi = qi.float().sum(1)
        invqs = torch.rand(b, device=dev, generator=g) + 0.5
        aux = torch.stack([scale, am, pen] + [torch.zeros_like(scale)] * 5)
        qaux = torch.zeros((b, 8), device=dev)
        qaux[:, 1], qaux[:, 2] = sqi, -invqs
        q5 = 2 * (torch.rand((b, D), device=dev, generator=g) < 0.5).to(torch.int8)
        cases = {
            "#7 sq8i_bucket": (bk.sq8i_bucket_gm, bk.sq8i_bucket_ref,
                               (qi, rows8, scale, am, pen, sqi, invqs, CHUNK)),
            "#12 v2": (xk.sq8i_v2_bucket_gm, xk.sq8i_v2_bucket_ref,
                       (qi, rows8, aux, qaux, CHUNK, "v2")),
            "#12 v2h": (xk.sq8i_v2_bucket_gm, xk.sq8i_v2_bucket_ref,
                        (qi, rows8, aux.bfloat16(), qaux.bfloat16(), CHUNK, "v2h")),
            "#12 v3": (xk.sq8i_v2_bucket_gm, xk.sq8i_v2_bucket_ref,
                       (qi, rows8, None, None, CHUNK, "v3")),
            "#5 hamming_mxu": (bk.hamming_mxu_gm, bk.hamming_mxu_ref, (q5, bits, aux5, CHUNK)),
        }
        for name, (kernel, plain, args) in cases.items():
            gm, gi = kernel(*args)
            rm, ri = plain(*args)
            same = torch.equal(gm, rm) and torch.equal(gi, ri)
            ms = _time(lambda: kernel(*args))
            lines.append(f"{name} B_pad {b}: {ms:.4f} ms, bit for bit: {same}")
            print(lines[-1], flush=True)
    log = _cuda.BUILD_LOG.get("sq8i_bucket", "").splitlines()
    for ln in log:
        if "Used" in ln or "spill" in ln:
            print("ptxas sq8i_bucket: " + ln.strip(), flush=True)
    if not all(ln.endswith("True") for ln in lines):
        sys.exit("int8_tc_timing: a kernel differs from its plain version")


if __name__ == "__main__":
    main()
