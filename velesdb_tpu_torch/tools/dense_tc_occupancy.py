#!/usr/bin/env python3
"""Build #2b (``csrc/dense_bucket_tc.cu``) beside a two-blocks-per-SM variant
of it and time both on one NVIDIA GPU.

    python3 velesdb_tpu_torch/tools/dense_tc_occupancy.py    # from the repo root

It builds the ``csrc/`` of the checkout it runs in (the current directory),
so run from another checkout's root (``cd build/parent && python3
<repo>/velesdb_tpu_torch/tools/dense_tc_occupancy.py``) it times that
checkout's #2b: two checkouts compared in one call.

The variant is the same source with query tiles capped at 64, the launch
bounds asking for two blocks per SM (at most 128 registers a thread) and the
stage ring sized so two blocks' shared memory fits: does a second resident
block hide the serial copy -> wgmma -> epilogue steps of the first? Both
builds go to ``build/tc/`` (nvcc with the package's flags), are held to
``half_scan_tolerance`` and timed with CUDA events (20 launches) at B_pad
256, 16, 64 and 128 on random bf16 rows (N 1,048,576, D_pad 128, chunk
8,192), in the order v0, v1, v1, v0.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

N, D, CHUNK = 1_048_576, 128, 8192
VARIANT = [  # (pattern in the source, text in the two-blocks-per-SM variant)
    (r"__global__ void __launch_bounds__\(kThreads, 1\)",
     "__global__ void __launch_bounds__(kThreads, (NQ <= 64 ? 2 : 1))"),
    (r"b_pad <= 64 \? 64 : 128;", "64;"),
    (r"free_bytes =\s*kSmemLimit -", "free_bytes = kSmemLimit / 2 -"),
]


def _build(_cuda) -> dict:
    src = open("velesdb_tpu_torch/csrc/dense_bucket_tc.cu").read()
    v1 = src
    for pattern, text in VARIANT:
        v1, count = re.subn(pattern, text, v1)
        assert count == 1, pattern
    os.makedirs("build/tc", exist_ok=True)
    procs = {}
    for name, text in (("v0", src), ("v1", v1)):
        with open(f"build/tc/{name}.cu", "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda._NVCC_FLAGS, "-I", "velesdb_tpu_torch/csrc", "-o",
             f"build/tc/{name}.so", f"build/tc/{name}.cu"],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                       for ln in err.splitlines() if "Used " in ln and " registers" in ln})
        print(f"{name}: nvcc rc {proc.returncode}, registers {', '.join(regs)}", flush=True)
        fn = ctypes.CDLL(os.path.abspath(f"build/tc/{name}.so")).dense_bucket_tc_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        libs[name] = fn
    return libs


def _time_ms(fn, iters=20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    sys.path.insert(0, os.getcwd())
    from velesdb_tpu_torch.ops import _cuda, bucket_kernel as bk

    libs = _build(_cuda)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.randn(N, D, device="cuda", generator=g).to(torch.bfloat16).contiguous()
    cc = (rows.float() ** 2).sum(1)
    q_all = (2 * torch.randn(256, D, device="cuda", generator=g)).to(torch.bfloat16)

    def run(fn, q):
        gm, gi = bk._gm_gi(q.shape[0], N, CHUNK, q.device)
        rc = fn(q.data_ptr(), rows.data_ptr(), cc.data_ptr(), gm.data_ptr(), gi.data_ptr(),
                q.shape[0], N, D, CHUNK, 2, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return gm, gi

    for b in (256, 16, 64, 128):
        q = q_all[:b].contiguous()
        ref = bk.half_scan_tolerance(q, rows, cc, CHUNK)
        line = []
        for name in ("v0", "v1", "v1", "v0"):
            gm, gi = run(libs[name], q)
            torch.cuda.synchronize()
            worst = bk.half_scan_error(q, rows, cc, CHUNK, gm, gi, ref=ref)[0]
            check = "" if worst <= 1.0 else " OUTSIDE THE TOLERANCE"
            ms = _time_ms(lambda: run(libs[name], q))
            line.append(f"{name} {ms:.4f} ms (worst {worst:.4f} of tol{check})")
        print(f"#2b B_pad {b}: " + ", ".join(line) + f"  [{card}]", flush=True)


if __name__ == "__main__":
    main()
