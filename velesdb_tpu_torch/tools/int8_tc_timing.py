#!/usr/bin/env python3
"""Time the int8 bucket scans (#7, #12's v2 / v2h / v3 epilogues, #5, #1)
and the exact Hamming top-k (#9) of the checkout this runs from, on one
NVIDIA GPU.

    python3 velesdb_tpu_torch/tools/int8_tc_timing.py    # from a checkout's root
    python3 velesdb_tpu_torch/tools/int8_tc_timing.py --topk    # #9 alone

It imports ``velesdb_tpu_torch`` from the current directory, so run from
another checkout's root (``cd build/parent && python3
<repo>/velesdb_tpu_torch/tools/int8_tc_timing.py``) it builds and times that
checkout's kernels: two checkouts compared in one call. Random operands made
on the card from seed 0 at the shapes of ``chip_smoke.py``'s cells: N
1,048,576 (#5: 1,310,720), D_pad 128, chunk 8,192, B_pad 256 and 16; 15% of
rows knocked out (#1: at ``_pd_invalid_pen``). #9 on the sign words of
100k-binary's shape (N 106,496, W 4, clustered data, 15% of rows invalid) at
B 256, 16 and 1, each with k 10 and 320; ``--topk`` times #9 alone. Each
kernel's first launch is held against its plain version bit for bit
(``torch.equal`` on every output), then 20 launches are timed with CUDA
events; #9's launches are then traced with ``torch.profiler`` for the device
time of each of its kernels and their sum. Prints the card's name and power
limit, the ptxas registers and spills of each kernel instantiation the run
built, one line per (kernel, batch) and one per (#9 shape, kernel).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import torch

N7, N5, D, CHUNK = 1_048_576, 1_310_720, 128, 8192
N9, D9 = 106_496, 100


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


def _profile(fn, calls=10) -> dict:
    """Device milliseconds a call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return per


def _ptxas(log: str):
    """``(entry function, registers, spill line)`` of each instantiation."""
    entry = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            yield entry, int(m.group(1))


def main() -> None:
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        sys.exit("int8_tc_timing: needs an NVIDIA GPU")
    from velesdb_tpu_torch.experiments import kernels as xk
    from velesdb_tpu_torch.ops import _cuda, bucket_kernel as bk
    from velesdb_tpu_torch.ops import pallas_kernels as pk
    from velesdb_tpu_torch.ops.quantization import binary_quantize

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
    rows_pd = torch.randint(-127, 128, (N7, D), dtype=torch.int8, device=dev, generator=g)
    pen_pd = torch.randint(0, bk._PD_PEN_CAP, (N7,), dtype=torch.int32, device=dev, generator=g)
    pen_pd[torch.rand(N7, device=dev, generator=g) < 0.15] = bk._pd_invalid_pen(D)
    ptile = bk.sq8pd_ptile(pen_pd, CHUNK)
    lines = []
    for b in () if "--topk" in sys.argv[1:] else (256, 16):
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
            "#1 sq8pd_bucket": (bk.sq8pd_bucket_gm, bk.sq8pd_bucket_gm_ref,
                                (qi, rows_pd, ptile, CHUNK)),
        }
        for name, (kernel, plain, args) in cases.items():
            out, want = kernel(*args), plain(*args)
            out, want = (out, want) if isinstance(out, tuple) else ((out,), (want,))
            same = all(torch.equal(a, r) for a, r in zip(out, want))
            ms = _time(lambda: kernel(*args))
            lines.append(f"{name} B_pad {b}: {ms:.4f} ms, bit for bit: {same}")
            print(lines[-1], flush=True)
    # #9 on clustered sign bits, so that distances tie as on the collection
    centers = torch.randn((64, D9), device=dev, generator=g) * 2.0
    pick = torch.randint(0, 64, (N9 + 256,), device=dev, generator=g)
    x = centers[pick] + 0.7 * torch.randn((N9 + 256, D9), device=dev, generator=g)
    packed, q9 = binary_quantize(x[:N9]), binary_quantize(x[N9:])
    valid = torch.rand(N9, device=dev, generator=g) >= 0.15
    for b, k in ((256, 10), (256, 320), (16, 10), (16, 320), (1, 10), (1, 320)):
        qb = q9[:b].contiguous()
        out, want = pk.hamming_topk(qb, packed, valid, k), pk.hamming_topk_ref(qb, packed, valid, k)
        same = torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        ms = _time(lambda: pk.hamming_topk(qb, packed, valid, k))
        lines.append(f"#9 hamming_topk B {b}, k {k}: {ms:.4f} ms, bit for bit: {same}")
        print(lines[-1], flush=True)
        per = _profile(lambda: pk.hamming_topk(qb, packed, valid, k))
        for name, t in sorted(per.items(), key=lambda kv: -kv[1]):
            print(f"    #9 B {b}, k {k} profile: {t:.4f} ms/call  {name[:90]}", flush=True)
        print(f"    #9 B {b}, k {k} device total: {sum(per.values()):.4f} ms/call", flush=True)
    for lib in sorted(_cuda.BUILD_LOG):
        for entry, regs in _ptxas(_cuda.BUILD_LOG[lib]):
            print(f"ptxas {lib}: {regs} registers  {entry}", flush=True)
        spills = {ln.strip() for ln in _cuda.BUILD_LOG[lib].splitlines() if "spill" in ln}
        print(f"ptxas {lib}: " + " | ".join(sorted(spills)), flush=True)
    if not all(ln.endswith("True") for ln in lines):
        sys.exit("int8_tc_timing: a kernel differs from its plain version")


if __name__ == "__main__":
    main()
