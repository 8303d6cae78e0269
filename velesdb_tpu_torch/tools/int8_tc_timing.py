#!/usr/bin/env python3
"""Time the int8 bucket scans (#7, #12's v2 / v2h / v3 epilogues, #5, #1)
and the exact Hamming top-k (#9) of the checkout this runs from, on one
NVIDIA GPU; or the packed Hamming bucket scan (#4); or the scored row gather
(#11).

    python3 velesdb_tpu_torch/tools/int8_tc_timing.py    # from a checkout's root
    python3 velesdb_tpu_torch/tools/int8_tc_timing.py --topk    # #9 alone
    python3 velesdb_tpu_torch/tools/int8_tc_timing.py --hamming  # #4 (and #5)
    python3 velesdb_tpu_torch/tools/int8_tc_timing.py --gather  # #11 alone
    python3 velesdb_tpu_torch/tools/int8_tc_timing.py --gather-parts  # #11 in parts

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

``--hamming`` times #4 (``hamming_bucket_gm``) on random packed words at
its two cells' shapes, W 4 (N 1,310,720) and W 8 (N 1,048,576), chunk 2,048,
B_pad 256 and 16, 15% of rows at penalty +inf: once with the rest at 0 (the
serve paths' penalties) and once with the first 128 rows of every chunk at
0.5 (every thread on the float select); and #5 on the same bits unpacked
(D_pad 128 / 256, chunk 8,192), the same distances from 8x the bytes. Each
held bit for bit (``gm``'s bits too), then timed with CUDA events; #4's
lines give its bound (the products at the int8 rate and one fp32 operation
a distance, or the bytes: the words, the penalties, the gm / gi writes) and
its share; then every instantiation's ptxas registers, spills and any
``wgmma`` serialization warning.

``--gather`` times #11 (``row_gather_scores`` at depth 1 and 2) and the
library yardstick ``q @ corpus[idx.long()].T`` on the experiment's data (N
1,000,000 x D 128 f32, standard normal from numpy seed 0, 8 queries; ids drawn
with numpy) at R 8,192 (the experiment's shape), 16,384 and 262,144 (the
graph beam's rows a step at b 16 and 256: ew 16 x degree 64), group 16, and
at D 960 (a GIST width, standard normal rows made on the card from seed 0) at
R 8,192. Each call takes a fresh id set (cold rows, as the experiment times).
Each kernel's first call is held against ``row_gather_scores_ref`` with
``torch.equal``; then three clocks a call: CUDA events over back-to-back
calls, the host's enqueue (host clock over the same calls, no synchronize
between), and, after every host-clock timing of the run, the device total of
each call's kernels from ``torch.profiler`` (a finished profiler session
makes later launches dearer on the host). With the device time it prints the
GB/s of the gathered rows (R x D x 4 bytes) and the bytes bound: the distinct
rows, the ids, the queries and the scores, each once, over 3.35 TB/s.

``--gather-parts`` runs ``--gather`` on patched copies of this checkout's
``csrc/row_gather.cu`` (under ``build/gather_parts/``, never committed), one
process each, and prints their device lines: ``copies`` (the sums skipped:
the rows' copies alone), ``scoring`` (no row copied: the sums over whatever
shared memory holds), ``cp16`` (each row copied by a warp of 16-byte
``cp.async`` completing on the same barrier, in place of one bulk copy),
``ahead1`` and ``ahead4`` (1 or 4 float4 words loaded ahead of the sums in
place of ``kAhead``). The parts are not bit for bit, so those lines say so.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

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


def _profile(fn, calls=10, count=None):
    """Device milliseconds a call of each kernel ``fn`` launches; with
    ``count``, also the number of events in the trace whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per, n = {}, 0
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
            n += count is not None and count in e.name
    return (per, n) if count is not None else per


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


def _enqueue(fn, args_list) -> float:
    """Host milliseconds to enqueue a call of ``fn`` (no synchronize between
    calls; the card runs behind)."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in args_list:
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / len(args_list)


def _cycle(fn, args_list) -> float:
    """CUDA-event milliseconds a call of ``fn`` over ``args_list`` in turn."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for args in args_list:
        fn(*args)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / len(args_list)


GATHER_SHAPES = ((128, 8192), (128, 16_384), (128, 262_144), (960, 8192))  # (D, R), group 16
GATHER_N = 1_000_000


def _gather(xk, dev) -> list:
    """#11 at ``GATHER_SHAPES``: held bit for bit, then timed on three clocks."""
    import numpy as np

    rng = np.random.default_rng(0)
    n = GATHER_N
    data = {128: torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)).to(dev)}
    q = {128: torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32)).to(dev)}
    g = torch.Generator(device=dev).manual_seed(0)
    data[960] = torch.randn((n, 960), device=dev, generator=g)
    q[960] = torch.randn((8, 960), device=dev, generator=g)
    fns = {
        "row_gather": lambda q, c, ix: xk.row_gather_scores(q, c, ix, group=16, stages=1),
        "row_gather_db": lambda q, c, ix: xk.row_gather_scores(q, c, ix, group=16, stages=2),
        "library": lambda q, c, ix: q @ c[ix.long()].T,
    }
    lines, cases = [], []
    for d, r in GATHER_SHAPES:
        n_sets = max(8, min(64, 1_048_576 // r))
        ids = torch.from_numpy(rng.integers(0, n, size=(n_sets, r), dtype=np.int32)).to(dev)
        sets = [(q[d], data[d], ids[i]) for i in range(n_sets)]
        distinct = int(torch.unique(ids[0]).numel())
        bound_ms = (distinct * d * 4 + r * 4 + 8 * d * 4 + 8 * r * 4) / 3.35e12 * 1e3
        want = xk.row_gather_scores_ref(*sets[0])
        for name, fn in fns.items():
            same = torch.equal(fn(*sets[0]), want) if name != "library" else True
            ev, host = _cycle(fn, sets), _enqueue(fn, sets)
            cases.append((d, r, name, fn, sets, bound_ms))
            lines.append(f"#11 D {d} R {r} {name}: events {ev:.4f} ms, host enqueue {host:.4f} "
                         f"ms a call, bit for bit: {same}")
            print(lines[-1], flush=True)
    for d, r, name, fn, sets, bound_ms in cases:  # after every host-clock timing
        per, launches = _profile(lambda: [fn(*a) for a in sets], calls=1, count="row_gather")
        dev_ms = sum(per.values()) / len(sets)
        if name != "library" and launches != len(sets):
            print(f"    #11 D {d} R {r} {name}: the profile holds {launches} launches of "
                  f"{len(sets)}: not measured", flush=True)
            continue
        if dev_ms <= 0.0:
            print(f"    #11 D {d} R {r} {name}: device not measured (no device events)", flush=True)
            continue
        print(f"    #11 D {d} R {r} {name}: device {dev_ms:.4f} ms a call (profile), "
              f"{r * d * 4 / dev_ms / 1e6:.1f} GB/s of gathered rows, bytes bound "
              f"{bound_ms:.4f} ms ({bound_ms / dev_ms:.4f} of it); "
              + ", ".join(f"{k[:40]} {t / len(sets):.4f}" for k, t in
                          sorted(per.items(), key=lambda kv: -kv[1])[:3]), flush=True)
    return lines


# (old, new) substitutions of csrc/row_gather.cu for --gather-parts; each
# "never" condition is false at run time, so the compiler keeps the code
_NEVER = " && r_total > 0x40000000"
GATHER_PARTS = {
    "copies": [("const int words = d >> 2;",
                "const int words = (d >> 2) * (r_total > 0x40000000);")],
    "scoring": [("ida < n;", "ida < n" + _NEVER + ";"), ("idb < n;", "idb < n" + _NEVER + ";")],
    "cp16": [("""    mbar_arrive_expect_tx(bar + st, (static_cast<uint32_t>(va) + vb) * row_bytes);
    if (va) bulk_copy(buf + lane * rs, corpus + ida * d, row_bytes, bar + st);
    if (vb) bulk_copy(buf + (lane + 32) * rs, corpus + idb * d, row_bytes, bar + st);""",
              """    (void)va;
    (void)vb;
    __syncwarp();
    for (int j = 0; j < count; ++j) {
      const long long id = ids[j];
      if (id < 0 || id >= n) continue;
      const uint32_t dst = smem_addr(buf + j * rs);
      for (int c = lane; c < (d >> 2); c += 32)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst + 16 * c),
                     "l"(corpus + id * d + 4 * c) : "memory");
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n"
                 ::"r"(smem_addr(bar + st)) : "memory");""")],
    "ahead1": [("constexpr int kAhead = 2;", "constexpr int kAhead = 1;")],
    "ahead4": [("constexpr int kAhead = 2;", "constexpr int kAhead = 4;")],
}


def _gather_parts() -> None:
    """``--gather`` on a patched copy of this checkout per part, in turn."""
    import shutil

    root = os.getcwd()
    with open(os.path.join(root, "velesdb_tpu_torch", "csrc", "row_gather.cu")) as f:
        source = f.read()
    for part, subs in GATHER_PARTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                sys.exit(f"int8_tc_timing: {part}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        where = os.path.join(root, "build", "gather_parts", part)
        shutil.rmtree(where, ignore_errors=True)
        shutil.copytree(os.path.join(root, "velesdb_tpu_torch"),
                        os.path.join(where, "velesdb_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        with open(os.path.join(where, "velesdb_tpu_torch", "csrc", "row_gather.cu"), "w") as f:
            f.write(text)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--gather"], cwd=where,
                             capture_output=True, text=True)
        for ln in run.stdout.splitlines():
            if "#11" in ln and "library" not in ln:
                print(f"{part}: {ln.strip()}", flush=True)


def _print_ptxas(_cuda) -> None:
    for lib in sorted(_cuda.BUILD_LOG):
        for entry, regs in _ptxas(_cuda.BUILD_LOG[lib]):
            print(f"ptxas {lib}: {regs} registers  {entry}", flush=True)
        spills = {ln.strip() for ln in _cuda.BUILD_LOG[lib].splitlines() if "spill" in ln}
        print(f"ptxas {lib}: " + " | ".join(sorted(spills)), flush=True)
        # e.g. "wgmma.mma_async instructions are serialized due to ..."
        for ln in sorted({ln.strip() for ln in _cuda.BUILD_LOG[lib].splitlines()
                          if "wgmma" in ln or "Performance" in ln}):
            print(f"ptxas {lib}: {ln}", flush=True)


# #4's shapes: glove100 BINARY (W 4) and hamming-1m-256b (W 8), chunk 2,048
HAMMING_SHAPES = ((4, 1_310_720), (8, 1_048_576))
HAMMING_CHUNK = 2048


def _hamming(bk, dev) -> list:
    """#4 at ``HAMMING_SHAPES``, B_pad 256 and 16, and #5 on the same bits
    (D_pad 128 / 256, chunk 8,192): each held bit for bit, then timed."""
    g = torch.Generator(device=dev).manual_seed(0)
    lines = []
    for w, n in HAMMING_SHAPES:
        packed = torch.randint(-(1 << 31), 1 << 31, (n, w), dtype=torch.int64, device=dev,
                               generator=g).to(torch.int32)
        pen = torch.where(torch.rand(n, device=dev, generator=g) < 0.15, torch.inf, 0.0)
        # every thread's first rows of each chunk at a finite penalty: the
        # float select over the whole scan, the select of the first design
        pen_f = pen.clone().view(-1, HAMMING_CHUNK)
        pen_f[:, :128] = 0.5
        pen_f = pen_f.reshape(-1)
        shift = torch.arange(32, device=dev)
        bits = ((packed.to(torch.int64)[:, :, None] >> shift) & 1).reshape(n, 32 * w)
        bits = bits.to(torch.int8)
        aux = (bits.to(torch.int32).sum(1) + bk._HAM_BIG * (pen > 0)).to(torch.int32)
        for b in (256, 16):
            q = torch.randint(-(1 << 31), 1 << 31, (b, w), dtype=torch.int64, device=dev,
                              generator=g).to(torch.int32)
            qbits = ((q.to(torch.int64)[:, :, None] >> shift) & 1).reshape(b, 32 * w)
            q5 = (2 * qbits).to(torch.int8)
            bytes_ = 4 * b * w + 4 * n * w + 4 * n + 8 * b * n // HAMMING_CHUNK * 128
            ops_ms = (2 * b * n * 32 * w / 1.979e15 + b * n / 67e12) * 1e3
            bound, by = max((ops_ms, "operations"), (bytes_ / 3.35e12 * 1e3, "bytes"))
            cases = {
                "#4 hamming_bucket": (bk.hamming_bucket_gm, bk.hamming_bucket_ref,
                                      (q, packed, pen, HAMMING_CHUNK)),
                "#4 hamming_bucket float select": (bk.hamming_bucket_gm, bk.hamming_bucket_ref,
                                                   (q, packed, pen_f, HAMMING_CHUNK)),
                f"#5 hamming_mxu D_pad {32 * w} chunk {CHUNK}": (
                    bk.hamming_mxu_gm, bk.hamming_mxu_ref, (q5, bits, aux, CHUNK)),
            }
            for name, (kernel, plain, args) in cases.items():
                out, want = kernel(*args), plain(*args)
                same = all(torch.equal(a, r) for a, r in zip(out, want))
                same = same and torch.equal(out[0].view(torch.int32), want[0].view(torch.int32))
                ms = _time(lambda: kernel(*args))
                share = (f", bound {bound:.4f} ms ({by}), {bound / ms:.4f} of it"
                         if "#4" in name else "")
                lines.append(f"{name} W {w}, N {n}, B_pad {b}: {ms:.4f} ms{share}, "
                             f"bit for bit: {same}")
                print(lines[-1], flush=True)
        del packed, bits, aux
        torch.cuda.empty_cache()
    return lines


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
    if "--gather-parts" in sys.argv[1:]:
        _gather_parts()
        return
    if "--gather" in sys.argv[1:] or "--hamming" in sys.argv[1:]:
        lines = _gather(xk, dev) if "--gather" in sys.argv[1:] else _hamming(bk, dev)
        _print_ptxas(_cuda)
        if not all(ln.endswith("True") for ln in lines):
            sys.exit("int8_tc_timing: a kernel differs from its plain version")
        return
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
    _print_ptxas(_cuda)
    if not all(ln.endswith("True") for ln in lines):
        sys.exit("int8_tc_timing: a kernel differs from its plain version")


if __name__ == "__main__":
    main()
