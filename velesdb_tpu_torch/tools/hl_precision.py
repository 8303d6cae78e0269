#!/usr/bin/env python3
"""Where #3 loses recall on the offset corpus, measured with plain versions.

    python3 velesdb_tpu_torch/tools/hl_precision.py     # from the root of a checkout; one card

``offset-full-hl`` (``chip_smoke.py`` phase 8b: 262,144 x 128 euclidean,
``make_clustered`` seed 42 plus 100 on every coordinate, 256 held-out
queries, k 10) searched by ``bucket_topk_hl`` with four scans in the bucket
select's place, each scored against the float64 oracle:

1. the kernel, #3 (``hl_bucket_gm``: three ``wgmma`` a 16-dim K step into
   one fp32 accumulator set);
2. its plain version (``hl_bucket_ref``: ``a = qhi.hi`` and ``e = qhi.lo``
   then ``qlo.hi``, each a dimension-order fp32 sum, then ``a + e``);
3. the split kept, summed in ``wgmma``'s K-step order: per 16-dim step the
   accumulator takes the exact sum of the step's ``hi.qhi`` products, then
   of its ``lo.qhi``, then of its ``hi.qlo``, one fp32 rounding each (the
   tensor cores' products are exact; this models their adds as one rounding
   a step);
4. dimension order without the ``lo`` products: ``qhi.hi`` alone.

Beside each recall: the share of bucket winners (``gm``) equal to the
kernel's, bit for bit. About a minute, most of it ``nvcc``.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def kstep_scores(qhi, qlo, hi, lo, cc, step: int = 16):
    """The split scores summed in ``wgmma``'s K-step order (variant 3)."""
    acc = torch.zeros((qhi.shape[0], hi.shape[0]), dtype=torch.float32, device=qhi.device)
    for t in range(0, qhi.shape[1], step):
        for a, b in ((qhi, hi), (qhi, lo), (qlo, hi)):
            part = a[:, t : t + step].double() @ b[:, t : t + step].double().T
            acc = (acc.double() + part).float()
    return acc - cc[None, :]


def main() -> None:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
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
    from velesdb_tpu_torch.ops import _cuda, bucket_kernel as bk

    _cuda.build_all(("dense_bucket_tc",))
    dev = torch.device("cuda")
    data = cs.make_clustered(np.random.default_rng(42), cs.OFFSET_N + cs.HELD_OUT, cs.SIFT_D)
    data = data + 100.0
    rows, q = torch.from_numpy(data[: cs.OFFSET_N]).to(dev), data[cs.OFFSET_N : cs.OFFSET_N + 256]
    hi, lo = bk.split_f32_rows(rows)
    cc = (rows * rows).sum(1)
    o_i = cs.oracle_topk(torch, rows.double(), q, "euclidean", cs.K)[1]
    qt = torch.from_numpy(q).to(dev)

    variants = {
        "kernel #3 (wgmma)": bk.hl_bucket_gm,
        "plain version (dimension order, split kept)": bk.hl_bucket_ref,
        "wgmma K-step order, split kept": lambda qh, ql, h, l, c, chunk: bk._bucket_select(
            kstep_scores(qh, ql, h, l, c), chunk),
        "dimension order, no lo products": lambda qh, ql, h, l, c, chunk: bk._bucket_select(
            bk._ordered_dot(qh, h) - c[None, :], chunk),
    }
    kernel, seen = bk.hl_bucket_gm, {}
    try:
        for name, fn in variants.items():
            gms = []

            def scan(*args, _fn=fn, _gms=gms):
                out = _fn(*args)
                _gms.append(out[0])
                return out

            bk.hl_bucket_gm = scan
            _, ids = bk.bucket_topk_hl(qt, hi, lo, cc, k=cs.K, metric="euclidean",
                                       chunk=cs.CHUNK)
            recall = np.mean([len(set(a) & set(b)) / cs.K
                              for a, b in zip(ids.cpu().numpy(), o_i)])
            seen[name] = (recall, gms[0])
    finally:
        bk.hl_bucket_gm = kernel
    ref = seen["kernel #3 (wgmma)"][1]
    for name, (recall, gm) in seen.items():
        cs.say(f"offset-full-hl b=256, {name}: recall@10 {recall:.4f}; bucket winners equal to "
               f"the kernel's {float((gm == ref).float().mean()):.4f}")


if __name__ == "__main__":
    main()
