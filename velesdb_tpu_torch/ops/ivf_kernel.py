"""IVF probe op: route each query to its partitions, score them, select.

Counterpart of ``velesdb_tpu/ops/ivf_kernel.py``. ``ivf_probe_topk``
(``:120``) routes the batch with one ``[B, P]`` matmul, scores every probed
partition with kernel #10 and selects the top-k outside the kernel. The TPU
kernel ``_probe_kernel`` (``:82``) walks a (query, probe) grid in order with a
scalar-prefetched probe id choosing each partition's DMA; here the
hand-written CUDA kernel ``csrc/ivf_probe.cu`` sorts the probes by partition
on the device (the schedule of :func:`probe_runs`) and reads each probed
partition's 128-row tiles once for the group of queries that probe it
(:func:`ivf_probe_scores`); :func:`ivf_probe_ref` is its plain version.

Scoring contract, as in the reference: "maximize" orientation, euclidean
queries doubled with ``pen = |c|^2`` (distances restored outside), cosine
``1/|c|`` folded into ``mul`` (and ``add`` for SQ8) by the caller, dead slots
at ``pen = +inf``. The reference stacks ``(mul, add, pen)`` on 8 sublanes,
``aux [P, 8, L]``; the port keeps the three rows, ``aux [P, 3, L]``.

Each dot sums over the dims in order, one rounded multiply and add per term,
so on the card the kernel equals its plain version bit for bit. SQ8 queries
are rounded to bf16 before the product (the reference's MXU operand; a bf16
value times a code <= 255 is exact in fp32); ``sum(q)`` comes from the
unrounded queries. The wrapper computes the cosine normalization and
``sum(q)`` once for both versions: CUDA's ``rsqrtf`` does not round as
torch's ``rsqrt`` does.

Selection is exact, with equal scores going to the smallest position on
every device (the reference selects with ``approx_max_k`` at ``nprobe * L >=
16,384``, exact on its CPU path). ``SMEM_PROBE_BYTES`` and
``probe_table_fits`` model the TPU's scalar memory for the graph's entry IVF
and are not carried over: the graph probes its entry IVF with #10 on every
unmasked search (``index/graph_index.py``, ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from velesdb_tpu_torch.ops.bucket_kernel import _P, _kernel_route, _launch, first_topk
from velesdb_tpu_torch.ops.distance import DistanceMetric, normalize

__all__ = [
    "LAUNCHES",
    "MAX_KERNEL_BATCH",
    "MIN_BLOCK_BYTES",
    "ivf_probe_ref",
    "ivf_probe_scores",
    "ivf_probe_supported",
    "ivf_probe_topk",
    "PROBE_GROUP",
    "SCHED_RANK_MAX",
    "probe_operands",
    "probe_runs",
]

# The reference's dispatch rule (``:61-62``): the kernel path serves small
# batches whose partition blocks are big enough; the plain probing path
# (``index/ivf.py:ivf_search_impl``) serves everything else.
MIN_BLOCK_BYTES = 65536  # L * D * itemsize below this: per-step overhead dominates
MAX_KERNEL_BATCH = 64  # probing only wins at small batch anyway

# Kernel launches, counted where the CUDA kernel is launched and nowhere else.
LAUNCHES = {"ivf_probe": 0}

_MAX_DPAD = 12288  # the kernel's bound on D_pad
# Queries scored against one copy of a partition tile (``kGroup`` in
# csrc/ivf_probe.cu). At sift1m-ivf's b 64 a partition is probed by 1.7
# queries on average, so 8 is rarely reached; 8 also keeps three f32 tiles
# (72 KB each) resident on an SM.
PROBE_GROUP = 8
# The most probes (B * nprobe) whose schedule #10 ranks on the card, one warp
# a probe against all of them: O(M^2) work, under the ~30 small launches of
# :func:`probe_runs` up to here. Above it the wrapper builds the schedule
# with :func:`probe_runs` (``torch.sort``, O(M log M)); the kernel then skips
# its ranking. The two cross between 16,384 and 32,768 probes on an H100
# (PERF.md, Findings). At most ``kRankMax`` of csrc/ivf_probe.cu.
SCHED_RANK_MAX = 16384


def ivf_probe_supported(b: int, L: int, d: int, itemsize: int = 1) -> bool:
    """``itemsize``: partition bytes per dim (1 = SQ8 codes, 4 = f32)."""
    return b <= MAX_KERNEL_BATCH and L * d * itemsize >= MIN_BLOCK_BYTES


def _check_probe(q, qsum, probe, rows, aux) -> None:
    if q.dtype != torch.float32 or qsum.dtype != torch.float32 or aux.dtype != torch.float32:
        raise TypeError("q, qsum and aux must be float32")
    if probe.dtype != torch.int32:
        raise TypeError(f"probe must be int32, got {probe.dtype}")
    if rows.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"rows must be int32 SQ8 words or float32, got {rows.dtype}")
    if q.ndim != 2 or qsum.shape != (q.shape[0],) or probe.ndim != 2 or rows.ndim != 3:
        raise ValueError(f"expected q [B, D_pad], qsum [B], probe [B, nprobe], rows [P, L, W]; "
                         f"got {tuple(q.shape)}, {tuple(qsum.shape)}, {tuple(probe.shape)}, "
                         f"{tuple(rows.shape)}")
    n_parts, L, width = rows.shape
    d_pad = 4 * width if rows.dtype == torch.int32 else width
    if probe.shape[0] != q.shape[0] or q.shape[1] != d_pad:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, probe {tuple(probe.shape)}, "
                         f"rows {tuple(rows.shape)}")
    if aux.shape != (n_parts, 3, L):
        raise ValueError(f"aux of shape {tuple(aux.shape)} for rows {tuple(rows.shape)}")
    if min(q.shape[0], probe.shape[1], n_parts, L, width) < 1 or d_pad > _MAX_DPAD:
        raise ValueError(f"empty input or D_pad={d_pad} above {_MAX_DPAD}")


def _ordered_bdot(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """fp32 ``dot[b, m] = sum_d q[b, d] * rows[b, m, d]`` over ``d = 0 .. D-1``
    in order, one elementwise multiply and one add per term, as the kernel's
    ``__fmul_rn`` / ``__fadd_rn`` round them."""
    rt = rows.float().permute(2, 0, 1).contiguous()  # [D, B, M]
    acc = torch.zeros(rt.shape[1:], dtype=torch.float32, device=q.device)
    for d in range(rt.shape[0]):
        acc = acc + q[:, d, None] * rt[d]
    return acc


def ivf_probe_ref(q, qsum, probe, rows, aux):
    """Plain torch version of #10: ``scores [B, nprobe, L] f32``, the
    fixed-order dot of each query with every row of its probed partitions
    (SQ8 words unpacked to dim order), then ``((dot * mul) + (qsum * add)) -
    pen``; ``-inf`` where a probe id is not a partition."""
    n_parts, L, width = rows.shape
    b, nprobe = probe.shape
    pid = probe.long()
    ok = (pid >= 0) & (pid < n_parts)
    pid = torch.where(ok, pid, 0)
    blk = rows[pid]  # [B, nprobe, L, W]
    if rows.dtype == torch.int32:
        blk = torch.cat([(blk >> (8 * j)) & 0xFF for j in range(4)], dim=-1)
    dot = _ordered_bdot(q, blk.reshape(b, nprobe * L, -1)).reshape(b, nprobe, L)
    a = aux[pid]  # [B, nprobe, 3, L]
    s = (dot * a[:, :, 0]) + (qsum[:, None, None] * a[:, :, 1])
    return torch.where(ok[:, :, None], s - a[:, :, 2], -torch.inf)


def probe_runs(probe: torch.Tensor, n_parts: int, group: int = PROBE_GROUP):
    """#10's schedule: the ``M = B * nprobe`` probes sorted by partition, on
    the probes' device and with no host synchronization.

    Returns int32 ``[M]`` tensors ``(order, spid, gsize)``: entry ``i`` is the
    (query, probe) slot ``order[i] = b * nprobe + j`` of partition
    ``spid[i]`` (``-1`` where the probe id is not a partition: those entries
    are kept, as one run, and score ``-inf``). The sort key ``(pid + 1) * M +
    slot`` is unique, so the order is deterministic: by partition, then by
    slot. A run (the entries of one partition) is cut into groups of at most
    ``group`` entries; ``gsize[i]`` is the size of the group starting at
    ``i``, and 0 where no group starts."""
    flat = probe.reshape(-1).long()
    m = flat.numel()
    pid = torch.where((flat >= 0) & (flat < n_parts), flat, -1)
    key = torch.sort((pid + 1) * m + torch.arange(m, device=flat.device)).values
    order, spid = key % m, key // m - 1
    i = torch.arange(m, device=flat.device)
    new = torch.ones(m, dtype=torch.bool, device=flat.device)
    new[1:] = spid[1:] != spid[:-1]
    last = torch.ones(m, dtype=torch.bool, device=flat.device)
    last[:-1] = new[1:]
    start = torch.cummax(torch.where(new, i, 0), 0).values
    end = torch.flip(torch.cummin(torch.flip(torch.where(last, i, m - 1), (0,)), 0).values, (0,))
    pos = i - start
    gsize = torch.where(pos % group == 0, torch.clamp(end + 1 - i, max=group), 0)
    return order.to(torch.int32), spid.to(torch.int32), gsize.to(torch.int32)


def ivf_probe_scores(q, qsum, probe, rows, aux, sched=None):
    """Probed-partition scores of #10, ``[B, nprobe, L] f32``: ``q [B, D_pad]
    f32``, ``qsum [B] f32``, ``probe [B, nprobe] int32``, ``rows [P, L, W]``
    int32 SQ8 words (D_pad = 4 W) or ``[P, L, D_pad]`` f32, ``aux [P, 3, L]
    f32``. CUDA tensors launch ``csrc/ivf_probe.cu`` on the current stream
    (or raise): the schedule of :func:`probe_runs` (ranked on the card up to
    ``SCHED_RANK_MAX`` probes, else by :func:`probe_runs`), then the scan;
    CPU tensors take :func:`ivf_probe_ref`. ``sched``, when given, is an
    int32 ``[3, B * nprobe]`` tensor on the probes' device that receives the
    schedule ``(order, spid, gsize)``; else it is scratch."""
    _check_probe(q, qsum, probe, rows, aux)
    (b, nprobe), (n_parts, L, width) = probe.shape, rows.shape
    m = b * nprobe
    if sched is not None and (sched.dtype != torch.int32 or sched.shape != (3, m)
                              or sched.device != probe.device or not sched.is_contiguous()):
        raise ValueError(f"sched must be a contiguous int32 [3, {m}] tensor on {probe.device}")
    if _kernel_route(q, qsum, probe, rows, aux):
        if sched is not None:
            torch.stack(probe_runs(probe, n_parts), out=sched)
        return ivf_probe_ref(q, qsum, probe, rows, aux)
    if sched is None:
        sched = torch.empty((3, m), dtype=torch.int32, device=q.device)
    ready = m > SCHED_RANK_MAX  # the schedule from probe_runs, not the ranking kernel
    if ready:
        torch.stack(probe_runs(probe, n_parts), out=sched)
    out = torch.empty((b, nprobe, L), dtype=torch.float32, device=q.device)
    _launch(LAUNCHES, "ivf_probe", "ivf_probe", "ivf_probe_launch",
            _P * 7 + (ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int),
            q, qsum, probe, rows, aux, sched, out, m, nprobe, n_parts, L, width,
            int(rows.dtype == torch.int32), int(ready))
    return out


def probe_operands(queries, cents, cent_sq, words, *, nprobe, metric):
    """Route ``queries [B, D]`` and prepare #10's operands: ``(q [B, D_pad]
    f32, qsum [B], probe [B, nprobe] int32, |q|^2 [B])``. Cosine queries are
    normalized, euclidean ones doubled; SQ8 queries are rounded to bf16 after
    ``qsum`` is taken from the unrounded ones."""
    from velesdb_tpu_torch.index.ivf import _route_mask

    metric = DistanceMetric.parse(metric)
    q = torch.as_tensor(queries, dtype=torch.float32, device=cents.device)
    quant = words.dtype == torch.int32
    d_pad = 4 * words.shape[2] if quant else words.shape[2]
    qq = torch.sum(q * q, dim=1)
    qn = normalize(q) if metric is DistanceMetric.COSINE else q
    route = qn @ cents.T
    if metric is DistanceMetric.EUCLIDEAN:
        route = route - 0.5 * cent_sq[None, :]
    _, probe = first_topk(_route_mask(route, cent_sq), nprobe)
    qk = F.pad(2.0 * qn if metric is DistanceMetric.EUCLIDEAN else qn, (0, d_pad - q.shape[1]))
    qsum = torch.sum(qk, dim=1)
    if quant:
        qk = qk.to(torch.bfloat16).float()
    return qk.contiguous(), qsum, probe.to(torch.int32).contiguous(), qq


def ivf_probe_topk(queries, cents, cent_sq, words, aux, flat_rows, *, k, nprobe, metric):
    """Probe-kernel search: routing matmul, #10 over the probed partitions,
    exact selection.

    ``queries [B, D] f32`` raw; ``cents [P, D] / cent_sq [P]`` partition
    routing; ``words`` either ``[P, L, W] int32`` packed SQ8 codes or ``[P, L,
    D] f32`` rows (dtype-dispatched); ``aux [P, 3, L] f32`` the (mul, add, pen)
    epilogue operands; ``flat_rows [P*L] int64`` original row ids.

    Returns ``(values [B, k], row_ids [B, k] int64)`` in the metric's native
    orientation (distance ascending for euclidean), ``-1`` ids for empty."""
    metric = DistanceMetric.parse(metric)
    q, qsum, probe, qq = probe_operands(queries, cents, cent_sq, words, nprobe=nprobe,
                                        metric=metric)
    b, L = q.shape[0], words.shape[1]
    scores = ivf_probe_scores(q, qsum, probe, words, aux)
    vals, pos = first_topk(scores.reshape(b, nprobe * L), min(k, nprobe * L))
    pid = torch.gather(probe, 1, pos // L).long()
    rows = flat_rows[pid * L + pos % L]
    empty = ~torch.isfinite(vals)
    rows = torch.where(empty, -1, rows)
    if metric is DistanceMetric.EUCLIDEAN:
        d2 = (qq[:, None] - vals).clamp_min(0.0)
        return torch.where(empty, torch.inf, torch.sqrt(d2)), rows
    return torch.where(empty, -torch.inf, vals), rows
