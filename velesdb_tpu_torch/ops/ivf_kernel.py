"""IVF probe op: route each query to its partitions, score them, select.

Counterpart of ``velesdb_tpu/ops/ivf_kernel.py``. ``ivf_probe_topk``
(``:120``) routes the batch with one ``[B, P]`` matmul, scores every probed
partition with kernel #10 and selects the top-k outside the kernel. The TPU
kernel ``_probe_kernel`` (``:82``) walks a (query, probe) grid in order with a
scalar-prefetched probe id choosing each partition's DMA; here the
hand-written CUDA kernel ``csrc/ivf_probe.cu`` gives every (query, probe,
128-row tile) its own block (:func:`ivf_probe_scores`), and
:func:`ivf_probe_ref` is its plain version.

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
and are not carried over (ROADMAP.md).
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
    "probe_operands",
]

# The reference's dispatch rule (``:61-62``): the kernel path serves small
# batches whose partition blocks are big enough; the plain probing path
# (``index/ivf.py:ivf_search_impl``) serves everything else.
MIN_BLOCK_BYTES = 65536  # L * D * itemsize below this: per-step overhead dominates
MAX_KERNEL_BATCH = 64  # probing only wins at small batch anyway

# Kernel launches, counted where the CUDA kernel is launched and nowhere else.
LAUNCHES = {"ivf_probe": 0}

_MAX_DPAD = 12288  # the query row in 48 KB of shared memory


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


def ivf_probe_scores(q, qsum, probe, rows, aux):
    """Probed-partition scores of #10, ``[B, nprobe, L] f32``: ``q [B, D_pad]
    f32``, ``qsum [B] f32``, ``probe [B, nprobe] int32``, ``rows [P, L, W]``
    int32 SQ8 words (D_pad = 4 W) or ``[P, L, D_pad]`` f32, ``aux [P, 3, L]
    f32``. CUDA tensors launch ``csrc/ivf_probe.cu`` on the current stream
    (or raise); CPU tensors take :func:`ivf_probe_ref`."""
    _check_probe(q, qsum, probe, rows, aux)
    if _kernel_route(q, qsum, probe, rows, aux):
        return ivf_probe_ref(q, qsum, probe, rows, aux)
    (b, nprobe), (n_parts, L, width) = probe.shape, rows.shape
    out = torch.empty((b, nprobe, L), dtype=torch.float32, device=q.device)
    _launch(LAUNCHES, "ivf_probe", "ivf_probe", "ivf_probe_launch",
            _P * 6 + (ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int),
            q, qsum, probe, rows, aux, out, b, nprobe, n_parts, L, width,
            int(rows.dtype == torch.int32))
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
