"""The experiments' own kernels: three SQ8 epilogues (#12) and the row gather (#11).

Counterparts of the Pallas functions defined inside ``main()`` of
``benchmarks/exp_sq8i_v2.py`` (``_k_v2``, ``_k_v2h``, ``_k_v3``) and
``benchmarks/exp_gather_kernel.py`` (``kern``, ``kern_db``). The other five
Pallas functions of the experiments compute functions the package already
has a kernel for, and the experiments call those (``_k_v1`` is #7,
``sq8i_bucket_gm``; ``_k_v5`` and ``_k_hme`` are #1, ``sq8pd_bucket_gm``;
``_k_hm`` is #5, ``hamming_mxu_gm``; ``exp_topk.py``'s ``_bucket_kernel`` is
#2 / #2b, ``dense_bucket_gm``, on the doubled queries).

- :func:`sq8i_v2_bucket_gm` launches ``csrc/sq8i_bucket.cu``'s second entry:
  #7's int8 dot and bucket select with the epilogue ``v2`` (the rank-1
  corrections summed first), ``v2h`` (the same, every step rounded to bf16)
  or ``v3`` (the raw dot). :func:`sq8i_v2_bucket_ref` is its plain version.
- :func:`row_gather_scores` launches ``csrc/row_gather.cu``: ``q [8, D] .
  corpus[idx]^T`` with each row brought to shared memory by one bulk copy,
  ``group`` rows a stage, one or two stages in flight (``stages``).
  :func:`row_gather_scores_ref` is its plain version.

Every kernel is bit for bit against its plain version on the card. A wrapper
takes the plain version only for CPU tensors; on CUDA tensors it launches its
kernel on the current stream or raises.
"""

from __future__ import annotations

import ctypes

import torch

from velesdb_tpu_torch.ops.bucket_kernel import (
    _IIJ,
    _P,
    _bucket_select,
    _check_rows,
    _gm_gi,
    _int8_dot,
    _kernel_route,
    _launch,
    _ordered_dot,
)

__all__ = [
    "LAUNCHES",
    "SQ8I_VARIANTS",
    "row_gather_scores",
    "row_gather_scores_ref",
    "sq8i_v2_bucket_gm",
    "sq8i_v2_bucket_ref",
]

# Kernel launches per function, counted where the CUDA kernel is launched and
# nowhere else (the CPU path of a wrapper does not count): one counter per
# epilogue of sq8i_v2_bucket_gm and per depth of row_gather_scores.
LAUNCHES = {"sq8i_v2_bucket": 0, "sq8i_v2h_bucket": 0, "sq8i_v3_bucket": 0,
            "row_gather": 0, "row_gather_db": 0}

SQ8I_VARIANTS = {"v2": 0, "v2h": 1, "v3": 2}
_V2_MAX_DPAD = 1024  # |doti| <= 127^2 * 1024 < 2^24: v3's f32 scores are exact
# csrc/row_gather.cu: rows a stage holds at most (kMaxGroup), and the dynamic
# shared memory a block may take (kSmemMax)
_GATHER_MAX_GROUP = 64
_GATHER_SMEM_MAX = 232_448


def _check_sq8i_v2(qi, rows8, aux, qaux, chunk: int, variant: str) -> None:
    if variant not in SQ8I_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {sorted(SQ8I_VARIANTS)}")
    _check_rows(qi, rows8, torch.int8, torch.int8, chunk)
    if qi.shape[1] % 16 or qi.shape[1] > _V2_MAX_DPAD:
        raise ValueError(f"D_pad={qi.shape[1]} must be a multiple of 16, <= {_V2_MAX_DPAD}")
    if variant == "v3":
        return
    want = torch.bfloat16 if variant == "v2h" else torch.float32
    if aux is None or qaux is None or aux.dtype != want or qaux.dtype != want:
        raise TypeError(f"{variant} needs aux and qaux in {want}")
    if aux.ndim != 2 or aux.shape[0] < 3 or aux.shape[1] != rows8.shape[0]:
        raise ValueError(f"aux must be [>=3, N={rows8.shape[0]}], got {tuple(aux.shape)}")
    if qaux.ndim != 2 or qaux.shape[0] != qi.shape[0] or qaux.shape[1] < 3:
        raise ValueError(f"qaux must be [B_pad={qi.shape[0]}, >=3], got {tuple(qaux.shape)}")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bf16 and back: one rounding to nearest even."""
    return x.to(torch.bfloat16).float()


def sq8i_v2_bucket_ref(qi, rows8, aux, qaux, chunk: int, variant: str):
    """Plain torch version of the three epilogues, ``(gm f32, gi int32)
    [B_pad, N/chunk*128]``. With ``doti = qi . rows8`` (exact int32),
    ``(scale, am, pen) = aux[0:3]`` and ``(sqi, niq) = qaux[:, 1:3]``
    (``niq = -1/qs``):

    - ``v2``:  ``s = doti*scale + (sqi*am + niq*pen)``, each product and sum
      rounded to fp32 in that order;
    - ``v2h``: the same on bf16 ``aux`` / ``qaux``, with ``doti``, the
      correction, the scaled dot and the sum each rounded to bf16 (products
      of two bf16 values are exact in fp32); the select runs on the bf16
      values;
    - ``v3``:  ``s = doti``.

    Then the bucket select, ties to the smallest slice."""
    doti = _int8_dot(qi, rows8)
    if variant == "v3":
        return _bucket_select(doti.float(), chunk)
    a = aux[:3].float()
    sq, niq = qaux[:, 1].float(), qaux[:, 2].float()
    corr = sq[:, None] * a[1][None, :] + niq[:, None] * a[2][None, :]
    if variant == "v2":
        return _bucket_select(doti.float() * a[0][None, :] + corr, chunk)
    t = _bf16(_bf16(doti.float()) * a[0][None, :])
    return _bucket_select(_bf16(t + _bf16(corr)), chunk)


def sq8i_v2_bucket_gm(qi, rows8, aux, qaux, chunk: int, variant: str):
    """Bucket winners of #7's int8 scan under the epilogue ``variant``
    (``"v2"``, ``"v2h"`` or ``"v3"``): ``qi [B_pad, D_pad] int8``, ``rows8
    [N, D_pad] int8``; ``aux [>=3, N]`` (rows scale / am / pen) and ``qaux
    [B_pad, >=3]`` (columns 1 / 2: sqi / -1/qs), f32 for ``v2``, bf16 for
    ``v2h``, unused (None) for ``v3``. Returns ``(gm f32, gi int32)``. CUDA
    tensors launch ``csrc/sq8i_bucket.cu`` (``sq8i_v2_bucket_launch``); CPU
    tensors take :func:`sq8i_v2_bucket_ref`."""
    _check_sq8i_v2(qi, rows8, aux, qaux, chunk, variant)
    tensors = (qi, rows8) if variant == "v3" else (qi, rows8, aux, qaux)
    if _kernel_route(*tensors):
        return sq8i_v2_bucket_ref(qi, rows8, aux, qaux, chunk, variant)
    (b_pad, d_pad), n = qi.shape, rows8.shape[0]
    gm, gi = _gm_gi(b_pad, n, chunk, qi.device)
    none = variant == "v3"
    _launch(LAUNCHES, f"sq8i_{variant}_bucket", "sq8i_bucket", "sq8i_v2_bucket_launch",
            _P * 6 + _IIJ + (ctypes.c_int, ctypes.c_int), qi, rows8,
            None if none else aux, None if none else qaux, gm, gi, b_pad, n, d_pad, chunk,
            0 if none else qaux.shape[1], SQ8I_VARIANTS[variant])
    return gm, gi


def _gather_smem_bytes(stages: int, group: int, d: int) -> int:
    """Shared memory of a ``csrc/row_gather.cu`` block (its ``smem_bytes``):
    32 bytes of barriers, ``stages * group`` ids rounded up to 16 bytes, then
    the 8 queries and ``stages * group`` rows, each ``D`` floats padded to an
    odd number of 16-byte units."""
    rs = d + 4 if d % 8 == 0 else d
    return 32 + (4 * stages * group + 15) // 16 * 16 + 4 * rs * (8 + stages * group)


def _check_gather(q, corpus, idx, group: int, stages: int) -> None:
    """The kernel's contract, checked alike for CPU and CUDA tensors, before
    any launch."""
    if q.dtype != torch.float32 or corpus.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"expected q, corpus float32 and idx int32, got {q.dtype}, "
                        f"{corpus.dtype}, {idx.dtype}")
    if q.ndim != 2 or q.shape[0] != 8 or corpus.ndim != 2 or q.shape[1] != corpus.shape[1]:
        raise ValueError(f"expected q [8, D] and corpus [N, D], got {tuple(q.shape)}, "
                         f"{tuple(corpus.shape)}")
    if idx.ndim != 1 or idx.shape[0] < 1:
        raise ValueError(f"idx must be [R], R >= 1, got {tuple(idx.shape)}")
    if q.shape[1] % 4:
        raise ValueError(f"D={q.shape[1]} must be a multiple of 4 (16-byte row copies)")
    if not 1 <= group <= _GATHER_MAX_GROUP or stages not in (1, 2):
        raise ValueError(f"group={group} must be in [1, {_GATHER_MAX_GROUP}], "
                         f"stages={stages} 1 or 2")
    if not (q.is_contiguous() and corpus.is_contiguous() and idx.is_contiguous()):
        raise ValueError("q, corpus and idx must be contiguous")
    if q.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError("q and corpus must start on a 16-byte boundary (one bulk copy a row)")
    smem = _gather_smem_bytes(stages, group, q.shape[1])
    if smem > _GATHER_SMEM_MAX:
        raise ValueError(f"{stages} x {group} rows of D={q.shape[1]} take {smem} bytes of "
                         f"shared memory, over the {_GATHER_SMEM_MAX} a block has")


def row_gather_scores_ref(q, corpus, idx):
    """Plain torch version of #11: ``out [8, R] = q . corpus[idx]^T`` summed
    over the dims in order, one rounded multiply and add per term."""
    return _ordered_dot(q, corpus[idx.long()])


def row_gather_scores(q, corpus, idx, *, group: int = 16, stages: int = 1):
    """Scores of 8 queries against gathered corpus rows, ``out [8, R] f32``:
    ``q [8, D] f32``, ``corpus [N, D] f32``, ``idx [R] int32`` in ``[0, N)``,
    all contiguous, ``q`` and ``corpus`` 16-byte aligned. On the card each
    row is brought to shared memory by one bulk copy, ``group`` rows a stage,
    and ``stages`` stages in flight (1: wait for each group before the next
    is issued; 2: issue the next before waiting). CUDA tensors launch
    ``csrc/row_gather.cu``; CPU tensors take :func:`row_gather_scores_ref`.
    On the card an id outside ``[0, N)`` scores NaN (no row is read); on the
    CPU it raises."""
    _check_gather(q, corpus, idx, group, stages)
    if _kernel_route(q, corpus, idx):
        return row_gather_scores_ref(q, corpus, idx)
    (n, d), r = corpus.shape, idx.shape[0]
    out = torch.empty((8, r), dtype=torch.float32, device=q.device)
    _launch(LAUNCHES, "row_gather" if stages == 1 else "row_gather_db", "row_gather",
            "row_gather_launch",
            _P * 4 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int),
            q, corpus, idx, out, n, d, r, group, stages)
    return out
