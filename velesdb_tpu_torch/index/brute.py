"""Brute-force (exact) device index over a padded slot array.

Counterpart of ``velesdb_tpu/index/brute.py`` for FULL, F16, BF16, SQ8 and
BINARY storage. The corpus lives as padded ``[N_pad, ...]`` tensors on the
index's device and every search scores the whole batch against it. The serve
cores, which :meth:`BruteForceIndex.serve_engine` names as the reference
does:

- FULL, F16, BF16 (f32, f16 or bf16 rows; cosine rows pre-normalized), at D
  < 512 and where the bucket collision guard holds (at least
  ``BUCKET_MIN_ROWS`` padded rows), in this order:
  1. ``int8-assist-pd`` (FULL): the per-dim int8 scan (the ``PdEnc``
     epilogue of ``csrc/sq8i_bucket.cu``) keeps m = clamp(2k-4, 16, 256)
     candidates, then an exact fp32 rerank;
  2. ``int8-assist`` (FULL, where ``sq8pd_build`` refuses the corpus and D <
     ``_SQ8I_MAX_DIM``): the per-row int8 scan (``csrc/sq8i_bucket.cu``) over
     an SQ8 shadow, then the exact rerank;
  3. ``split-bf16`` (FULL, where ``sq8pd_build`` refuses and D >=
     ``_SQ8I_MAX_DIM``): the (hi, lo) bf16 scan on the tensor cores (the
     split mode of ``csrc/dense_bucket_tc.cu``);
  4. ``bucket-f32`` (F16/BF16, and FULL where the assist guard fails): the
     float bucket scan on the tensor cores (``csrc/dense_bucket_tc.cu``: half
     rows as they are, f32 rows split into bf16 pairs in the kernel);
  5. ``streamed-scan`` — everything else: chunked fp32 matmul + exact top-k
     (half corpora upcast one chunk at a time).
- FULL, F16, BF16 with the hamming or jaccard metric: ``fused-xla``, the
  reference's name for its fused XLA program (``_fused_search``): the rows
  binarized once a rebuild (``v > 0.5``), one f32 product of 0/1 rows, then
  ``first_topk`` (ties to the lowest slot, as ``lax.top_k``). Plain torch.
- SQ8 (uint8 codes + per-row affine): ``sq8-int8`` (``csrc/sq8i_bucket.cu``)
  where the bucket collision guard holds and D < ``_SQ8I_MAX_DIM``,
  ``sq8-bucket`` (the SQ8 mode of ``csrc/dense_bucket_tc.cu``, block-packed
  words unpacked on the tensor cores) where it holds
  and D >= ``_SQ8I_MAX_DIM``, else ``sq8-streamed`` (plain torch).
- BINARY (packed sign bits, ``v >= 0``), under every metric: ``hamming-mxu``
  (``csrc/sq8i_bucket.cu``) while the 1 byte/bit shadow fits
  ``VELESDB_HAMMING_MXU_MAX_BYTES``, else ``hamming-bucket``
  (``csrc/hamming_bucket.cu``: the packed words on the int8 tensor cores)
  where the guard holds, else ``hamming-topk``
  (``csrc/hamming_topk.cu``, exact). Values are the Hamming distance of the
  sign bits for hamming and euclidean, ``1 - dist/dim`` for the
  higher-is-better metrics (cosine, dot, jaccard), as in the reference
  (``brute.py:577-659``; its CPU path ``_fused_search`` computes the same).
- SQ8 with hamming or jaccard builds and raises the reference's
  ``ValueError`` at search (``brute.py:920``).

There is no fallback between cores at run time: a failing kernel raises.
``_SQ8I_MAX_DIM`` is the reference's build-time dispatch rule (``:79``), read
at each rebuild; lowering it is the one way to the ``split-bf16`` and
``sq8-bucket`` cores.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from velesdb_tpu_torch.ops.bucket_kernel import (
    _HAM_BIG,
    BUCKET_MIN_ROWS,
    HAMMING_CHUNK,
    _div,
    _pd_invalid_pen,
    bucket_chunk,
    bucket_topk_entry,
    bucket_topk_hl,
    first_topk,
    hamming_bits_rows,
    hamming_bucket_topk,
    hamming_mxu_topk,
    split_f32_rows,
    sq8_bucket_topk,
    sq8_int8_rows,
    sq8i_bucket_topk,
    sq8i_rerank_topk,
    sq8pd_build,
    sq8pd_ptile,
    sq8pd_rerank_topk,
)
from velesdb_tpu_torch.ops.distance import (
    SET_METRICS,
    DistanceMetric,
    binarize,
    hamming_distances,
    normalize,
    pairwise_scores,
    set_scores,
)
from velesdb_tpu_torch.ops.pallas_kernels import hamming_topk
from velesdb_tpu_torch.ops.quantization import (
    STORAGE_DTYPE,
    SQ8Vectors,
    StorageMode,
    binary_quantize,
    sq8_dequantize,
    sq8_dot_scores,
    sq8_pack_blocked,
    sq8_quantize,
)
from velesdb_tpu_torch.ops.streamed import sq8_streamed_topk, streamed_topk
from velesdb_tpu_torch.ops.topk import DENSE_ELEMS, pad_mask

__all__ = ["BruteForceIndex", "pad_rows", "state_from_jax"]

_FLOAT_MODES = (StorageMode.FULL, StorageMode.F16, StorageMode.BF16)

# The reference's dispatch constant (``brute.py:79``): the per-row int8 shadow
# (FULL) and int8 rows (SQ8) are built below this dim; at or above it FULL
# builds the split-bf16 (hi, lo) shadow and SQ8 the block-packed words.
# Read at each rebuild.
_SQ8I_MAX_DIM = [1 << 30]


def _ham_mxu_max_bytes() -> int:
    """Device-memory budget of the 1 byte/bit Hamming shadow, read at each
    rebuild as the reference reads it (``brute.py:63-71``)."""
    return int(os.environ.get("VELESDB_HAMMING_MXU_MAX_BYTES", 4 << 30))


def _bucket_safe(n_pad: int, chunk: int, k: int) -> bool:
    """Collision-recall guard: one winner per 128-lane bucket loses
    ~(k-1)/(2*nbuckets) of the true top-k; keep that under ~1%."""
    return n_pad >= BUCKET_MIN_ROWS and (k - 1) <= 0.02 * (n_pad // chunk) * 128


def pad_rows(n: int, minimum: int = 1024) -> int:
    """Padded row count: the next power of two up to 64K rows, then
    power-of-two/16 steps (multiples of 8192, so every kernel chunk divides
    the padded count)."""
    target = max(n, minimum)
    pow2 = 1 << (target - 1).bit_length()
    if pow2 <= 65536:
        return pow2
    step = pow2 // 16
    return ((target + step - 1) // step) * step


def _pd_m(k: int) -> int:
    """Coarse candidates per query for a top-k assist search."""
    return min(max(2 * k - 4, 16), 256)


def _affine_fold(sq: SQ8Vectors, valid: torch.Tensor, metric: DistanceMetric):
    """Per-metric scan state of an SQ8 corpus (reference ``:285-327``):
    ``(scale, minv, pen, deq_sq)``. Cosine folds ``1/|deq|`` into scale and
    minv so raw dots are cosine scores; euclidean's penalty is ``|deq|^2``;
    knocked-out rows carry ``pen = +inf``."""
    deq_sq = torch.sum(sq8_dequantize(sq) ** 2, dim=1)
    scale, minv = sq.scale, sq.minv
    base = torch.zeros_like(deq_sq)
    if metric is DistanceMetric.COSINE:
        inv = torch.where(deq_sq > 1e-30, torch.rsqrt(deq_sq.clamp_min(1e-30)), 0.0)
        scale, minv = scale * inv, minv * inv
    elif metric is DistanceMetric.EUCLIDEAN:
        base = deq_sq
    return scale, minv, torch.where(valid, base, torch.inf), deq_sq


def _assist_shadow(x: torch.Tensor, valid: torch.Tensor, metric: DistanceMetric):
    """The per-row SQ8 shadow of a FULL corpus that ``sq8pd_build`` refused:
    ``(rows8, scale, minv, pen, shift)``. It refuses corpora whose
    norms dwarf their spread, and per-row codes of such rows spend their 255
    steps on the offset. For euclidean the port therefore quantizes the rows
    centered on the valid rows' mean ``shift`` (the coarse pass shifts the
    queries alike; distances are unchanged). The reference quantizes the raw
    rows (ROADMAP.md, faults of the reference); cosine and dot, whose pd
    shadow is never refused for its penalty, keep ``shift = None``."""
    shift = None
    if metric is DistanceMetric.EUCLIDEAN:
        count = valid.sum().clamp_min(1).to(torch.float32)
        shift = torch.sum(torch.where(valid[:, None], x, 0.0), dim=0) / count
        x = x - shift[None, :]
    sq = sq8_quantize(x)
    scale, minv, pen, _ = _affine_fold(sq, valid, metric)
    return sq8_int8_rows(sq.codes), scale, minv, pen, shift


class BruteForceIndex:
    """Exact search over a device-resident padded corpus."""

    def __init__(self, dim: int, metric: DistanceMetric,
                 storage_mode: StorageMode = StorageMode.FULL, device="cuda"):
        self.dim = int(dim)
        self.metric = DistanceMetric.parse(metric)
        self.storage_mode = StorageMode.parse(storage_mode)
        self.device = torch.device(device)
        self.n_pad = 0
        self._chunk = 0  # bucket_chunk(n_pad): the one chunk rule of #1/#7/#5
        self._valid = None  # [N_pad] bool
        # FULL, F16, BF16
        self._full_w = None  # [N_pad, round_up(D, 8)] f32/f16/bf16, zero-padded
        self._full = None  # [:, :D] view of _full_w (cosine rows pre-normalized)
        self._full_sqnorm = None  # [N_pad] f32, from the f32 rows
        self._bucket_pen = None  # [N_pad] f32: |c|^2 (euclidean) or 0, +inf invalid
        self._full_hl = None  # (hi, lo) bf16 [N_pad, D_pad] when the pd build refuses
        self._assist_pd = None  # (rows_pd, pen_int, pen_f32, sdim, mid, qu)
        self._pd_ptile = None  # [N_pad] int32, built with the shadow
        self._assist = None  # (rows8, scale, minv, pen, shift) when the pd build refuses
        # SQ8
        self._sq8 = None  # SQ8Vectors (codes [N_pad, D] uint8, scale, minv)
        self._sq_norm = None  # [N_pad] f32: |deq|^2 (euclidean), |deq| (cosine)
        self._sq8_rows8 = None  # [N_pad, D_pad] int8 (code - 128), D < _SQ8I_MAX_DIM
        self._sq8_words = None  # [N_pad, D_pad/4] int32 packed codes, D >= _SQ8I_MAX_DIM
        self._sq8_scale = None  # [N_pad] f32 (cosine: scale/|deq| folded)
        self._sq8_minv = None  # [N_pad] f32 (cosine: minv/|deq| folded)
        self._sq8_pen = None  # [N_pad] f32 additive penalty, +inf knocked out
        # hamming / jaccard on float storage
        self._set_bits = None  # [N_pad, D] f32 0/1 of the stored rows
        self._set_count = None  # [N_pad] f32 ones a row
        # BINARY
        self._packed = None  # [N_pad, W] int32 words (uint32 bits)
        self._ham_bits = None  # [N_pad, D_pad] int8 0/1, while the budget allows
        self._ham_aux = None  # [N_pad] int32 |c| + _HAM_BIG * knocked_out

    # -- build -------------------------------------------------------------

    def rebuild(self, slots: np.ndarray, valid: np.ndarray) -> None:
        """Upload the host slot array ``[used, D]`` as padded device state,
        with the shadows its serve cores need."""
        used = slots.shape[0]
        n_pad = pad_rows(used)
        x = torch.zeros((n_pad, self.dim), dtype=torch.float32, device=self.device)
        x[:used] = torch.from_numpy(np.ascontiguousarray(slots, np.float32)).to(self.device)
        vmask = torch.zeros(n_pad, dtype=torch.bool, device=self.device)
        vmask[:used] = torch.from_numpy(np.array(valid, dtype=bool)).to(self.device)
        self._reset(n_pad, vmask)
        mode = self.storage_mode
        if self.metric in SET_METRICS and mode in _FLOAT_MODES:
            # membership of the stored (possibly half-rounded) values, once;
            # no search of these metrics reads the float rows
            self._set_bits = binarize(x.to(STORAGE_DTYPE[mode]))
            self._set_count = torch.sum(self._set_bits, dim=1)
        elif mode in _FLOAT_MODES:
            if self.metric is DistanceMetric.COSINE:
                # cosine is normalization-invariant: store rows pre-normalized
                x = normalize(x)
            # norms and penalty from the f32 rows, before any half cast
            self._full_sqnorm = torch.sum(x * x, dim=1)
            base = (self._full_sqnorm if self.metric is DistanceMetric.EUCLIDEAN
                    else torch.zeros_like(self._full_sqnorm))
            self._bucket_pen = torch.where(vmask, base, torch.inf)
            self._set_full(x.to(STORAGE_DTYPE[mode]))
            if mode is StorageMode.FULL and self.dim < 512 and n_pad >= BUCKET_MIN_ROWS:
                self._set_pd(sq8pd_build(x, vmask, self.dim, self.metric))
                if self._assist_pd is None and self.dim < _SQ8I_MAX_DIM[0]:
                    self._assist = _assist_shadow(x, vmask, self.metric)
                elif self._assist_pd is None:
                    d_pad = -(-self.dim // 128) * 128
                    self._full_hl = split_f32_rows(F.pad(x, (0, d_pad - self.dim)))
        elif mode is StorageMode.SQ8:
            sq = sq8_quantize(x)
            scale, minv, pen, deq_sq = _affine_fold(sq, vmask, self.metric)
            self._sq8 = sq
            if self.metric is DistanceMetric.EUCLIDEAN:
                self._sq_norm = deq_sq
            elif self.metric is DistanceMetric.COSINE:
                self._sq_norm = torch.sqrt(deq_sq)
            if self.dim < _SQ8I_MAX_DIM[0]:
                self._sq8_rows8 = sq8_int8_rows(sq.codes)
            else:
                self._sq8_words = sq8_pack_blocked(sq.codes)
            self._sq8_scale, self._sq8_minv, self._sq8_pen = scale, minv, pen
        else:
            self._packed = binary_quantize(x)
            d_pad = -(-self.dim // 128) * 128
            if n_pad * d_pad <= _ham_mxu_max_bytes():
                bits = hamming_bits_rows(x, self.dim)
                csum = bits.to(torch.int32).sum(dim=1)
                self._ham_bits = bits
                self._ham_aux = torch.where(vmask, csum, csum + _HAM_BIG).to(torch.int32)

    def _reset(self, n_pad: int, valid: torch.Tensor) -> None:
        for name in ("_full_w", "_full", "_full_sqnorm", "_bucket_pen", "_full_hl", "_assist_pd",
                     "_pd_ptile", "_assist", "_sq8", "_sq_norm", "_sq8_rows8", "_sq8_words",
                     "_sq8_scale", "_sq8_minv", "_sq8_pen", "_set_bits", "_set_count",
                     "_packed", "_ham_bits", "_ham_aux"):
            setattr(self, name, None)
        self.n_pad = n_pad
        self._chunk = bucket_chunk(n_pad)
        self._valid = valid

    def _set_full(self, rows: torch.Tensor) -> None:
        """Store the float rows ``[N_pad, D]`` once, zero-padded in width to a
        multiple of 8 (what ``csrc/dense_bucket_tc.cu`` reads): ``bucket-f32``
        hands ``_full_w`` to the kernel without a copy, the other cores read
        its ``[:, :D]`` view ``_full``."""
        pad = (-self.dim) % 8
        self._full_w = F.pad(rows, (0, pad)) if pad else rows.contiguous()
        self._full = self._full_w[:, :self.dim]

    def _set_pd(self, pd) -> None:
        self._assist_pd = pd
        self._pd_ptile = sq8pd_ptile(pd[1], self._chunk) if pd is not None else None

    def load_state(self, state: dict) -> None:
        """Adopt padded device state, e.g. from :func:`state_from_jax`."""
        self._reset(state["valid"].shape[0], state["valid"])
        for key, value in state.items():
            if key not in ("valid", "assist_pd", "full"):
                setattr(self, f"_{key}", value)
        if state.get("full") is not None:
            self._set_full(state["full"])
        if state.get("assist_pd") is not None:
            self._set_pd(state["assist_pd"])

    # -- search ------------------------------------------------------------

    def _plan(self, k: int) -> tuple[str, int]:
        """``(engine, m)`` for a top-``k`` search (``m``: coarse candidates of
        an assist core). The single source of the dispatch rule for
        :meth:`search` and :meth:`serve_engine`."""
        mode, n_pad = self.storage_mode, self.n_pad
        if mode is StorageMode.BINARY:  # every metric scores the sign bits
            if self._ham_bits is not None and _bucket_safe(n_pad, self._chunk, k):
                return "hamming-mxu", 0
            if _bucket_safe(n_pad, HAMMING_CHUNK, k):
                return "hamming-bucket", 0
            return "hamming-topk", 0
        if self.metric in SET_METRICS and mode in _FLOAT_MODES:
            return "fused-xla", 0
        if mode in _FLOAT_MODES:  # reference ``:373-400``
            if self.dim >= 512:
                return "streamed-scan", 0
            m = _pd_m(k)
            if m >= k and _bucket_safe(n_pad, self._chunk, m):
                if self._assist_pd is not None:
                    return "int8-assist-pd", m
                if self._assist is not None:
                    return "int8-assist", m
            if _bucket_safe(n_pad, self._chunk, k):
                return ("split-bf16" if self._full_hl is not None else "bucket-f32"), 0
            return "streamed-scan", 0
        if _bucket_safe(n_pad, self._chunk, k):
            return ("sq8-int8" if self._sq8_rows8 is not None else "sq8-bucket"), 0
        return "sq8-streamed", 0

    def serve_engine(self, k: int = 10) -> str:
        """Name of the core a ``search(..., k)`` would run right now."""
        return self._plan(min(k, self.n_pad))[0]

    def search(self, queries, k: int, mask=None):
        """Masked exact top-k. Returns ``(values [B, k] f32, slot ids [B, k]
        int64)`` on the index's device in the metric's native orientation;
        empty slots are id -1. BINARY storage scores Hamming distance of the
        sign bits (``1 - dist/dim`` for similarity metrics)."""
        self._refuse_sq8_set_metric()
        q = torch.atleast_2d(
            torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        ).contiguous()
        k_eff = min(k, self.n_pad)
        mask_dev = pad_mask(mask, self.n_pad, self.device)
        engine, m = self._plan(k_eff)
        valid = self._valid if mask_dev is None else self._valid & mask_dev

        def knock(t, value):
            return t if mask_dev is None else torch.where(mask_dev, t, value)

        if engine == "fused-xla":
            return self._set_search(q, k_eff, valid)
        if engine == "int8-assist-pd":
            rows_pd, _, _, sdim, _, qu = self._assist_pd
            ptile = knock(self._pd_ptile, -64 * _pd_invalid_pen(self.dim))
            return sq8pd_rerank_topk(
                q, rows_pd, ptile, sdim, qu, self._full, k=k_eff, m=m,
                metric=self.metric, chunk=self._chunk, dim=self.dim,
            )
        if engine == "int8-assist":
            rows8, scale, minv, pen, shift = self._assist
            return sq8i_rerank_topk(
                q, rows8, scale, minv, knock(pen, torch.inf), self._full, k=k_eff, m=m,
                metric=self.metric, chunk=self._chunk, shift=shift,
            )
        if engine == "split-bf16":
            hi, lo = self._full_hl
            return bucket_topk_hl(q, hi, lo, self._bucket_pen, mask_dev, k=k_eff,
                                  metric=self.metric, chunk=self._chunk)
        if engine == "bucket-f32":
            return bucket_topk_entry(q, self._full_w, self._bucket_pen, mask_dev, k=k_eff,
                                     metric=self.metric, chunk=self._chunk)
        if engine == "streamed-scan":
            return streamed_topk(
                q, self._full, valid=valid, k=k_eff, metric=self.metric,
                corpus_sqnorm=self._full_sqnorm,
            )
        if engine == "sq8-int8":
            return sq8i_bucket_topk(
                q, self._sq8_rows8, self._sq8_scale, self._sq8_minv,
                knock(self._sq8_pen, torch.inf), k=k_eff, metric=self.metric,
                chunk=self._chunk,
            )
        if engine == "sq8-bucket":
            return sq8_bucket_topk(
                q, self._sq8_words, self._sq8_scale, self._sq8_minv,
                knock(self._sq8_pen, torch.inf), k=k_eff, metric=self.metric,
                chunk=self._chunk,
            )
        if engine == "sq8-streamed":
            cn = self._sq_norm if self._sq_norm is not None else torch.zeros_like(self._sq8.scale)
            return sq8_streamed_topk(
                q, self._sq8, cnorm=cn, valid=valid, k=k_eff, metric=self.metric,
            )
        if engine == "hamming-mxu":
            qbits = F.pad((q >= 0.0).to(torch.int8), (0, self._ham_bits.shape[1] - self.dim))
            dist, idx = hamming_mxu_topk(
                qbits, self._ham_bits, knock(self._ham_aux, self._ham_aux + _HAM_BIG),
                k=k_eff, chunk=self._chunk,
            )
        elif engine == "hamming-bucket":
            pen = torch.where(valid, 0.0, torch.inf)
            dist, idx = hamming_bucket_topk(
                binary_quantize(q), self._packed, pen, k=k_eff, chunk=HAMMING_CHUNK,
            )
        else:
            dist, idx = hamming_topk(binary_quantize(q), self._packed, valid=valid, k=k_eff)
        if self.metric.higher_is_better:
            sim = 1.0 - _div(dist, float(self.dim))
            return torch.where(idx < 0, -torch.inf, sim), idx
        return dist, idx

    def _refuse_sq8_set_metric(self) -> None:
        """SQ8 has no set-metric scores: the reference raises this at search
        (``_sq8_metric_scores``, ``brute.py:920``)."""
        if self.storage_mode is StorageMode.SQ8 and self.metric in SET_METRICS:
            raise ValueError(f"metric {self.metric} not supported in sq8 mode")

    def scores(self, queries) -> torch.Tensor:
        """``[B, N_pad]`` scores of every padded slot, knocked-out ones
        included, in the metric's native direction (reference ``:450``)."""
        self._refuse_sq8_set_metric()
        q = torch.atleast_2d(
            torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        )
        mode, metric = self.storage_mode, self.metric
        if mode is StorageMode.BINARY:
            d = hamming_distances(binary_quantize(q), self._packed).float()
            return 1.0 - _div(d, float(self.dim)) if metric.higher_is_better else d
        if metric in SET_METRICS:
            return set_scores(q, self._set_bits, self._set_count, metric)
        if mode in _FLOAT_MODES:
            return pairwise_scores(q, self._full, metric)
        dots = sq8_dot_scores(q, self._sq8)
        if metric is DistanceMetric.DOT_PRODUCT:
            return dots
        if metric is DistanceMetric.COSINE:
            denom = torch.linalg.vector_norm(q, dim=-1, keepdim=True) * self._sq_norm[None, :]
            return torch.where(denom > 1e-30, dots / denom.clamp_min(1e-30), 0.0)
        qq = torch.sum(q * q, dim=-1, keepdim=True)
        return torch.sqrt((qq + self._sq_norm[None, :] - 2.0 * dots).clamp_min(0.0))

    def _set_search(self, q: torch.Tensor, k: int, valid: torch.Tensor):
        """``fused-xla``: exact hamming / jaccard top-k over the binarized
        rows, in query slices of ``DENSE_ELEMS`` scores."""
        hib = self.metric.higher_is_better
        rows = max(1, DENSE_ELEMS // self.n_pad)
        vals_out, idx_out = [], []
        for r0 in range(0, q.shape[0], rows):
            s = set_scores(q[r0 : r0 + rows], self._set_bits, self._set_count, self.metric)
            s = torch.where(valid[None, :], s if hib else -s, -torch.inf)
            vals, idx = first_topk(s, k)
            vals_out.append(vals if hib else -vals)
            idx_out.append(torch.where(vals == -torch.inf, -1, idx))
        return torch.cat(vals_out), torch.cat(idx_out)


def state_from_jax(arrays: dict, device) -> dict:
    """Turn the JAX index's padded arrays into this package's device state.

    ``arrays`` holds numpy copies of the reference ``BruteForceIndex``'s
    state, under its attribute names without the leading underscore:
    ``valid`` always; FULL, F16, BF16: ``full`` (f32, f16 or bf16, kept in
    its dtype), ``full_sqnorm``, ``bucket_pen``, and the pd shadow as
    ``rows_pd``, ``pen_int``, ``pen_f32``, ``sdim``, ``mid``, ``qu``, or the
    per-row shadow as ``assist`` (the reference's uncentered 4-tuple
    ``(rows8, scale, minv, pen)``, adopted with ``shift = None``), or the
    split-bf16 pair as ``full_hl``; SQ8: ``sq8`` (the ``(codes, scale,
    minv)`` tuple), ``sq_norm`` (absent or None for dot), ``sq8_rows8`` or
    ``sq8_words``, ``sq8_scale``, ``sq8_minv``, ``sq8_pen``; BINARY:
    ``packed`` (uint32 words) and, when built, ``ham_bits`` and ``ham_aux``.
    Other keys are accepted and not used. The result feeds
    :meth:`BruteForceIndex.load_state`, so both packages search from
    identical state."""

    def put(a, dtype):
        a = np.ascontiguousarray(a)
        if dtype == np.int32 and a.dtype == np.uint32:
            a = a.view(np.int32)  # the same bits; torch has no full uint32
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    def put_float(a):
        """f32/f16 as they are; numpy holds JAX's bfloat16 as ml_dtypes'
        bfloat16, which torch.from_numpy refuses: its bits go over as int16."""
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(a if a.dtype == np.float16 else a.astype(np.float32)).to(device)

    f32, i32, i8 = np.float32, np.int32, np.int8
    state = {"valid": put(arrays["valid"], bool)}
    plain = {
        "full_sqnorm": f32, "bucket_pen": f32, "sq_norm": f32, "sq8_rows8": i8,
        "sq8_words": i32, "sq8_scale": f32, "sq8_minv": f32, "sq8_pen": f32,
        "packed": i32, "ham_bits": i8, "ham_aux": i32,
    }
    for key, dtype in plain.items():
        if arrays.get(key) is not None:
            state[key] = put(arrays[key], dtype)
    if arrays.get("full") is not None:
        state["full"] = put_float(arrays["full"])
    if arrays.get("full_hl") is not None:
        state["full_hl"] = tuple(put_float(a) for a in arrays["full_hl"])
    if "rows_pd" in arrays:
        state["assist_pd"] = (
            put(arrays["rows_pd"], i8), put(arrays["pen_int"], i32),
            put(arrays["pen_f32"], f32), put(arrays["sdim"], f32),
            put(arrays["mid"], f32), float(arrays["qu"]),
        )
    if arrays.get("assist") is not None:
        rows8, scale, minv, pen = arrays["assist"]
        state["assist"] = (put(rows8, i8), put(scale, f32), put(minv, f32), put(pen, f32), None)
    if arrays.get("sq8") is not None:
        codes, scale, minv = arrays["sq8"]
        state["sq8"] = SQ8Vectors(put(codes, np.uint8), put(scale, f32), put(minv, f32))
    return state
