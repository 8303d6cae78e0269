"""Vector quantization: storage modes, SQ8 affine codes, 1-bit sign packing.

Counterpart of ``velesdb_tpu/ops/quantization.py`` (``quantization.rs``):

- **SQ8** (``QuantizedVector::from_f32``, ``quantization.rs:229``): per-vector
  min/max affine mapping to ``uint8`` (4x memory), ``deq = code * scale + min``.
- **Binary** (``BinaryQuantizedVector::from_f32``, ``quantization.rs:68``):
  ``v >= 0`` -> bit 1, packed 32 dims per word LSB-first (32x memory). Torch
  has no full uint32 dtype, so the words are ``int32`` tensors holding the
  reference's uint32 bits unchanged (``.view(uint32)`` in numpy gives them
  back).

- **F16 / BF16** (``half_precision.rs``): the rows cast to half precision
  (2x memory); :data:`STORAGE_DTYPE` maps the float modes to their dtypes.
- **Block-packed SQ8 words** (:func:`sq8_pack_blocked`, reference
  ``bucket_kernel.py:877``): four codes per int32 word for the staged SQ8
  bucket scan.

The functions take tensors or host arrays (a result of host input lies on
the CPU), as the reference's do. Both packages round half to even, and every
constant here is an fp32 tensor, never a Python scalar (a scalar divisor
becomes a reciprocal multiply on CUDA), so the codes equal the reference's
bit for bit on the CPU.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from velesdb_tpu_torch.ops.distance import as_tensor

__all__ = [
    "StorageMode",
    "STORAGE_DTYPE",
    "VectorPrecision",
    "SQ8Vectors",
    "sq8_quantize",
    "sq8_dequantize",
    "sq8_dot_scores",
    "sq8_pack_blocked",
    "sq8_unpack_blocked",
    "packed_words",
    "binary_quantize",
    "binary_unpack",
    "hamming_similarity",
    "numpy_sq8_roundtrip",
]


class StorageMode(str, enum.Enum):
    FULL = "full"
    SQ8 = "sq8"
    BINARY = "binary"
    F16 = "f16"
    BF16 = "bf16"

    @classmethod
    def parse(cls, v) -> "StorageMode":
        return v if isinstance(v, cls) else cls(str(v).strip().lower())


# device dtype of the float storage modes' rows
STORAGE_DTYPE = {
    StorageMode.FULL: torch.float32,
    StorageMode.F16: torch.float16,
    StorageMode.BF16: torch.bfloat16,
}


class VectorPrecision(str, enum.Enum):
    """Parity with ``VectorPrecision`` (``half_precision.rs:36``)."""

    F32 = "f32"
    F16 = "f16"
    BF16 = "bf16"

    @property
    def dtype(self) -> torch.dtype:
        return {
            VectorPrecision.F32: torch.float32,
            VectorPrecision.F16: torch.float16,
            VectorPrecision.BF16: torch.bfloat16,
        }[self]


class SQ8Vectors(NamedTuple):
    """Per-vector affine-quantized batch: ``deq = codes * scale + minv``."""

    codes: torch.Tensor  # [N, D] uint8
    scale: torch.Tensor  # [N] f32 (range / 255)
    minv: torch.Tensor  # [N] f32


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def sq8_quantize(x: torch.Tensor) -> SQ8Vectors:
    """Per-vector min/max affine quantization (``quantization.rs:229-252``)."""
    x = as_tensor(x).float()
    minv = torch.amin(x, dim=-1)
    maxv = torch.amax(x, dim=-1)
    rng = maxv - minv
    # XLA folds the reference's ``rng / 255.0`` into a multiply by the fp32
    # reciprocal of 255; the code division below is a true division in both
    scale = torch.where(rng > 0, rng * _f32(1.0 / 255.0, rng), 1.0)
    codes = torch.clamp(torch.round((x - minv[..., None]) / scale[..., None]), 0, 255)
    return SQ8Vectors(codes.to(torch.uint8), scale, minv)


def sq8_dequantize(q: SQ8Vectors) -> torch.Tensor:
    """``quantization.rs:267-270``: ``f32(code) * scale + min``."""
    return q.codes.float() * q.scale[..., None] + q.minv[..., None]


def sq8_dot_scores(queries, q: SQ8Vectors) -> torch.Tensor:
    """Asymmetric dot scores ``[B, N]`` of f32 queries against an SQ8 corpus:
    one product with the raw codes plus the rank-1 correction,
    ``scale_n (q . codes_n) + minv_n sum(q)`` (reference ``:94-111``)."""
    queries = as_tensor(queries).float()
    code_dot = queries @ q.codes.float().T
    qsum = torch.sum(queries, dim=-1, keepdim=True)
    return code_dot * q.scale[None, :] + qsum * q.minv[None, :]


def sq8_pack_blocked(codes: torch.Tensor) -> torch.Tensor:
    """Pack ``[N, D] uint8`` SQ8 codes into ``[N, D_pad/4] int32`` words,
    ``D_pad = round_up(D, 4)`` (pad codes 0): byte ``j`` of word ``w`` holds
    dim ``j * (D_pad / 4) + w``, so each byte plane unpacks to a contiguous
    block of dims (reference ``bucket_kernel.py:877-891``)."""
    n, d = codes.shape
    d_pad = -(-d // 4) * 4
    planes = F.pad(codes.to(torch.int64), (0, d_pad - d)).reshape(n, 4, d_pad // 4)
    w = planes[:, 0] | (planes[:, 1] << 8) | (planes[:, 2] << 16) | (planes[:, 3] << 24)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def sq8_unpack_blocked(words: torch.Tensor) -> torch.Tensor:
    """The codes of :func:`sq8_pack_blocked` back as ``[N, D_pad]`` float32."""
    planes = [(torch.bitwise_right_shift(words, 8 * j) & 0xFF) for j in range(4)]
    return torch.cat(planes, dim=1).float()


def packed_words(dim: int) -> int:
    """Number of 32-bit words for ``dim`` packed bits."""
    return (dim + 31) // 32


def binary_quantize(x, threshold_half: bool = False) -> torch.Tensor:
    """Sign-pack ``[N, D] f32`` into ``[N, ceil(D/32)] int32`` words: ``v >= 0``
    -> 1 (with ``threshold_half``, the f32 set metrics' ``v > 0.5``), bit
    ``d`` of word ``w`` is dimension ``w * 32 + d`` (reference ``:124-141``)."""
    x = as_tensor(x)
    n, d = x.shape
    w = packed_words(d)
    bits = (x > 0.5) if threshold_half else (x >= 0.0)
    bits = F.pad(bits.to(torch.int64), (0, w * 32 - d)).reshape(n, w, 32)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=x.device),
        torch.arange(32, device=x.device),
    )
    words = torch.sum(bits * weights, dim=-1)  # [0, 2^32) in int64
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def binary_unpack(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """Unpack ``[N, W]`` words back to ``[N, dim]`` {0, 1} float32."""
    packed = as_tensor(packed)
    n, w = packed.shape
    shifts = torch.arange(32, device=packed.device)
    bits = torch.bitwise_and(
        torch.bitwise_right_shift(packed.to(torch.int64)[..., None], shifts), 1
    )
    return bits.reshape(n, w * 32)[:, :dim].float()


def hamming_similarity(dist, dim: int) -> torch.Tensor:
    """``1 - dist / dim`` (``quantization.rs`` Hamming similarity)."""
    return 1.0 - as_tensor(dist).float() / float(dim)


def numpy_sq8_roundtrip(x: np.ndarray) -> np.ndarray:
    """The SQ8 round trip in numpy, the tests' yardstick for the device path
    (reference ``:157-164``)."""
    minv = x.min(axis=-1, keepdims=True)
    maxv = x.max(axis=-1, keepdims=True)
    rng = maxv - minv
    scale = np.where(rng > 0, rng / 255.0, 1.0)
    codes = np.clip(np.round((x - minv) / scale), 0, 255).astype(np.uint8)
    return codes.astype(np.float32) * scale + minv
