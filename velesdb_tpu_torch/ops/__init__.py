"""Compute: batched distances, top-k, quantization, the streamed scan, and
the bucket and top-k scans with their hand-written CUDA kernels (``csrc/``).
The names exported here are the reference package's ``velesdb_tpu.ops``."""

from velesdb_tpu_torch.ops.distance import (
    DistanceMetric,
    normalize,
    pairwise_hamming_packed,
    pairwise_scores,
    score_one,
)
from velesdb_tpu_torch.ops.quantization import (
    SQ8Vectors,
    StorageMode,
    VectorPrecision,
    binary_quantize,
    binary_unpack,
    hamming_similarity,
    packed_words,
    sq8_dequantize,
    sq8_dot_scores,
    sq8_quantize,
)
from velesdb_tpu_torch.ops.topk import mask_scores, merge_top_k, top_k

__all__ = [
    "DistanceMetric",
    "normalize",
    "pairwise_scores",
    "pairwise_hamming_packed",
    "score_one",
    "StorageMode",
    "VectorPrecision",
    "SQ8Vectors",
    "sq8_quantize",
    "sq8_dequantize",
    "sq8_dot_scores",
    "binary_quantize",
    "binary_unpack",
    "packed_words",
    "hamming_similarity",
    "top_k",
    "merge_top_k",
    "mask_scores",
]
