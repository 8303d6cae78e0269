"""Compute: batched distances, top-k, the streamed scan, and the pd bucket
scan with its hand-written CUDA kernel (``csrc/``)."""

from velesdb_tpu_torch.ops.distance import DistanceMetric, normalize, pairwise_scores
from velesdb_tpu_torch.ops.quantization import StorageMode
from velesdb_tpu_torch.ops.topk import mask_scores, merge_top_k, top_k

__all__ = [
    "DistanceMetric",
    "normalize",
    "pairwise_scores",
    "StorageMode",
    "top_k",
    "merge_top_k",
    "mask_scores",
]
