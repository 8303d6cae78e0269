"""Sharded IVF: one partitioned index a rank, merged with an all-gather.

Counterpart of ``velesdb_tpu/parallel/sharded_ivf.py``. Corpus rows go
round-robin over the row shards (``np.arange(shard, n, S)``); each rank
trains its own k-means routing over its rows with the port's ``IvfIndex``,
the partition geometry is unified across ranks (an ``all_reduce(MAX)`` of
the live partition count and the partition length), partition rows hold
global corpus rows, and a query batch probes each shard with
``ivf_search_impl`` (plain torch, as the reference probes here with its XLA
path, not the probe kernel #10), then merges as ``parallel.sharded`` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from velesdb_tpu_torch.index.ivf import IvfIndex, ivf_search_impl
from velesdb_tpu_torch.index.params import SearchQuality
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.parallel.sharded import (
    Mesh,
    _dp_queries,
    _global_result,
    n_row_shards,
    row_axes,
    row_shard,
)

__all__ = ["ShardedIvfIndex"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _row_max(mesh: Mesh, values) -> list[int]:
    """Element-wise maximum of small integers over the row group."""
    t = torch.tensor(values, dtype=torch.int64)
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.groups[row_axes(mesh)][0])
    return t.cpu().tolist()


def _sq_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sums of squares in float64 rounded to fp32, as the reference's
    ``np.sum(x.astype(np.float64) ** 2, axis)``."""
    return torch.sum(x.double() ** 2, dim=dim).float()


class ShardedIvfIndex:
    """Row-sharded IVF over the mesh's ranks."""

    def __init__(self, mesh: Mesh, dim: int, metric: DistanceMetric,
                 n_clusters: int | None = None):
        self.mesh = mesh
        self.n_shards = n_row_shards(mesh)
        self.dim = dim
        self.metric = DistanceMetric.parse(metric)
        self.n_clusters = n_clusters
        self.n = 0
        self.c_local = 0
        self.part_len = 0
        self._cents = None  # [C, D] this shard's centroids
        self._cent_sq = None  # [C]
        self._parts = None  # [C, L, D]
        self._part_rows = None  # [C, L] GLOBAL corpus rows, -1 pad
        self._part_sq = None  # [C, L]

    def build(self, corpus: np.ndarray, valid: np.ndarray | None = None) -> None:
        corpus = np.asarray(corpus, np.float32)
        n = corpus.shape[0]
        valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
        self.n = n
        rows = np.arange(row_shard(self.mesh), n, self.n_shards)
        dev = self.mesh.device
        sub = IvfIndex(self.dim, self.metric, n_clusters=self.n_clusters, device=dev)
        sub.build(corpus[rows], valid[rows])
        # unify the partition geometry across shards (uniform [C, L]);
        # c_real strips the sub-index's bucket-padded trailing partitions
        cr = sub.c_real or sub.c
        c_max, l_max = _row_max(self.mesh, [cr, sub.part_len])
        l_max = _round_up(l_max, 8)
        self.c_local, self.part_len = c_max, l_max
        cents = torch.zeros((c_max, self.dim), dtype=torch.float32, device=dev)
        cents[:cr] = sub._centroids[:cr]
        # geometry-padding partitions copy the first centroid: probing them
        # is redundant but harmless (their rows are -1)
        cents[cr:] = cents[0]
        parts = torch.zeros((c_max, l_max, self.dim), dtype=torch.float32, device=dev)
        parts[:cr, : sub.part_len] = sub._parts[:cr]
        prows = torch.full((c_max, l_max), -1, dtype=torch.int64, device=dev)
        local = sub._part_rows[:cr]
        glob = torch.from_numpy(rows).to(dev)[local.clamp_min(0)]
        prows[:cr, : sub.part_len] = torch.where(local >= 0, glob, -1)
        self._cents, self._cent_sq = cents, _sq_f32(cents, 1)
        self._parts, self._part_rows, self._part_sq = parts, prows, _sq_f32(parts, 2)

    def search(self, queries, k: int, nprobe: int | None = None, ef: int | None = None,
               quality=None):
        """``(values [B, k], corpus row ids [B, k])`` best-first, numpy, on
        every rank."""
        if quality is not None:
            ef = SearchQuality.parse(quality).ef
        if nprobe is None:
            ef = ef or 128
            nprobe = max(2, min(-(-ef * 8 // max(self.part_len, 1)), self.c_local))
        q_np = np.atleast_2d(np.asarray(queries, np.float32))
        b = q_np.shape[0]
        dp = self.mesh.shape["dp"]
        b_pad = -(-max(b, 8) // dp) * dp
        lv, li = ivf_search_impl(_dp_queries(self.mesh, q_np, b_pad), self._cents,
                                 self._cent_sq, self._parts, self._part_rows, self._part_sq,
                                 None, k=k, nprobe=int(min(nprobe, self.c_local)),
                                 metric=self.metric)
        return _global_result(self.mesh, lv, li, k, self.metric.higher_is_better, b)
