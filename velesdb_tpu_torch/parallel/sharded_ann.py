"""Sharded ANN: one beam-search graph a rank, merged with an all-gather.

Counterpart of ``velesdb_tpu/parallel/sharded_ann.py``. Corpus rows go
round-robin over the row shards; each rank builds one ``GraphIndex`` over its
rows (graphs never cross shards, so no pointer chases another device), and a
query batch runs a beam search on every shard, then merges the ``[B, k]``
partials as ``parallel.sharded`` does; ``_row_of`` maps the shards' padded
rows back to corpus rows.

The per-shard SQ8 entry IVFs are unified as the reference's
``_upload_entry`` does (``:132-201``): partitions padded to the largest
shard's count and length, pad partitions copying centroid 0, their rows -1.
The probe kernel's ``aux`` is ``[C, 3, L]`` (mul, add, pen) as in the port's
``IvfIndex``. Every unmasked entry scan runs kernel #10
(``ops/ivf_kernel.py:ivf_probe_topk``, ``csrc/ivf_probe.cu``; on the CPU its
plain version), as the port's single-card graph does; the reference's
``probe_table_fits`` / ``MIN_BLOCK_BYTES`` guard models the TPU's scalar
memory and is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from velesdb_tpu_torch.index.graph_index import GraphIndex, beam_search_impl
from velesdb_tpu_torch.index.params import GraphParams, SearchQuality
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.parallel.sharded import (
    Mesh,
    _dp_queries,
    _global_result,
    _one,
    n_row_shards,
    row_shard,
)
from velesdb_tpu_torch.parallel.sharded_ivf import _row_max, _sq_f32

__all__ = ["ShardedGraphIndex"]


def _entry_kernel_state(psq, scale, minv, prows, metric: DistanceMetric) -> torch.Tensor:
    """The probe kernel's ``aux [C, 3, L]`` of SQ8 partitions, folded as the
    reference folds it on the host: cosine's ``1/|deq|`` into the affine,
    euclidean's ``|deq|^2`` as the penalty, ``+inf`` on dead slots."""
    inv = torch.where(psq > 1e-30, _one(psq) / torch.sqrt(psq.clamp_min(1e-30)), 0.0)
    zero = torch.zeros_like(psq)
    if metric is DistanceMetric.COSINE:
        mul, add, pen = scale * inv, minv * inv, zero
    elif metric is DistanceMetric.EUCLIDEAN:
        mul, add, pen = scale, minv, psq
    else:
        mul, add, pen = scale, minv, zero
    pen = torch.where(prows >= 0, pen, torch.inf)
    return torch.stack([mul, add, pen], dim=1).float().contiguous()


class ShardedGraphIndex:
    """Row-sharded beam-search ANN over the mesh's ranks."""

    def __init__(self, mesh: Mesh, dim: int, metric: DistanceMetric,
                 params: GraphParams | None = None):
        self.mesh = mesh
        self.n_shards = n_row_shards(mesh)
        self.dim = dim
        self.metric = DistanceMetric.parse(metric)
        self.params = params
        self.n = 0
        self.n_local = 0
        self._corpus = None  # [n_local, D] this shard's rows
        self._adj = None  # [n_local, degree] int32, LOCAL indices
        self._sqnorm = None  # [n_local]
        self._valid = None  # [n_local]
        self._seeds = None  # [E] local indices
        self._row_of = None  # host: global padded row -> corpus row
        # the shard's SQ8 entry IVF, geometry-unified across shards:
        # (cents, cent_sq, words, scale, minv, part_rows, part_sq), or None
        self._entry = None
        self._entry_c = 0  # partitions a shard
        self._entry_kern = None  # (aux [C, 3, L], flat rows [C*L]): #10's state
        self._entry_len = 0  # partition length L
        self.build_seconds = {}  # the shard's GraphIndex build stages

    def build(self, corpus: np.ndarray, valid: np.ndarray | None = None) -> None:
        """Partition rows round-robin over the shards and build this rank's
        graph over its rows (every rank passes the whole array or a memory
        map of it)."""
        n = corpus.shape[0]
        valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
        self.n = n
        s = self.n_shards
        self.params = self.params or GraphParams.auto(self.dim, max(n // s, 1))
        n_local = -(-n // s)
        shard = row_shard(self.mesh)
        dev = self.mesh.device
        rows = np.arange(shard, n, s)
        row_of = np.full(s * n_local, -1, np.int64)
        for j in range(s):
            own = np.arange(j, n, s)
            row_of[j * n_local : j * n_local + len(own)] = own
        mine = np.ascontiguousarray(corpus[rows], np.float32)
        block = F.pad(torch.from_numpy(mine).to(dev), (0, 0, 0, n_local - len(rows)))
        sub = GraphIndex(self.dim, self.metric, params=self.params, device=dev)
        self.build_seconds = {}
        sub.build(mine, valid[rows], corpus_dev=block, profile=self.build_seconds)
        if sub._adj is not None:
            adj = sub._adj[: len(rows)]
        else:
            adj = torch.full((len(rows), self.params.degree), -1, dtype=torch.int32,
                             device=dev)
        self.n_local = n_local
        self._row_of = row_of
        self._corpus = block
        self._adj = F.pad(adj, (0, 0, 0, n_local - len(rows)), value=-1).contiguous()
        self._valid = F.pad(torch.from_numpy(valid[rows]).to(dev), (0, n_local - len(rows)))
        self._sqnorm = _sq_f32(block, 1)
        seeds = sub._seed_ids if sub._seed_ids is not None else torch.zeros(
            1, dtype=torch.int64, device=dev)
        eiv = sub._entry_ivf
        # the fewest seeds of any shard; whether every shard has an entry IVF
        fewest, no_entry = _row_max(self.mesh, [-len(seeds), int(eiv is None)])
        self._seeds = seeds[:-fewest]
        self._entry = self._entry_kern = None
        self._entry_c = self._entry_len = 0
        if not no_entry:
            self._upload_entry(eiv)

    def _upload_entry(self, e) -> None:
        """Unify the shards' SQ8 entry IVFs: ``[C, L]`` padded to the largest
        across shards (pad partitions copy the first centroid and hold -1
        rows, which the entry scan skips); the partitions' rows stay local."""
        dev = self.mesh.device
        c, L = e.c_real or e.c, e.part_len
        c_max, l_max = _row_max(self.mesh, [c, L])
        w = e._parts.shape[-1]
        cents = torch.zeros((c_max, self.dim), dtype=torch.float32, device=dev)
        cents[:c] = e._centroids[:c]
        cents[c:] = cents[0]
        words = torch.zeros((c_max, l_max, w), dtype=torch.int32, device=dev)
        words[:c, :L] = e._parts[:c]
        scale = torch.zeros((c_max, l_max), dtype=torch.float32, device=dev)
        minv = torch.zeros_like(scale)
        psq = torch.zeros_like(scale)
        prows = torch.full((c_max, l_max), -1, dtype=torch.int64, device=dev)
        scale[:c, :L] = e._part_scale[:c]
        minv[:c, :L] = e._part_minv[:c]
        psq[:c, :L] = e._part_sq[:c]
        prows[:c, :L] = e._part_rows[:c]
        self._entry = (cents, _sq_f32(cents, 1), words, scale, minv, prows, psq)
        self._entry_c, self._entry_len = c_max, l_max
        self._entry_kern = (_entry_kernel_state(psq, scale, minv, prows, self.metric),
                            prows.reshape(-1))

    def search(self, queries, k: int, ef: int | None = None,
               quality: SearchQuality | None = None, entry_mode: str | None = None):
        """``(values [B, k], corpus row ids [B, k])`` best-first, numpy, on
        every rank. ``entry_mode``: None or ``"kernel"`` scans the entry IVF
        with #10 (its plain version on the CPU); ``"xla"`` with
        ``ivf_search_impl``, the reference's default scan on its CPU."""
        if entry_mode not in (None, "kernel", "xla"):
            raise ValueError(f"unknown entry_mode {entry_mode!r}")
        if quality is not None:
            ef = SearchQuality.parse(quality).ef
        ef = ef or 128
        beam, expansions = self.params.beam_for_ef(ef, k)
        q_np = np.atleast_2d(np.asarray(queries, np.float32))
        b = q_np.shape[0]
        dp = self.mesh.shape["dp"]
        b_pad = -(-max(b, 8) // dp) * dp
        ep = min(self.params.entry_probes, max(self._entry_c, 1))
        mode, state = "legacy", None
        if self._entry is not None:
            cents, csq, words, scale, minv, prows, psq = self._entry
            if entry_mode == "xla":
                mode, state = "xla", (cents, csq, (words, scale, minv), prows, psq)
            else:
                mode, state = "kernel", (cents, csq, words, *self._entry_kern)
        kk = min(k, beam)
        lv, li = beam_search_impl(
            _dp_queries(self.mesh, q_np, b_pad), self._corpus, self._adj, self._sqnorm,
            self._valid, self._seeds, None, None, None, state,
            k=kk, beam=beam, expansions=expansions, degree=self._adj.shape[1],
            entry_points=min(self.params.entry_points, beam), metric=self.metric,
            entry_probes=ep, entry_mode=mode, expand_width=self.params.expand_width)
        gi = torch.where(li >= 0, li + row_shard(self.mesh) * self.n_local, -1)
        vals, gidx = _global_result(self.mesh, lv, gi, kk, self.metric.higher_is_better, b)
        # padded global rows back to corpus rows
        return vals, np.where(gidx >= 0, self._row_of[np.maximum(gidx, 0)], -1)
