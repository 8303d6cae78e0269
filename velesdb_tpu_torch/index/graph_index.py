"""Graph ANN index: batched beam search over a padded adjacency table.

Counterpart of ``velesdb_tpu/index/graph_index.py``, the CAGRA-style
re-architecture of VelesDB's HNSW: the graph is a flat ``[N_pad, degree]``
int32 adjacency table, built from a kNN graph (exact below
``EXACT_KNN_MAX_ROWS``, IVF-bucketed above, ``index/ivf.py:ivf_self_knn``),
pruned by the VAMANA alpha rule and filled with reverse and pseudo-random
edges; a search expands ``expand_width`` candidates of every query's beam a
step, one gather of their neighbour rows, one batched dot, one merge.

The beam's entries come from one of three stages, in this order:

- the SQ8 entry IVF (``entry_probes >= 8`` and ``n >= 4096``, one restart):
  unmasked searches probe it with kernel #10 (``ops/ivf_kernel.py:
  ivf_probe_topk``, ``csrc/ivf_probe.cu``) at every batch size, on the CPU
  through #10's plain version; masked searches take ``ivf_search_impl`` with
  the mask at every batch size, as the reference's do. The reference also
  asks ``use_pallas()``, ``L * D >= MIN_BLOCK_BYTES`` and the TPU's scalar
  memory (``probe_table_fits``); none of those apply here, and the
  reference's kill switch and demotion record (``:626-640``) are not carried
  over: a failing launch raises;
- IVF-routed entries (the approximate build's router);
- the dense seed scan over a strided sample of valid rows.

The beam's gathers, batched dots and selections are plain torch, as the
reference's are XLA outside any Pallas kernel. What differs from a literal
translation:

- every ``lax.top_k`` (entry pick, expansion pick, pool merge, accumulator,
  restart merge, final select) sends equal scores to the smallest position
  on every device (:func:`~velesdb_tpu_torch.ops.bucket_kernel.first_topk`;
  ``torch.topk`` orders ties one way on the CPU and another on CUDA);
- the two dedups of an expansion (against the pool, ``[B, M, beam]``, and
  within the expansion, ``[B, M, M]``) are one stable sort of the pool and
  the expansion's ids (:func:`_expansion_dups`), the same "first valid
  occurrence" result without the boolean cubes;
- ``jax.lax.fori_loop`` is a Python loop of ``max(2, ceil(expansions /
  expand_width))`` steps;
- the reference scores gathers at ``Precision.HIGHEST``; here fp32 ``bmm``
  (TF32 off). The quantized traversal's bf16 queries times codes are exact
  products, summed in fp32;
- the uint32 fill hash of :func:`_assemble_adjacency_dev` wraps in int64 with
  ``& 0xFFFFFFFF``.

Ids are int64 on the way out; the adjacency is stored int32.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from velesdb_tpu_torch.index.ivf import _METRICS, IvfIndex, ivf_search_impl, ivf_self_knn
from velesdb_tpu_torch.index.ivf import ivf_state_from_jax, nn_descent_round
from velesdb_tpu_torch.index.ivf import stage_mark as _mark
from velesdb_tpu_torch.index.params import GraphParams, SearchQuality
from velesdb_tpu_torch.ops.bucket_kernel import first_topk
from velesdb_tpu_torch.ops.chunked import _best, self_knn
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.ivf_kernel import ivf_probe_topk
from velesdb_tpu_torch.ops.quantization import SQ8Vectors, sq8_quantize

__all__ = ["GraphIndex", "beam_search_impl", "graph_state_from_jax"]

EXPAND_WIDTH = 4  # candidates expanded per beam step when the params leave it open

# per-dispatch budget of the entry stage's largest per-query block (#10's
# [B, probes, L] scores, or the routed entries' [B, probes*L, D] gather):
# search() splits larger batches into chunks under it
_ENTRY_GATHER_BUDGET = 1 << 30

# nodes pruned per step (the [block, K, D] candidate gather)
_PRUNE_BLOCK = 16384


class GraphIndex:
    """Beam-search ANN over a device-resident padded adjacency table."""

    # the exact O(N^2 D) self-kNN build up to here, the IVF-bucketed
    # approximate build above
    EXACT_KNN_MAX_ROWS = 65_536

    def __init__(self, dim: int, metric: DistanceMetric, params: GraphParams | None = None,
                 device="cuda"):
        self.dim = dim
        self.metric = DistanceMetric.parse(metric)
        if self.metric not in _METRICS:
            raise ValueError(f"graph index does not support metric {self.metric}")
        self.params = params or GraphParams()
        self.device = torch.device(device)
        self.n = 0  # rows at the build
        self.n_pad = 0
        self._corpus = None  # [N_pad, D] f32
        self._adj = None  # [N_pad, degree] int32, -1 = empty
        self._sqnorm = None  # [N_pad] f32
        self._valid = None  # [N_pad] bool
        self._seed_ids = None  # [S] int64 routing sample
        self._adj_host = None  # [N, degree] int32 host copy (save path)
        self._sq8trav = None  # SQ8Vectors shadow (quantized traversal)
        self._route_cents = None  # [P, D] f32: the approximate build's router
        self._route_csq = None  # [P] f32
        self._route_rows = None  # [P, L] int64
        self._route_host = None  # host copies of (cents, rows) for save
        self._entry_ivf = None  # SQ8 IvfIndex serving the wide entry scan
        self._kept = None  # (excluded slots, their [n_pad] keep mask)
        self._dirty = True

    # -- build -------------------------------------------------------------------

    def build(self, corpus, valid: np.ndarray, corpus_dev: torch.Tensor | None = None,
              profile: dict | None = None) -> None:
        """Full build from the host slot array ``corpus [n, D]``.
        ``corpus_dev`` (a tensor of at least ``n`` rows on the index's device,
        e.g. the collection's resident rows, pre-normalized for cosine) is
        what the build reads and the beam gathers instead of an upload.
        ``profile`` receives per-stage seconds (knn, prune, assemble,
        upload.*, entry.*)."""
        t = time.perf_counter()
        n = corpus.shape[0]
        p = self.params
        self.n = n
        if n == 0:
            self.n_pad = 0
            self._dirty = False
            return
        valid = np.asarray(valid, bool)
        dev = None
        if corpus_dev is not None:
            dev = corpus_dev[:n]
            if dev.dtype != torch.float32:
                dev = dev.float()
        knn_k = min(p.knn_k, max(1, int(valid.sum()) - 1))
        router = None
        src = corpus if dev is None else dev
        if n <= self.EXACT_KNN_MAX_ROWS:
            knn_idx = self_knn(src, knn_k, self.metric, valid=valid, device=self.device)
        else:
            # partitions of ~256 rows at any n (the serving cap of 8192
            # clusters would grow L past ~2M rows)
            build_c = n // 256 if n // 256 > 8192 else None
            # the post-kNN pipeline stays on the device with no refinement
            on_device = p.refine_rounds == 0 and dev is not None
            knn_idx, router = ivf_self_knn(
                src, knn_k, self.metric, valid=valid, nprobe=p.build_nprobe,
                passes=p.build_passes, n_clusters=build_c, return_router=True,
                profile=profile, return_device=on_device, device=self.device)
            for _ in range(p.refine_rounds):
                knn_idx = nn_descent_round(src, knn_idx, self.metric, valid=valid,
                                           device=self.device)
        t = _mark(profile, "knn", t, self.device)
        if isinstance(knn_idx, torch.Tensor):
            fwd = self._alpha_prune_dev(knn_idx, dev)
            t = _mark(profile, "prune", t, self.device)
            adj = _assemble_adjacency_dev(fwd, n=n, degree=p.degree)
            t = _mark(profile, "assemble", t, self.device)
        else:
            fwd = self._alpha_prune_host(corpus, knn_idx.astype(np.int32), dev)
            t = _mark(profile, "prune", t, self.device)
            adj = _assemble_adjacency(fwd, n, p.degree)
            t = _mark(profile, "assemble", t, self.device)
        self._upload(corpus, valid, adj, dev, router=router, profile=profile,
                     corpus_dev=corpus_dev)
        _mark(profile, "upload", t, self.device)
        self._dirty = False

    def _prune_keep(self, fwd: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
        """VAMANA keep mask of ``fwd [n, k]`` (distance-ordered candidates)
        over ``corpus``, block by block."""
        return torch.cat([
            _alpha_prune_block(corpus[s : s + _PRUNE_BLOCK], fwd[s : s + _PRUNE_BLOCK], corpus,
                               self.metric, self.params.alpha)
            for s in range(0, fwd.shape[0], _PRUNE_BLOCK)])

    def _alpha_prune_dev(self, fwd: torch.Tensor, dev: torch.Tensor) -> torch.Tensor:
        """The prune on a device-resident kNN ``[n, k]`` (no host trip)."""
        if self.params.alpha <= 1.0:
            return fwd
        return torch.where(self._prune_keep(fwd, dev), fwd, -1)

    def _alpha_prune_host(self, corpus: np.ndarray, fwd: np.ndarray, dev=None) -> np.ndarray:
        """The prune of a host kNN: scored on the device, one readback."""
        if self.params.alpha <= 1.0:
            return fwd
        if dev is None:
            dev = torch.from_numpy(np.ascontiguousarray(corpus, np.float32)).to(self.device)
        keep = self._prune_keep(torch.from_numpy(fwd).to(dev.device).long(), dev).cpu().numpy()
        return np.where(keep, fwd, -1)

    def _upload(self, corpus, valid, adj, dev=None, router=None, entry_ivf_path=None,
                profile: dict | None = None, corpus_dev: torch.Tensor | None = None) -> None:
        """Device state from a build or a load: corpus rows (aliasing
        ``corpus_dev`` where it holds ``n_pad`` f32 rows), adjacency,
        validity, norms, the SQ8 traversal shadow, the entry IVF (restored
        from ``entry_ivf_path``, seeded from the router's centroids, or
        built), the router and the seed sample."""
        t = time.perf_counter()
        n = corpus.shape[0]
        self._adj_host = None if isinstance(adj, torch.Tensor) else np.asarray(adj, np.int32)[:n]
        self.n_pad = ((n + 1023) // 1024) * 1024  # multiple of 1024, not pow2
        pad = self.n_pad - n
        cap_mode = self.params.quantized_traversal and not self.params.traversal_rerank
        if (corpus_dev is not None and corpus_dev.dtype == torch.float32
                and corpus_dev.shape[0] >= self.n_pad):
            self._corpus = corpus_dev[: self.n_pad]  # rows past n are never reached
        elif dev is not None:
            self._corpus = F.pad(dev, (0, 0, 0, pad)) if pad else dev
        elif cap_mode:
            self._corpus = None  # capacity mode never holds f32 rows on the device
        else:
            self._corpus = torch.from_numpy(
                np.pad(np.asarray(corpus, np.float32), ((0, pad), (0, 0)))).to(self.device)
        valid_p = np.pad(np.asarray(valid, bool), (0, pad))
        if isinstance(adj, torch.Tensor):
            m = adj.shape[0]
            adj = adj.to(self.device, torch.int32)
            if m < self.n_pad:
                adj = F.pad(adj, (0, 0, 0, self.n_pad - m), value=-1)
            self._adj = adj[: self.n_pad].contiguous()
        else:
            self._adj = torch.from_numpy(
                np.pad(np.asarray(adj, np.int32), ((0, pad), (0, 0)), constant_values=-1)
            ).to(self.device)
        self._valid = torch.from_numpy(valid_p).to(self.device)
        if self._corpus is not None:
            self._sqnorm = torch.sum(self._corpus * self._corpus, dim=-1)
        else:
            c32 = np.asarray(corpus, np.float32)
            sn = np.zeros(self.n_pad, np.float32)
            sn[:n] = np.einsum("nd,nd->n", c32, c32)
            self._sqnorm = torch.from_numpy(sn).to(self.device)
        t = _mark(profile, "upload.corpus", t, self.device)
        self._sq8trav = None
        if self.params.quantized_traversal:
            if self._corpus is not None:
                self._sq8trav = sq8_quantize(self._corpus)
            else:
                self._sq8trav = _host_sq8(np.asarray(corpus, np.float32), self.n_pad, self.device)
            if cap_mode:
                self._corpus = None
        t = _mark(profile, "upload.quantize", t, self.device)
        self._entry_ivf = None
        if self.params.entry_probes >= 8 and n >= 4096:
            sq8src = self._sq8trav
            if sq8src is None:
                src = self._corpus
                if src is None:
                    src = torch.from_numpy(np.pad(np.asarray(corpus, np.float32),
                                                  ((0, pad), (0, 0)))).to(self.device)
                sq8src = sq8_quantize(src)
            eiv = IvfIndex(self.dim, self.metric, device=self.device)
            loaded = entry_ivf_path is not None and eiv.load(entry_ivf_path, sq8src, valid_p)
            if not loaded:
                eprof = {} if profile is not None else None
                if router is not None:
                    # the approximate build's router is a k-means clustering
                    # of this corpus: its centroids seed the entry IVF (the
                    # assembly alone), subsampled to the serving cap
                    cents_e = router[0]
                    if cents_e.shape[0] > 8192:
                        cents_e = cents_e[np.linspace(0, cents_e.shape[0] - 1, 8192)
                                          .astype(np.int64)]
                    eiv.build_from_centroids(sq8src, valid_p, cents_e, profile=eprof)
                else:
                    eiv.build(sq8src, valid_p, profile=eprof)
                for key, v in (eprof or {}).items():
                    profile["entry." + key] = profile.get("entry." + key, 0.0) + v
            if eiv._parts is not None:
                self._entry_ivf = eiv
        t = _mark(profile, "upload.entry", t, self.device)
        if router is not None:
            cents, rows = router
            self._route_host = (np.asarray(cents, np.float32), np.asarray(rows, np.int32))
            self._route_cents = torch.from_numpy(self._route_host[0]).to(self.device)
            self._route_csq = torch.sum(self._route_cents * self._route_cents, dim=1)
            self._route_rows = torch.from_numpy(self._route_host[1]).to(self.device).long()
        else:
            self._route_cents = self._route_csq = self._route_rows = self._route_host = None
        # routing sample: strided over valid rows, padded by repetition
        s = min(self.params.seed_sample, max(1, n))
        valid_rows = np.flatnonzero(valid_p[:n])
        if len(valid_rows) == 0:
            valid_rows = np.array([0])
        pick = valid_rows[np.linspace(0, len(valid_rows) - 1, s).astype(np.int64)]
        self._seed_ids = torch.from_numpy(pick.astype(np.int64)).to(self.device)
        _mark(profile, "upload.router_seeds", t, self.device)

    def invalidate(self, _ids=None) -> None:
        self._dirty = True

    @property
    def dirty(self) -> bool:
        return self._dirty

    # -- search ------------------------------------------------------------------

    def _entry_mode(self, mask) -> str:
        """``"kernel"`` (#10) for an unmasked search with an entry IVF,
        ``"xla"`` (``ivf_search_impl``) for a masked one, else ``"legacy"``
        (routed entries or the dense seed scan)."""
        if self._entry_ivf is None or max(1, self.params.restarts) != 1:
            return "legacy"
        return "kernel" if mask is None else "xla"

    def _kept_rows(self, exclude: np.ndarray) -> torch.Tensor:
        """``[n_pad]`` bool on the device, False at the ``exclude`` slots
        (sorted unique), cached for the last such set and layout."""
        ex = self._kept
        if ex is None or ex[1].shape[0] != self.n_pad or not np.array_equal(ex[0], exclude):
            keep = torch.ones(self.n_pad, dtype=torch.bool, device=self.device)
            keep[torch.from_numpy(exclude[(exclude >= 0) & (exclude < self.n_pad)])] = False
            self._kept = ex = (exclude, keep)
        return ex[1]

    def _dispatch_cap(self) -> int:
        """Largest query batch one beam dispatch serves (``search`` splits
        larger batches): the entry stage's per-query block stays under
        ``_ENTRY_GATHER_BUDGET`` (#10's ``[B, probes, L]`` f32 scores with an
        entry IVF, the routed entries' ``[B, probes*L, D]`` f32 gather),
        rounded down to a power of two, at least 32."""
        eiv = self._entry_ivf
        if eiv is not None and max(1, self.params.restarts) == 1:
            ep = max(1, min(self.params.entry_probes, eiv.c_real or eiv.c))
            cap = _ENTRY_GATHER_BUDGET // max(1, 4 * ep * eiv.part_len)
            return 1 << max(5, cap.bit_length() - 1)
        if self._route_rows is not None:
            ep = max(1, self.params.entry_probes) * max(1, self.params.restarts)
            rows = ep * self._route_rows.shape[1]
            cap = _ENTRY_GATHER_BUDGET // max(1, rows * self.dim * 4)
            return 1 << max(5, cap.bit_length() - 1)
        return 8192  # dense seed entry: no per-query block

    def search(self, queries, k: int, ef: int | None = None, quality=None, mask=None,
               exclude=None):
        """Batched ANN search: ``(values [B, k] f32, slot ids [B, k] int64)``
        on the index's device, scores in the metric's native orientation,
        -1 where empty. ``mask`` (``[>= n_pad]`` bool, numpy or tensor)
        filters results at selection; the walk still routes through
        filtered rows so the graph stays connected.

        ``exclude`` (slot ids, the collection's graph delta) leaves those
        rows out, as a mask that drops them would, but an unmasked search
        keeps its #10 entry scan: their slots turn dead in a copy of the
        entry IVF's probe state (``IvfIndex._excluded_state``), and the
        accumulator and the final selection drop them as a mask does. The
        reference folds them into the mask, which moves the entry stage to
        ``ivf_search_impl``."""
        if quality is not None:
            ef = SearchQuality.parse(quality).ef
        ef = ef or 128
        q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32)).to(self.device)
        exclude = None if exclude is None else np.unique(np.asarray(exclude, np.int64))
        if exclude is not None and not len(exclude):
            exclude = None
        cap = self._dispatch_cap()
        if q.shape[0] > cap:
            outs = [self.search(q[s : s + cap], k, ef=ef, mask=mask, exclude=exclude)
                    for s in range(0, q.shape[0], cap)]
            return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
        beam, expansions = self.params.beam_for_ef(ef, k)
        restarts = max(1, self.params.restarts)
        if restarts > 1:  # iso-budget split of the ef budget over R beams
            beam = max(32, ((beam // restarts + 7) // 8) * 8)
            expansions = max(32, ((expansions // restarts + 7) // 8) * 8)
        mask_dev = None
        if mask is not None:
            m = torch.as_tensor(np.asarray(mask, bool) if not isinstance(mask, torch.Tensor)
                                else mask).to(self.device, torch.bool)
            mask_dev = F.pad(m, (0, max(0, self.n_pad - m.shape[0])))[: self.n_pad]
        mode = self._entry_mode(mask_dev)
        if exclude is not None:
            keep = self._kept_rows(exclude)
            mask_dev = keep if mask_dev is None else mask_dev & keep
        eiv = self._entry_ivf
        state, probes = None, self.params.entry_probes
        if mode != "legacy":
            probes = min(self.params.entry_probes, eiv.c_real or eiv.c)
            if mode == "kernel":
                aux, frows = eiv._kernel_state()
                if exclude is not None:
                    aux = eiv._excluded_state(exclude)
                state = (eiv._centroids, eiv._cent_sq, eiv._parts, aux, frows)
            else:
                state = (eiv._centroids, eiv._cent_sq,
                         (eiv._parts, eiv._part_scale, eiv._part_minv), eiv._part_rows,
                         eiv._part_sq)
        quant = self._sq8trav
        router = None
        if self._route_cents is not None:
            router = (self._route_cents, self._route_csq, self._route_rows)
        return beam_search_impl(
            q, quant if quant is not None else self._corpus, self._adj, self._sqnorm,
            self._valid, self._seed_ids, mask_dev,
            self._corpus if quant is not None else None, router, state,
            k=min(k, beam), beam=beam, expansions=expansions, degree=self._adj.shape[1],
            entry_points=min(self.params.entry_points, beam), metric=self.metric,
            restarts=restarts, entry_probes=probes, entry_mode=mode,
            expand_width=self.params.expand_width)

    # -- persistence (the reference's ``ann.npz`` format) ------------------------

    def _host_adj(self) -> np.ndarray | None:
        """Host adjacency ``[n, degree]`` int32, read back once, at save."""
        if self._adj_host is None and self._adj is not None:
            self._adj_host = self._adj[: self.n].cpu().numpy().astype(np.int32, copy=False)
        return self._adj_host

    def save(self, path: str, version: int = 0) -> None:
        if self._adj is None:
            return
        extra = {}
        if self._route_host is not None:
            extra = {"route_cents": self._route_host[0], "route_rows": self._route_host[1]}
        np.savez_compressed(
            path, adj=self._host_adj(), degree=self.params.degree, knn_k=self.params.knn_k,
            alpha=self.params.alpha, entry_points=self.params.entry_points,
            metric=self.metric.value, n=self.n, version=version, **extra)
        if self._entry_ivf is not None:
            self._entry_ivf.save(self._entry_path(path), version=version)
        elif os.path.exists(self._entry_path(path)):
            os.remove(self._entry_path(path))  # a stale recipe of other params

    @staticmethod
    def _entry_path(path: str) -> str:
        return path + ".entry.npz"

    def load(self, path: str, corpus: np.ndarray, valid: np.ndarray, version: int = 0) -> bool:
        """Restore the adjacency (and the router, and the entry IVF from its
        recipe, with no k-means run) if the file matches the corpus size,
        metric and version; graph properties come from the file, runtime
        knobs stay the caller's."""
        if not os.path.exists(path):
            return False
        data = np.load(path, allow_pickle=False)
        if (int(data["n"]) != corpus.shape[0] or str(data["metric"]) != self.metric.value
                or int(data["version"] if "version" in data else -1) != version):
            return False
        self.params = dataclasses.replace(
            self.params, degree=int(data["degree"]), knn_k=int(data["knn_k"]),
            alpha=float(data["alpha"]))
        self.n = corpus.shape[0]
        router = None
        if "route_cents" in data:
            router = (data["route_cents"], data["route_rows"])
        self._upload(corpus, valid, data["adj"], router=router,
                     entry_ivf_path=self._entry_path(path))
        self._dirty = False
        return True


def _host_sq8(c32: np.ndarray, n_pad: int, device) -> SQ8Vectors:
    """SQ8 codes of host rows, quantized on the host block by block (the
    affine of ``sq8_quantize``: per-row min/max, round-half-even codes), so
    only one byte a dim is uploaded."""
    n, d = c32.shape
    codes = np.zeros((n_pad, d), np.uint8)
    scale = np.ones(n_pad, np.float32)
    minv = np.zeros(n_pad, np.float32)
    step = 1 << 20
    for s in range(0, n, step):
        blk = c32[s : s + step]
        mn, mx = blk.min(axis=1), blk.max(axis=1)
        sc = np.where(mx > mn, (mx - mn) / 255.0, 1.0)
        codes[s : s + len(blk)] = np.clip(np.round((blk - mn[:, None]) / sc[:, None]), 0, 255)
        scale[s : s + len(blk)] = sc
        minv[s : s + len(blk)] = mn
    return SQ8Vectors(*(torch.from_numpy(a).to(device) for a in (codes, scale, minv)))


# ----------------------------------------------------------------------------
# build functions
# ----------------------------------------------------------------------------


def _alpha_prune_block(base, cand_idx, corpus, metric, alpha):
    """VAMANA diversification of a block of nodes (reference ``:746``):
    ``base [Bn, D]``, ``cand_idx [Bn, K]`` distance-ordered candidates. Keep
    candidate j unless a kept candidate i < j satisfies ``alpha * d(c_i,
    c_j) <= d(node, c_j)``. Returns the keep mask ``[Bn, K]``."""
    cvecs = corpus[cand_idx.clamp_min(0).long()].float()  # [Bn, K, D]
    node_d = _metric_dist(base[:, None, :].float(), cvecs, metric)  # [Bn, K]
    if metric is DistanceMetric.EUCLIDEAN:
        csq = torch.sum(cvecs * cvecs, dim=-1)
        dots = torch.bmm(cvecs, cvecs.transpose(1, 2))
        cc = csq[:, :, None] + csq[:, None, :] - 2.0 * dots
    elif metric is DistanceMetric.COSINE:
        cn = cvecs * torch.rsqrt(torch.sum(cvecs * cvecs, dim=-1, keepdim=True).clamp_min(1e-30))
        cc = 1.0 - torch.bmm(cn, cn.transpose(1, 2))
    else:
        cc = -torch.bmm(cvecs, cvecs.transpose(1, 2))
    k = cand_idx.shape[1]
    invalid = cand_idx < 0
    close = alpha * cc <= node_d[:, None, :]  # [Bn, i, j]
    keep = torch.zeros(cand_idx.shape, dtype=torch.bool, device=cand_idx.device)
    keep[:, 0] = ~invalid[:, 0]
    for j in range(1, k):
        conflict = torch.any(keep[:, :j] & close[:, :j, j], dim=1)
        keep[:, j] = ~conflict & ~invalid[:, j]
    return keep


def _metric_dist(a, b, metric):
    """Lower-is-better internal distance (broadcasting)."""
    if metric is DistanceMetric.EUCLIDEAN:
        return torch.sum((a - b) ** 2, dim=-1)
    if metric is DistanceMetric.COSINE:
        an = a / torch.linalg.norm(a, dim=-1, keepdim=True).clamp_min(1e-30)
        bn = b / torch.linalg.norm(b, dim=-1, keepdim=True).clamp_min(1e-30)
        return 1.0 - torch.sum(an * bn, dim=-1)
    return -torch.sum(a * b, dim=-1)


def _assemble_adjacency(fwd: np.ndarray, n: int, degree: int) -> np.ndarray:
    """Forward edges + reverse-edge fill to ``degree`` (host numpy,
    reference ``:804``), duplicates dropped, empty slots filled with the
    pseudo-random long-range edges of :func:`_fill_hash`."""
    k = fwd.shape[1]
    adj = np.full((n, degree), -1, dtype=np.int32)
    width = min(k, degree)
    adj[:, :width] = fwd[:, :width]
    fill = (adj >= 0).sum(axis=1)
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = fwd.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    group_start = np.searchsorted(dst_s, np.arange(n))
    pos = np.arange(len(dst_s)) - group_start[dst_s]
    slot = fill[dst_s] + pos
    sel = slot < degree
    adj[dst_s[sel], slot[sel]] = src_s[sel]
    # sort descending so -1 lands last, then blank adjacent repeats
    s = np.sort(adj, axis=1)[:, ::-1]
    dup = np.zeros_like(s, dtype=bool)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    s[dup] = -1
    s = np.sort(s, axis=1)[:, ::-1]
    if n > 1:
        rows, cols = np.nonzero(s < 0)
        rnd = ((rows.astype(np.int64) * 2654435761 + cols.astype(np.int64) * 40503 + 12345)
               & 0xFFFFFFFF) % n
        rnd = np.where(rnd == rows, (rnd + 1) % n, rnd)
        s[rows, cols] = rnd
    return np.ascontiguousarray(s)


def _fill_hash(rows: torch.Tensor, cols: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's uint32 fill hash ``(r * 2654435761 + c * 40503 +
    12345) mod 2^32 mod n`` in int64 (``r < 2^31``: no overflow), with a
    self-edge moved to the next row."""
    rnd = ((rows * 2654435761 + cols * 40503 + 12345) & 0xFFFFFFFF) % n
    return torch.where(rnd == rows, (rnd + 1) % n, rnd)


def _assemble_adjacency_dev(fwd: torch.Tensor, *, n: int, degree: int) -> torch.Tensor:
    """Device analog of :func:`_assemble_adjacency` (reference ``:858``):
    ``fwd [n_rows, k]`` (-1 padded; rows >= ``n`` all -1) -> ``[n_rows,
    degree]`` int32, equal to the host assembly."""
    dev = fwd.device
    fwd = fwd.long()
    n_rows, k = fwd.shape
    width = min(k, degree)
    adj = torch.full((n_rows, degree), -1, dtype=torch.int64, device=dev)
    adj[:, :width] = fwd[:, :width]
    fill = torch.sum(adj >= 0, dim=1)
    # reverse edges grouped by destination: a stable sort by dst keeps the
    # host path's first-come slot order (src-major flat order)
    src = torch.arange(n_rows, device=dev).repeat_interleave(k)
    dst = fwd.reshape(-1)
    dst_key = torch.where(dst >= 0, dst, n_rows)
    dst_s, order = torch.sort(dst_key, stable=True)
    src_s = src[order]
    group_start = torch.searchsorted(dst_s, torch.arange(n_rows, device=dev))
    dst_c = dst_s.clamp(0, n_rows - 1)
    pos = torch.arange(dst_s.shape[0], device=dev) - group_start[dst_c]
    slot = fill[dst_c] + pos
    ok = (dst_s < n_rows) & (slot < degree)
    adj[dst_s[ok], slot[ok]] = src_s[ok]
    s = torch.sort(adj, dim=1, descending=True).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    s = torch.sort(torch.where(dup, -1, s), dim=1, descending=True).values
    if n > 1:
        rnd = _fill_hash(torch.arange(n_rows, device=dev)[:, None],
                         torch.arange(degree, device=dev)[None, :], n)
        s = torch.where(s < 0, rnd, s)
    live = torch.arange(n_rows, device=dev)[:, None] < n
    return torch.where(live, s, -1).to(torch.int32)


# ----------------------------------------------------------------------------
# beam search
# ----------------------------------------------------------------------------


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """``[B, W]`` True where no earlier column of the row holds the same
    value: ``sum(tril(ids[:, :, None] == ids[:, None, :], -1), 2) == 0``
    through one stable sort."""
    s, order = torch.sort(ids, dim=1, stable=True)
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[:, 1:] = s[:, 1:] == s[:, :-1]
    return ~torch.zeros_like(rep).scatter(1, order, rep)


def _expansion_dups(pool_ids: torch.Tensor, nbrs: torch.Tensor, bad0: torch.Tensor):
    """Expansion entries to drop beside ``bad0``: ``nbrs [B, M]`` already in
    the pool ``pool_ids [B, beam]``, or repeating an earlier entry of the
    expansion that is itself kept. The reference's
    ``any(nbrs[:, :, None] == ids[:, None, :], 2)`` and its ``[B, M, M]``
    first-occurrence sum, as one stable sort of the pool ids (first) and the
    expansion's ids, with rows already bad and empty pool slots given
    unique keys."""
    p = pool_ids.shape[1]
    big = 1 << 40  # above every row id
    pos = torch.arange(p + nbrs.shape[1], device=nbrs.device)
    keys = torch.cat([torch.where(pool_ids >= 0, pool_ids, big + pos[:p]),
                      torch.where(bad0, big + pos[p:], nbrs)], dim=1)
    return ~_first_occurrence(keys)[:, p:]


def beam_search_impl(
    queries,  # [B, D] f32
    corpus,  # [N_pad, D] f32, or SQ8Vectors (quantized traversal)
    adj,  # [N_pad, degree] int32
    sqnorm,  # [N_pad] f32
    valid,  # [N_pad] bool
    seed_ids,  # [S] int64 routing sample
    mask,  # [N_pad] bool or None: the result filter
    rerank_corpus=None,  # [N_pad, D] f32: f32 rescore of the pool's head
    router=None,  # (cents [P, D], cent_sq [P], part_rows [P, L]): routed entries
    entry_state=None,  # the entry IVF's arrays (see entry_mode)
    *,
    k: int,
    beam: int,
    expansions: int,
    degree: int,
    entry_points: int,
    metric,
    restarts: int = 1,
    entry_probes: int = 2,
    entry_mode: str = "legacy",
    expand_width: int | None = None,
):
    """Batched best-first beam search (reference ``:922``), on the tensors'
    device. ``entry_mode``: ``"kernel"`` (``entry_state = (cents, cent_sq,
    words, aux, flat_rows)``, #10 through ``ivf_probe_topk``), ``"xla"``
    (``entry_state = (cents, cent_sq, (words, scale, minv), part_rows,
    part_sq)``, ``ivf_search_impl`` with the mask), else routed entries when
    ``router`` is given, else the dense seed scan. The coarse entries are
    rescored exactly before seeding the beam. Internal distances are
    lower-is-better: L2^2, ``1 - cos``, ``-dot``. Returns ``(values [B, k],
    ids [B, k] int64)`` in the metric's orientation, -1 where empty."""
    metric = DistanceMetric.parse(metric)
    inf = torch.inf
    quant = isinstance(corpus, SQ8Vectors)
    dev = queries.device
    b = queries.shape[0]
    if metric is DistanceMetric.COSINE:
        qn = queries / torch.linalg.norm(queries, dim=-1, keepdim=True).clamp_min(1e-30)
    else:
        qn = queries
    R = max(1, restarts)
    b0 = b
    if R > 1:  # fold restarts into the batch: row b*R + r is query b's restart r
        qn = torch.repeat_interleave(qn, R, dim=0)
        b = b0 * R
    if quant:
        qsum = torch.sum(qn, dim=-1, keepdim=True)
        qb = qn.to(torch.bfloat16).float()  # bf16 x code <= 255: exact in fp32
    qq = torch.sum(qn * qn, dim=-1, keepdim=True)

    def gathered_dots(node_ids):
        """``q . row`` for each query's own gathered rows ``[B, M]``."""
        safe = node_ids.clamp_min(0)
        if quant:
            cd = torch.bmm(corpus.codes[safe].float(), qb[:, :, None])[:, :, 0]
            return cd * corpus.scale[safe] + qsum * corpus.minv[safe]
        return torch.bmm(corpus[safe], qn[:, :, None])[:, :, 0]

    def q_dist(node_ids):
        dots = gathered_dots(node_ids)
        if metric is DistanceMetric.EUCLIDEAN:
            return qq + sqnorm[node_ids.clamp_min(0)] - 2.0 * dots
        if metric is DistanceMetric.COSINE:
            return 1.0 - dots / torch.sqrt(sqnorm[node_ids.clamp_min(0)].clamp_min(1e-30))
        return -dots

    def exact_dist(vecs, dots):
        """Distances of f32 rows ``vecs [B, M, D]`` with ``dots [B, M]``."""
        if metric is DistanceMetric.EUCLIDEAN:
            return qq + torch.sum(vecs * vecs, dim=-1) - 2.0 * dots
        if metric is DistanceMetric.COSINE:
            return 1.0 - dots / torch.sqrt(torch.sum(vecs * vecs, dim=-1).clamp_min(1e-30))
        return -dots

    # ---- stage 1: entry points ----
    if entry_state is not None and entry_mode != "legacy":
        if entry_mode == "kernel":
            e_cents, e_csq, e_words, e_aux, e_frows = entry_state
            _, init_ids = ivf_probe_topk(qn, e_cents, e_csq, e_words, e_aux, e_frows,
                                         k=entry_points, nprobe=entry_probes, metric=metric)
        else:
            e_cents, e_csq, e_parts, e_prows, e_psq = entry_state
            _, init_ids = ivf_search_impl(qn, e_cents, e_csq, e_parts, e_prows, e_psq, mask,
                                          k=entry_points, nprobe=entry_probes, metric=metric)
        # exact rescore: the coarse SQ8 scores only ranked the candidates
        badc = (init_ids < 0) | ~valid[init_ids.clamp_min(0)]
        init_d = torch.where(badc, inf, q_dist(init_ids))
        init_ids = torch.where(badc, -1, init_ids)
    elif router is not None:
        cents, csq, rrows = router
        aff = qn @ cents.T
        if metric is DistanceMetric.EUCLIDEAN:
            aff = aff - 0.5 * csq[None, :]
        n_parts = cents.shape[0]
        ep = max(1, entry_probes)
        if R > 1:  # restart r enters from the query's probes [ep*r, ep*r + ep)
            nprobe_tot = min(ep * R, n_parts)
            _, pids_all = first_topk(aff, nprobe_tot)
            r_idx = torch.arange(b, device=dev) % R
            sel = torch.clamp_max(ep * r_idx[:, None] + torch.arange(ep, device=dev)[None, :],
                                  nprobe_tot - 1)
            pids = torch.gather(pids_all, 1, sel)
        else:
            _, pids = first_topk(aff, min(ep, n_parts))
        cand = rrows[pids].reshape(b, -1)
        badc = (cand < 0) | ~valid[cand.clamp_min(0)]
        cd = torch.where(badc, inf, q_dist(cand))
        init_d, pos = _best(cd, min(entry_points, cand.shape[1]), False)
        init_ids = torch.gather(cand, 1, pos)
        first = _first_occurrence(init_ids)
        init_d = torch.where(first, init_d, inf)
        init_ids = torch.where(first, init_ids, -1)
    else:
        # dense seed scan (no router: small or exact-built corpora)
        if quant:
            seed_vecs = (corpus.codes[seed_ids].float() * corpus.scale[seed_ids][:, None]
                         + corpus.minv[seed_ids][:, None])
        else:
            seed_vecs = corpus[seed_ids]
        seed_dots = qn @ seed_vecs.T
        if metric is DistanceMetric.EUCLIDEAN:
            seed_d = qq + sqnorm[seed_ids][None, :] - 2.0 * seed_dots
        elif metric is DistanceMetric.COSINE:
            seed_d = 1.0 - seed_dots / torch.sqrt(sqnorm[seed_ids][None, :].clamp_min(1e-30))
        else:
            seed_d = -seed_dots
        seed_d = torch.where(valid[seed_ids][None, :], seed_d, inf)
        n_seed = seed_ids.shape[0]
        e = min(entry_points, max(1, n_seed // R))
        if R > 1:  # restart r seeds from the (r*e ... (r+1)*e) best sample rows
            d_all, pos_all = _best(seed_d, min(R * e, n_seed), False)
            band = torch.clamp_max(torch.arange(b, device=dev)[:, None] % R * e
                                   + torch.arange(e, device=dev)[None, :], d_all.shape[1] - 1)
            init_d = torch.gather(d_all, 1, band)
            entry_pos = torch.gather(pos_all, 1, band)
        else:
            init_d, entry_pos = _best(seed_d, e, False)
        init_ids = seed_ids[entry_pos]
        # repeated seeds (a padded routing sample repeats ids)
        first = torch.ones_like(init_ids, dtype=torch.bool)
        first[:, 1:] = init_ids[:, 1:] != init_ids[:, :-1]
        init_d = torch.where(first, init_d, inf)
        init_ids = torch.where(first, init_ids, -1)

    pad = max(beam - init_ids.shape[1], 0)
    ids = F.pad(init_ids, (0, pad), value=-1)[:, :beam]
    dist = F.pad(init_d, (0, pad), value=inf)[:, :beam]
    vis = torch.zeros_like(ids, dtype=torch.bool)

    # filtered-result accumulator: a running top-A of every scored node that
    # passes the mask (entries and each expansion), merged with the pool at
    # the final selection, so masked candidates survive pool eviction
    acc_w = 0
    if mask is not None:
        acc_w = min(beam, max(2 * k, 32))
        mk0 = mask[ids.clamp_min(0)] & (ids >= 0)
        acc_d, apos = _best(torch.where(mk0, dist, inf), acc_w, False)
        acc_i = torch.gather(torch.where(mk0, ids, -1), 1, apos)

    ew = max(1, min(expand_width or EXPAND_WIDTH, beam))
    steps = max(2, -(-expansions // ew))
    m = ew * degree
    for _ in range(steps):
        sel_d, best_pos = _best(torch.where(vis | (ids < 0), inf, dist), ew, False)
        has = sel_d < inf
        bids = torch.gather(ids, 1, best_pos)
        vis = vis.scatter(1, best_pos, True)
        nbrs = adj[bids.clamp_min(0)].reshape(b, m).long()
        nd = q_dist(nbrs)
        bad = ((nbrs < 0) | ~valid[nbrs.clamp_min(0)]
               | ~torch.repeat_interleave(has, degree, dim=1))
        bad = bad | _expansion_dups(ids, nbrs, bad)
        nd = torch.where(bad, inf, nd)
        nids = torch.where(bad, -1, nbrs)
        if acc_w:
            amk = mask[nids.clamp_min(0)] & (nids >= 0)
            acc_d, aord = _best(torch.cat([acc_d, torch.where(amk, nd, inf)], dim=1), acc_w, False)
            acc_i = torch.gather(torch.cat([acc_i, torch.where(amk, nids, -1)], dim=1), 1, aord)
        all_d = torch.cat([dist, nd], dim=1)
        dist, order = _best(all_d, beam, False)
        ids = torch.gather(torch.cat([ids, nids], dim=1), 1, order)
        vis = torch.gather(F.pad(vis, (0, m), value=False), 1, order)

    # ---- f32 rerank of the pool's head (dual precision) ----
    if rerank_corpus is not None:
        r_width = min(beam, max(32, 4 * k))
        rids = ids[:, :r_width]
        rvecs = rerank_corpus[rids.clamp_min(0)]
        exact = exact_dist(rvecs, torch.bmm(rvecs, qn[:, :, None])[:, :, 0])
        head = dist[:, :r_width]
        head = torch.where(torch.isinf(head) | (rids < 0), head, exact)
        dist = torch.cat([head, dist[:, r_width:]], dim=1)

    # ---- final selection (the result filter applies here) ----
    if mask is not None:
        keep = mask[ids.clamp_min(0)] & (ids >= 0)
        dist = torch.where(keep, dist, inf)
        if acc_w:
            if rerank_corpus is not None:
                # the accumulator rode the quantized basis: rescore it exactly
                avecs = rerank_corpus[acc_i.clamp_min(0)]
                aex = exact_dist(avecs, torch.bmm(avecs, qn[:, :, None])[:, :, 0])
                acc_d = torch.where(torch.isinf(acc_d) | (acc_i < 0), acc_d, aex)
            # union pool + accumulator (pool first, so its reranked head wins
            # the first-occurrence dedup), pre-trim, dedup
            ids = torch.cat([ids, acc_i], dim=1)
            width = min(ids.shape[1], 2 * k + acc_w)
            dist, pre = _best(torch.cat([dist, acc_d], dim=1), width, False)
            ids = torch.gather(ids, 1, pre)
            first = _first_occurrence(ids)
            dist = torch.where(first, dist, inf)
            ids = torch.where(first, ids, -1)
    if R > 1:
        # merge restarts: unfold to [B0, R*w], keep the best-ranked copy of
        # an id found by several restarts
        w = ids.shape[1]
        ids = ids.reshape(b0, R * w)
        dist, pre = _best(dist.reshape(b0, R * w), min(R * w, max(R * k, k)), False)
        ids = torch.gather(ids, 1, pre)
        first = _first_occurrence(ids)
        ids = torch.where(first, ids, -1)
        dist = torch.where(first, dist, inf)
    out_d, order = _best(dist, k, False)
    out_ids = torch.gather(ids, 1, order)
    if metric is DistanceMetric.EUCLIDEAN:
        out_v = torch.sqrt(out_d.clamp_min(0.0))
    elif metric is DistanceMetric.COSINE:
        out_v = 1.0 - out_d
    else:
        out_v = -out_d
    empty = torch.isinf(out_d)
    out_v = torch.where(empty, -inf if metric.higher_is_better else inf, out_v)
    return out_v, torch.where(empty, -1, out_ids)


def graph_state_from_jax(arrays: dict, device) -> GraphIndex:
    """A port :class:`GraphIndex` holding a reference ``GraphIndex``'s
    state, so both packages search the same graph.

    ``arrays`` holds numpy copies of the reference index's arrays under their
    attribute names without the leading underscore: ``adj``, ``valid``,
    ``sqnorm``, ``seed_ids``, ``corpus`` (absent in capacity mode),
    ``sq8trav`` (a ``(codes, scale, minv)`` triple or None), ``route_cents``,
    ``route_csq`` and ``route_rows`` (or None), ``entry_ivf`` (the dict
    :func:`~velesdb_tpu_torch.index.ivf.ivf_state_from_jax` takes, or None),
    its scalars ``dim``, ``n``, ``n_pad``, ``metric``, and ``params`` (the
    reference's ``GraphParams`` or a dict of its fields)."""

    def put(a, dtype):
        if a is None:
            return None
        return torch.tensor(np.asarray(a, dtype), device=device)

    params = arrays["params"]
    if dataclasses.is_dataclass(params):
        params = dataclasses.asdict(params)
    metric = getattr(arrays["metric"], "value", arrays["metric"])
    gi = GraphIndex(int(arrays["dim"]), metric, GraphParams(**params), device=device)
    gi.n, gi.n_pad = int(arrays["n"]), int(arrays["n_pad"])
    gi._corpus = put(arrays.get("corpus"), np.float32)
    gi._adj = put(arrays["adj"], np.int32)
    gi._sqnorm = put(arrays["sqnorm"], np.float32)
    gi._valid = put(arrays["valid"], bool)
    gi._seed_ids = put(arrays["seed_ids"], np.int64)
    sq = arrays.get("sq8trav")
    if sq is not None:
        gi._sq8trav = SQ8Vectors(put(sq[0], np.uint8), put(sq[1], np.float32),
                                 put(sq[2], np.float32))
    if arrays.get("route_cents") is not None:
        gi._route_cents = put(arrays["route_cents"], np.float32)
        gi._route_csq = put(arrays["route_csq"], np.float32)
        gi._route_rows = put(arrays["route_rows"], np.int64)
        gi._route_host = (np.asarray(arrays["route_cents"], np.float32),
                          np.asarray(arrays["route_rows"], np.int32))
    if arrays.get("entry_ivf") is not None:
        gi._entry_ivf = ivf_state_from_jax(arrays["entry_ivf"], device)
    gi._dirty = False
    return gi
