"""Multi-device search: a corpus row-sharded over the ranks of a
``torch.distributed`` world, each shard's top-k merged with an all-gather.

Counterpart of ``velesdb_tpu/parallel/sharded.py``. The reference lays its
shards on the devices of a ``jax.sharding.Mesh`` and runs one ``shard_map``
program; here each rank of a process group owns one shard on its own device,
and the body of each ``shard_map`` is that rank's own code:

- :func:`make_mesh` names the axes ``("dp", "rows")``, with one process
  group per axis: NCCL on ``cuda``, gloo on ``cpu``. With no process group
  started and no rendezvous in the environment it starts a world of 1 in
  the process, the reference's single-host case.
- ``rows`` shards the corpus. A batch's ``[B, k']`` partials cross the
  ``rows`` group in one ``all_gather`` and are selected again
  (:func:`_merge_partials`: ties go to the lowest shard, then the in-shard
  rank, as ``lax.top_k`` keeps them). ``dp`` splits the query batch, and a
  second ``all_gather`` over ``dp`` gives every rank the whole ``[B, k]``,
  as ``np.asarray`` of the reference's global result does.
- Three shard modes: *streamed* (``streamed_topk``, plain torch), *assist*
  (``sq8i_rerank_topk``: kernel #7 of ``csrc/sq8i_bucket.cu`` on FULL
  storage at D < 512) and *SQ8* (``sq8_streamed_topk``, plain torch).

A rank builds its shard on its device from its own rows. The rebuild's
arrays are the reference's: the assist chunk padding, the cosine
pre-normalization, the true-division quantization (:func:`_sq8_quantize_div`)
and the uncentered int8 shadow with its ``+inf`` penalty; row sums run in
numpy's pairwise order (:func:`_np_row_sum`), so they equal the reference's
host arrays bit for bit on either device. (The port's single-card assist
centers its euclidean shadow, ``index/brute.py:_assist_shadow``; the sharded
one keeps the reference's form so that ids compare exactly.)

A gloo group gathers host tensors only, so on gloo the partials cross
through the host; the choice follows the group's backend.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from velesdb_tpu_torch.ops.bucket_kernel import bucket_chunk, first_topk, sq8i_rerank_topk
from velesdb_tpu_torch.ops.bucket_kernel import sq8_int8_rows
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.quantization import STORAGE_DTYPE, SQ8Vectors, StorageMode
from velesdb_tpu_torch.ops.streamed import sq8_streamed_topk, streamed_topk

__all__ = [
    "Mesh",
    "make_mesh",
    "ShardedBruteForce",
    "shard_rows",
    "sharded_ingest_search_step",
    "row_axes",
    "n_row_shards",
    "shard_layout",
]

# rows of the assist shadow's coarse-scan chunk: a shard holds a multiple
ASSIST_CHUNK = 8192
# rows quantized per step of a rebuild (bounds its temporaries on the device)
_BUILD_ROWS = 1 << 20


class Mesh:
    """The ranks of the default process group laid out row-major on named
    axes: this rank's coordinates, its device, and one process group per
    axis (plus one over the row axes when there are two of them)."""

    def __init__(self, axis_names, sizes, device: torch.device):
        world = dist.get_world_size()
        if int(np.prod(sizes)) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, sizes))} does not hold the "
                             f"{world} ranks of the world")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device = device
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        grid = np.arange(world).reshape(sizes)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, grid.shape))))
        axes_sets = [(a,) for a in self.axis_names]
        if len(row_axes(self)) > 1:
            axes_sets.append(row_axes(self))
        # every rank creates every group, in one order (new_group's contract)
        self.groups = {axes: self._group(grid, axes) for axes in axes_sets}

    def _group(self, grid: np.ndarray, axes) -> tuple:
        """``(group, size)`` of the ranks that differ from this one along
        ``axes`` only, ordered row-major over ``axes``."""
        pos = [self.axis_names.index(a) for a in axes]
        lines = np.moveaxis(grid, pos, range(grid.ndim - len(pos), grid.ndim))
        lines = lines.reshape(-1, int(np.prod([grid.shape[p] for p in pos])))
        mine = None
        for ranks in lines.tolist():
            if len(ranks) == dist.get_world_size():
                group = dist.group.WORLD
            else:
                group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (group, len(ranks))
        return mine

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, {self.device}, {self.backend})"


def row_axes(mesh: Mesh):
    """Row-sharding axis names for ``mesh``: ``("dcn", "rows")`` on a hybrid
    multi-host mesh (``make_hybrid_mesh``), whose partials merge over both in
    one gather, else ``("rows",)``."""
    return ("dcn", "rows") if "dcn" in mesh.axis_names else ("rows",)


def n_row_shards(mesh: Mesh) -> int:
    n = 1
    for a in row_axes(mesh):
        n *= mesh.shape[a]
    return n


def row_shard(mesh: Mesh) -> int:
    """This rank's shard index over the row axes (row-major)."""
    i = 0
    for a in row_axes(mesh):
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def _start_world(kind: str) -> None:
    """Start the default process group unless one exists: from the
    ``VELESDB_*`` rendezvous (``multihost.init_distributed``), else from
    torch's ``env://`` variables, else a world of 1 in this process."""
    if dist.is_initialized():
        return
    backend = "nccl" if kind == "cuda" else "gloo"
    from velesdb_tpu_torch.parallel.multihost import init_distributed

    init_distributed(backend=backend)
    if dist.is_initialized():
        return
    if {"MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"} <= os.environ.keys():
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def mesh_device(device="cuda") -> torch.device:
    """``device`` checked, the world started on its backend, and a bare
    ``cuda`` resolved to card ``rank % device_count`` (the current device of
    an NCCL rank)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda') needs a CUDA device; pass device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {device!r}")
    _start_world(dev.type)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        if dist.get_backend() == "nccl":
            torch.cuda.set_device(dev)
    elif dist.get_backend() == "nccl":
        raise ValueError("an NCCL world cannot hold CPU shards")
    return dev


def make_mesh(n_devices: int | None = None, dp: int = 1, device="cuda") -> Mesh:
    """A ``(dp, rows)`` mesh over the ranks of the world: ``rows`` shards the
    corpus, ``dp`` splits the query batch. ``n_devices`` must be the world's
    size (one rank a device)."""
    dev = mesh_device(device)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"requested {n_devices} devices, the world has {n} ranks")
    if n % dp:
        raise ValueError(f"n_devices={n} not divisible by dp={dp}")
    return Mesh(("dp", "rows"), (dp, n // dp), dev)


def _all_gather(mesh: Mesh, axes, t: torch.Tensor) -> torch.Tensor:
    """``[G, *t.shape]``: ``t`` from each rank of the group over ``axes``, in
    its order. A gloo group gathers host tensors, into a list."""
    group, size = mesh.groups[tuple(axes)]
    t = t.contiguous()
    if mesh.backend == "nccl":
        out = t.new_empty((size, *t.shape))
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    t = t.cpu()
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def _pack(vals, ids) -> torch.Tensor:
    """``[B, k, 2]`` float64: f32 values and int64 ids below 2^53 both hold
    exactly, so one gather carries both."""
    return torch.stack([vals.double(), ids.double()], dim=-1)


def _merge_partials(mesh: Mesh, lv, gi, k: int, higher_is_better: bool):
    """Local ``[B, k']`` partials (global row ids, -1 empty) -> the row
    group's ``[B, k]``: one gather, then one select over the shard-major
    concatenation, ties to the smallest position (``lax.top_k``'s rule)."""
    both = _all_gather(mesh, row_axes(mesh), _pack(lv, gi))  # [S, B, k', 2]
    b = lv.shape[0]
    both = both.transpose(0, 1).reshape(b, -1, 2)
    av, ai = both[..., 0].float(), both[..., 1].long()
    key = torch.where(ai >= 0, av if higher_is_better else -av, -torch.inf)
    mv, pos = first_topk(key, min(k, key.shape[1]))
    empty = mv == -torch.inf
    worst = -torch.inf if higher_is_better else torch.inf
    vals = torch.where(empty, worst, torch.gather(av, 1, pos))
    return vals, torch.where(empty, -1, torch.gather(ai, 1, pos))


def _global_result(mesh: Mesh, lv, gi, k: int, higher_is_better: bool, b: int):
    """Merge over the row axes, gather the ``dp`` slices, and return the
    first ``b`` rows as numpy ``(values f32, ids int64)`` on every rank:
    two gathers a call."""
    vals, ids = _merge_partials(mesh, lv, gi, k, higher_is_better)
    both = _all_gather(mesh, ("dp",), _pack(vals, ids)).reshape(-1, vals.shape[1], 2)[:b]
    both = both.cpu()
    return both[..., 0].float().numpy(), both[..., 1].long().numpy()


def _dp_queries(mesh: Mesh, queries, b_pad: int) -> torch.Tensor:
    """This rank's ``dp`` slice of the batch padded to ``b_pad`` rows."""
    q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)))
    q = F.pad(q, (0, 0, 0, b_pad - q.shape[0]))
    per = b_pad // mesh.shape["dp"]
    d = mesh.coords["dp"]
    return q[d * per : (d + 1) * per].to(mesh.device)


def _block(mesh: Mesh, array, n_local: int, pad_value=0) -> torch.Tensor:
    """This rank's ``n_local`` rows of the host ``array`` (rows past its end
    filled with ``pad_value``) as a tensor on the mesh's device."""
    lo = row_shard(mesh) * n_local
    # a copy where the rows are not a writable C array (a memory map)
    part = np.require(array[lo : lo + n_local], requirements=["C", "W"])
    t = torch.from_numpy(part).to(mesh.device)
    if t.shape[0] < n_local:
        fill = torch.full((n_local - t.shape[0], *t.shape[1:]), pad_value, dtype=t.dtype,
                          device=t.device)
        t = torch.cat([t, fill])
    return t


def shard_rows(mesh: Mesh, array: np.ndarray, pad_value=0) -> torch.Tensor:
    """This rank's shard of ``[N, ...]`` host data row-sharded over the row
    axes, N padded up to a multiple of the shard count with ``pad_value``.
    (The reference returns the global array; here each rank holds its part.)"""
    array = np.asarray(array)
    n_local = -(-array.shape[0] // n_row_shards(mesh))
    return _block(mesh, array, n_local, pad_value)


def _np_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of ``x [N, D]`` in numpy's pairwise order (``np.sum(axis=1)``
    of float32 rows: eight running sums below 128 columns, halves above), as
    elementwise fp32 adds: equal to the reference's host sums on every
    device."""
    n = x.shape[1]
    if n < 8:
        res = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[:, i]
        return res
    if n <= 128:
        r = x[:, :8]
        whole = n - n % 8
        for i in range(8, whole, 8):
            r = r + x[:, i : i + 8]
        res = (r[:, 0] + r[:, 1] + (r[:, 2] + r[:, 3])) + (r[:, 4] + r[:, 5] + (r[:, 6] + r[:, 7]))
        for i in range(whole, n):
            res = res + x[:, i]
        return res
    half = n // 2
    half -= half % 8
    return _np_row_sum(x[:, :half]) + _np_row_sum(x[:, half:])


def _one(like: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=like.device)


def _sq8_quantize_div(x: torch.Tensor):
    """The reference's rebuild-time SQ8 quantization (``sharded.py:234``,
    ``_sq8_quantize_host``) on the rank's device: the scale is a true
    division by 255 (``sq8_quantize`` multiplies by its reciprocal, as XLA
    folds the single-card one), 1 below 1e-12. Returns ``(codes uint8,
    scale, minv)``, in row blocks."""
    codes, scale, minv = [], [], []
    for s in range(0, x.shape[0], _BUILD_ROWS):
        blk = x[s : s + _BUILD_ROWS]
        lo = torch.amin(blk, dim=1)
        sc = (torch.amax(blk, dim=1) - lo) / (255.0 * _one(blk))
        sc = torch.where(sc > 1e-12, sc, 1.0)
        cd = torch.clamp(torch.round((blk - lo[:, None]) / sc[:, None]), 0, 255)
        codes.append(cd.to(torch.uint8))
        scale.append(sc)
        minv.append(lo)
    return torch.cat(codes), torch.cat(scale), torch.cat(minv)


def _deq_sq(codes, scale, minv) -> torch.Tensor:
    """``sum((codes * scale + minv) ** 2)`` a row, in numpy's order."""
    return torch.cat([
        _np_row_sum((codes[s : s + _BUILD_ROWS].float() * scale[s : s + _BUILD_ROWS, None]
                     + minv[s : s + _BUILD_ROWS, None]) ** 2)
        for s in range(0, codes.shape[0], _BUILD_ROWS)])


def _metric_cnorm(deq_sq: torch.Tensor, metric: DistanceMetric) -> torch.Tensor:
    """``sq8_streamed_topk``'s cnorm conventions: euclidean -> squared norms,
    cosine -> norms, dot -> zeros."""
    if metric is DistanceMetric.EUCLIDEAN:
        return deq_sq
    if metric is DistanceMetric.COSINE:
        return torch.sqrt(deq_sq)
    return torch.zeros_like(deq_sq)


def shard_layout(n: int, shards: int, dim: int, storage_mode=StorageMode.FULL) -> dict:
    """Rows and device bytes of one shard of ``n`` rows over ``shards``:
    ``n_local`` (a multiple of :data:`ASSIST_CHUNK` where the assist shadow
    is built: FULL at D < 512), ``n_pad`` over all shards, ``assist`` and
    ``bytes`` (the rows in their storage type, the int8 shadow at D padded
    to 128 with its three f32 row arrays, the f32 norms, the validity)."""
    mode = StorageMode.parse(storage_mode)
    assist = mode is StorageMode.FULL and dim < 512
    n_local = -(-max(n, 1) // shards)
    if assist:
        n_local = -(-n_local // ASSIST_CHUNK) * ASSIST_CHUNK
    if mode is StorageMode.SQ8:
        row = dim + 4 * 3  # codes; scale, minv, cnorm
    else:
        row = dim * (4 if mode is StorageMode.FULL else 2) + 4  # rows; cnorm
        if assist:
            row += -(-dim // 128) * 128 + 4 * 3  # rows8; scale2, minv2, pen
    return {"n_local": n_local, "n_pad": n_local * shards, "assist": assist,
            "bytes": n_local * (row + 1)}


class ShardedBruteForce:
    """Exact or quantized search over a corpus row-sharded across the mesh's
    ranks: the multi-device counterpart of ``index.brute.BruteForceIndex``,
    same masked top-k, capacity x S (x 4 more in ``sq8``, x 2 in half
    modes). Every rank calls ``rebuild`` and ``search`` with the same
    arguments and gets the same global answer."""

    def __init__(self, mesh: Mesh, dim: int, metric: DistanceMetric,
                 storage_mode: StorageMode = StorageMode.FULL):
        self.mesh = mesh
        self.dim = dim
        self.metric = DistanceMetric.parse(metric)
        self.storage_mode = StorageMode.parse(storage_mode)
        if self.storage_mode not in (
            StorageMode.FULL, StorageMode.BF16, StorageMode.F16, StorageMode.SQ8
        ):
            raise ValueError(f"sharded engine does not support mode {self.storage_mode}")
        self.n = 0
        self.n_pad = 0  # rows over all shards
        self.n_local = 0  # rows of this rank's shard
        self._corpus = None  # [n_local, D] f32 / f16 / bf16 (full and half modes)
        self._codes = None  # [n_local, D] uint8 (sq8)
        self._scale = None
        self._minv = None
        self._cnorm = None  # metric-specific corpus norms
        self._valid = None
        # int8-assist shadow (FULL mode, D < 512): (rows8 [n_local, D_pad128]
        # int8, scale2, minv2, pen), uncentered as in the reference
        self._assist = None
        self._assist_chunk = 0

    def rebuild(self, corpus: np.ndarray, valid: np.ndarray | None = None) -> None:
        """Build this rank's shard of ``corpus [N, D]`` (every rank passes the
        whole array, or a memory map of it: only its own rows are read)."""
        n = corpus.shape[0]
        valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
        self.n = n
        mode = self.storage_mode
        self._assist = None
        layout = shard_layout(n, n_row_shards(self.mesh), self.dim, mode)
        build_assist = layout["assist"]
        if build_assist:  # a shard's rows are a multiple of the coarse-scan chunk
            self._assist_chunk = ASSIST_CHUNK
        n_local = self.n_local = layout["n_local"]
        self.n_pad = layout["n_pad"]
        x = _block(self.mesh, corpus, n_local).float()
        v = _block(self.mesh, valid, n_local, False)
        self._valid = v
        if mode is StorageMode.SQ8:
            codes, scale, minv = _sq8_quantize_div(x)
            del x
            # the reference pads the quantized arrays: scale 0 past the rows
            real = min(n_local, max(0, n - row_shard(self.mesh) * n_local))
            scale[real:] = 0.0
            self._codes, self._scale, self._minv = codes, scale, minv
            self._cnorm = _metric_cnorm(_deq_sq(codes, scale, minv), self.metric)
            return
        if build_assist and self.metric is DistanceMetric.COSINE:
            # cosine scores are normalization-invariant: the scored copy is
            # stored pre-normalized, so the rerank's raw dots are cosines
            nrm = torch.sqrt(_np_row_sum(x * x))
            x = x / torch.clamp_min(nrm, 1e-30)[:, None]
        self._cnorm = _np_row_sum(x * x)  # streamed_topk takes squared norms
        self._corpus = x if mode is StorageMode.FULL else x.to(STORAGE_DTYPE[mode])
        if build_assist:
            codes, scale, minv = _sq8_quantize_div(x)
            deq_sq = _deq_sq(codes, scale, minv)
            base = torch.zeros_like(deq_sq)
            scale2, minv2 = scale, minv
            if self.metric is DistanceMetric.COSINE:
                inv = torch.where(deq_sq > 1e-30,
                                  _one(deq_sq) / torch.sqrt(deq_sq.clamp_min(1e-30)), 0.0)
                scale2, minv2 = scale * inv, minv * inv
            elif self.metric is DistanceMetric.EUCLIDEAN:
                base = deq_sq
            pen = torch.where(v, base, torch.inf)
            self._assist = (sq8_int8_rows(codes), scale2, minv2, pen)

    def _assist_serves(self, b_pad: int, k: int) -> bool:
        """The single-card serve split's guard on the local shard: the
        oversample covers k and the bucket count keeps the coarse collision
        loss under ~1% (``index.brute._bucket_safe`` on ``n_local``). The
        port's chunk rule depends on the rows alone, so ``b_pad`` (the
        reference's VMEM model input) does not change it."""
        from velesdb_tpu_torch.index.brute import _bucket_safe, _pd_m

        m = _pd_m(k)
        return m >= k and _bucket_safe(self.n_local, self._assist_chunk_for(), m)

    def _assist_chunk_for(self) -> int:
        return min(bucket_chunk(self.n_local), self._assist_chunk)

    def search(self, queries, k: int, mask: np.ndarray | None = None, chunk: int = 65536):
        """``(values [B, k], global row ids [B, k])`` as numpy on every rank."""
        from velesdb_tpu_torch.index.brute import _pd_m

        q_np = np.atleast_2d(np.asarray(queries, np.float32))
        b = q_np.shape[0]
        dp = self.mesh.shape["dp"]
        b_pad = -(-b // dp) * dp
        q = _dp_queries(self.mesh, q_np, b_pad)
        md = None
        if mask is not None:
            md = _block(self.mesh, np.asarray(mask, bool), self.n_local, False)
        vv = self._valid if md is None else self._valid & md
        kl = min(k, self.n_local)
        step = min(chunk, self.n_local)
        if self.storage_mode is StorageMode.SQ8:
            lv, li = sq8_streamed_topk(q, SQ8Vectors(self._codes, self._scale, self._minv),
                                       cnorm=self._cnorm, valid=vv, k=kl, metric=self.metric,
                                       chunk=step)
        elif self._assist is not None and self._assist_serves(b_pad, k):
            rows8, scale2, minv2, pen = self._assist
            if md is not None:
                pen = torch.where(md, pen, torch.inf)
            lv, li = sq8i_rerank_topk(q, rows8, scale2, minv2, pen, self._corpus, k=kl,
                                      m=_pd_m(k), metric=self.metric,
                                      chunk=self._assist_chunk_for())
        else:
            lv, li = streamed_topk(q, self._corpus, valid=vv, k=kl, metric=self.metric,
                                   chunk=step, corpus_sqnorm=self._cnorm)
        gi = torch.where(li >= 0, li + row_shard(self.mesh) * self.n_local, -1)
        return _global_result(self.mesh, lv, gi, k, self.metric.higher_is_better, b)


def sharded_ingest_search_step(mesh: Mesh, dim: int, metric: DistanceMetric):
    """A full ingest + search step over the mesh: write new rows into the
    row-sharded corpus, then search it.

    Returns ``step(corpus, valid, new_rows, write_pos, queries, *, k) ->
    (corpus, valid, values, indices)``: ``corpus [n_local, D]`` and ``valid
    [n_local]`` are this rank's shards (``shard_rows``), updated in place
    (``index_copy_`` on the rank that owns each slot, in place of the
    reference's buffer donation); ``new_rows [R, D]`` and ``queries [B, D]``
    are the same on every rank, ``write_pos`` the global slot of the first
    new row. The search is the streamed shard mode; values and indices come
    back as numpy ``[B, k]`` on every rank."""
    metric = DistanceMetric.parse(metric)

    def step(corpus, valid, new_rows, write_pos, queries, *, k):
        n_local = corpus.shape[0]
        lo = row_shard(mesh) * n_local
        rows = torch.as_tensor(np.asarray(new_rows, np.float32)).to(corpus.device)
        pos = int(np.asarray(write_pos).reshape(-1)[0])
        tgt = pos + torch.arange(rows.shape[0], device=corpus.device)
        mine = (tgt >= lo) & (tgt < lo + n_local)
        local = tgt[mine] - lo
        corpus.index_copy_(0, local, rows[mine].to(corpus.dtype))
        valid.index_fill_(0, local, True)
        q_np = np.atleast_2d(np.asarray(queries, np.float32))
        b = q_np.shape[0]
        b_pad = -(-b // mesh.shape["dp"]) * mesh.shape["dp"]
        lv, li = streamed_topk(_dp_queries(mesh, q_np, b_pad), corpus, valid=valid,
                               k=min(k, n_local), metric=metric, chunk=min(65536, n_local))
        gi = torch.where(li >= 0, li + lo, -1)
        vals, ids = _global_result(mesh, lv, gi, k, metric.higher_is_better, b)
        return corpus, valid, vals, ids

    return step
