"""Multi-host scale-out: the ``torch.distributed`` bootstrap and hybrid meshes.

Counterpart of ``velesdb_tpu/parallel/multihost.py``:

- :func:`init_distributed` starts the default process group from
  ``VELESDB_COORD_ADDR`` / ``VELESDB_NUM_PROCESSES`` / ``VELESDB_PROCESS_ID``
  (or explicit arguments), adopts one that already exists, and does nothing
  on a single host with no configuration.
- :func:`make_hybrid_mesh` lays the ranks out on ``("dcn", "dp", "rows")``:
  ``dcn`` spans the hosts (slices), ``rows`` the ranks of a host, so the
  engines of ``parallel.sharded`` shard rows over ``dcn x rows`` and merge
  the ``[B, k]`` partials across both in one gather. On one host ``dcn`` is 1.

A rank is one process and one device here; the reference's process holds
several devices. So a slice is a host: :func:`num_slices` counts the
distinct host names of the ranks. Ranks of one host must be numbered
contiguously (as ``torchrun`` numbers them).
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.streamed import streamed_topk
from velesdb_tpu_torch.parallel.sharded import (
    Mesh,
    _dp_queries,
    _global_result,
    mesh_device,
    n_row_shards,
    row_shard,
)

__all__ = [
    "init_distributed",
    "make_hybrid_mesh",
    "num_slices",
    "segment_for_host",
    "dcn_sharded_search",
    "make_global_rows",
]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Idempotent multi-process bootstrap. Returns True when a world of more
    than one rank is active after the call.

    The arguments default to ``VELESDB_COORD_ADDR`` (``host:port`` of rank
    0's TCP store), ``VELESDB_NUM_PROCESSES`` and ``VELESDB_PROCESS_ID``;
    ``backend`` to NCCL where a card is present, else gloo. With no address
    (the single-host case) nothing starts and the result is False. A process
    group started by the caller is adopted as it is."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    addr = coordinator_address or os.environ.get("VELESDB_COORD_ADDR")
    if addr is None:
        return False
    world = num_processes or int(os.environ.get("VELESDB_NUM_PROCESSES", "1"))
    rank = process_id if process_id is not None else int(os.environ.get("VELESDB_PROCESS_ID", "0"))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    return world > 1


def num_slices() -> int:
    """Number of hosts among the ranks of the world (1 with no world). A
    collective: every rank calls it."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 1
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return len(set(names))


def make_hybrid_mesh(dp: int = 1, device="cuda", slices: int | None = None) -> Mesh:
    """A ``(dcn, dp, rows)`` mesh: ``dcn`` over ``slices`` hosts (default:
    the hosts the ranks run on), ``dp`` splitting the batch, ``rows`` the
    rest. Sharded engines address the same three names either way."""
    dev = mesh_device(device)
    n = dist.get_world_size()
    slices = slices or num_slices()
    if n % (slices * dp):
        raise ValueError(f"{n} ranks not divisible by slices*dp={slices * dp}")
    return Mesh(("dcn", "dp", "rows"), (slices, dp, n // (slices * dp)), dev)


def make_global_rows(mesh: Mesh, make_local, n: int, row_shape=(), dtype=np.float32):
    """This rank's shard of a global ``[n, *row_shape]`` array row-sharded
    over ``(dcn, rows)``, a tensor on the mesh's device. ``make_local(start,
    stop)`` makes the rows of one shard, and only this rank's are made (there
    is no memory shared across hosts: the ingest path in array form). ``n``
    must divide evenly by the shard count (pad first)."""
    shards = n_row_shards(mesh)
    if n % shards:
        raise ValueError(f"rows {n} must divide by dcn*rows={shards}")
    n_local = n // shards
    start = row_shard(mesh) * n_local
    local = np.asarray(make_local(start, start + n_local), dtype)
    if local.shape != (n_local, *row_shape):
        raise ValueError(f"make_local gave {local.shape}, not {(n_local, *row_shape)}")
    return torch.from_numpy(np.ascontiguousarray(local)).to(mesh.device)


def dcn_sharded_search(mesh: Mesh, queries, corpus, valid, cnorm, *, k: int, metric,
                       chunk: int = 65536):
    """Cross-host search over a ``(dcn, dp, rows)`` mesh: ``corpus [n_local,
    D]``, ``valid`` and ``cnorm`` (squared norms) are this rank's shards
    (:func:`make_global_rows`), ``queries [B, D]`` the whole batch on every
    rank (each takes its ``dp`` slice). Each rank runs the streamed engine on
    its shard, and the ``[B, k']`` partials merge over ``dcn`` and ``rows``
    in one gather. Returns numpy ``(values [B, k], global row ids [B, k])``
    on every rank."""
    metric = DistanceMetric.parse(metric)
    n_local = corpus.shape[0]
    q_np = np.atleast_2d(np.asarray(queries, np.float32))
    b = q_np.shape[0]
    b_pad = -(-b // mesh.shape["dp"]) * mesh.shape["dp"]
    lv, li = streamed_topk(_dp_queries(mesh, q_np, b_pad), corpus, valid=valid,
                           k=min(k, n_local), metric=metric, chunk=min(chunk, n_local),
                           corpus_sqnorm=cnorm)
    gi = torch.where(li >= 0, li + row_shard(mesh) * n_local, -1)
    return _global_result(mesh, lv, gi, k, metric.higher_is_better, b)


def segment_for_host(n_rows_total: int, host: int | None = None,
                     n_hosts: int | None = None) -> tuple[int, int]:
    """Contiguous corpus segment ``[start, end)`` owned by process ``host``
    (default: this rank) of ``n_hosts`` (default: the world's size) when
    rows partition over processes (the ingest routing helper)."""
    started = dist.is_initialized()
    h = host if host is not None else (dist.get_rank() if started else 0)
    nh = n_hosts or (dist.get_world_size() if started else 1)
    per = -(-n_rows_total // nh)
    start = h * per
    return start, min(start + per, n_rows_total)
