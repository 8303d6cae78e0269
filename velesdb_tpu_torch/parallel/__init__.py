"""Multi-device search on ``torch.distributed``: meshes of ranks, sharded
engines, the top-k merge over an all-gather (counterpart of
``velesdb_tpu/parallel``)."""

from velesdb_tpu_torch.parallel.sharded import (
    ShardedBruteForce,
    make_mesh,
    shard_rows,
    sharded_ingest_search_step,
)

from velesdb_tpu_torch.parallel.multihost import (
    init_distributed,
    make_hybrid_mesh,
    segment_for_host,
)
from velesdb_tpu_torch.parallel.sharded_ann import ShardedGraphIndex
from velesdb_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex
from velesdb_tpu_torch.parallel.carried import sharded_state_from_jax

__all__ = [
    "ShardedBruteForce",
    "ShardedGraphIndex",
    "ShardedIvfIndex",
    "init_distributed",
    "make_hybrid_mesh",
    "make_mesh",
    "segment_for_host",
    "shard_rows",
    "sharded_ingest_search_step",
    "sharded_state_from_jax",
]
