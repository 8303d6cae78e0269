"""A reference sharded engine's state as the port's shard, so that both
packages search the same shards, partitions and graphs (beside
``index.ivf.ivf_state_from_jax`` and ``index.graph_index.graph_state_from_jax``;
reference builds are not bit-reproducible on the card, where k-means sums
with atomics)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from velesdb_tpu_torch.index.params import GraphParams
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.quantization import STORAGE_DTYPE, StorageMode
from velesdb_tpu_torch.parallel.sharded import ShardedBruteForce
from velesdb_tpu_torch.parallel.sharded_ann import ShardedGraphIndex
from velesdb_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex

__all__ = ["reference_arrays", "sharded_state_from_jax"]

_ARRAYS = {
    "ShardedBruteForce": ("corpus", "codes", "scale", "minv", "cnorm", "valid", "assist"),
    "ShardedIvfIndex": ("cents", "cent_sq", "parts", "part_rows", "part_sq"),
    "ShardedGraphIndex": ("corpus", "adj", "sqnorm", "valid", "seeds", "row_of", "entry",
                          "entry_kern"),
}
_SCALARS = {
    "ShardedBruteForce": ("dim", "n", "n_pad", "assist_chunk"),
    "ShardedIvfIndex": ("dim", "n", "n_shards", "c_local", "part_len", "n_clusters"),
    "ShardedGraphIndex": ("dim", "n", "n_shards", "n_local", "entry_c", "entry_len"),
}


def _host(a):
    """A numpy copy of a reference array (bfloat16 widened to float32,
    which holds it exactly); tuples element by element."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(_host(x) for x in a)
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def reference_arrays(ref) -> dict:
    """Numpy copies of a reference ``ShardedBruteForce``, ``ShardedIvfIndex``
    or ``ShardedGraphIndex``'s global arrays (attribute names without the
    leading underscore, tuples kept), its scalars, ``kind`` (the class name),
    ``metric`` and, per engine, ``storage_mode`` or ``params``: picklable, so
    that ranks which cannot import the reference receive it."""
    kind = type(ref).__name__
    if kind not in _ARRAYS:
        raise TypeError(f"not a reference sharded engine: {kind}")
    out = {"kind": kind, "metric": DistanceMetric.parse(ref.metric.value).value}
    for key in _SCALARS[kind]:
        out[key] = getattr(ref, key if hasattr(ref, key) else "_" + key)
    for key in _ARRAYS[kind]:
        out[key] = _host(getattr(ref, "_" + key))
    if kind == "ShardedBruteForce":
        out["storage_mode"] = ref.storage_mode.value
    if kind == "ShardedGraphIndex":
        out["params"] = dataclasses.asdict(ref.params)
    return out


def sharded_state_from_jax(ref_engine, rank: int, world: int, device):
    """The port's engine holding row shard ``rank`` of ``world`` of a
    reference sharded engine (the engine itself, or :func:`reference_arrays`
    of it), on ``device``. Its ``mesh`` is None: set it to the mesh whose
    row shard ``rank`` of ``world`` this process holds before searching."""
    a = ref_engine if isinstance(ref_engine, dict) else reference_arrays(ref_engine)
    device = torch.device(device)

    def part(x, dtype=None):
        if x is None:
            return None
        per = x.shape[0] // world
        t = torch.from_numpy(np.ascontiguousarray(x[rank * per : (rank + 1) * per]))
        return t.to(device) if dtype is None else t.to(device, dtype)

    kind = a["kind"]
    if kind == "ShardedBruteForce":
        mode = StorageMode.parse(a["storage_mode"])
        eng = ShardedBruteForce(None, a["dim"], a["metric"], mode)
        eng.n, eng.n_pad, eng._assist_chunk = a["n"], a["n_pad"], a["assist_chunk"]
        eng.n_local = a["n_pad"] // world
        eng._corpus = part(a["corpus"], STORAGE_DTYPE.get(mode, torch.float32))
        eng._codes = part(a["codes"])
        eng._scale, eng._minv = part(a["scale"]), part(a["minv"])
        eng._cnorm, eng._valid = part(a["cnorm"]), part(a["valid"])
        if a["assist"] is not None:
            eng._assist = tuple(part(x) for x in a["assist"])
        return eng
    if kind == "ShardedIvfIndex":
        eng = ShardedIvfIndex.__new__(ShardedIvfIndex)
        eng.mesh, eng.metric = None, DistanceMetric.parse(a["metric"])
        for key in _SCALARS[kind]:
            setattr(eng, key, a[key])
        eng._cents, eng._cent_sq = part(a["cents"]), part(a["cent_sq"])
        eng._parts = part(a["parts"])
        eng._part_rows = part(a["part_rows"], torch.int64)
        eng._part_sq = part(a["part_sq"])
        return eng
    eng = ShardedGraphIndex.__new__(ShardedGraphIndex)
    eng.mesh, eng.metric = None, DistanceMetric.parse(a["metric"])
    eng.params, eng.build_seconds = GraphParams(**a["params"]), {}
    for key in _SCALARS[kind]:
        setattr(eng, "_" + key if key.startswith("entry") else key, a[key])
    eng._corpus, eng._adj = part(a["corpus"]), part(a["adj"], torch.int32)
    eng._sqnorm, eng._valid = part(a["sqnorm"]), part(a["valid"])
    eng._seeds = part(a["seeds"], torch.int64)
    eng._row_of = np.asarray(a["row_of"], np.int64)
    eng._entry = eng._entry_kern = None
    if a["entry"] is not None:
        cents, csq, words, scale, minv, prows, psq = a["entry"]
        eng._entry = (part(cents), part(csq), part(words, torch.int32), part(scale),
                      part(minv), part(prows, torch.int64), part(psq))
    if a["entry_kern"] is not None:
        aux, frows = a["entry_kern"]
        eng._entry_kern = (part(np.ascontiguousarray(aux[:, :3])), part(frows, torch.int64))
    return eng
