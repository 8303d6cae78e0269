"""What the four kernel experiments share: device choice, float64 host
oracles, recall@k and the timing protocol.

The protocol is the JAX scripts': each timing sample runs ``iters`` calls on
distinct query batches with no host synchronization between them, and the
best of ``samples`` samples is kept. On the card a sample is timed with CUDA
events around the calls (the last event waits for the device); on the CPU
with ``time.perf_counter``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = [
    "add_device_arg",
    "device_name",
    "enc_topk",
    "host_topk",
    "recall",
    "resolve_device",
    "time_batches",
]


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")


def resolve_device(name: str) -> torch.device:
    """The device to run on. ``cuda`` without a card raises: an experiment
    never falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs an NVIDIA GPU; pass --device cpu to run "
                               "the plain versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def enc_topk(gm: torch.Tensor, k: int, chunk: int):
    """Top ``k`` of #1's encoded bucket maxima ``gm [B, N/chunk*128] int32``
    (``value * 64 + slice``), exact on the int32 codes (the JAX scripts used
    ``approx_max_k`` on an f32 cast): ``(value int32, row int64)``."""
    enc, pos = torch.topk(gm, min(k, gm.shape[1]), dim=1)
    i_dec = enc & 63
    val = (enc - i_dec) // 64  # exact, sign-safe
    return val, (pos // 128) * chunk + i_dec.long() * 128 + (pos % 128)


def host_topk(corpus: np.ndarray, queries: np.ndarray, k: int, metric: str,
              chunk: int = 131_072) -> np.ndarray:
    """Exact top-``k`` row ids ``[B, k]`` of each query in float64 on the host:
    smallest squared distance (``euclidean``) or largest dot (``dot``; a
    cosine search over unit rows and unit queries)."""
    q = np.asarray(queries, np.float64)
    best_s = best_i = None
    for c0 in range(0, corpus.shape[0], chunk):
        c = np.asarray(corpus[c0 : c0 + chunk], np.float64)
        s = q @ c.T
        if metric == "euclidean":
            s = 2.0 * s - (c * c).sum(1)[None, :]  # -|q - c|^2 + |q|^2
        elif metric != "dot":
            raise ValueError(f"unsupported metric {metric!r}")
        kk = min(k, s.shape[1])
        part = np.argpartition(-s, kk - 1, axis=1)[:, :kk]
        ps = np.take_along_axis(s, part, 1)
        if best_s is None:
            best_s, best_i = ps, part + c0
        else:
            cs = np.concatenate([best_s, ps], 1)
            ci = np.concatenate([best_i, part + c0], 1)
            top = np.argpartition(-cs, k - 1, axis=1)[:, :k]
            best_s, best_i = np.take_along_axis(cs, top, 1), np.take_along_axis(ci, top, 1)
    order = np.argsort(-best_s, axis=1, kind="stable")
    return np.take_along_axis(best_i, order, 1)


def recall(ids, truth: np.ndarray) -> float:
    """recall@k of returned ids ``[B, >=k]`` (torch or numpy) against
    oracle ids ``[B, k]``."""
    got = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    k = truth.shape[1]
    return float(np.mean([len(set(g[:k].tolist()) & set(t.tolist())) / k
                          for g, t in zip(got, truth)]))


def time_batches(fn, batches, dev: torch.device, samples: int, roll=None):
    """Best seconds per call of ``fn(batch)`` over ``samples`` timing
    samples, and every sample's seconds per call. ``batches`` is a list of
    argument tuples, one per call; sample ``s`` runs them rotated by
    ``roll(s)`` (default ``1 + 7 s``, the JAX scripts' ``jnp.roll``), so
    no two samples start on the same batch. One call warms up first."""
    fn(*batches[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    per_call = []
    for s in range(samples):
        shift = (1 + 7 * s) if roll is None else roll(s)
        shift %= len(batches)
        order = batches[-shift:] + batches[:-shift] if shift else list(batches)
        if dev.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for args in order:
                fn(*args)
            t1.record()
            t1.synchronize()
            per_call.append(t0.elapsed_time(t1) / 1e3 / len(order))
        else:
            t0 = time.perf_counter()
            for args in order:
                fn(*args)
            per_call.append((time.perf_counter() - t0) / len(order))
    return min(per_call), per_call
