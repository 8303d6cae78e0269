"""Inputs of a run, made from its seed: rows, user ids, payload fields and
the query pool. A configuration names its data model (``data.model``), and
``perfbench/data/<model>.py`` makes them: ``make_dataset(cfg, seed,
device)`` and ``make_pool(cfg, traffic, seed, ds, device)``.

Every stream has a generator of its own, seeded from ``(seed, stream)``, so
that a change to one size leaves the other streams as they were. Rows and
queries are drawn on the device the run serves from; payloads are built
with vectorised code on the host, where the program takes them.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

import perfbench

__all__ = ["ID_BASE", "generator", "Dataset", "make_dataset", "QueryPool", "make_pool",
           "filter_mask"]

# user ids are a seeded permutation of ID_BASE .. ID_BASE + n - 1, so that a
# wrong slot-to-id map shows
ID_BASE = 1_000_000_000

_STREAMS = {"centers": 1, "rows": 2, "ids": 3, "payload": 4, "pool": 5, "order": 6}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of one seed (any
    whole number: the pair is hashed to 63 bits)."""
    h = hashlib.sha256(f"{int(seed)}/{_STREAMS[stream]}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h[:8], "little") & (2**63 - 1))
    return g


class Dataset:
    """The rows of one run: ``rows [n, d] f32`` on the device; ``ids [n]
    int64`` (numpy: row ``i`` is upserted as ``ids[i]``); ``fields``, the
    payload's fields by name (a list or a numpy array each, ``{}`` for no
    payload); ``aux``, what the data model keeps to draw its queries."""

    def __init__(self, rows, ids, fields=None, aux=None):
        self.rows = rows
        self.ids = ids
        self.fields = fields or {}
        self.aux = aux or {}

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    def payloads(self):
        """What the program is given: one dict a row, or ``None``."""
        if not self.fields:
            return None
        names = list(self.fields)
        cols = [v.tolist() if isinstance(v, np.ndarray) else v for v in self.fields.values()]
        return [dict(zip(names, vals)) for vals in zip(*cols)]


class QueryPool:
    """The held-out queries of one run: ``vectors [P, d]`` on the device,
    ``texts`` (a list, or ``None``) and the order the window sends them in
    (``order``: a permutation of the pool)."""

    def __init__(self, vectors, texts, order):
        self.vectors = vectors
        self.texts = texts
        self.order = order

    def batch(self, i: int, b: int) -> np.ndarray:
        """Pool rows of the window's ``i``-th call of batch ``b``."""
        p = self.order.shape[0]
        start = (i * b) % p
        idx = self.order[start : start + b]
        if idx.shape[0] < b:
            idx = np.concatenate([idx, self.order[: b - idx.shape[0]]])
        return idx


def make_ids(n: int, seed: int, device) -> np.ndarray:
    return (torch.randperm(n, generator=generator(seed, "ids", device), device=device)
            + ID_BASE).cpu().numpy()


def make_order(p: int, seed: int, device) -> np.ndarray:
    return torch.randperm(p, generator=generator(seed, "order", device), device=device).cpu().numpy()


def make_dataset(cfg: dict, seed: int, device) -> Dataset:
    return perfbench.load("data", cfg["data"]["model"]).make_dataset(cfg, seed, device)


def make_pool(cfg: dict, traffic: dict, seed: int, ds: Dataset, device) -> QueryPool:
    """``cfg["queries"]`` held-out queries, drawn by the data model."""
    return perfbench.load("data", cfg["data"]["model"]).make_pool(cfg, traffic, seed, ds, device)


_CMP = {"lt": np.less, "lte": np.less_equal, "gt": np.greater, "gte": np.greater_equal}


def filter_mask(filt: dict | None, ds: Dataset) -> np.ndarray | None:
    """``[n] bool`` rows that a traffic filter admits, from the generated
    payload fields (the benchmark's own reading of the filter)."""
    if filt is None:
        return None
    if filt["type"] not in _CMP:
        raise ValueError(f"the benchmark reads no filter of type {filt['type']!r}")
    return _CMP[filt["type"]](np.asarray(ds.fields[filt["field"]]), float(filt["value"]))
