"""The comparison that decides ``correct``: what the window's calls returned
against the plain reference, over every query answered.

Answers arrive as one record a call: the pool rows it sent (``qidx [b]``)
and the user ids and scores it got back (``ids [b, k]``, ``-1`` / NaN where
a row held fewer hits). The reference's answers are worked out from the
generated inputs alone, by the traffic's operation
(``perfbench/ops/<op>.py``: ``reference`` and ``numbers``).

Numbers compared for every operation (each beside its limit in the cell's
workload file):

- ``miss``: 1 - recall@k against the reference's top k (under the filter),
  over every query answered;
- ``filtered_out``: hits the filter excludes;
- ``malformed``: rows of the wrong length, with an id no row has, or with
  an id twice;

and those the operation adds (``perfbench/ops/<op>.py``).
"""

from __future__ import annotations

from itertools import chain
from operator import itemgetter

import numpy as np
import torch

import perfbench
from perfbench.data import ID_BASE

__all__ = ["Answers", "Reference", "reference", "control_answers", "in_lists", "Hits",
           "judge", "verdict"]

_ID, _SCORE = itemgetter("id"), itemgetter("score")


class Answers:
    """The window's answers, stacked: ``qidx [M]``, ``ids [M, k]``,
    ``scores [M, k]``, ``lens [M]`` (hits a row held)."""

    def __init__(self, k: int):
        self.k = k
        self._parts: list[tuple] = []

    def add(self, qidx: np.ndarray, results) -> None:
        """Record one call's hydrated results (a list of hit lists)."""
        k = self.k
        lens = np.fromiter(map(len, results), np.int64, len(results))
        total = int(lens.sum())
        ids = np.fromiter(map(_ID, chain.from_iterable(results)), np.int64, total)
        sc = np.fromiter(map(_SCORE, chain.from_iterable(results)), np.float64, total)
        if lens.size and lens.min() == lens.max() == k:
            ids, sc = ids.reshape(-1, k), sc.reshape(-1, k)
        else:
            out_i = np.full((len(results), k), -1, np.int64)
            out_s = np.full((len(results), k), np.nan)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            for r, (s, n) in enumerate(zip(starts, lens)):
                n = min(n, k)
                out_i[r, :n], out_s[r, :n] = ids[s : s + n], sc[s : s + n]
            ids, sc = out_i, out_s
        self._parts.append((np.asarray(qidx, np.int64), ids, sc, lens))

    def add_arrays(self, qidx, ids, scores) -> None:
        """Record answers given as arrays (the control's)."""
        ids = np.asarray(ids, np.int64)
        lens = (ids >= 0).sum(1)
        self._parts.append((np.asarray(qidx, np.int64), ids, np.asarray(scores, np.float64), lens))

    def stacked(self):
        if not self._parts:
            k = self.k
            return (np.zeros(0, np.int64), np.zeros((0, k), np.int64), np.zeros((0, k)),
                    np.zeros(0, np.int64))
        return tuple(np.concatenate(p) for p in zip(*self._parts))

    @property
    def count(self) -> int:
        return sum(p[0].shape[0] for p in self._parts)


class Reference:
    """The reference's answers over the whole pool (rows, not ids)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def reference(cfg, traffic, ds, pool, mask, dtype=torch.float64) -> Reference:
    """The reference's answers to every pool query, in ``dtype`` (float64;
    bfloat16 for the control), by the traffic's operation."""
    return perfbench.load("ops", traffic["op"]).reference(cfg, traffic, ds, pool, mask, dtype)


def control_answers(ds, pool, ctrl: Reference, k: int) -> Answers:
    """The control's answers to one pass over the pool, as the program's
    would be recorded (user ids, public scores)."""
    ans = Answers(k)
    rows = ctrl.rows
    ids = np.where(rows >= 0, ds.ids[np.maximum(rows, 0)], -1)
    ans.add_arrays(np.arange(rows.shape[0]), ids, ctrl.scores)
    return ans


def in_lists(hit_rows, lists, chunk=65536):
    """``[M, k]`` bool and ``[M, k]`` rank: where each hit row stands in
    its query's reference list (``lists [M, F]``), -1 where absent."""
    rank = np.full(hit_rows.shape, -1, np.int64)
    for s in range(0, hit_rows.shape[0], chunk):
        h = torch.from_numpy(hit_rows[s : s + chunk])
        lst = torch.from_numpy(lists[s : s + chunk])
        eq = (h[:, :, None] == lst[:, None, :]) & (h[:, :, None] >= 0)
        found = eq.any(2)
        pos = eq.to(torch.int8).argmax(2)
        rank[s : s + chunk] = torch.where(found, pos, -1).numpy()
    return rank >= 0, rank


class Hits:
    """The answers as the operation's numbers see them: ``qidx [M]``,
    ``ids``, ``scores``, ``rows`` (the row each id was upserted from, -1
    where none) and ``known`` (``[M, k]`` bool: the id is a row's)."""

    def __init__(self, qidx, ids, scores, rows, known):
        self.qidx, self.ids, self.scores, self.rows, self.known = qidx, ids, scores, rows, known


def judge(cfg, traffic, ds, pool, mask, ref: Reference, answers: Answers) -> dict:
    """The numbers compared, and the recall over every answered query."""
    k = answers.k
    qidx, ids, scores, lens = answers.stacked()
    n = ds.n
    # user id -> row (the ids are a permutation of ID_BASE .. ID_BASE + n - 1)
    row_of = np.empty(n, np.int64)
    row_of[ds.ids - ID_BASE] = np.arange(n)
    present = ids >= 0
    known = present & (ids >= ID_BASE) & (ids < ID_BASE + n)
    rows = np.where(known, row_of[np.clip(ids - ID_BASE, 0, n - 1)], -1)
    admitted = n if mask is None else int(mask.sum())
    want = min(k, admitted)
    srt = np.sort(np.where(present, ids, -1 - np.arange(k)[None, :]), axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    bad_row = (lens != want) | (present & ~known).any(1) | dup
    out = {"malformed": int(bad_row.sum())}
    out["filtered_out"] = 0 if mask is None else int((known & ~mask[np.maximum(rows, 0)]).sum())

    ref_rows = ref.rows[qidx]
    inter = in_lists(rows, ref_rows)[0].sum()
    denom = int((ref_rows >= 0).sum())
    recall = float(inter) / max(denom, 1)
    out["miss"] = 1.0 - recall
    hits = Hits(qidx, ids, scores, rows, known)
    out.update(perfbench.load("ops", traffic["op"]).numbers(cfg, traffic, ds, pool, ref, hits))
    out["_recall"] = recall
    out["_answered"] = qidx.shape[0]
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[tuple[str, float, float, bool]]]:
    """``correct`` and one ``(name, value, limit, ok)`` per number compared:
    a number passes at or under its limit; a number with no limit fails."""
    rows = []
    for name, value in numbers.items():
        if name.startswith("_"):
            continue
        limit = limits.get(name)
        ok = limit is not None and value <= limit
        rows.append((name, value, limit, ok))
    return all(r[3] for r in rows) and bool(rows), rows
