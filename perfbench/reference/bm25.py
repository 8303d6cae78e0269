"""BM25 over payload texts, frozen to the program's semantics, in NumPy.

Frozen here so that a change of the program cannot move the yardstick:

- tokens: the lowercased text split into runs of ``[a-z0-9]`` (every other
  character separates), empties dropped;
- a document's text: the payload's one string value, its text (a row
  without one is no document);
- scoring: k1 = 1.2, b = 0.75, IDF ``ln(1 + (N - df + 0.5) / (df + 0.5))``
  over the N documents, a query term counted as often as it appears;
- ranking: score descending, ties to the lower row, rows scoring 0 left
  out, a filter mask applied before the ranking.

Everything is float64.
"""

from __future__ import annotations

import math
import re

import numpy as np

__all__ = ["K1", "B", "tokenize", "ranked", "Bm25"]

K1 = 1.2
B = 0.75
_TOKEN = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> list[str]:
    return _TOKEN.findall(text.lower())


def ranked(s: np.ndarray, k: int, mask=None):
    """``(scores [k], rows [k])``: the best ``k`` rows by their scores ``s``,
    best first, ties to the lower row, rows scoring 0 or outside ``mask``
    left out; short lists pad with score 0 and row -1."""
    if mask is not None:
        s = np.where(mask, s, 0.0)
    live = np.flatnonzero(s > 0.0)
    order = live[np.lexsort((live, -s[live]))][:k]
    vals = np.zeros(k, np.float64)
    rows = np.full(k, -1, np.int64)
    vals[: order.size] = s[order]
    rows[: order.size] = order
    return vals, rows


class Bm25:
    """Postings of ``texts`` (one a row; ``None`` or no tokens = no
    document), scored per query on demand."""

    def __init__(self, texts):
        vocab: dict[str, int] = {}
        doc_of, term_of = [], []
        lens = np.zeros(len(texts), np.int64)
        for row, text in enumerate(texts):
            toks = tokenize(text) if text else []
            lens[row] = len(toks)
            for t in toks:
                term_of.append(vocab.setdefault(t, len(vocab)))
                doc_of.append(row)
        self.vocab = vocab
        self.n_rows = len(texts)
        self.lens = lens
        self.n_docs = int(np.count_nonzero(lens))
        self.avg_len = float(lens.sum()) / max(self.n_docs, 1)
        # (term, row) pairs with their counts, grouped by term
        pairs = np.asarray(term_of, np.int64) * max(self.n_rows, 1) + np.asarray(doc_of, np.int64)
        uniq, tf = np.unique(pairs, return_counts=True)
        self._term = uniq // max(self.n_rows, 1)
        self._row = uniq % max(self.n_rows, 1)
        self._tf = tf.astype(np.float64)
        self._start = np.searchsorted(self._term, np.arange(len(vocab) + 1))

    def scores(self, query: str) -> np.ndarray:
        """float64 ``[n_rows]`` BM25 scores of one query."""
        out = np.zeros(self.n_rows, np.float64)
        counts: dict[int, int] = {}
        for t in tokenize(query):
            tid = self.vocab.get(t)
            if tid is not None:
                counts[tid] = counts.get(tid, 0) + 1
        for tid, qtf in counts.items():
            s, e = self._start[tid], self._start[tid + 1]
            rows, tf = self._row[s:e], self._tf[s:e]
            df = e - s
            idf = math.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))
            norm = K1 * (1.0 - B + B * self.lens[rows] / self.avg_len)
            out[rows] += qtf * idf * tf * (K1 + 1.0) / (tf + norm)
        return out

    def topk(self, query: str, k: int, mask=None):
        """:func:`ranked` over one query's scores."""
        return ranked(self.scores(query), k, mask)
