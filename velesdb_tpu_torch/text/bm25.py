"""BM25 full-text scoring as a device postings-block scatter-add.

Counterpart of ``velesdb_tpu/text/bm25.py``. The per-(term, doc) BM25
contribution is precomputed at index time (k1 = 1.2, b = 0.75, IDF
``ln(1 + (N - df + 0.5)/(df + 0.5))``)::

    score(q, d) = sum_{t in q} qtf(t) * idf(t) * tf(t,d)*(k1+1) / (tf + k1*(1-b+b*len_d/avg_len))

so each term's postings flatten into fixed-size blocks of ``BLOCK``
(doc slot, contribution) pairs, built on the host exactly as the reference
builds them and kept as two tensors on the index's device. A query batch is:

1. host (:meth:`Bm25Index.prep_batch`): tokenize, look up each query's
   distinct terms' block ranges, pad to a rectangular ``[B, L]`` block-id
   matrix and its weights (term multiplicity), and record where each term's
   blocks begin;
2. device (:func:`bm25_score_blocks`): for each step j, gather the blocks of
   every query's j-th distinct term, weight them, scatter-add them into a
   dense ``[B, n_pad + 1]`` score matrix, then mask and select the top k
   with ties to the lowest slot (``first_topk``, ``lax.top_k``'s rule).

Adding one term at a time keeps the reference's summation order: its CPU
scatter adds a document's contributions in the query's term order. A term's
postings hold each document at most once and each query owns its row, so no
step updates one element twice and ``scatter_add_`` needs no atomic order;
the scores equal the reference's bit for bit on the CPU and on the card.
"""

from __future__ import annotations

import math
import threading
from collections import Counter, defaultdict

import numpy as np
import torch

from velesdb_tpu_torch.ops.bucket_kernel import first_topk
from velesdb_tpu_torch.ops.topk import DENSE_ELEMS, pad_mask
from velesdb_tpu_torch.text.tokenizer import extract_text, tokenize

__all__ = ["Bm25Index", "BLOCK", "bm25_score_blocks", "bm25_state_from_jax"]

BLOCK = 128  # postings per block

K1 = 1.2
B = 0.75


class Bm25Index:
    """Full-text index: host postings builder + device block scorer.

    Mutations mark the index dirty; ``refresh()`` re-flattens the postings
    into device blocks. Parity surface: ``add_document``,
    ``remove_document``, ``search``, ``search_batch``.
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._docs: dict[int, Counter] = {}  # slot -> term counts
        self._doc_len: dict[int, int] = {}
        # guards _docs/_doc_len: refresh() snapshots under it while writer
        # threads mutate
        self._mut = threading.Lock()
        # one refresh at a time: a caller that finds a build running waits
        # for it instead of scoring the blocks it replaces
        self._refresh_lock = threading.Lock()
        self._dirty = True
        # device state
        self._vocab: dict[str, int] = {}
        self._term_blocks: list[tuple[int, int]] = []  # term_id -> (start, count)
        self._idf: np.ndarray | None = None
        self._block_docs = None  # [NB, BLOCK] int32, -1 pad; last row the sentinel
        self._block_scores = None  # [NB, BLOCK] f32 (idf included)
        self.n_pad = 0

    # -- mutation (host) -----------------------------------------------------

    def add_document(self, slot: int, text: str) -> None:
        toks = tokenize(text)
        if not toks:
            self.remove_document(slot)
            return
        with self._mut:
            self._docs[slot] = Counter(toks)
            self._doc_len[slot] = len(toks)
            self._dirty = True

    def add_payload(self, slot: int, payload) -> None:
        self.add_document(slot, extract_text(payload))

    def remove_document(self, slot: int) -> None:
        with self._mut:
            if self._docs.pop(slot, None) is not None:
                self._doc_len.pop(slot, None)
                self._dirty = True

    def invalidate(self, _ids=None) -> None:
        self._dirty = True

    def __len__(self) -> int:
        return len(self._docs)

    @property
    def dirty(self) -> bool:
        return self._dirty

    # -- build (host -> device) ----------------------------------------------

    def refresh(self, n_slots: int) -> None:
        """Flatten postings into device blocks over ``n_slots`` doc slots."""
        with self._refresh_lock:
            if not self._dirty:
                return
            self.n_pad = 1 << max(7, (max(n_slots, 1) - 1).bit_length())
            with self._mut:
                # cleared before the build so a mutation during it re-dirties;
                # a failed build restores it
                self._dirty = False
                docs = dict(self._docs)
                doc_len = dict(self._doc_len)
            try:
                self._build_blocks(docs, doc_len)
            except BaseException:
                with self._mut:
                    self._dirty = True
                raise

    def _build_blocks(self, docs: dict, doc_len: dict) -> None:
        """The reference's host build, array for array: vocabulary sorted,
        postings in document insertion order."""
        n_docs = len(docs)
        if n_docs == 0:
            self._vocab = {}
            self._term_blocks = []
            self._block_docs = None
            return
        avg_len = sum(doc_len.values()) / n_docs

        postings: dict[str, list[tuple[int, float]]] = defaultdict(list)
        for slot, counts in docs.items():
            dl = doc_len[slot]
            norm = K1 * (1.0 - B + B * dl / avg_len)
            for term, tf in counts.items():
                postings[term].append((slot, tf * (K1 + 1.0) / (tf + norm)))

        vocab = {t: i for i, t in enumerate(sorted(postings))}
        idf = np.empty(len(vocab), np.float32)
        docs_blocks: list[np.ndarray] = []
        score_blocks: list[np.ndarray] = []
        term_blocks: list[tuple[int, int]] = []
        for term, tid in vocab.items():
            plist = postings[term]
            df = len(plist)
            idf[tid] = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
            start = len(docs_blocks)
            arr = np.asarray(plist, np.float64)
            d = arr[:, 0].astype(np.int32)
            s = (arr[:, 1] * idf[tid]).astype(np.float32)
            for off in range(0, len(d), BLOCK):
                dd = d[off : off + BLOCK]
                ss = s[off : off + BLOCK]
                pad = BLOCK - len(dd)
                docs_blocks.append(np.pad(dd, (0, pad), constant_values=-1))
                score_blocks.append(np.pad(ss, (0, pad)))
            term_blocks.append((start, len(docs_blocks) - start))
        self._vocab = vocab
        self._idf = idf
        self._term_blocks = term_blocks
        # +1 sentinel zero-block so padded block ids gather harmlessly
        docs_blocks.append(np.full(BLOCK, -1, np.int32))
        score_blocks.append(np.zeros(BLOCK, np.float32))
        self._block_docs = torch.from_numpy(np.stack(docs_blocks)).to(self.device)
        self._block_scores = torch.from_numpy(np.stack(score_blocks)).to(self.device)

    def load_state(self, state: dict) -> None:
        """Adopt blocks built elsewhere (:func:`bm25_state_from_jax`); the
        index then scores from them until a mutation dirties it."""
        self._block_docs = state["block_docs"]
        self._block_scores = state["block_scores"]
        self._vocab = dict(state["vocab"])
        self._term_blocks = [tuple(tb) for tb in state["term_blocks"]]
        self.n_pad = int(state["n_pad"])
        self._dirty = False

    # -- query ---------------------------------------------------------------

    def search_batch(self, queries: list[str], k: int, n_slots: int, mask=None):
        """Batched BM25 top-k. Returns numpy ``(scores [B, k], slots [B, k])``;
        empty slots are ``-1``. ``mask [>=n_slots] bool`` restricts results
        (the column filter pushed down)."""
        got = self.search_batch_dev(queries, k, n_slots, mask=mask)
        if got is None:
            b = len(queries)
            return np.zeros((b, k), np.float32), np.full((b, k), -1, np.int64)
        vals, slots = got
        return vals.cpu().numpy(), slots.cpu().numpy()

    def prep_batch(self, queries: list[str], n_slots: int):
        """Host half of a batched query: ``(block_ids [B, L], weights [B, L],
        term_starts [B, T + 1])`` numpy arrays, or ``None`` when no query term
        hits the vocabulary or the index is empty. ``block_ids`` and
        ``weights`` are the reference's (sentinel-padded to a power of two);
        row b's j-th distinct term owns the blocks ``term_starts[b, j]`` to
        ``term_starts[b, j + 1]``, and T is the most distinct terms of any
        query (shorter rows repeat their end)."""
        self.refresh(n_slots)
        if self._block_docs is None:
            return None
        sentinel = self._block_docs.shape[0] - 1
        terms: list[list[tuple[int, int, int]]] = []  # per query: (start, count, qtf)
        for q in queries:
            row = []
            for term, qtf in Counter(tokenize(q)).items():
                tid = self._vocab.get(term)
                if tid is not None:
                    row.append((*self._term_blocks[tid], qtf))
            terms.append(row)
        max_l = max((sum(c for _, c, _ in row) for row in terms), default=0)
        if max_l == 0:
            return None
        b = len(queries)
        l_pad = 1 << (max_l - 1).bit_length()
        bid = np.full((b, l_pad), sentinel, np.int32)
        wt = np.zeros((b, l_pad), np.float32)
        term_starts = np.zeros((b, max(len(row) for row in terms) + 1), np.int32)
        for i, row in enumerate(terms):
            pos = 0
            for j, (start, count, qtf) in enumerate(row):
                bid[i, pos : pos + count] = np.arange(start, start + count, dtype=np.int32)
                wt[i, pos : pos + count] = qtf
                pos += count
                term_starts[i, j + 1] = pos
            term_starts[i, len(row) + 1 :] = pos
        return bid, wt, term_starts

    def search_batch_dev(self, queries: list[str], k: int, n_slots: int, mask=None):
        """Batched BM25 top-k as device tensors ``(scores f32, slots int64)``
        (``slots == -1`` for empty), or ``None`` when no query term hits the
        vocabulary or the index is empty."""
        prep = self.prep_batch(queries, n_slots)
        if prep is None:
            return None
        return bm25_score_blocks(
            *prep, self._block_docs, self._block_scores,
            pad_mask(mask, self.n_pad, self.device), n_pad=self.n_pad, k=k,
        )

    def search(self, query: str, k: int, n_slots: int, mask=None):
        """Single query -> ``[(slot, score), ...]`` best-first."""
        vals, slots = self.search_batch([query], k, n_slots, mask=mask)
        return [
            (int(s), float(v)) for s, v in zip(slots[0], vals[0]) if s >= 0 and v > 0
        ]


def bm25_score_blocks(bid, wt, term_starts, block_docs, block_scores, mask, *, n_pad, k):
    """Score a prepared batch: gather each step's postings blocks, weight
    them, scatter-add into dense ``[B, n_pad + 1]`` scores (padding into the
    last column), mask, top-``k``. ``bid``, ``wt`` and ``term_starts`` are
    :meth:`Bm25Index.prep_batch`'s host arrays; the blocks and ``mask``
    (``[n_pad]`` bool or ``None``) lie on the device. Returns ``(scores [B,
    k] f32, slots [B, k] int64)``, slot ``-1`` where the score is 0."""
    device = block_docs.device
    b = bid.shape[0]
    sentinel = block_docs.shape[0] - 1
    counts = np.diff(term_starts, axis=1)
    ids_parts, wt_parts, steps = [], [], []
    width = 0
    for j in range(counts.shape[1]):
        lj = int(counts[:, j].max())
        if lj == 0:
            continue
        cols = np.minimum(term_starts[:, j : j + 1] + np.arange(lj), bid.shape[1] - 1)
        live = np.arange(lj)[None, :] < counts[:, j : j + 1]
        ids_parts.append(np.where(live, np.take_along_axis(bid, cols, 1), sentinel))
        wt_parts.append(np.where(live, np.take_along_axis(wt, cols, 1), np.float32(0.0)))
        steps.append((width, lj))
        width += lj
    ids_all = torch.from_numpy(np.concatenate(ids_parts, 1).astype(np.int64)).to(device)
    wt_all = torch.from_numpy(np.concatenate(wt_parts, 1).astype(np.float32)).to(device)
    k_eff = min(k, n_pad)
    rows = max(1, DENSE_ELEMS // n_pad)
    vals_out, idx_out = [], []
    for r0 in range(0, b, rows):
        ids, w = ids_all[r0 : r0 + rows], wt_all[r0 : r0 + rows]
        bs = ids.shape[0]
        dense = torch.zeros((bs, n_pad + 1), dtype=torch.float32, device=device)
        for off, lj in steps:
            step_ids = ids[:, off : off + lj]
            docs = block_docs[step_ids]  # [bs, lj, BLOCK]
            scores = block_scores[step_ids] * w[:, off : off + lj, None]
            hit = docs >= 0
            dense.scatter_add_(
                1, torch.where(hit, docs, n_pad).reshape(bs, -1).long(),
                torch.where(hit, scores, 0.0).reshape(bs, -1),
            )
        dense = dense[:, :n_pad]
        if mask is not None:
            dense = torch.where(mask[None, :], dense, 0.0)
        vals, idx = first_topk(dense, k_eff)
        vals_out.append(vals)
        idx_out.append(torch.where(vals > 0.0, idx, -1))
    vals, idx = torch.cat(vals_out), torch.cat(idx_out)
    if k_eff < k:
        vals = torch.cat([vals, vals.new_zeros(b, k - k_eff)], 1)
        idx = torch.cat([idx, idx.new_full((b, k - k_eff), -1)], 1)
    return vals, idx


def bm25_state_from_jax(arrays: dict, device) -> dict:
    """Turn a reference ``Bm25Index``'s state into this package's, for
    :meth:`Bm25Index.load_state`: ``arrays`` holds ``block_docs`` and
    ``block_scores`` (numpy copies of ``_block_docs`` / ``_block_scores``),
    ``vocab``, ``term_blocks`` and ``n_pad``. Both packages then score from
    identical blocks."""
    return {
        "block_docs": torch.from_numpy(np.array(arrays["block_docs"], np.int32)).to(device),
        "block_scores": torch.from_numpy(np.array(arrays["block_scores"], np.float32)).to(device),
        "vocab": dict(arrays["vocab"]),
        "term_blocks": [tuple(int(v) for v in tb) for tb in arrays["term_blocks"]],
        "n_pad": int(arrays["n_pad"]),
    }
