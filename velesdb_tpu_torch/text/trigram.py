"""Trigram index for LIKE / ILIKE — candidate masks for kernel pushdown.

Counterpart of the reference's pg_trgm-style index (``index/trigram/``,
``extract_trigrams_simd`` — SIMD trigram extraction feeding RoaringBitmaps).
Extraction stays on the host (strings never go to the device); the match
set comes back as a **dense boolean mask over doc slots**, which flows
straight into the vector and BM25 scorers as a predicate mask (SURVEY.md §7
step 4: pre-filter, not post-filter). A host-only copy of
``velesdb_tpu/text/trigram.py``.

Semantics: candidates = docs containing every trigram of the pattern's
literal runs (conjunction), then exact LIKE verification on the candidates —
same contract as the reference (index prunes, verify confirms).
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["TrigramIndex", "trigrams", "like_to_regex"]


def trigrams(text: str) -> set[str]:
    """pg_trgm-compatible trigrams: two leading / one trailing space pad per
    word (``index/trigram/`` extraction semantics)."""
    out: set[str] = set()
    for word in re.findall(r"[a-z0-9]+", text.lower()):
        padded = f"  {word} "
        for i in range(len(padded) - 2):
            out.add(padded[i : i + 3])
    return out


def like_to_regex(pattern: str, case_insensitive: bool) -> re.Pattern:
    """Compile a SQL LIKE pattern (``%``/``_`` wildcards, ``\\`` escape)."""
    rx = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            rx.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            rx.append(".*")
        elif c == "_":
            rx.append(".")
        else:
            rx.append(re.escape(c))
        i += 1
    flags = re.DOTALL | (re.IGNORECASE if case_insensitive else 0)
    return re.compile("^" + "".join(rx) + "$", flags)


def _literal_runs(pattern: str) -> list[str]:
    """Literal substrings between wildcards (trigram candidates source)."""
    runs, cur, i = [], [], 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            cur.append(pattern[i + 1])
            i += 2
            continue
        if c in "%_":
            if cur:
                runs.append("".join(cur))
                cur = []
        else:
            cur.append(c)
        i += 1
    if cur:
        runs.append("".join(cur))
    return runs


class TrigramIndex:
    """Trigram -> doc-slot postings with dense-mask query output."""

    def __init__(self):
        self._postings: dict[str, set[int]] = {}
        self._texts: dict[int, str] = {}  # slot -> raw text (verification)

    def add_document(self, slot: int, text: str) -> None:
        self.remove_document(slot)
        self._texts[slot] = text
        for tg in trigrams(text):
            self._postings.setdefault(tg, set()).add(slot)

    def remove_document(self, slot: int) -> None:
        old = self._texts.pop(slot, None)
        if old is not None:
            for tg in trigrams(old):
                s = self._postings.get(tg)
                if s is not None:
                    s.discard(slot)

    def __len__(self) -> int:
        return len(self._texts)

    def match_mask(
        self, pattern: str, n_slots: int, case_insensitive: bool = False
    ) -> np.ndarray:
        """``[n_slots] bool`` mask of docs matching ``LIKE pattern``.

        Trigram conjunction prunes candidates; regex verification confirms.
        Patterns with no >=3-char literal run fall back to a full verify scan
        (same degradation as the reference's trigram index).
        """
        runs = _literal_runs(pattern)
        tgs: set[str] = set()
        for run in runs:
            # use interior trigrams of the run's alphanumeric fragments only:
            # the index stores word-padded trigrams, so cross-word or
            # punctuation-adjacent trigrams of the raw run would never match
            for frag in re.findall(r"[a-z0-9]+", run.lower()):
                if len(frag) >= 3:
                    tgs.update(frag[i : i + 3] for i in range(len(frag) - 2))
        candidates: set[int] | None = None
        if tgs:
            for tg in tgs:
                posting = self._postings.get(tg, set())
                candidates = (
                    set(posting) if candidates is None else candidates & posting
                )
                if not candidates:
                    break
        if candidates is None:
            candidates = set(self._texts)  # no usable trigram: verify all
        rx = like_to_regex(pattern, case_insensitive)
        mask = np.zeros(n_slots, bool)
        for slot in candidates:
            if slot < n_slots and rx.match(self._texts[slot]):
                mask[slot] = True
        return mask
