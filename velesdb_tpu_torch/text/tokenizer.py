"""Tokenization for full-text indexing.

Parity with the reference's BM25 tokenizer (``index/bm25.rs:114`` —
lowercase, split on non-alphanumeric, drop empties). Kept host-side: token
streams are string work; only scoring runs on device.
"""

from __future__ import annotations

import re

__all__ = ["tokenize", "extract_text"]

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> list[str]:
    """Lowercase alphanumeric tokens, reference semantics (``bm25.rs:114``)."""
    return _TOKEN_RE.findall(text.lower())


def extract_text(payload) -> str:
    """Concatenate every string value in a payload (nested dicts/lists
    included) — the reference's index-from-payload-strings text extraction
    (``collection/types.rs:169``)."""
    parts: list[str] = []
    _walk(payload, parts)
    return " ".join(parts)


def _walk(value, out: list[str]) -> None:
    if isinstance(value, str):
        out.append(value)
    elif isinstance(value, dict):
        for v in value.values():
            _walk(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _walk(v, out)
