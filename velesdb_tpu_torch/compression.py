"""Dictionary compression for payload snapshots.

Counterpart of ``velesdb-core/src/compression/`` (payload dictionary
compression, 176 LoC). Payloads in one collection share structure (same JSON
keys, repeated string values), so a zlib preset dictionary trained on sample
payloads compresses small records far better than plain deflate — the same
shape as the reference's dictionary coder.
"""

from __future__ import annotations

import json
import zlib
from collections import Counter

__all__ = ["train_dictionary", "compress", "decompress", "DICT_MAX"]

DICT_MAX = 16 * 1024  # zlib preset dictionary budget


def train_dictionary(samples: list[bytes], max_size: int = DICT_MAX) -> bytes:
    """Build a preset dictionary from sample blobs: most frequent substrings
    last (zlib favors the dictionary tail for matches)."""
    if not samples:
        return b""
    grams: Counter[bytes] = Counter()
    for blob in samples[:256]:
        for n in (8, 16, 32):
            for i in range(0, max(len(blob) - n, 0), n // 2):
                grams[blob[i : i + n]] += 1
    # frequency-weighted, deduped by containment is overkill — concatenate
    # the most common grams until the budget fills, least common first so
    # the most valuable bytes land at the dictionary tail
    chosen: list[bytes] = []
    size = 0
    for gram, count in grams.most_common():
        if count < 2:
            break
        if size + len(gram) > max_size:
            break
        chosen.append(gram)
        size += len(gram)
    chosen.reverse()
    return b"".join(chosen)


def compress(blob: bytes, zdict: bytes = b"", level: int = 6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY, zdict) \
        if zdict else zlib.compressobj(level)
    return c.compress(blob) + c.flush()


def decompress(blob: bytes, zdict: bytes = b"") -> bytes:
    d = zlib.decompressobj(zdict=zdict) if zdict else zlib.decompressobj()
    return d.decompress(blob) + d.flush()
