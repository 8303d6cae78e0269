"""Storage modes of a collection.

Counterpart of ``StorageMode`` in ``velesdb_tpu/ops/quantization.py``
(``quantization.rs:20``). Only ``FULL`` is served by this package so far; the
SQ8/binary quantizers and the half-precision modes are still to be ported
(ROADMAP.md).
"""

from __future__ import annotations

import enum

__all__ = ["StorageMode"]


class StorageMode(str, enum.Enum):
    FULL = "full"
    SQ8 = "sq8"
    BINARY = "binary"
    F16 = "f16"
    BF16 = "bf16"

    @classmethod
    def parse(cls, v) -> "StorageMode":
        return v if isinstance(v, cls) else cls(str(v).strip().lower())
