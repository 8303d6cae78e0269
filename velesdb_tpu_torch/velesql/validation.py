"""Query validation against configured limits.

Counterpart of ``velesql/validation.rs`` (``QueryValidator``, limits, error
kinds — 638 LoC): structural checks happen at parse time; this layer enforces
the *resource* limits from ``LimitsConfig`` before execution so oversized
requests fail fast with a clear error instead of burning device time.
"""

from __future__ import annotations

import numpy as np

from velesdb_tpu_torch.utils.config import LimitsConfig
from velesdb_tpu_torch.velesql.ast import SelectStatement, SetOp

__all__ = ["ValidationError", "validate_query", "validate_vector"]


class ValidationError(ValueError):
    pass


MAX_FUSED_VECTORS = 16
MAX_SET_OP_DEPTH = 8


def validate_query(root, limits: LimitsConfig | None = None, _depth: int = 0) -> None:
    limits = limits or LimitsConfig()
    if isinstance(root, SetOp):
        if _depth >= MAX_SET_OP_DEPTH:
            raise ValidationError("set-operation chain too deep")
        validate_query(root.left, limits, _depth + 1)
        validate_query(root.right, limits, _depth + 1)
        return
    stmt: SelectStatement = root
    if stmt.limit is not None and stmt.limit > limits.max_k:
        raise ValidationError(
            f"LIMIT {stmt.limit} exceeds limits.max_k={limits.max_k}"
        )
    if stmt.offset and stmt.offset > limits.max_k * 100:
        raise ValidationError(f"OFFSET {stmt.offset} unreasonably large")
    if stmt.near is not None and len(stmt.near.vectors) > MAX_FUSED_VECTORS:
        raise ValidationError(
            f"NEAR_FUSED with {len(stmt.near.vectors)} vectors "
            f"(max {MAX_FUSED_VECTORS})"
        )
    if len(stmt.joins) > 8:
        raise ValidationError("too many JOIN clauses (max 8)")
    if len(stmt.group_by) > 16:
        raise ValidationError("too many GROUP BY fields (max 16)")
    if stmt.filter is not None:
        from velesdb_tpu_torch.velesql.parser import subquery_nodes

        if _depth >= MAX_SET_OP_DEPTH:
            raise ValidationError("subquery nesting too deep")
        for node in subquery_nodes(stmt.filter):
            validate_query(node["query"], limits, _depth + 1)


def validate_vector(vec, limits: LimitsConfig | None = None) -> np.ndarray:
    limits = limits or LimitsConfig()
    arr = np.asarray(vec, np.float32)
    if arr.ndim != 1:
        raise ValidationError(f"vector must be 1-D, got shape {arr.shape}")
    if arr.shape[0] > limits.max_dim:
        raise ValidationError(
            f"vector dim {arr.shape[0]} exceeds limits.max_dim={limits.max_dim}"
        )
    if not np.isfinite(arr).all():
        raise ValidationError("vector contains NaN/Inf")
    return arr
