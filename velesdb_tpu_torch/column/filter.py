"""Filter DSL: serde-tagged condition tree, evaluated as host payload matching
or compiled to vectorized column masks.

Parity with ``velesdb-core/src/filter/mod.rs:32-160``: conditions are tagged
dicts ``{"type": "eq", "field": ..., "value": ...}`` with
eq/neq/gt/gte/lt/lte/in/contains/is_null/is_not_null/and/or/not/like/ilike,
dot-notation nested fields, wrapped in ``{"condition": ...}`` or given bare.

Two evaluation paths (the reference has the same split between
``filter/matching.rs`` per-payload checks and ``column_store/filter.rs``
bitmap filters):

- :func:`matches` — one payload dict (used by query post-checks)
- :class:`~velesdb_tpu_torch.column.store.ColumnStore` ``mask_for_filter`` —
  vectorized over typed columns, producing the boolean mask pushed into the
  distance kernel (replaces the reference's 4x over-fetch post-filter,
  ``search/vector.rs:182``).
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["normalize_filter", "matches", "like_to_regex", "FilterError"]


class FilterError(ValueError):
    pass


_VALID_OPS = {
    "eq",
    "neq",
    "gt",
    "gte",
    "lt",
    "lte",
    "in",
    "contains",
    "is_null",
    "is_not_null",
    "and",
    "or",
    "not",
    "like",
    "ilike",
    "field_cmp",
}


def normalize_filter(filt: dict) -> dict:
    """Unwrap ``{"condition": ...}`` and validate the condition tree."""
    if not isinstance(filt, dict):
        raise FilterError(f"filter must be a dict, got {type(filt).__name__}")
    # unwrap the Filter{condition} envelope — but not a bare NOT node, which
    # also has a "condition" key plus its "type" tag
    cond = filt["condition"] if ("condition" in filt and "type" not in filt) else filt
    _validate(cond)
    return cond


def _validate(cond: dict) -> None:
    if not isinstance(cond, dict) or "type" not in cond:
        raise FilterError(f"condition must have a 'type': {cond!r}")
    t = cond["type"]
    if t not in _VALID_OPS:
        raise FilterError(f"unknown condition type: {t!r}")
    if t in ("and", "or"):
        for c in cond.get("conditions", []):
            _validate(c)
    elif t == "not":
        _validate(cond.get("condition", {}))
    elif t in ("like", "ilike"):
        if "field" not in cond or "pattern" not in cond:
            raise FilterError(f"{t} requires field and pattern")
    elif t == "in":
        if "field" not in cond or "values" not in cond:
            raise FilterError("in requires field and values")
    elif t in ("is_null", "is_not_null"):
        if "field" not in cond:
            raise FilterError(f"{t} requires field")
    elif t == "field_cmp":
        if "field" not in cond or "rhs_field" not in cond:
            raise FilterError("field_cmp requires field and rhs_field")
    else:
        if "field" not in cond:
            raise FilterError(f"{t} requires field")


def get_path(payload: Any, path: str):
    """Dot-notation nested lookup (``velesql/json_path.rs:58`` analog)."""
    cur = payload
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur


def like_to_regex(pattern: str, case_insensitive: bool = False) -> re.Pattern:
    r"""SQL LIKE -> compiled regex (``%``/``_`` wildcards, ``\%``/``\_`` literals)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern) and pattern[i + 1] in "%_":
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    flags = re.IGNORECASE | re.DOTALL if case_insensitive else re.DOTALL
    return re.compile("^" + "".join(out) + "$", flags)


def _cmp(a, b, op) -> bool:
    if a is None:
        return False
    try:
        if op == "gt":
            return a > b
        if op == "gte":
            return a >= b
        if op == "lt":
            return a < b
        if op == "lte":
            return a <= b
    except TypeError:
        return False
    return False


def matches(payload: Any, cond: dict) -> bool:
    """Evaluate a (normalized) condition against one payload dict."""
    t = cond["type"]
    if t == "and":
        return all(matches(payload, c) for c in cond.get("conditions", []))
    if t == "or":
        return any(matches(payload, c) for c in cond.get("conditions", []))
    if t == "not":
        return not matches(payload, cond["condition"])
    v = get_path(payload, cond["field"]) if payload is not None else None
    if t == "field_cmp":
        rv = get_path(payload, cond["rhs_field"]) if payload is not None else None
        op = cond.get("op", "eq")
        if rv is None or v is None:
            return False
        if op == "eq":
            return v == rv
        if op == "neq":
            return v != rv
        return _cmp(v, rv, op)
    if t == "eq":
        return v == cond.get("value")
    if t == "neq":
        return v != cond.get("value")
    if t in ("gt", "gte", "lt", "lte"):
        return _cmp(v, cond.get("value"), t)
    if t == "in":
        if isinstance(v, list):
            return any(x in cond["values"] for x in v)
        return v in cond["values"]
    if t == "contains":
        if isinstance(v, str):
            return cond.get("value", "") in v
        if isinstance(v, list):
            return cond.get("value") in v
        return False
    if t == "is_null":
        return v is None
    if t == "is_not_null":
        return v is not None
    if t == "like":
        return isinstance(v, str) and bool(like_to_regex(cond["pattern"]).match(v))
    if t == "ilike":
        return isinstance(v, str) and bool(
            like_to_regex(cond["pattern"], case_insensitive=True).match(v)
        )
    raise FilterError(f"unknown condition type {t!r}")
