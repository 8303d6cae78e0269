"""ColumnStore: typed columns over collection slots with vectorized filtering.

Counterpart of ``velesdb-core/src/column_store/`` (``ColumnStore``
``mod.rs:42``, ``TypedColumn`` ``types.rs:73``, bitmap filters
``filter.rs:16-274``): typed Int/Float/String/Bool columns with string
interning, null bitmaps, TTL row expiry, and predicate evaluation.

Copied from ``velesdb_tpu/column/store.py``. Instead of RoaringBitmap set
algebra, predicates evaluate to dense boolean masks over the slot axis
(vectorized NumPy on host) which are pushed *into* the masked search —
pre-filtering, where the reference post-filters with 4x over-fetch
(``search/vector.rs:182-183``).

Columns are slot-aligned with the collection's vector store, auto-ingested
from scalar payload fields (nested dicts flatten to dot paths).
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np

from velesdb_tpu_torch.column.filter import (
    FilterError,
    like_to_regex,
    matches,
    normalize_filter,
)

__all__ = ["ColumnStore", "StringTable", "Column"]

_GROW = 1024

_CMP_UFUNC = {
    "eq": np.equal,
    "neq": np.not_equal,
    "gt": np.greater,
    "gte": np.greater_equal,
    "lt": np.less,
    "lte": np.less_equal,
}


class StringTable:
    """String interning: value <-> int32 code (``column_store`` StringTable)."""

    def __init__(self):
        self.to_code: dict[str, int] = {}
        self.values: list[str] = []

    def intern(self, s: str) -> int:
        code = self.to_code.get(s)
        if code is None:
            code = len(self.values)
            self.to_code[s] = code
            self.values.append(s)
        return code

    def lookup(self, code: int) -> str | None:
        if 0 <= code < len(self.values):
            return self.values[code]
        return None

    def __len__(self):
        return len(self.values)


class Column:
    """One typed column: numpy values + null mask, grown on demand."""

    __slots__ = ("kind", "data", "valid")

    def __init__(self, kind: str, capacity: int):
        self.kind = kind  # "int" | "float" | "str" | "bool"
        dtype = {"int": np.int64, "float": np.float64, "str": np.int32, "bool": np.bool_}[
            kind
        ]
        self.data = np.zeros(capacity, dtype)
        self.valid = np.zeros(capacity, np.bool_)

    def grow(self, capacity: int) -> None:
        if capacity <= len(self.data):
            return
        data = np.zeros(capacity, self.data.dtype)
        valid = np.zeros(capacity, np.bool_)
        data[: len(self.data)] = self.data
        valid[: len(self.valid)] = self.valid
        self.data, self.valid = data, valid


def _classify(v):
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float"
    if isinstance(v, str):
        return "str"
    return None


def _flatten(payload: dict, prefix: str = "", out=None) -> dict:
    out = {} if out is None else out
    for k, v in payload.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(v, key + ".", out)
        else:
            out[key] = v
    return out


class ColumnStore:
    """Slot-aligned typed columns with mask-producing predicate evaluation."""

    def __init__(self, mask_cache_size: int = 64):
        self.columns: dict[str, Column] = {}
        self.strings = StringTable()
        self.capacity = 0
        self._expiry: dict[int, float] = {}  # slot -> unix expiry (TTL rows)
        self._mask_cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._mask_cache_size = mask_cache_size
        self._version = 0
        # virtual "id" column: (slot_ids, valid) provider wired by the
        # Collection (vectors.occupancy) so `WHERE id ...` predicates — and
        # the executor's correlated-subquery `id IN [...]` rewrites — lower
        # to masks without materializing an id column. An explicit payload
        # column named "id" shadows it.
        self._id_source = None

    # -- ingest ------------------------------------------------------------

    def _ensure_capacity(self, slot: int) -> None:
        if slot >= self.capacity:
            self.capacity = max(slot + 1, self.capacity + _GROW)
            for col in self.columns.values():
                col.grow(self.capacity)

    def upsert_row(self, slot: int, payload: dict | None, ttl: float | None = None) -> None:
        """Ingest scalar payload fields at ``slot`` (nested dicts flatten)."""
        self._ensure_capacity(slot)
        self._version += 1
        self._mask_cache.clear()
        for col in self.columns.values():
            col.valid[slot] = False
        if not payload:
            return
        for key, v in _flatten(payload).items():
            kind = _classify(v)
            if kind is None:
                continue  # lists/None stay payload-only (host fallback)
            col = self.columns.get(key)
            if col is None:
                col = Column(kind, self.capacity)
                self.columns[key] = col
            elif col.kind != kind:
                # type conflict: int widens to float, else skip (ref coerces
                # similarly in TypedColumn::insert)
                if {col.kind, kind} == {"int", "float"}:
                    if col.kind == "int":
                        self._widen_to_float(key)
                        col = self.columns[key]
                    v = float(v)
                    kind = "float"
                else:
                    continue
            col.data[slot] = self.strings.intern(v) if kind == "str" else v
            col.valid[slot] = True
        if ttl is not None:
            self._expiry[slot] = time.time() + ttl

    def _widen_to_float(self, key: str) -> None:
        old = self.columns[key]
        new = Column("float", len(old.data))
        new.data = old.data.astype(np.float64)
        new.valid = old.valid
        self.columns[key] = new

    def remove_row(self, slot: int) -> None:
        self._version += 1
        self._mask_cache.clear()
        if slot < self.capacity:
            for col in self.columns.values():
                col.valid[slot] = False
        self._expiry.pop(slot, None)

    def invalidate(self, _ids=None) -> None:
        self._mask_cache.clear()

    # -- TTL / vacuum (AutoVacuumConfig analog, types.rs:258) ---------------

    def expired_slots(self, now: float | None = None) -> list[int]:
        now = time.time() if now is None else now
        return [s for s, t in self._expiry.items() if t <= now]

    def vacuum(self, now: float | None = None) -> int:
        dead = self.expired_slots(now)
        for s in dead:
            self.remove_row(s)
        return len(dead)

    # -- predicate -> mask ---------------------------------------------------

    def mask_for_filter(self, filt: dict, n_rows: int) -> np.ndarray:
        """Vectorized condition tree -> bool mask over ``n_rows`` slots."""
        cond = normalize_filter(filt)
        # repr is ~4x cheaper than canonical json here; a key-order mismatch
        # between equal trees only costs a redundant miss, never a wrong hit
        key = f"{cond!r}#{n_rows}#{self._version}"
        cached = self._mask_cache.get(key)
        if cached is not None:
            self._mask_cache.move_to_end(key)
            return cached
        mask = self._eval(cond, n_rows)
        self._mask_cache[key] = mask
        if len(self._mask_cache) > self._mask_cache_size:
            self._mask_cache.popitem(last=False)
        return mask

    def _col(self, field: str, n: int) -> Column | None:
        col = self.columns.get(field)
        if col is not None:
            col.grow(max(n, self.capacity))
        return col

    def _eval(self, cond: dict, n: int) -> np.ndarray:
        # INVARIANT: every branch returns a freshly-allocated array the
        # caller owns — and/or fold in-place into the first child's result
        t = cond["type"]
        if t == "and":
            kids = cond.get("conditions", [])
            if not kids:
                return np.ones(n, bool)
            out = self._eval(kids[0], n)
            for c in kids[1:]:
                out &= self._eval(c, n)
            return out
        if t == "or":
            kids = cond.get("conditions", [])
            if not kids:
                return np.zeros(n, bool)
            out = self._eval(kids[0], n)
            for c in kids[1:]:
                out |= self._eval(c, n)
            return out
        if t == "not":
            out = self._eval(cond["condition"], n)
            np.logical_not(out, out=out)
            return out

        if t == "field_cmp":
            return self._field_cmp_mask(cond, n)

        field = cond["field"]
        col = self._col(field, n)
        if col is None:
            if field == "id" and self._id_source is not None:
                return self._id_mask(t, cond, n)
            # unknown column: nothing matches except null checks
            return np.full(n, t == "is_null", bool)
        data, valid = col.data[:n], col.valid[:n]
        if t == "is_null":
            return ~valid
        if t == "is_not_null":
            return valid.copy()
        if t in ("like", "ilike"):
            return self._string_pred(
                col, n, like_to_regex(cond["pattern"], t == "ilike").match
            )
        if t == "contains":
            needle = cond.get("value", "")
            return self._string_pred(col, n, lambda s: needle in s)
        if t == "in":
            vals = cond["values"]
            out = np.zeros(n, bool)
            for v in vals:
                out |= self._scalar_cmp(col, n, "eq", v)
            return out
        return self._scalar_cmp(col, n, t, cond.get("value"))

    def set_id_source(self, fn) -> None:
        """Wire the virtual "id" column provider: ``fn() -> (ids, valid)``."""
        self._id_source = fn

    def _id_mask(self, t: str, cond: dict, n: int) -> np.ndarray:
        """Predicates on the virtual row-id column. Stale-cache safety: the
        mask cache keys on the column version, which every slot (re)use bumps
        via upsert_row; deletions without a column touch are masked out by
        the occupancy/valid AND every consumer already applies."""
        ids_full, valid_full = self._id_source()
        m = min(n, len(ids_full))
        data = np.full(n, -1, np.int64)
        vld = np.zeros(n, bool)
        data[:m] = ids_full[:m]
        vld[:m] = valid_full[:m]
        if t == "is_null":
            return ~vld
        if t == "is_not_null":
            return vld
        if t in ("like", "ilike", "contains"):
            return np.zeros(n, bool)
        if t == "in":
            vals = [int(v) for v in cond["values"]
                    if isinstance(v, (int, np.integer))
                    or (isinstance(v, float) and v.is_integer())]
            if not vals:
                return np.zeros(n, bool)
            out = np.isin(data, np.asarray(vals, np.int64))
            out &= vld
            return out
        try:
            value = int(cond.get("value"))
        except (TypeError, ValueError):
            return np.zeros(n, bool) if t != "neq" else vld
        ufunc = _CMP_UFUNC.get(t)
        if ufunc is None:
            raise FilterError(f"bad id predicate {t}")
        out = ufunc(data, value)
        out &= vld
        return out

    def _field_cmp_mask(self, cond: dict, n: int) -> np.ndarray:
        """Column-to-column comparison (correlated-subquery residue and the
        plain ``WHERE a < b`` case). String columns share one interning
        table, so code equality IS string equality; ordered string compare
        and cross-kind compares conservatively match nothing."""
        col_l = self._col(cond["field"], n)
        col_r = self._col(cond["rhs_field"], n)
        if col_l is None or col_r is None:
            return np.zeros(n, bool)
        op = cond.get("op", "eq")
        dl, vl = col_l.data[:n], col_l.valid[:n]
        dr, vr = col_r.data[:n], col_r.valid[:n]
        if col_l.kind == "str" or col_r.kind == "str":
            if col_l.kind != col_r.kind or op not in ("eq", "neq"):
                return np.zeros(n, bool)
        elif col_l.kind == "bool" or col_r.kind == "bool":
            if col_l.kind != col_r.kind or op not in ("eq", "neq"):
                return np.zeros(n, bool)
        ufunc = _CMP_UFUNC.get(op)
        if ufunc is None:
            raise FilterError(f"bad field_cmp op {op}")
        out = ufunc(dl, dr)
        out &= vl
        out &= vr
        return out

    def _scalar_cmp(self, col: Column, n: int, op: str, value) -> np.ndarray:
        data, valid = col.data[:n], col.valid[:n]
        if col.kind == "str":
            if not isinstance(value, str):
                return np.zeros(n, bool) if op != "neq" else valid.copy()
            code = self.strings.to_code.get(value)
            if code is None:
                return np.zeros(n, bool) if op != "neq" else valid.copy()
            if op == "eq":
                return valid & (data == code)
            if op == "neq":
                return valid & (data != code)
            # ordered comparison on strings: evaluate per distinct value
            ops = {
                "gt": lambda s: s > value,
                "gte": lambda s: s >= value,
                "lt": lambda s: s < value,
                "lte": lambda s: s <= value,
            }
            return self._string_pred(col, n, ops[op])
        if col.kind == "bool" and not isinstance(value, bool):
            return np.zeros(n, bool)
        try:
            value = (
                bool(value)
                if col.kind == "bool"
                else float(value) if col.kind == "float" else int(value)
            )
        except (TypeError, ValueError):
            return np.zeros(n, bool) if op != "neq" else valid.copy()
        ufunc = _CMP_UFUNC.get(op)
        if ufunc is None:
            raise FilterError(f"bad scalar op {op}")
        out = ufunc(data, value)  # fresh array; fold validity in-place
        out &= valid
        return out

    def _string_pred(self, col: Column, n: int, pred) -> np.ndarray:
        """Apply a string predicate once per *distinct* interned value, then
        broadcast through codes — the trigram-index trick done densely."""
        if col.kind != "str":
            return np.zeros(n, bool)
        codes_used = np.unique(col.data[:n][col.valid[:n]])
        ok = np.zeros(len(self.strings) + 1, bool)
        for c in codes_used:
            s = self.strings.lookup(int(c))
            if s is not None and pred(s):
                ok[c] = True
        return col.valid[:n] & ok[np.minimum(col.data[:n], len(self.strings))]

    # -- host fallback -------------------------------------------------------

    @staticmethod
    def payload_matches(payload, filt: dict) -> bool:
        return matches(payload, normalize_filter(filt))
