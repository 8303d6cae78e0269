"""VelesQL AST nodes.

Counterpart of ``velesdb-core/src/velesql/ast/`` (``Query`` ``ast/mod.rs:37``,
``SelectStatement`` ``ast/select.rs:26``, ``Condition`` ``ast/condition.rs:13``).
Python dataclasses instead of Rust enums; conditions lower to the filter DSL
(tagged dicts) so the executor reuses the ColumnStore mask compiler directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = [
    "Query",
    "SelectStatement",
    "SetOp",
    "NearClause",
    "SimilarityCond",
    "TextMatch",
    "OrderBy",
    "Aggregate",
    "SelectItem",
    "WithOptions",
    "FusionSpec",
    "JoinClause",
]


@dataclasses.dataclass
class NearClause:
    """``vector NEAR $v`` / ``NEAR [..]`` (+ ``NEAR_FUSED [...] USING FUSION``)."""

    field: str
    vectors: list[Any]  # params ("$name") or literal number lists
    fused: bool = False
    fusion: Optional["FusionSpec"] = None


@dataclasses.dataclass
class FusionSpec:
    """``USING FUSION rrf(k=60) | weighted(0.7, 0.3) | average | maximum``."""

    strategy: str
    rrf_k: int = 60
    weights: Optional[list[float]] = None


@dataclasses.dataclass
class SimilarityCond:
    """``similarity(field, $v) >= 0.8`` — threshold similarity predicate."""

    field: str
    vector: Any
    op: str  # gt/gte/lt/lte
    threshold: float
    negated: bool = False


@dataclasses.dataclass
class TextMatch:
    """``field MATCH 'query'`` — BM25 text predicate."""

    field: str  # "*" = any text field (we index payload-wide, like reference)
    query: Any  # str or "$param"


@dataclasses.dataclass
class Aggregate:
    """COUNT/SUM/AVG/MIN/MAX(field|*)."""

    func: str
    field: Optional[str]  # None = *
    alias: Optional[str] = None

    @property
    def default_name(self) -> str:
        return f"{self.func.lower()}({self.field or '*'})"


@dataclasses.dataclass
class SelectItem:
    """Projection item: field path, aggregate, or similarity() expr."""

    expr: Any  # str field | Aggregate | ("similarity", field, vec)
    alias: Optional[str] = None


@dataclasses.dataclass
class OrderBy:
    expr: Any  # str field | ("similarity", field, vec) | Aggregate
    desc: bool = False


@dataclasses.dataclass
class WithOptions:
    """``WITH (ef_search=.., quality='balanced')`` per-query overrides
    (``grammar.pest:117-120``)."""

    ef_search: Optional[int] = None
    quality: Optional[str] = None


@dataclasses.dataclass
class JoinClause:
    """``[INNER|LEFT|RIGHT|FULL] JOIN coll [AS a] ON l.f = r.f | USING (f)``."""

    kind: str  # inner | left | right | full
    collection: str
    alias: str
    left_field: str  # possibly alias-qualified
    right_field: str


@dataclasses.dataclass
class SelectStatement:
    columns: list[SelectItem]
    distinct: bool
    collection: str
    alias: Optional[str] = None
    joins: list["JoinClause"] = dataclasses.field(default_factory=list)
    near: Optional[NearClause] = None
    similarity: list[SimilarityCond] = dataclasses.field(default_factory=list)
    text_match: Optional[TextMatch] = None
    filter: Optional[dict] = None  # lowered filter-DSL condition tree
    where_mode: str = "and"  # "and" | "or": how similarity/text join filters
    group_by: list[str] = dataclasses.field(default_factory=list)
    having: Optional[dict] = None  # {"agg": Aggregate, "op": str, "value": num}
    order_by: list[OrderBy] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    with_options: WithOptions = dataclasses.field(default_factory=WithOptions)


@dataclasses.dataclass
class SetOp:
    """UNION [ALL] / INTERSECT / EXCEPT chain."""

    op: str  # union | union_all | intersect | except
    left: Any  # SelectStatement | SetOp
    right: Any


@dataclasses.dataclass
class Query:
    root: Any  # SelectStatement | SetOp (MATCH added with the graph layer)
    text: str = ""
