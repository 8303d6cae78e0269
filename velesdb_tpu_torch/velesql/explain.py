"""EXPLAIN: query plan tree rendering.

Counterpart of ``QueryPlan::from_select`` (``velesql/explain.rs``, 564 LoC):
node types VectorSearch / TextSearch / Fusion / Filter(mask pushdown) /
Scan / Aggregate / Sort / Distinct / Limit / SetOp. The plan mirrors what the
executor will actually run — filters show as pushdown masks on the search
nodes, not post-filters, because that is how the TPU kernels consume them.
"""

from __future__ import annotations

import dataclasses

from velesdb_tpu_torch.velesql.ast import Aggregate, Query, SelectStatement, SetOp
from velesdb_tpu_torch.velesql.executor import DEFAULT_LIMIT

__all__ = ["PlanNode", "explain"]


@dataclasses.dataclass
class PlanNode:
    kind: str
    detail: str = ""
    children: list["PlanNode"] = dataclasses.field(default_factory=list)

    def render(self, indent: int = 0) -> str:
        pad = "  " * indent
        line = f"{pad}-> {self.kind}" + (f" ({self.detail})" if self.detail else "")
        return "\n".join([line] + [c.render(indent + 1) for c in self.children])

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "detail": self.detail,
            "children": [c.to_dict() for c in self.children],
        }


def explain(query: Query, db=None) -> PlanNode:
    """Plan tree; with ``db`` the vector nodes carry the cost-based
    planner's engine choice + estimates (``query_cost`` EXPLAIN analog)."""
    return _plan_node(query.root, db)


def _plan_node(node, db=None) -> PlanNode:
    if isinstance(node, SetOp):
        return PlanNode(
            "SetOp",
            node.op.upper(),
            [_plan_node(node.left, db), _plan_node(node.right, db)],
        )
    return _plan_select(node, db)


def _engine_annotation(stmt: SelectStatement, db) -> str:
    if db is None:
        return ""
    try:
        coll = db.get_collection(stmt.collection)
    except Exception:
        return ""
    if coll.count() < coll.ann_min_rows:
        return ", engine=exact (corpus below ANN crossover)"
    choice = coll.planner.choose(
        max(coll.vectors.used_slots, 1), coll.dim, 1, have_ivf=True
    )
    ms = choice.est_ns / 1e6
    return f", engine={choice.engine} (est {ms:.2f}ms/batch)"


def _plan_select(stmt: SelectStatement, db=None) -> PlanNode:
    has_vec = stmt.near is not None or bool(stmt.similarity)
    has_txt = stmt.text_match is not None
    mask = "mask pushdown" if stmt.filter is not None else "no filter"

    sources: list[PlanNode] = []
    if stmt.near is not None:
        ef = stmt.with_options.ef_search
        detail = f"field={stmt.near.field}, vectors={len(stmt.near.vectors)}"
        if ef:
            detail += f", ef={ef}"
        detail += f", {mask}" + _engine_annotation(stmt, db)
        sources.append(PlanNode("VectorSearch", detail))
    elif stmt.similarity:
        sources.append(
            PlanNode("VectorScore", f"{len(stmt.similarity)} threshold(s), {mask}")
        )
    if has_txt:
        sources.append(PlanNode("TextSearch", f"BM25, {mask}"))
    if not sources:
        sources.append(
            PlanNode(
                "Scan",
                "ColumnStore mask" if stmt.filter is not None else "full scan",
            )
        )

    if len(sources) > 1:
        strat = (
            stmt.near.fusion.strategy
            if stmt.near is not None and stmt.near.fusion
            else ("union" if stmt.where_mode == "or" else "rrf")
        )
        root = PlanNode("Fusion", strat, sources)
    elif stmt.where_mode == "or" and stmt.filter is not None:
        root = PlanNode("Union", "similarity OR metadata", sources + [PlanNode("Scan", "ColumnStore mask")])
    else:
        root = sources[0]

    for sim in stmt.similarity:
        if stmt.near is not None:
            root = PlanNode(
                "SimilarityFilter", f"{sim.field} {sim.op} {sim.threshold}", [root]
            )
    aggregating = bool(stmt.group_by) or any(
        isinstance(c.expr, Aggregate) for c in stmt.columns
    )
    if aggregating:
        detail = f"group_by={stmt.group_by or '[]'}"
        if stmt.having:
            detail += ", having"
        root = PlanNode("Aggregate", detail, [root])
    if stmt.order_by:
        root = PlanNode(
            "Sort",
            ", ".join(
                (e.expr if isinstance(e.expr, str) else "similarity()")
                + (" DESC" if e.desc else "")
                for e in stmt.order_by
            ),
            [root],
        )
    if stmt.distinct:
        root = PlanNode("Distinct", "", [root])
    limit = stmt.limit if stmt.limit is not None else (DEFAULT_LIMIT if (has_vec or has_txt) else None)
    if limit is not None or stmt.offset:
        root = PlanNode(
            "Limit",
            f"limit={limit if limit is not None else 'all'}, offset={stmt.offset}",
            [root],
        )
    return root
