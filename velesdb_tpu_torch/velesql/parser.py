"""VelesQL parser: a contextual tokenizer and a recursive-descent parser -> AST.

Counterpart of ``velesdb_tpu/velesql/parser.py`` (and of the reference's pest
grammar, ``velesql/grammar.pest``). Covers: SELECT [DISTINCT] cols FROM coll,
WHERE with ``vector NEAR $v``, ``NEAR_FUSED [..] USING FUSION``,
``similarity(f, $v) > t``, ``MATCH 'text'``, comparison/IN/BETWEEN/LIKE/ILIKE/
IS NULL predicates, AND/OR/NOT, temporal ``NOW() - INTERVAL '7 days'``,
GROUP BY/HAVING/ORDER BY (incl. similarity()), LIMIT/OFFSET,
``WITH (ef_search=..)``, UNION/UNION ALL/INTERSECT/EXCEPT, quoted identifiers
and ``$param`` placeholders.

The grammar is :data:`GRAMMAR`, an LALR(1) grammar. The reference runs it
through lark; this module parses it by recursive descent and needs no parser
library. It calls the same rule callbacks (``_ToAst``) with the same children
in the same order, and lexes each token with the terminals the LALR(1) state
before it accepts (:mod:`~velesdb_tpu_torch.velesql.lexer`), so the same
texts parse to the same AST and the same texts raise :class:`ParseError`:
a keyword counts as one only where the grammar accepts it
(``SELECT * FROM t WHERE limit = 5`` reads ``limit`` as a field).

The WHERE tree is lowered at parse time into the split the executor wants
(NEAR clause + similarity conds + text match + residual filter DSL), the same
extraction the reference does per query (``search/query/extraction.rs``).
"""

from __future__ import annotations

import time

from velesdb_tpu_torch.velesql.ast import (
    Aggregate,
    FusionSpec,
    JoinClause,
    NearClause,
    OrderBy,
    Query,
    SelectItem,
    SelectStatement,
    SetOp,
    SimilarityCond,
    TextMatch,
    WithOptions,
)
from velesdb_tpu_torch.velesql.lexer import COMMON, END, Lexer, TokenStream, keyword, literal
from velesdb_tpu_torch.velesql.lexer import accepts as _acc

__all__ = ["parse", "ParseError"]

_AGG_FUNCS = {"count", "sum", "avg", "min", "max"}
_CMP_FLIP = {"gt": "lt", "gte": "lte", "lt": "gt", "lte": "gte"}

GRAMMAR = r"""
?start: set_expr

?set_expr: select_stmt
         | set_expr "UNION"i "ALL"i select_stmt -> union_all
         | set_expr "UNION"i select_stmt        -> union
         | set_expr "INTERSECT"i select_stmt    -> intersect
         | set_expr "EXCEPT"i select_stmt       -> except_

select_stmt: "SELECT"i distinct? projection "FROM"i table_ref join_clause* \
             where_clause? group_clause? having_clause? order_clause? \
             limit_clause? offset_clause? with_clause?

table_ref: ident ("AS"i ident)?
join_clause: "JOIN"i table_ref join_cond            -> join_inner
           | "INNER"i "JOIN"i table_ref join_cond   -> join_inner
           | "LEFT"i "OUTER"i "JOIN"i table_ref join_cond  -> join_left
           | "LEFT"i "JOIN"i table_ref join_cond    -> join_left
           | "RIGHT"i "OUTER"i "JOIN"i table_ref join_cond -> join_right
           | "RIGHT"i "JOIN"i table_ref join_cond   -> join_right
           | "FULL"i "OUTER"i "JOIN"i table_ref join_cond  -> join_full
           | "FULL"i "JOIN"i table_ref join_cond    -> join_full
join_cond: "ON"i ident_path CMP_OP ident_path -> join_on
         | "USING"i "(" ident ")" -> join_using

distinct: "DISTINCT"i
projection: STAR -> star_proj
          | sel_item ("," sel_item)*
sel_item: expr ("AS"i ident)?
?expr: func_call
     | ident_path -> field_expr
func_call: NAME "(" func_args? ")"
func_args: func_arg ("," func_arg)*
?func_arg: ident_path -> field_expr
         | value
         | STAR -> star_arg

where_clause: "WHERE"i or_expr
?or_expr: and_expr ("OR"i and_expr)*
?and_expr: not_expr ("AND"i not_expr)*
?not_expr: "NOT"i not_expr -> not_
         | "(" or_expr ")"
         | predicate

?predicate: ident_path "NEAR_FUSED"i vec_list "USING"i "FUSION"i fusion_spec -> near_fused
          | ident_path "NEAR"i vector_atom -> near
          | func_call CMP_OP value -> func_cmp
          | ident_path "MATCH"i value -> text_match
          | ident_path CMP_OP value -> cmp
          | ident_path "NOT"i "IN"i "(" select_stmt ")" -> not_in_subquery
          | ident_path "IN"i "(" select_stmt ")" -> in_subquery
          | "EXISTS"i "(" select_stmt ")" -> exists_subquery
          | ident_path CMP_OP "(" select_stmt ")" -> cmp_subquery
          | "(" select_stmt ")" CMP_OP value -> cmp_subquery_l
          | ident_path CMP_OP ident_path -> field_cmp
          | ident_path "NOT"i "IN"i "(" value ("," value)* ")" -> not_in
          | ident_path "IN"i "(" value ("," value)* ")" -> in_
          | ident_path "NOT"i "BETWEEN"i value "AND"i value -> not_between
          | ident_path "BETWEEN"i value "AND"i value -> between
          | ident_path "NOT"i "LIKE"i value -> not_like
          | ident_path "LIKE"i value -> like
          | ident_path "NOT"i "ILIKE"i value -> not_ilike
          | ident_path "ILIKE"i value -> ilike
          | ident_path "IS"i "NOT"i "NULL"i -> is_not_null
          | ident_path "IS"i "NULL"i -> is_null

vec_list: "[" vector_atom ("," vector_atom)* "]"
?vector_atom: PARAM -> param
            | num_array
num_array: "[" number ("," number)* "]"
fusion_spec: NAME fusion_args?
fusion_args: "(" fusion_arg ("," fusion_arg)* ")"
fusion_arg: NAME "=" value -> kw_arg
          | value

group_clause: "GROUP"i "BY"i ident_path ("," ident_path)*
having_clause: "HAVING"i func_call CMP_OP value
order_clause: "ORDER"i "BY"i order_item ("," order_item)*
order_item: (func_call | ident_path) order_dir?
order_dir: "ASC"i -> asc
         | "DESC"i -> desc
limit_clause: "LIMIT"i INT
offset_clause: "OFFSET"i INT
with_clause: "WITH"i "(" with_item ("," with_item)* ")"
with_item: NAME "=" value

?value: string
      | number
      | "TRUE"i -> true_
      | "FALSE"i -> false_
      | "NULL"i -> null_
      | PARAM -> param
      | temporal
temporal: "NOW"i "(" ")" (PLUSMINUS "INTERVAL"i string)? -> now_expr
        | "INTERVAL"i string -> interval

ident_path: ident ("." ident)*
ident: NAME | QUOTED_IDENT
?number: SIGNED_NUMBER -> num
?string: STRING -> str_

STAR: "*"
PLUSMINUS: "+" | "-"
CMP_OP: "==" | "=" | "!=" | "<>" | ">=" | "<=" | ">" | "<"
PARAM: /\$[a-zA-Z_][a-zA-Z0-9_]*/
NAME: /[a-zA-Z_][a-zA-Z0-9_]*/
QUOTED_IDENT: /"[^"]+"/
STRING: /'([^']|'')*'/
%import common.SIGNED_NUMBER
%import common.INT
%import common.WS
%ignore WS
"""


class ParseError(ValueError):
    """Raised on any syntactic or structural VelesQL error."""


def _cmp_name(op: str) -> str:
    return {
        "=": "eq",
        "==": "eq",
        "!=": "neq",
        "<>": "neq",
        ">": "gt",
        ">=": "gte",
        "<": "lt",
        "<=": "lte",
    }[op]


_INTERVAL_UNITS = {
    "second": 1.0,
    "seconds": 1.0,
    "minute": 60.0,
    "minutes": 60.0,
    "hour": 3600.0,
    "hours": 3600.0,
    "day": 86400.0,
    "days": 86400.0,
    "week": 604800.0,
    "weeks": 604800.0,
    "month": 2592000.0,
    "months": 2592000.0,
    "year": 31536000.0,
    "years": 31536000.0,
}


def _interval_seconds(text: str) -> float:
    parts = text.split()
    if len(parts) != 2:
        raise ParseError(f"bad INTERVAL {text!r} (want '<n> <unit>')")
    try:
        n = float(parts[0])
    except ValueError as e:
        raise ParseError(f"bad INTERVAL amount {parts[0]!r}") from e
    unit = parts[1].lower()
    if unit not in _INTERVAL_UNITS:
        raise ParseError(f"bad INTERVAL unit {unit!r}")
    return n * _INTERVAL_UNITS[unit]


class _Now:
    """Deferred NOW() ± INTERVAL — resolved to epoch seconds at execution."""

    def __init__(self, offset: float = 0.0):
        self.offset = offset

    def resolve(self) -> float:
        return time.time() + self.offset


class _Interval:
    def __init__(self, seconds: float):
        self.seconds = seconds


class _ToAst:
    """The reference's inline transformer: one method per rule or alias,
    called with the rule's kept children in order."""

    # -- scalars ------------------------------------------------------------
    def num(self, tok):
        f = float(tok)
        return int(f) if f.is_integer() and "." not in tok and "e" not in tok.lower() else f

    def str_(self, tok):
        return str(tok)[1:-1].replace("''", "'")

    def true_(self):
        return True

    def false_(self):
        return False

    def null_(self):
        return None

    def param(self, tok):
        return str(tok)

    def now_expr(self, sign=None, interval=None):
        if sign is None:
            return _Now()
        secs = _interval_seconds(interval)
        return _Now(-secs if str(sign) == "-" else secs)

    def interval(self, s):
        return _Interval(_interval_seconds(s))

    def ident(self, tok):
        s = str(tok)
        return s[1:-1] if s.startswith('"') else s

    def ident_path(self, *parts):
        return ".".join(parts)

    def num_array(self, *nums):
        return list(nums)

    def vec_list(self, *vecs):
        return list(vecs)

    def star_proj(self, _tok):
        return ["*"]

    def star_arg(self, _tok):
        return "*"

    # -- expressions ----------------------------------------------------------
    def field_expr(self, path):
        return path

    def func_args(self, *args):
        return list(args)

    def func_call(self, name, args=None):
        fname = str(name).lower()
        args = args or []
        if fname == "similarity":
            if len(args) != 2:
                raise ParseError("similarity() takes (field, $vector)")
            return ("similarity", args[0], args[1])
        if fname in _AGG_FUNCS:
            if fname == "count" and (not args or args == ["*"]):
                return Aggregate("count", None)
            if len(args) != 1 or not isinstance(args[0], str):
                raise ParseError(f"{fname}() takes one field")
            return Aggregate(fname, args[0])
        raise ParseError(f"unknown function {fname!r}")

    def sel_item(self, expr, alias=None):
        return SelectItem(expr, alias)

    def projection(self, *items):
        return list(items)

    def distinct(self):
        return True

    # -- predicates -> tagged nodes -------------------------------------------
    def near(self, field, vec):
        return ("near", NearClause(field, [vec]))

    def near_fused(self, field, vecs, fusion):
        return ("near", NearClause(field, vecs, fused=True, fusion=fusion))

    def fusion_spec(self, name, args=None):
        strat = str(name).lower()
        rrf_k, weights, pos = 60, None, []
        for a in args or []:
            if isinstance(a, tuple) and a[0] == "kw":
                if a[1] == "k":
                    rrf_k = int(a[2])
                else:
                    raise ParseError(f"unknown fusion arg {a[1]!r}")
            else:
                pos.append(float(a))
        if pos:
            weights = pos
        return FusionSpec(strat, rrf_k=rrf_k, weights=weights)

    def fusion_args(self, *args):
        return list(args)

    def kw_arg(self, name, value):
        return ("kw", str(name).lower(), value)

    def func_cmp(self, fn, op, value):
        if not (isinstance(fn, tuple) and fn[0] == "similarity"):
            raise ParseError("only similarity() may appear in comparisons")
        opn = _cmp_name(str(op))
        if opn in ("eq", "neq"):
            raise ParseError("similarity() supports >, >=, <, <= only")
        return ("sim", SimilarityCond(fn[1], fn[2], opn, value))

    def text_match(self, field, q):
        return ("match", TextMatch(field, q))

    def cmp(self, field, op, value):
        return {"type": _cmp_name(str(op)), "field": field, "value": value}

    def in_(self, field, *values):
        return {"type": "in", "field": field, "values": list(values)}

    def not_in(self, field, *values):
        return ("not", self.in_(field, *values))

    def in_subquery(self, field, sub):
        # subquery predicates carry a `correlations` list filled in when the
        # ENCLOSING statement assembles (reference: EPIC-039 US-003,
        # parser/values.rs:338 detect_correlated_columns); empty = the
        # materialize-once fast path of subquery_optimizer.rs
        return {"type": "in_subquery", "field": field, "query": sub,
                "correlations": []}

    def not_in_subquery(self, field, sub):
        return ("not", self.in_subquery(field, sub))

    def exists_subquery(self, sub):
        return {"type": "exists_subquery", "query": sub, "correlations": []}

    def cmp_subquery(self, field, op, sub):
        # scalar subquery comparison: total > (SELECT AVG(total) FROM t)
        return {"type": "cmp_subquery", "field": field,
                "op": _cmp_name(str(op)), "query": sub, "correlations": []}

    def cmp_subquery_l(self, sub, op, value):
        # scalar subquery on the LEFT: (SELECT COUNT(*) ...) = 0;
        # field None marks the literal-comparison form for the executor
        return {"type": "cmp_subquery", "field": None,
                "op": _cmp_name(str(op)), "value": value,
                "query": sub, "correlations": []}

    def field_cmp(self, left, op, right):
        # column-to-column comparison; inside a subquery a side qualified
        # with the outer alias makes the subquery correlated
        return {"type": "field_cmp", "field": left,
                "op": _cmp_name(str(op)), "rhs_field": right}

    # -- joins -----------------------------------------------------------------
    def table_ref(self, name, alias=None):
        return ("table", name, alias)

    def join_on(self, left, op, right):
        if _cmp_name(str(op)) != "eq":
            raise ParseError("JOIN ... ON supports equality only")
        return ("on", left, right)

    def join_using(self, field):
        return ("using", field)

    def _join(self, kind, table, cond):
        _, name, alias = table
        alias = alias or name
        if cond[0] == "using":
            left_f = right_f = cond[1]
        else:
            left_f, right_f = cond[1], cond[2]
        return ("join", JoinClause(kind, name, alias, left_f, right_f))

    def join_inner(self, table, cond):
        return self._join("inner", table, cond)

    def join_left(self, table, cond):
        return self._join("left", table, cond)

    def join_right(self, table, cond):
        return self._join("right", table, cond)

    def join_full(self, table, cond):
        return self._join("full", table, cond)

    def between(self, field, lo, hi):
        return {
            "type": "and",
            "conditions": [
                {"type": "gte", "field": field, "value": lo},
                {"type": "lte", "field": field, "value": hi},
            ],
        }

    def not_between(self, field, lo, hi):
        return ("not", self.between(field, lo, hi))

    def like(self, field, pat):
        return {"type": "like", "field": field, "pattern": pat}

    def not_like(self, field, pat):
        return ("not", self.like(field, pat))

    def ilike(self, field, pat):
        return {"type": "ilike", "field": field, "pattern": pat}

    def not_ilike(self, field, pat):
        return ("not", self.ilike(field, pat))

    def is_null(self, field):
        return {"type": "is_null", "field": field}

    def is_not_null(self, field):
        return {"type": "is_not_null", "field": field}

    def not_(self, inner):
        return ("not", inner)

    def or_expr(self, *branches):
        return ("or", list(branches))

    def and_expr(self, *branches):
        return ("and", list(branches))

    # -- clauses ----------------------------------------------------------------
    def where_clause(self, tree):
        return ("where", tree)

    def group_clause(self, *fields):
        return ("group", list(fields))

    def having_clause(self, fn, op, value):
        if not isinstance(fn, Aggregate):
            raise ParseError("HAVING requires an aggregate")
        return ("having", {"agg": fn, "op": _cmp_name(str(op)), "value": value})

    def order_item(self, expr, direction=None):
        return OrderBy(expr, desc=(direction == "desc"))

    def asc(self):
        return "asc"

    def desc(self):
        return "desc"

    def order_clause(self, *items):
        return ("order", list(items))

    def limit_clause(self, n):
        return ("limit", int(n))

    def offset_clause(self, n):
        return ("offset", int(n))

    def with_item(self, name, value):
        return (str(name).lower(), value)

    def with_clause(self, *items):
        opts = WithOptions()
        for name, value in items:
            if name == "ef_search":
                opts.ef_search = int(value)
            elif name == "quality":
                opts.quality = str(value)
            else:
                raise ParseError(f"unknown WITH option {name!r}")
        return ("with", opts)

    # -- statement ----------------------------------------------------------------
    def select_stmt(self, *parts):
        parts = list(parts)
        distinct = False
        if parts and parts[0] is True:
            distinct = True
            parts.pop(0)
        columns_raw = parts.pop(0)
        table = parts.pop(0)  # ("table", name, alias)
        if columns_raw == ["*"]:
            columns = [SelectItem("*")]
        else:
            columns = list(columns_raw)
        stmt = SelectStatement(
            columns=columns,
            distinct=distinct,
            collection=table[1],
            alias=table[2] or table[1],
        )
        while parts and isinstance(parts[0], tuple) and parts[0][0] == "join":
            stmt.joins.append(parts.pop(0)[1])
        for tag, payload in parts:
            if tag == "where":
                _lower_where(stmt, payload)
            elif tag == "group":
                stmt.group_by = payload
            elif tag == "having":
                stmt.having = payload
            elif tag == "order":
                stmt.order_by = payload
            elif tag == "limit":
                stmt.limit = payload
            elif tag == "offset":
                stmt.offset = payload
            elif tag == "with":
                stmt.with_options = payload
        _detect_correlations(stmt)
        return stmt

    def union(self, left, right):
        return SetOp("union", left, right)

    def union_all(self, left, right):
        return SetOp("union_all", left, right)

    def intersect(self, left, right):
        return SetOp("intersect", left, right)

    def except_(self, left, right):
        return SetOp("except", left, right)


def subquery_nodes(cond):
    """Yield every subquery predicate dict in a filter tree (any depth)."""
    if not isinstance(cond, dict):
        return
    t = cond.get("type")
    if t in ("and", "or"):
        for c in cond.get("conditions", []):
            yield from subquery_nodes(c)
    elif t == "not":
        yield from subquery_nodes(cond.get("condition") or {})
    elif t in ("in_subquery", "exists_subquery", "cmp_subquery"):
        yield cond


def _flip_cmp(op: str) -> str:
    return {"eq": "eq", "neq": "neq", "gt": "lt", "gte": "lte",
            "lt": "gt", "lte": "gte"}[op]


def _detect_correlations(stmt: SelectStatement) -> None:
    """Mark subquery predicates that reference the enclosing statement.

    Analog of the reference's ``detect_correlated_columns`` (EPIC-039
    US-003, ``parser/values.rs:338``): inside a subquery's WHERE, a field
    qualified with the OUTER statement's alias (or collection name) is a
    correlated reference — unless the subquery's own alias shadows it (same
    table name = non-correlated, per the reference's semantics). Detection
    is single-level: a depth-2 subquery can correlate only to its immediate
    parent. Each entry records the comparison normalized to
    ``inner OP outer_value`` form so the executor can substitute or
    join-rewrite without re-deriving directions.
    """
    if stmt.filter is None:
        return
    outer_names = {stmt.alias or stmt.collection, stmt.collection}
    for node in subquery_nodes(stmt.filter):
        sub = node["query"]
        names = outer_names - {
            sub.alias or sub.collection,
            sub.collection,
            *(j.alias for j in sub.joins),
        }
        if not names or sub.filter is None:
            continue
        _collect_correlated(sub.filter, names, node["correlations"])


def _collect_correlated(cond, outer_names: set, out: list) -> None:
    if not isinstance(cond, dict):
        return
    t = cond.get("type")
    if t in ("and", "or"):
        for c in cond.get("conditions", []):
            _collect_correlated(c, outer_names, out)
    elif t == "not":
        _collect_correlated(cond.get("condition") or {}, outer_names, out)
    elif t == "field_cmp":
        l_outer = cond["field"].split(".", 1)[0] in outer_names
        r_outer = cond["rhs_field"].split(".", 1)[0] in outer_names
        if l_outer and r_outer:
            raise ParseError(
                "correlated comparison references the outer query on both sides"
            )
        if l_outer or r_outer:
            out.append({
                "kind": "join",
                "op": cond["op"] if r_outer else _flip_cmp(cond["op"]),
                "inner": cond["rhs_field"] if l_outer else cond["field"],
                "outer": cond["field"] if l_outer else cond["rhs_field"],
                "node": cond,
            })
    elif cond.get("field", "").split(".", 1)[0] in outer_names:
        # outer-referencing predicate with a literal (e.g. o.vip = TRUE):
        # constant per outer row — forces the PerRow strategy
        out.append({"kind": "pred", "node": cond})


def _is_special(node) -> bool:
    """True if the node (sub)tree holds NEAR/similarity/MATCH predicates."""
    if isinstance(node, tuple):
        if node[0] in ("near", "sim", "match"):
            return True
        if node[0] in ("and", "or"):
            return any(_is_special(c) for c in node[1])
        if node[0] == "not":
            return _is_special(node[1])
    return False


def _lower_where(stmt: SelectStatement, tree) -> None:
    """Split the WHERE tree into NEAR / similarity / MATCH / residual filter.

    Mirrors the reference's extraction + mode select
    (``search/query/mod.rs:90-160``): a top-level ``OR`` between a
    similarity branch and a metadata branch selects *union mode*.
    """
    if isinstance(tree, tuple) and tree[0] == "or":
        special = [b for b in tree[1] if _is_special(b)]
        plain = [b for b in tree[1] if not _is_special(b)]
        if special and plain:
            stmt.where_mode = "or"
            for b in special:
                _extract_conjunct(stmt, b)
            stmt.filter = _to_filter(("or", plain) if len(plain) > 1 else plain[0])
            return
    conjuncts = tree[1] if isinstance(tree, tuple) and tree[0] == "and" else [tree]
    residual = []
    for c in conjuncts:
        if _is_special(c):
            _extract_conjunct(stmt, c)
        else:
            residual.append(c)
    if residual:
        stmt.filter = _to_filter(
            ("and", residual) if len(residual) > 1 else residual[0]
        )


def _extract_conjunct(stmt: SelectStatement, node) -> None:
    if isinstance(node, tuple) and node[0] == "near":
        if stmt.near is not None:
            raise ParseError("multiple NEAR clauses in one query")
        stmt.near = node[1]
    elif isinstance(node, tuple) and node[0] == "sim":
        stmt.similarity.append(node[1])
    elif isinstance(node, tuple) and node[0] == "match":
        if stmt.text_match is not None:
            raise ParseError("multiple MATCH clauses in one query")
        stmt.text_match = node[1]
    elif isinstance(node, tuple) and node[0] == "not" and isinstance(
        node[1], tuple
    ) and node[1][0] == "sim":
        sim = node[1][1]
        stmt.similarity.append(
            SimilarityCond(sim.field, sim.vector, sim.op, sim.threshold, negated=True)
        )
    elif isinstance(node, tuple) and node[0] == "and":
        for c in node[1]:
            if _is_special(c):
                _extract_conjunct(stmt, c)
            else:
                stmt.filter = (
                    _to_filter(c)
                    if stmt.filter is None
                    else {"type": "and", "conditions": [stmt.filter, _to_filter(c)]}
                )
    else:
        raise ParseError(
            "NEAR/similarity/MATCH must appear in a top-level conjunction "
            "(or one OR branch)"
        )


def _to_filter(node) -> dict:
    """Condition tree -> filter-DSL tagged dict."""
    if isinstance(node, dict):
        return node
    if isinstance(node, tuple):
        if node[0] == "and":
            return {"type": "and", "conditions": [_to_filter(c) for c in node[1]]}
        if node[0] == "or":
            return {"type": "or", "conditions": [_to_filter(c) for c in node[1]]}
        if node[0] == "not":
            return {"type": "not", "condition": _to_filter(node[1])}
    raise ParseError(f"cannot use {node!r} as a metadata filter")




# -- tokenizer -----------------------------------------------------------------

_KEYWORDS = (
    "ALL AND AS ASC BETWEEN BY DESC DISTINCT EXCEPT EXISTS FALSE FROM FULL FUSION GROUP "
    "HAVING ILIKE IN INNER INTERSECT INTERVAL IS JOIN LEFT LIKE LIMIT MATCH NEAR NEAR_FUSED "
    "NOT NOW NULL OFFSET ON OR ORDER OUTER RIGHT SELECT TRUE UNION USING WHERE WITH"
).split()
_TERMINALS = {
    **COMMON,
    **{k: keyword(k) for k in _KEYWORDS},
    "QUOTED_IDENT": COMMON["NAME"]._replace(name="QUOTED_IDENT", regex='"[^"]+"',
                                            value='"[^"]+"'),
    "EQUAL": literal("EQUAL", "="),
    "LSQB": literal("LSQB", "["),
    "RSQB": literal("RSQB", "]"),
}
_lexer = Lexer(_TERMINALS, ParseError)


# What the state after each kind of token accepts (named after the token and
# its place in the grammar). One LALR(1) core merges the lookaheads of every
# context it occurs in, so e.g. after any value the closing ``)`` and ``,`` of
# the enclosing lists are accepted too.
_VALUE = _acc("FALSE INTERVAL NOW NULL PARAM SIGNED_NUMBER STRING TRUE")
_PRED = _acc("EXISTS LPAR NAME NOT QUOTED_IDENT")  # where a condition starts
_IDENT = _acc("NAME QUOTED_IDENT")  # where an identifier starts
_AFTER_PRED = _acc("$END AND EXCEPT GROUP HAVING INTERSECT LIMIT OFFSET OR ORDER RPAR UNION WITH")
_AFTER_VALUE = _AFTER_PRED | {"COMMA"}
_AFTER_NUMBER = _AFTER_VALUE | {"RSQB"}
_AFTER_NOW = _AFTER_VALUE | {"PLUSMINUS"}
_AFTER_IDENT = _acc(
    "$END AND AS ASC BETWEEN CMP_OP COMMA DESC DOT EXCEPT FROM FULL GROUP HAVING ILIKE IN INNER "
    "INTERSECT IS JOIN LEFT LIKE LIMIT MATCH NEAR NEAR_FUSED NOT OFFSET ON OR ORDER RIGHT RPAR "
    "UNION USING WHERE WITH")
_AFTER_EXPR_NAME = _acc(  # NAME where a function call or a field may start
    "$END AS ASC BETWEEN CMP_OP COMMA DESC DOT EXCEPT FROM ILIKE IN INTERSECT IS LIKE LIMIT "
    "LPAR MATCH NEAR NEAR_FUSED NOT OFFSET RPAR UNION WITH")
_AFTER_CALL = _acc("$END AS ASC CMP_OP COMMA DESC EXCEPT FROM INTERSECT LIMIT OFFSET RPAR UNION WITH")
_AFTER_FUSION_NAME = _AFTER_PRED | {"LPAR"}
_AFTER_USING_RPAR = _acc(
    "$END EXCEPT FULL GROUP HAVING INNER INTERSECT JOIN LEFT LIMIT OFFSET ORDER RIGHT RPAR UNION "
    "WHERE WITH")
_AFTER_WITH = _acc("$END EXCEPT INTERSECT RPAR UNION")
_AFTER_OFFSET = _AFTER_WITH | {"WITH"}
_AFTER_LIMIT = _AFTER_OFFSET | {"OFFSET"}
_AFTER_DIR = _AFTER_LIMIT | {"COMMA", "LIMIT"}
_CALL_ARG = _acc("FALSE INTERVAL NAME NOW NULL PARAM QUOTED_IDENT SIGNED_NUMBER STAR STRING TRUE")
_FUSION_ARG = _VALUE | {"NAME"}
_VECTOR = _acc("LSQB PARAM")


class _Parser(TokenStream):
    """Recursive descent over :data:`GRAMMAR`; one instance per text."""

    def __init__(self, text: str):
        super().__init__(_lexer, text, _acc("SELECT"), "VelesQL")
        self.cb = _ToAst()

    # -- statements -------------------------------------------------------------

    def start(self):
        cb = self.cb
        left = self.select()
        while True:
            k = self.peek()
            if k == "UNION":
                self.take(_acc("ALL SELECT"))
                if self.peek() == "ALL":
                    self.take(_acc("SELECT"))
                    left = cb.union_all(left, self.select())
                else:
                    left = cb.union(left, self.select())
            elif k == "INTERSECT":
                self.take(_acc("SELECT"))
                left = cb.intersect(left, self.select())
            elif k == "EXCEPT":
                self.take(_acc("SELECT"))
                left = cb.except_(left, self.select())
            elif k == END:
                return left
            else:
                raise self.fail()

    def select(self):
        cb = self.cb
        self.expect("SELECT", _acc("DISTINCT NAME QUOTED_IDENT STAR"))
        parts = []
        if self.peek() == "DISTINCT":
            self.take(_acc("NAME QUOTED_IDENT STAR"))
            parts.append(cb.distinct())
        parts.append(self.projection())
        self.expect("FROM", _IDENT)
        parts.append(self.table_ref())
        while self.peek() in ("JOIN", "INNER", "LEFT", "RIGHT", "FULL"):
            parts.append(self.join())
        if self.peek() == "WHERE":
            self.take(_PRED)
            parts.append(cb.where_clause(self.or_expr()))
        if self.peek() == "GROUP":
            self.take(_acc("BY"))
            self.expect("BY", _IDENT)
            fields = [self.ident_path()]
            while self.peek() == "COMMA":
                self.take(_IDENT)
                fields.append(self.ident_path())
            parts.append(cb.group_clause(*fields))
        if self.peek() == "HAVING":
            self.take(_acc("NAME"))
            fn = self.call(self.expect("NAME", _acc("LPAR")))
            op = self.expect("CMP_OP", _VALUE)
            parts.append(cb.having_clause(fn, op, self.value()))
        if self.peek() == "ORDER":
            self.take(_acc("BY"))
            self.expect("BY", _IDENT)
            items = [self.order_item()]
            while self.peek() == "COMMA":
                self.take(_IDENT)
                items.append(self.order_item())
            parts.append(cb.order_clause(*items))
        if self.peek() == "LIMIT":
            self.take(_acc("INT"))
            parts.append(cb.limit_clause(self.expect("INT", _AFTER_LIMIT)))
        if self.peek() == "OFFSET":
            self.take(_acc("INT"))
            parts.append(cb.offset_clause(self.expect("INT", _AFTER_OFFSET)))
        if self.peek() == "WITH":
            self.take(_acc("LPAR"))
            self.expect("LPAR", _acc("NAME"))
            items = [self.with_item()]
            while self.peek() == "COMMA":
                self.take(_acc("NAME"))
                items.append(self.with_item())
            self.expect("RPAR", _AFTER_WITH)
            parts.append(cb.with_clause(*items))
        return cb.select_stmt(*parts)

    def projection(self):
        if self.peek() == "STAR":
            return self.cb.star_proj(self.take(_acc("FROM")))
        items = [self.sel_item()]
        while self.peek() == "COMMA":
            self.take(_IDENT)
            items.append(self.sel_item())
        return self.cb.projection(*items)

    def sel_item(self):
        expr = self.expr()
        if self.peek() == "AS":
            self.take(_IDENT)
            return self.cb.sel_item(expr, self.ident())
        return self.cb.sel_item(expr)

    def table_ref(self):
        name = self.ident()
        if self.peek() == "AS":
            self.take(_IDENT)
            return self.cb.table_ref(name, self.ident())
        return self.cb.table_ref(name)

    def join(self):
        cb = self.cb
        k = self.peek()
        if k == "JOIN":
            self.take(_IDENT)
        elif k == "INNER":
            self.take(_acc("JOIN"))
            self.expect("JOIN", _IDENT)
        else:  # LEFT | RIGHT | FULL [OUTER] JOIN
            self.take(_acc("JOIN OUTER"))
            if self.peek() == "OUTER":
                self.take(_acc("JOIN"))
            self.expect("JOIN", _IDENT)
        table = self.table_ref()
        if self.peek() == "ON":
            self.take(_IDENT)
            left = self.ident_path()
            op = self.expect("CMP_OP", _IDENT)
            cond = cb.join_on(left, op, self.ident_path())
        elif self.peek() == "USING":
            self.take(_acc("LPAR"))
            self.expect("LPAR", _IDENT)
            field = self.ident()
            self.expect("RPAR", _AFTER_USING_RPAR)
            cond = cb.join_using(field)
        else:
            raise self.fail()
        kind = {"JOIN": "inner", "INNER": "inner", "LEFT": "left", "RIGHT": "right",
                "FULL": "full"}[k]
        return getattr(cb, f"join_{kind}")(table, cond)

    def with_item(self):
        name = self.expect("NAME", _acc("EQUAL"))
        self.expect("EQUAL", _VALUE)
        return self.cb.with_item(name, self.value())

    def order_item(self):
        cb = self.cb
        if self.peek() == "NAME":
            name = self.take(_AFTER_EXPR_NAME)
            expr = self.call(name) if self.peek() == "LPAR" else self.path_rest(cb.ident(name))
        else:
            expr = self.ident_path()
        k = self.peek()
        if k in ("ASC", "DESC"):
            self.take(_AFTER_DIR)
            return cb.order_item(expr, cb.asc() if k == "ASC" else cb.desc())
        return cb.order_item(expr)

    # -- expressions ------------------------------------------------------------

    def ident(self):
        if self.peek() not in ("NAME", "QUOTED_IDENT"):
            raise self.fail()
        return self.cb.ident(self.take(_AFTER_IDENT))

    def path_rest(self, first):
        parts = [first]
        while self.peek() == "DOT":
            self.take(_IDENT)
            parts.append(self.ident())
        return self.cb.ident_path(*parts)

    def ident_path(self):
        return self.path_rest(self.ident())

    def expr(self):
        """``func_call`` or ``ident_path -> field_expr``."""
        if self.peek() == "NAME":
            name = self.take(_AFTER_EXPR_NAME)
            if self.peek() == "LPAR":
                return self.call(name)
            return self.cb.field_expr(self.path_rest(self.cb.ident(name)))
        return self.cb.field_expr(self.ident_path())

    def call(self, name):
        cb = self.cb
        self.expect("LPAR", _CALL_ARG | {"RPAR"})
        if self.peek() == "RPAR":
            self.take(_AFTER_CALL)
            return cb.func_call(name)
        args = [self.call_arg()]
        while self.peek() == "COMMA":
            self.take(_CALL_ARG)
            args.append(self.call_arg())
        self.expect("RPAR", _AFTER_CALL)
        return cb.func_call(name, cb.func_args(*args))

    def call_arg(self):
        k = self.peek()
        if k == "STAR":
            return self.cb.star_arg(self.take(_acc("COMMA RPAR")))
        if k in ("NAME", "QUOTED_IDENT"):
            return self.cb.field_expr(self.ident_path())
        return self.value()

    def value(self):
        cb = self.cb
        k = self.peek()
        if k == "STRING":
            return cb.str_(self.take(_AFTER_VALUE))
        if k == "SIGNED_NUMBER":
            return cb.num(self.take(_AFTER_NUMBER))
        if k == "PARAM":
            return cb.param(self.take(_AFTER_VALUE))
        if k in ("TRUE", "FALSE", "NULL"):
            self.take(_AFTER_VALUE)
            return {"TRUE": cb.true_, "FALSE": cb.false_, "NULL": cb.null_}[k]()
        if k == "NOW":
            self.take(_acc("LPAR"))
            self.expect("LPAR", _acc("RPAR"))
            self.expect("RPAR", _AFTER_NOW)
            if self.peek() != "PLUSMINUS":
                return cb.now_expr()
            sign = self.take(_acc("INTERVAL"))
            self.expect("INTERVAL", _acc("STRING"))
            return cb.now_expr(sign, cb.str_(self.expect("STRING", _AFTER_VALUE)))
        if k == "INTERVAL":
            self.take(_acc("STRING"))
            return cb.interval(cb.str_(self.expect("STRING", _AFTER_VALUE)))
        raise self.fail()

    def values(self):
        vals = [self.value()]
        while self.peek() == "COMMA":
            self.take(_VALUE)
            vals.append(self.value())
        return vals

    # -- conditions -------------------------------------------------------------

    def or_expr(self):
        branches = [self.and_expr()]
        while self.peek() == "OR":
            self.take(_PRED)
            branches.append(self.and_expr())
        return branches[0] if len(branches) == 1 else self.cb.or_expr(*branches)

    def and_expr(self):
        branches = [self.not_expr()]
        while self.peek() == "AND":
            self.take(_PRED)
            branches.append(self.not_expr())
        return branches[0] if len(branches) == 1 else self.cb.and_expr(*branches)

    def not_expr(self):
        k = self.peek()
        if k == "NOT":
            self.take(_PRED)
            return self.cb.not_(self.not_expr())
        if k == "LPAR":
            self.take(_PRED | {"SELECT"})
            if self.peek() == "SELECT":
                sub = self.select()
                self.expect("RPAR", _acc("CMP_OP"))
                op = self.expect("CMP_OP", _VALUE)
                return self.cb.cmp_subquery_l(sub, op, self.value())
            inner = self.or_expr()
            self.expect("RPAR", _AFTER_PRED)
            return inner
        return self.predicate()

    def subquery(self):
        """``select_stmt ")"`` after the opening parenthesis."""
        sub = self.select()
        self.expect("RPAR", _AFTER_PRED)
        return sub

    def predicate(self):
        cb = self.cb
        k = self.peek()
        if k == "EXISTS":
            self.take(_acc("LPAR"))
            self.expect("LPAR", _acc("SELECT"))
            return cb.exists_subquery(self.subquery())
        if k == "NAME":
            name = self.take(_AFTER_EXPR_NAME)
            if self.peek() == "LPAR":
                fn = self.call(name)
                op = self.expect("CMP_OP", _VALUE)
                return cb.func_cmp(fn, op, self.value())
            field = self.path_rest(cb.ident(name))
        elif k == "QUOTED_IDENT":
            field = self.ident_path()
        else:
            raise self.fail()
        k = self.peek()
        if k == "NEAR_FUSED":
            self.take(_acc("LSQB"))
            vecs = self.vec_list()
            self.expect("USING", _acc("FUSION"))
            self.expect("FUSION", _acc("NAME"))
            return cb.near_fused(field, vecs, self.fusion_spec())
        if k == "NEAR":
            self.take(_VECTOR)
            return cb.near(field, self.vector_atom())
        if k == "MATCH":
            self.take(_VALUE)
            return cb.text_match(field, self.value())
        if k == "CMP_OP":
            op = self.take(_VALUE | _IDENT | {"LPAR"})
            k = self.peek()
            if k == "LPAR":
                self.take(_acc("SELECT"))
                return cb.cmp_subquery(field, op, self.subquery())
            if k in ("NAME", "QUOTED_IDENT"):
                return cb.field_cmp(field, op, self.ident_path())
            return cb.cmp(field, op, self.value())
        if k == "IS":
            self.take(_acc("NOT NULL"))
            if self.peek() == "NOT":
                self.take(_acc("NULL"))
                self.expect("NULL", _AFTER_PRED)
                return cb.is_not_null(field)
            self.expect("NULL", _AFTER_PRED)
            return cb.is_null(field)
        negated = k == "NOT"
        if negated:
            self.take(_acc("BETWEEN ILIKE IN LIKE"))
            k = self.peek()
        pre = "not_" if negated else ""
        if k == "IN":
            self.take(_acc("LPAR"))
            self.expect("LPAR", _VALUE | {"SELECT"})
            if self.peek() == "SELECT":
                return getattr(cb, pre + "in_subquery")(field, self.subquery())
            vals = self.values()
            self.expect("RPAR", _AFTER_PRED)
            return getattr(cb, pre + "in" if negated else "in_")(field, *vals)
        if k == "BETWEEN":
            self.take(_VALUE)
            lo = self.value()
            self.expect("AND", _VALUE)
            return getattr(cb, pre + "between")(field, lo, self.value())
        if k in ("LIKE", "ILIKE"):
            self.take(_VALUE)
            return getattr(cb, pre + k.lower())(field, self.value())
        raise self.fail()

    def vec_list(self):
        self.expect("LSQB", _VECTOR)
        vecs = [self.vector_atom()]
        while self.peek() == "COMMA":
            self.take(_VECTOR)
            vecs.append(self.vector_atom())
        self.expect("RSQB", _acc("USING"))
        return self.cb.vec_list(*vecs)

    def vector_atom(self):
        cb = self.cb
        if self.peek() == "PARAM":
            return cb.param(self.take(_AFTER_NUMBER))
        self.expect("LSQB", _acc("SIGNED_NUMBER"))
        nums = [cb.num(self.expect("SIGNED_NUMBER", _AFTER_NUMBER))]
        while self.peek() == "COMMA":
            self.take(_acc("SIGNED_NUMBER"))
            nums.append(cb.num(self.expect("SIGNED_NUMBER", _AFTER_NUMBER)))
        self.expect("RSQB", _AFTER_NUMBER)
        return cb.num_array(*nums)

    def fusion_spec(self):
        cb = self.cb
        name = self.expect("NAME", _AFTER_FUSION_NAME)
        if self.peek() != "LPAR":
            return cb.fusion_spec(name)
        self.take(_FUSION_ARG)
        args = [self.fusion_arg()]
        while self.peek() == "COMMA":
            self.take(_FUSION_ARG)
            args.append(self.fusion_arg())
        self.expect("RPAR", _AFTER_PRED)
        return cb.fusion_spec(name, cb.fusion_args(*args))

    def fusion_arg(self):
        if self.peek() == "NAME":
            name = self.take(_acc("EQUAL"))
            self.expect("EQUAL", _VALUE)
            return self.cb.kw_arg(name, self.value())
        # ``fusion_arg: value`` has no callback: the reference's transformer
        # leaves a tree node there, which ``fusion_spec`` cannot read as a
        # weight, so positional fusion weights are a parse error in both
        return _Node("fusion_arg", [self.value()])


class _Node:
    """A rule result with no callback (a tree node in the reference)."""

    def __init__(self, rule: str, children: list):
        self.rule = rule
        self.children = children


def parse(text: str) -> Query:
    """Parse VelesQL text into a :class:`Query` (``Parser::parse`` analog)."""
    try:
        root = _Parser(text).start()
    except ParseError:
        raise
    except Exception as e:  # a callback's own failure -> uniform ParseError
        raise ParseError(f"VelesQL syntax error: {e}") from e
    return Query(root=root, text=text)
