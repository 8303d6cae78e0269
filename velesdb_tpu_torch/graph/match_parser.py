"""Cypher-ish MATCH parser: recursive descent over the reference's grammar.

Counterpart of ``velesdb_tpu/graph/match_parser.py`` and of
``velesql/parser/match_parser.rs`` + ``MatchClause``
(``velesql/ast/graph_pattern.rs:12``). Separate grammar module from SELECT
(like the reference) — patterns, variable-length hops, WHERE over bindings,
RETURN projection, ORDER BY (incl. similarity()), LIMIT::

    MATCH (a:Person {city: 'Paris'})-[r:KNOWS*1..2]->(b:Person)
    WHERE b.age > 30 AND similarity(b, $v) > 0.7
    RETURN a, b.name, similarity(b, $v) AS score
    ORDER BY score DESC LIMIT 10

The grammar is :data:`GRAMMAR`, an LALR(1) grammar that the reference runs
through lark. This module parses it by recursive descent, with the contextual
tokenizer of :mod:`~velesdb_tpu_torch.velesql.lexer` (each token lexed with the
terminals the LALR(1) state before it accepts), and calls the reference's
callbacks (``_ToMatch``) with the same children, so the same texts give the
same statements and the same texts raise :class:`ParseError`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from velesdb_tpu_torch.velesql.lexer import COMMON, END, Lexer, TokenStream, keyword, literal
from velesdb_tpu_torch.velesql.lexer import accepts as _acc
from velesdb_tpu_torch.velesql.parser import ParseError, _interval_seconds, _Now

__all__ = ["MatchStatement", "NodePattern", "EdgePattern", "parse_match"]


@dataclasses.dataclass
class NodePattern:
    var: Optional[str]
    labels: list[str]
    props: dict


@dataclasses.dataclass
class EdgePattern:
    var: Optional[str]
    labels: list[str]
    direction: str  # out | in | both
    min_hops: int = 1
    max_hops: int = 1


@dataclasses.dataclass
class ReturnItem:
    expr: Any  # ("var", name) | ("field", var, path) | ("similarity", var, vec)
    alias: Optional[str] = None


@dataclasses.dataclass
class OrderItem:
    expr: Any
    desc: bool = False


@dataclasses.dataclass
class MatchStatement:
    nodes: list[NodePattern]
    edges: list[EdgePattern]
    where: Optional[list] = None  # list of condition dicts (conjunction)
    returns: list[ReturnItem] = dataclasses.field(default_factory=list)
    order_by: list[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None


GRAMMAR = r"""
?start: match_stmt
match_stmt: "MATCH"i pattern where_part? "RETURN"i ret_items order_part? limit_part?

pattern: node_pat (edge_pat node_pat)*
node_pat: "(" NAME? label_spec* prop_map? ")"
label_spec: ":" NAME
prop_map: "{" prop_pair ("," prop_pair)* "}"
prop_pair: NAME ":" value

edge_pat: "-[" edge_body "]->"  -> edge_out
        | "<-[" edge_body "]-"  -> edge_in
        | "-[" edge_body "]-"   -> edge_both
edge_body: NAME? label_spec* hops?
hops: "*" (INT (".." INT)?)?

where_part: "WHERE"i cond ("AND"i cond)*
?cond: "similarity"i "(" NAME "," value ")" CMP_OP value -> sim_cond
     | field_ref CMP_OP value                            -> cmp_cond
     | field_ref "IN"i "(" value ("," value)* ")"        -> in_cond
     | field_ref "LIKE"i value                           -> like_cond
     | field_ref "IS"i "NOT"i "NULL"i                    -> notnull_cond
     | field_ref "IS"i "NULL"i                           -> null_cond
field_ref: NAME ("." NAME)+

ret_items: ret_item ("," ret_item)*
ret_item: ret_expr ("AS"i NAME)?
?ret_expr: "similarity"i "(" NAME "," value ")" -> ret_sim
         | field_ref -> ret_field
         | NAME -> ret_var

order_part: "ORDER"i "BY"i order_item ("," order_item)*
order_item: (NAME | field_ref) order_dir?
order_dir: "ASC"i -> asc
         | "DESC"i -> desc
limit_part: "LIMIT"i INT

?value: STRING -> str_
      | SIGNED_NUMBER -> num
      | "TRUE"i -> true_
      | "FALSE"i -> false_
      | "NULL"i -> null_
      | PARAM -> param
      | "NOW"i "(" ")" (PLUSMINUS "INTERVAL"i STRING)? -> now_expr

PLUSMINUS: "+" | "-"
CMP_OP: "==" | "=" | "!=" | "<>" | ">=" | "<=" | ">" | "<"
PARAM: /\$[a-zA-Z_][a-zA-Z0-9_]*/
NAME: /[a-zA-Z_][a-zA-Z0-9_]*/
STRING: /'([^']|'')*'/
%import common.SIGNED_NUMBER
%import common.INT
%import common.WS
%ignore WS
"""

_CMP = {
    "=": "eq",
    "==": "eq",
    "!=": "neq",
    "<>": "neq",
    ">": "gt",
    ">=": "gte",
    "<": "lt",
    "<=": "lte",
}


class _ToMatch:
    """The reference's transformer: one method per rule or alias, called with
    the rule's kept children in order."""

    def str_(self, tok):
        return str(tok)[1:-1].replace("''", "'")

    def num(self, tok):
        f = float(tok)
        return int(f) if f.is_integer() and "." not in tok else f

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
        secs = _interval_seconds(str(interval)[1:-1])
        return _Now(-secs if str(sign) == "-" else secs)

    def label_spec(self, name):
        return ("label", str(name))

    def prop_pair(self, name, value):
        return (str(name), value)

    def prop_map(self, *pairs):
        return ("props", dict(pairs))

    def node_pat(self, *parts):
        var, labels, props = None, [], {}
        for p in parts:
            if isinstance(p, tuple) and p[0] == "label":
                labels.append(p[1])
            elif isinstance(p, tuple) and p[0] == "props":
                props = p[1]
            else:
                var = str(p)  # bare NAME token = binding variable
        return NodePattern(var, labels, props)

    def hops(self, lo=None, hi=None):
        if lo is None:
            return (1, None)
        lo = int(lo)
        return (lo, int(hi) if hi is not None else lo)

    def edge_body(self, *parts):
        var, labels, hops = None, [], (1, 1)
        for p in parts:
            if isinstance(p, tuple) and p[0] == "label":
                labels.append(p[1])
            elif isinstance(p, tuple):
                hops = p
            else:
                var = str(p)
        return (var, labels, hops)

    def edge_out(self, body):
        return _mk_edge(body, "out")

    def edge_in(self, body):
        return _mk_edge(body, "in")

    def edge_both(self, body):
        return _mk_edge(body, "both")

    def field_ref(self, *names):
        return (str(names[0]), ".".join(str(n) for n in names[1:]))

    def sim_cond(self, var, vec, op, thr):
        o = _CMP[str(op)]
        if o in ("eq", "neq"):
            raise ParseError("similarity() supports >, >=, <, <= only")
        return {"kind": "sim", "var": str(var), "vector": vec, "op": o, "value": thr}

    def cmp_cond(self, ref, op, value):
        return {
            "kind": "cmp",
            "var": ref[0],
            "field": ref[1],
            "op": _CMP[str(op)],
            "value": value,
        }

    def in_cond(self, ref, *values):
        return {"kind": "in", "var": ref[0], "field": ref[1], "values": list(values)}

    def like_cond(self, ref, pat):
        return {"kind": "like", "var": ref[0], "field": ref[1], "pattern": pat}

    def null_cond(self, ref):
        return {"kind": "is_null", "var": ref[0], "field": ref[1]}

    def notnull_cond(self, ref):
        return {"kind": "is_not_null", "var": ref[0], "field": ref[1]}

    def where_part(self, *conds):
        return ("where", list(conds))

    def ret_sim(self, var, vec):
        return ("similarity", str(var), vec)

    def ret_field(self, ref):
        return ("field", ref[0], ref[1])

    def ret_var(self, name):
        return ("var", str(name))

    def ret_item(self, expr, alias=None):
        return ReturnItem(expr, str(alias) if alias is not None else None)

    def ret_items(self, *items):
        return ("returns", list(items))

    def order_item(self, expr, direction=None):
        if isinstance(expr, tuple):
            expr = ("field", expr[0], expr[1])
        else:
            expr = str(expr)
        return OrderItem(expr, desc=(direction == "desc"))

    def asc(self):
        return "asc"

    def desc(self):
        return "desc"

    def order_part(self, *items):
        return ("order", list(items))

    def limit_part(self, n):
        return ("limit", int(n))

    def pattern(self, *parts):
        nodes = [p for p in parts if isinstance(p, NodePattern)]
        edges = [p for p in parts if isinstance(p, EdgePattern)]
        return ("pattern", nodes, edges)

    def match_stmt(self, *parts):
        stmt = MatchStatement(nodes=[], edges=[])
        for p in parts:
            if p[0] == "pattern":
                stmt.nodes, stmt.edges = p[1], p[2]
            elif p[0] == "where":
                stmt.where = p[1]
            elif p[0] == "returns":
                stmt.returns = p[1]
            elif p[0] == "order":
                stmt.order_by = p[1]
            elif p[0] == "limit":
                stmt.limit = p[1]
        if len(stmt.nodes) != len(stmt.edges) + 1:
            raise ParseError("malformed MATCH pattern")
        return stmt


def _mk_edge(body, direction) -> EdgePattern:
    var, labels, (lo, hi) = body
    if hi is None:
        hi = 16  # unbounded "*" capped like the reference's guardrails
    if lo < 0 or hi < lo:
        raise ParseError(f"bad hop range *{lo}..{hi}")
    return EdgePattern(var, labels, direction, lo, hi)




# -- tokenizer -----------------------------------------------------------------

_TERMINALS = {
    **COMMON,
    **{k: keyword(k) for k in (
        "AND AS ASC BY DESC FALSE IN INTERVAL IS LIKE LIMIT MATCH NOT NOW NULL ORDER RETURN "
        "TRUE WHERE").split()},
    "SIMILARITY": keyword("SIMILARITY", "similarity"),
    "COLON": literal("COLON", ":"),
    "LBRACE": literal("LBRACE", "{"),
    "RBRACE": literal("RBRACE", "}"),
    "EDGE_OPEN": literal("EDGE_OPEN", "-["),
    "EDGE_IN_OPEN": literal("EDGE_IN_OPEN", "<-["),
    "EDGE_OUT_CLOSE": literal("EDGE_OUT_CLOSE", "]->"),
    "EDGE_CLOSE": literal("EDGE_CLOSE", "]-"),
    "RANGE": literal("RANGE", ".."),
}
_lexer = Lexer(_TERMINALS, ParseError)


# What the state after each kind of token accepts (LALR(1) lookaheads merged
# over the contexts one core occurs in, as in the VelesQL parser).
_VALUE = _acc("FALSE NOW NULL PARAM SIGNED_NUMBER STRING TRUE")
_AFTER_VALUE = _acc("AND COMMA RBRACE RETURN RPAR")
_COND = _acc("NAME SIMILARITY")
_AFTER_COND = _acc("AND RETURN")
_EDGE_END = _acc("EDGE_OUT_CLOSE EDGE_CLOSE")
_AFTER_LABEL = _acc("COLON LBRACE RPAR STAR") | _EDGE_END
_AFTER_REF_NAME = _acc("$END AS ASC CMP_OP COMMA DESC DOT IN IS LIKE LIMIT ORDER")
_AFTER_RET = _acc("$END AS COMMA LIMIT ORDER")
_AFTER_ORDER_ITEM = _acc("$END COMMA LIMIT")


class _Parser(TokenStream):
    """Recursive descent over :data:`GRAMMAR`; one instance per text."""

    def __init__(self, text: str):
        super().__init__(_lexer, text, _acc("MATCH"), "MATCH")
        self.cb = _ToMatch()

    def start(self):
        cb = self.cb
        self.expect("MATCH", _acc("LPAR"))
        parts = [self.pattern()]
        if self.peek() == "WHERE":
            self.take(_COND)
            conds = [self.cond()]
            while self.peek() == "AND":
                self.take(_COND)
                conds.append(self.cond())
            parts.append(cb.where_part(*conds))
        self.expect("RETURN", _COND)
        items = [self.ret_item()]
        while self.peek() == "COMMA":
            self.take(_COND)
            items.append(self.ret_item())
        parts.append(cb.ret_items(*items))
        if self.peek() == "ORDER":
            self.take(_acc("BY"))
            self.expect("BY", _acc("NAME"))
            items = [self.order_item()]
            while self.peek() == "COMMA":
                self.take(_acc("NAME"))
                items.append(self.order_item())
            parts.append(cb.order_part(*items))
        if self.peek() == "LIMIT":
            self.take(_acc("INT"))
            parts.append(cb.limit_part(self.expect("INT", _acc("$END"))))
        if self.peek() != END:
            raise self.fail()
        return cb.match_stmt(*parts)

    # -- pattern ----------------------------------------------------------------

    def pattern(self):
        parts = [self.node_pat()]
        while self.peek() in ("EDGE_OPEN", "EDGE_IN_OPEN"):
            parts.append(self.edge_pat())
            parts.append(self.node_pat())
        return self.cb.pattern(*parts)

    def node_pat(self):
        self.expect("LPAR", _acc("COLON LBRACE NAME RPAR"))
        parts = []
        if self.peek() == "NAME":
            parts.append(self.take(_acc("COLON LBRACE RPAR")))
        while self.peek() == "COLON":
            parts.append(self.label_spec())
        if self.peek() == "LBRACE":
            self.take(_acc("NAME"))
            pairs = [self.prop_pair()]
            while self.peek() == "COMMA":
                self.take(_acc("NAME"))
                pairs.append(self.prop_pair())
            self.expect("RBRACE", _acc("RPAR"))
            parts.append(self.cb.prop_map(*pairs))
        self.expect("RPAR", _acc("RETURN WHERE EDGE_OPEN EDGE_IN_OPEN"))
        return self.cb.node_pat(*parts)

    def label_spec(self):
        self.take(_acc("NAME"))
        return self.cb.label_spec(self.expect("NAME", _AFTER_LABEL))

    def prop_pair(self):
        name = self.expect("NAME", _acc("COLON"))
        self.expect("COLON", _VALUE)
        return self.cb.prop_pair(name, self.value())

    def edge_pat(self):
        cb = self.cb
        if self.peek() == "EDGE_IN_OPEN":
            self.take(_acc("COLON NAME STAR EDGE_CLOSE"))
            body = self.edge_body()
            self.expect("EDGE_CLOSE", _acc("LPAR"))
            return cb.edge_in(body)
        self.take(_acc("COLON NAME STAR") | _EDGE_END)
        body = self.edge_body()
        if self.peek() == "EDGE_OUT_CLOSE":
            self.take(_acc("LPAR"))
            return cb.edge_out(body)
        self.expect("EDGE_CLOSE", _acc("LPAR"))
        return cb.edge_both(body)

    def edge_body(self):
        parts = []
        if self.peek() == "NAME":
            parts.append(self.take(_acc("COLON STAR") | _EDGE_END))
        while self.peek() == "COLON":
            parts.append(self.label_spec())
        if self.peek() == "STAR":
            self.take(_acc("INT") | _EDGE_END)
            if self.peek() != "INT":
                parts.append(self.cb.hops())
            else:
                lo = self.take(_EDGE_END | {"RANGE"})
                if self.peek() == "RANGE":
                    self.take(_acc("INT"))
                    parts.append(self.cb.hops(lo, self.expect("INT", _EDGE_END)))
                else:
                    parts.append(self.cb.hops(lo))
        return self.cb.edge_body(*parts)

    # -- conditions and projections ---------------------------------------------

    def similarity(self, after: frozenset):
        """``similarity ( NAME , value )``: ``(var, vector)``."""
        self.take(_acc("LPAR"))
        self.expect("LPAR", _acc("NAME"))
        var = self.expect("NAME", _acc("COMMA"))
        self.expect("COMMA", _VALUE)
        vec = self.value()
        self.expect("RPAR", after)
        return var, vec

    def field_ref(self, first: str):
        """``NAME ("." NAME)+`` after its first name."""
        names = [first]
        self.expect("DOT", _acc("NAME"))
        names.append(self.expect("NAME", _AFTER_REF_NAME))
        while self.peek() == "DOT":
            self.take(_acc("NAME"))
            names.append(self.expect("NAME", _AFTER_REF_NAME))
        return self.cb.field_ref(*names)

    def cond(self):
        cb = self.cb
        if self.peek() == "SIMILARITY":
            var, vec = self.similarity(_acc("CMP_OP"))
            op = self.expect("CMP_OP", _VALUE)
            return cb.sim_cond(var, vec, op, self.value())
        ref = self.field_ref(self.expect("NAME", _acc("DOT")))
        k = self.peek()
        if k == "CMP_OP":
            op = self.take(_VALUE)
            return cb.cmp_cond(ref, op, self.value())
        if k == "IN":
            self.take(_acc("LPAR"))
            self.expect("LPAR", _VALUE)
            vals = [self.value()]
            while self.peek() == "COMMA":
                self.take(_VALUE)
                vals.append(self.value())
            self.expect("RPAR", _AFTER_COND)
            return cb.in_cond(ref, *vals)
        if k == "LIKE":
            self.take(_VALUE)
            return cb.like_cond(ref, self.value())
        if k == "IS":
            self.take(_acc("NOT NULL"))
            if self.peek() == "NOT":
                self.take(_acc("NULL"))
                self.expect("NULL", _AFTER_COND)
                return cb.notnull_cond(ref)
            self.expect("NULL", _AFTER_COND)
            return cb.null_cond(ref)
        raise self.fail()

    def ret_item(self):
        cb = self.cb
        if self.peek() == "SIMILARITY":
            expr = cb.ret_sim(*self.similarity(_AFTER_RET))
        else:
            name = self.expect("NAME", _AFTER_RET | {"DOT"})
            expr = cb.ret_field(self.field_ref(name)) if self.peek() == "DOT" else cb.ret_var(name)
        if self.peek() == "AS":
            self.take(_acc("NAME"))
            return cb.ret_item(expr, self.expect("NAME", _acc("$END COMMA LIMIT ORDER")))
        return cb.ret_item(expr)

    def order_item(self):
        cb = self.cb
        name = self.expect("NAME", _AFTER_ORDER_ITEM | {"ASC", "DESC", "DOT"})
        expr = self.field_ref(name) if self.peek() == "DOT" else name
        k = self.peek()
        if k in ("ASC", "DESC"):
            self.take(_AFTER_ORDER_ITEM)
            return cb.order_item(expr, cb.asc() if k == "ASC" else cb.desc())
        return cb.order_item(expr)

    def value(self):
        cb = self.cb
        k = self.peek()
        if k == "STRING":
            return cb.str_(self.take(_AFTER_VALUE))
        if k == "SIGNED_NUMBER":
            return cb.num(self.take(_AFTER_VALUE))
        if k == "PARAM":
            return cb.param(self.take(_AFTER_VALUE))
        if k in ("TRUE", "FALSE", "NULL"):
            self.take(_AFTER_VALUE)
            return {"TRUE": cb.true_, "FALSE": cb.false_, "NULL": cb.null_}[k]()
        if k == "NOW":
            self.take(_acc("LPAR"))
            self.expect("LPAR", _acc("RPAR"))
            self.expect("RPAR", _AFTER_VALUE | {"PLUSMINUS"})
            if self.peek() != "PLUSMINUS":
                return cb.now_expr()
            sign = self.take(_acc("INTERVAL"))
            self.expect("INTERVAL", _acc("STRING"))
            return cb.now_expr(sign, self.expect("STRING", _AFTER_VALUE))
        raise self.fail()


def parse_match(text: str) -> MatchStatement:
    try:
        return _Parser(text).start()
    except ParseError:
        raise
    except Exception as e:
        raise ParseError(f"MATCH syntax error: {e}") from e
