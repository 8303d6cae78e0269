"""VelesQL: SQL dialect over vectors + text + columns (+ graph MATCH).

Parser, AST, executor, cache, EXPLAIN and the query planner
(``planner.py``): the counterpart of ``velesdb_tpu/velesql/``. The parsers
are recursive descent over the reference's grammars and need no parser
library.
"""

from velesdb_tpu_torch.velesql.ast import Query, SelectStatement, SetOp
from velesdb_tpu_torch.velesql.cache import QueryCache
from velesdb_tpu_torch.velesql.executor import QueryError, execute
from velesdb_tpu_torch.velesql.explain import explain
from velesdb_tpu_torch.velesql.parser import ParseError, parse

__all__ = [
    "parse",
    "execute",
    "explain",
    "Query",
    "SelectStatement",
    "SetOp",
    "QueryCache",
    "ParseError",
    "QueryError",
]
