"""The port's VelesQL and MATCH parsers against the JAX package's (lark) ones.

Inputs: every query string of the reference's VelesQL and graph tests (read
from their sources with ``ast``), cases for the join and fusion forms, the
contextual-keyword cases, and 2,400 seeded mutants of each grammar's strings
made with ``tests/test_fuzz.py``'s ``_mutate``. Each input must parse to the
same statement in both packages, compared structurally (class name and
fields, recursively; ``_Now`` by its offset, ``_Interval`` by its seconds),
or raise ``ParseError`` in both.
"""

import ast
import dataclasses
import os
import random

import pytest

from test_fuzz import SEED_QUERIES, _mutate
from velesdb_tpu.graph import match_parser as ref_match
from velesdb_tpu.velesql import parser as ref_sql
from velesdb_tpu_torch.graph import match_parser as port_match
from velesdb_tpu_torch.velesql import parser as port_sql

HERE = os.path.dirname(os.path.abspath(__file__))

# words the grammar reads as a name wherever it does not accept them as a
# keyword (the contextual lexer): the reference parses each of these
CONTEXTUAL = [
    "SELECT * FROM t WHERE limit = 5",
    "SELECT limit FROM t",
    "SELECT * FROM select",
]
EXTRA_SQL = [
    "SELECT * FROM a INNER JOIN b ON a.x = b.y",
    "SELECT * FROM a LEFT OUTER JOIN b ON a.x = b.y RIGHT OUTER JOIN c USING (z) "
    "FULL OUTER JOIN d ON a.q == d.q",
    "SELECT * FROM t WHERE v NEAR_FUSED [$a, $b] USING FUSION rrf(k = 60) LIMIT 5",
    "SELECT * FROM t WHERE v NEAR_FUSED [$a, [1, 2.5, -3e2]] USING FUSION weighted(0.7, 0.3)",
    "SELECT * FROM t WHERE v NEAR_FUSED [$a, $b] USING FUSION rrf(k = 'x', 0.5) AND x = 1",
    "SELECT limit FROM t WHERE limit = 5 ORDER BY limit DESC LIMIT 3",
    "SELECT * FROM select WHERE from IS NOT NULL AND \"select\" NOT IN (1, 2) OFFSET 1 "
    "WITH (ef_search = 32, quality = 'fast')",
    "SELECT COUNT(*) AS n, AVG(price) FROM t WHERE x BETWEEN 1 AND 5 AND NOT "
    "(y ILIKE '%a%' OR z NOT LIKE 'b') GROUP BY text HAVING COUNT(*) > 1",
    "SELECT * FROM t WHERE ts > NOW() AND ts < NOW() + INTERVAL '2 hours' AND d > INTERVAL '1 day'",
    "SELECT * FROM o WHERE EXISTS (SELECT * FROM c WHERE c.id = o.cid) AND "
    "(SELECT COUNT(*) FROM c) = 0 AND total > (SELECT AVG(total) FROM o)",
    "SELECT * FROM t WHERE similarity(v, $q) >= 0.5 AND NOT similarity(v, $q) > 0.9 AND "
    "body MATCH $txt UNION ALL SELECT * FROM u EXCEPT SELECT * FROM w INTERSECT SELECT * FROM z",
    "SELECT a ASb FROM t WHERE x = 5 LIMIT10",
    "SELECT a ASCb FROM t",
    "SELECT * FROM t WHERE x ISNOTNULL AND y NOTIN (1)",
]
EXTRA_MATCH = [
    "MATCH (a:P)-[:K]->(b) WHERE b.ts > NOW() - INTERVAL '3 days' AND b.x IS NULL AND "
    "b.y IS NOT NULL AND b.z IN (1, 'a', TRUE, NULL) AND b.w LIKE '%q%' RETURN b "
    "ORDER BY b.x ASC, c DESC LIMIT 3",
    "MATCH (a)<-[r:R*2]-(b {k: NOW() + INTERVAL '1 hour', j: $p, f: FALSE})-[*]-(c)"
    "-[e*1..4]->(d) RETURN similarity(d, $v) AS s, a.b.c, r",
    "MATCH (a) WHERE similarity(a, $q) > 0.5 RETURN a",
    "MATCH (a)-[*3..1]->(b) RETURN b",
]


def _strings(files, keep):
    out = []
    for name in files:
        with open(os.path.join(HERE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                if keep(node.value) and node.value not in out:
                    out.append(node.value)
    return out


SQL = _strings(
    ["test_velesql.py", "test_velesql_join.py", "test_subquery_correlated.py", "test_fuzz.py",
     "test_e2e_complete.py"],
    lambda s: "SELECT" in s.upper() and "FROM" in s.upper(),
) + CONTEXTUAL + EXTRA_SQL
MATCHES = _strings(
    ["test_graph.py", "test_features.py", "test_e2e_complete.py"],
    lambda s: s.lstrip().upper().startswith("MATCH"),
) + EXTRA_MATCH


def _norm(x):
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                tuple((f.name, _norm(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if type(x).__name__ == "_Now":
        return ("_Now", x.offset)
    if type(x).__name__ == "_Interval":
        return ("_Interval", x.seconds)
    if isinstance(x, dict):
        return ("dict", tuple((k, _norm(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_norm(v) for v in x))
    assert isinstance(x, (str, int, float, bool, type(None))), type(x)
    return (type(x).__name__, x)


def _outcome(fn, error, text):
    try:
        return _norm(fn(text))
    except error:
        return "ParseError"


def _same_sql(text):
    want = _outcome(ref_sql.parse, ref_sql.ParseError, text)
    got = _outcome(port_sql.parse, port_sql.ParseError, text)
    assert got == want, text
    return want != "ParseError"


def _same_match(text):
    want = _outcome(ref_match.parse_match, ref_sql.ParseError, text)
    got = _outcome(port_match.parse_match, port_sql.ParseError, text)
    assert got == want, text
    return want != "ParseError"


def test_corpus_sizes():
    assert len(SQL) >= 90 and len(MATCHES) >= 20


@pytest.mark.parametrize("text", SQL)
def test_parse_matches_reference(text):
    _same_sql(text)


@pytest.mark.parametrize("text", MATCHES)
def test_parse_match_matches_reference(text):
    _same_match(text)


def _mutants(corpus, same, seed, n):
    """``n`` mutants (1-3 ``_mutate`` steps each), checked as they are made;
    mutants that parse join the pool, as in the fuzz test."""
    rng = random.Random(seed)
    pool = list(corpus)
    parsed = 0
    for _ in range(n):
        text = rng.choice(pool)
        for _ in range(rng.randrange(1, 4)):
            text = _mutate(rng, text)
        if same(text):
            parsed += 1
            pool.append(text)
    return parsed


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_parse_mutants_match_reference(seed):
    assert _mutants(SQL, _same_sql, seed, 600) > 10


@pytest.mark.parametrize("seed", [21, 22, 23, 24])
def test_parse_match_mutants_match_reference(seed):
    assert _mutants(MATCHES, _same_match, seed, 600) > 10


@pytest.mark.parametrize("text", CONTEXTUAL)
def test_contextual_keywords_issue_cases(text):
    assert _same_sql(text)


_SQL_KEYWORDS = port_sql._KEYWORDS
_MATCH_KEYWORDS = [k for k in port_match._TERMINALS if port_match._TERMINALS[k].ignorecase]


@pytest.mark.parametrize("kw", _SQL_KEYWORDS)
def test_keyword_read_as_name(kw):
    """Every keyword is a name where the grammar does not accept it: as a
    table, after a dot and after BY (lower case, as users write fields)."""
    k = kw.lower()
    text = f"SELECT t.{k} FROM {k} ORDER BY {k} DESC"
    assert _same_sql(text)
    stmt = port_sql.parse(text).root
    assert stmt.collection == k and stmt.columns[0].expr == f"t.{k}"
    assert stmt.order_by[0].expr == k and stmt.order_by[0].desc


@pytest.mark.parametrize("kw", _MATCH_KEYWORDS)
def test_match_keyword_read_as_name(kw):
    k = kw.lower()
    text = f"MATCH ({k}:{k} {{{k}: 1}})-[{k}:{k}]->(b) RETURN b.{k} AS {k} ORDER BY {k}"
    assert _same_match(text)
    stmt = port_match.parse_match(text)
    assert stmt.nodes[0].var == k and stmt.nodes[0].labels == [k]
    assert stmt.nodes[0].props == {k: 1} and stmt.edges[0].labels == [k]
    assert stmt.returns[0].alias == k and stmt.order_by[0].expr == k


def test_parser_never_crashes_on_mutations():
    rng = random.Random(1234)
    corpus = list(SEED_QUERIES)
    parsed = 0
    for _ in range(800):
        base = rng.choice(corpus)
        text = base
        for _ in range(rng.randrange(1, 4)):
            text = _mutate(rng, text)
        try:
            port_sql.parse(text)
            parsed += 1
            corpus.append(text)  # grammar-valid mutants breed further
        except port_sql.ParseError:
            pass  # the ONLY acceptable failure mode
    assert parsed > 10  # sanity: some mutants still parse
