"""VelesQL: so far only the query planner (``planner.py``).

The parser, AST, executor, cache and EXPLAIN modules of
``velesdb_tpu/velesql/`` are not ported yet (ROADMAP.md, queue 5), so this
package imports nothing on its own.
"""
