"""CLI: REPL, query, info/list/show, JSONL import/export, graph ops, serve.

The port of ``velesdb_tpu/cli.py`` (counterpart of ``velesdb-cli``,
``main.rs:85-294``: clap commands ``repl`` / ``query`` / ``info`` / ``list`` /
``show`` / ``export`` / ``import`` + graph commands; rustyline REPL
``repl.rs:56``), argparse + readline instead. The global ``--device``
("cuda" unless ``cpu`` is asked for) is where the database, and the server
``serve`` starts, put their collections::

    python -m velesdb_tpu_torch.cli --path DIR [--device cpu] SUBCOMMAND ...
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from velesdb_tpu_torch.database import Database

__all__ = ["main"]


def _print_rows(rows, as_json: bool) -> None:
    if as_json:
        print(json.dumps(rows, indent=2, default=_jsonify))
        return
    for row in rows:
        print(json.dumps(row, default=_jsonify))


def _jsonify(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def cmd_list(db: Database, args) -> int:
    for name in db.list_collections():
        info = db.get_collection(name).info()
        print(
            f"{name}  dim={info['dim']} metric={info['metric']} "
            f"mode={info['storage_mode']} count={info['count']}"
        )
    return 0


def cmd_info(db: Database, args) -> int:
    print(json.dumps(db.get_collection(args.collection).info(), indent=2))
    return 0


def cmd_create(db: Database, args) -> int:
    col = db.create_collection(
        args.collection, args.dim, metric=args.metric, storage_mode=args.mode
    )
    print(json.dumps(col.info(), indent=2))
    return 0


def cmd_show(db: Database, args) -> int:
    col = db.get_collection(args.collection)
    got = col.get(args.id)
    if got is None:
        print(f"point {args.id} not found", file=sys.stderr)
        return 1
    vec, payload = got
    out = {"id": args.id, "payload": payload}
    if args.vector:
        out["vector"] = np.asarray(vec).tolist()
    print(json.dumps(out, indent=2, default=_jsonify))
    return 0


def cmd_query(db: Database, args) -> int:
    params = json.loads(args.params) if args.params else None
    text = args.velesql.strip()
    if text.upper().startswith("MATCH"):
        if not args.collection:
            print("MATCH queries need --collection", file=sys.stderr)
            return 1
        rows = db.match_query(args.collection, text, params)
    elif text.upper().startswith("EXPLAIN"):
        print(db.explain_query(text[len("EXPLAIN") :].strip()).render())
        return 0
    else:
        rows = db.query(text, params)
    _print_rows(rows, args.json)
    return 0


def cmd_import(db: Database, args) -> int:
    """JSONL import: ``{"id", "vector", "payload"}`` per line (``import`` cmd)."""
    col = db.get_collection(args.collection)
    ids, vecs, payloads = [], [], []
    src = open(args.file) if args.file != "-" else sys.stdin
    n = 0
    try:
        for line in src:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            ids.append(int(rec["id"]))
            vecs.append(rec["vector"])
            payloads.append(rec.get("payload"))
            if len(ids) >= args.batch:
                col.upsert_bulk(ids, np.asarray(vecs, np.float32), payloads)
                n += len(ids)
                ids, vecs, payloads = [], [], []
        if ids:
            col.upsert_bulk(ids, np.asarray(vecs, np.float32), payloads)
            n += len(ids)
    finally:
        if src is not sys.stdin:
            src.close()
    col.flush()
    print(f"imported {n} points into {args.collection}")
    return 0


def cmd_export(db: Database, args) -> int:
    col = db.get_collection(args.collection)
    dst = open(args.file, "w") if args.file != "-" else sys.stdout
    slot_ids, valid = col.vectors.occupancy()
    n = 0
    try:
        for slot in np.flatnonzero(valid):
            vid = int(slot_ids[slot])
            got = col.get(vid)
            if got is None:
                continue
            vec, payload = got
            dst.write(
                json.dumps(
                    {"id": vid, "vector": np.asarray(vec).tolist(), "payload": payload},
                    default=_jsonify,
                )
                + "\n"
            )
            n += 1
    finally:
        if dst is not sys.stdout:
            dst.close()
    print(f"exported {n} points", file=sys.stderr)
    return 0


def cmd_edge(db: Database, args) -> int:
    col = db.get_collection(args.collection)
    props = json.loads(args.properties) if args.properties else None
    eid = col.add_edge(args.src, args.dst, args.label, props)
    print(json.dumps({"edge_id": eid}))
    return 0


def cmd_traverse(db: Database, args) -> int:
    col = db.get_collection(args.collection)
    results = col.traverse(
        args.start, max_depth=args.depth, direction=args.direction, label=args.label
    )
    for node, depth, path in results:
        print(json.dumps({"id": node, "depth": depth, "path_edges": path}))
    return 0


def cmd_index(db: Database, args) -> int:
    """Show/configure the search engine and trigger rebuilds (the CLI face
    of the round-2 planner-selectable engines + incremental delta)."""
    col = db.get_collection(args.collection)
    if args.kind:
        if args.kind not in ("auto", "exact", "graph", "ivf"):
            raise ValueError(f"unknown index kind {args.kind!r}")
        col.index_kind = args.kind
    if args.delta_fraction is not None:
        if not 0.0 < args.delta_fraction <= 1.0:
            raise ValueError("delta fraction must be in (0, 1]")
        col.delta_rebuild_fraction = args.delta_fraction
    if args.rebuild:
        col.refresh_device()
        if args.rebuild == "graph":
            if col.ann is None:
                raise ValueError("collection does not support a graph index")
            col.ann.invalidate()
            col._ensure_ann(force=True)
        else:
            if col.ivf is not None:
                col.ivf.invalidate()
            col._ensure_ivf()
    print(
        json.dumps(
            {
                "index_kind": col.index_kind,
                "ann_min_rows": col.ann_min_rows,
                "delta_rebuild_fraction": col.delta_rebuild_fraction,
                "graph_built": col.ann is not None
                and not col.ann.dirty
                and col.ann.n_pad > 0,
                "ivf_built": col.ivf is not None and not col.ivf.dirty,
                "delta_rows": {k: len(v) for k, v in col._stale.items()},
            },
            indent=2,
        )
    )
    return 0


def cmd_migrate(db: Database, args) -> int:
    """Migrate from an external source (``velesdb-migrate`` CLI analog);
    ``--wizard`` walks through source/options interactively."""
    from velesdb_tpu_torch.migrate import CONNECTORS, MigrationPipeline

    if args.wizard:
        print("velesdb-tpu-torch migration wizard")
        print(f"sources: {', '.join(sorted(CONNECTORS))}")
        args.source = input("source type> ").strip()
        args.location = input("location (path or URL)> ").strip()
        args.source_collection = (
            input("source collection/table (blank if n/a)> ").strip() or None
        )
        args.collection = input("target collection> ").strip()
        dim_s = input("target dim (blank if target exists)> ").strip()
        args.dim = int(dim_s) if dim_s else None
    if args.source not in CONNECTORS:
        print(f"unknown source {args.source!r}; have {sorted(CONNECTORS)}",
              file=sys.stderr)
        return 1
    cls = CONNECTORS[args.source]
    if args.source in ("qdrant", "chroma"):
        if not args.source_collection:
            print("--source-collection required for service sources", file=sys.stderr)
            return 1
        connector = cls(args.location, args.source_collection)
    elif args.source == "pgvector":
        connector = cls(args.location, args.source_collection or "items")
    else:
        connector = cls(args.location)
    try:
        coll = db.get_collection(args.collection)
    except KeyError:
        if args.dim is None:
            print("target collection missing: pass --dim to create", file=sys.stderr)
            return 1
        coll = db.create_collection(args.collection, args.dim)
    report = MigrationPipeline(
        connector,
        coll,
        batch_size=args.batch,
        dry_run=args.dry_run,
        on_progress=lambda n: print(f"  {n} migrated...", file=sys.stderr),
    ).run()
    print(json.dumps(dict(report)))
    return 0 if report.failed == 0 else 1


def cmd_serve(db: Database, args) -> int:
    from velesdb_tpu_torch.server.app import serve

    db.close()  # server opens its own handle
    serve(args.path, args.host, args.port, device=args.device)
    return 0


def cmd_repl(db: Database, args) -> int:
    """Interactive REPL (``repl.rs:56``): VelesQL + MATCH + meta commands."""
    try:
        import readline  # noqa: F401  (history/line editing)
    except ImportError:
        pass
    current: str | None = args.collection
    print("velesdb-tpu-torch REPL — \\h for help, \\q to quit")
    while True:
        try:
            prompt = f"velesdb[{current or ''}]> "
            line = input(prompt).strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line:
            continue
        try:
            if line in ("\\q", "exit", "quit"):
                return 0
            if line == "\\h":
                print(
                    "\\l           list collections\n"
                    "\\u NAME      use collection (for MATCH)\n"
                    "\\i NAME      collection info\n"
                    "\\q           quit\n"
                    "SELECT ...   VelesQL query\n"
                    "MATCH ...    graph query (against \\u collection)\n"
                    "EXPLAIN ...  show query plan"
                )
                continue
            if line == "\\l":
                for name in db.list_collections():
                    print(name)
                continue
            if line.startswith("\\u "):
                current = line[3:].strip()
                db.get_collection(current)  # validate
                continue
            if line.startswith("\\i "):
                print(json.dumps(db.get_collection(line[3:].strip()).info(), indent=2))
                continue
            upper = line.upper()
            if upper.startswith("EXPLAIN"):
                print(db.explain_query(line[len("EXPLAIN") :].strip()).render())
            elif upper.startswith("MATCH"):
                if not current:
                    print("no collection selected: \\u NAME first")
                    continue
                _print_rows(db.match_query(current, line), False)
            else:
                _print_rows(db.query(line), False)
        except Exception as e:  # REPL never dies on user errors
            print(f"error: {e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="velesdb-torch", description="velesdb_tpu_torch CLI")
    p.add_argument("--path", default=".", help="database directory")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list collections")

    sp = sub.add_parser("info", help="collection info")
    sp.add_argument("collection")

    sp = sub.add_parser("create", help="create a collection")
    sp.add_argument("collection")
    sp.add_argument("--dim", type=int, required=True)
    sp.add_argument("--metric", default="cosine")
    sp.add_argument("--mode", default="full")

    sp = sub.add_parser("show", help="show one point")
    sp.add_argument("collection")
    sp.add_argument("id", type=int)
    sp.add_argument("--vector", action="store_true")

    sp = sub.add_parser("query", help="run VelesQL / MATCH / EXPLAIN")
    sp.add_argument("velesql")
    sp.add_argument("--params", help="JSON parameter object")
    sp.add_argument("--collection", help="collection for MATCH queries")
    sp.add_argument("--json", action="store_true", help="pretty JSON array output")

    sp = sub.add_parser("import", help="import JSONL points")
    sp.add_argument("collection")
    sp.add_argument("file", help="JSONL path or - for stdin")
    sp.add_argument("--batch", type=int, default=1024)

    sp = sub.add_parser("export", help="export points as JSONL")
    sp.add_argument("collection")
    sp.add_argument("file", help="output path or - for stdout")

    sp = sub.add_parser("edge", help="add a graph edge")
    sp.add_argument("collection")
    sp.add_argument("src", type=int)
    sp.add_argument("dst", type=int)
    sp.add_argument("label")
    sp.add_argument("--properties", help="JSON properties")

    sp = sub.add_parser("traverse", help="BFS traversal")
    sp.add_argument("collection")
    sp.add_argument("start", type=int)
    sp.add_argument("--depth", type=int, default=3)
    sp.add_argument("--direction", default="out")
    sp.add_argument("--label")

    sp = sub.add_parser("index", help="show/configure the search engine")
    sp.add_argument("collection")
    sp.add_argument("--kind", help="auto | exact | graph | ivf")
    sp.add_argument("--delta-fraction", type=float, dest="delta_fraction",
                    help="delta budget before a full ANN rebuild (0, 1]")
    sp.add_argument("--rebuild", choices=["graph", "ivf"],
                    help="force a full index rebuild now")

    sp = sub.add_parser("migrate", help="import from an external vector DB / file")
    sp.add_argument("--source", help="jsonl|json|csv|numpy|qdrant|chroma|pgvector")
    sp.add_argument("--location", help="file path, base URL, or DSN")
    sp.add_argument("--source-collection", help="source collection/table name")
    sp.add_argument("--collection", help="target collection")
    sp.add_argument("--dim", type=int, help="dim when creating the target")
    sp.add_argument("--batch", type=int, default=512)
    sp.add_argument("--dry-run", action="store_true")
    sp.add_argument("--wizard", action="store_true", help="interactive prompts")

    sp = sub.add_parser("serve", help="start the REST server")
    sp.add_argument("--host", default=None)
    sp.add_argument("--port", type=int, default=None)

    sp = sub.add_parser("repl", help="interactive REPL")
    sp.add_argument("--collection", help="initial collection for MATCH")

    args = p.parse_args(argv)
    db = Database.open(args.path, device=args.device)
    try:
        handler = {
            "list": cmd_list,
            "info": cmd_info,
            "create": cmd_create,
            "show": cmd_show,
            "query": cmd_query,
            "import": cmd_import,
            "export": cmd_export,
            "edge": cmd_edge,
            "traverse": cmd_traverse,
            "index": cmd_index,
            "migrate": cmd_migrate,
            "serve": cmd_serve,
            "repl": cmd_repl,
        }[args.cmd]
        return handler(db, args)
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if args.cmd != "serve":
            db.close()


if __name__ == "__main__":
    sys.exit(main())
