"""Interactive SQL console.

Counterpart of trino_tpu/cli.py. Analogue of client/trino-cli
(Trino.java:36, Console.java:80 — jline REPL over the statement
protocol; SURVEY.md §2.11). Two modes:

  python -m trino_tpu_torch.cli --server http://host:port     remote protocol
  python -m trino_tpu_torch.cli --catalog tpch --schema tiny  in-process engine

The in-process engine runs on the CUDA card and fails without one;
`--device cpu` runs it on the CPU.

`--execute "sql"` runs one statement and exits (the CLI batch mode).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence


def format_table(column_names: Sequence[str], rows: Sequence[Sequence]) -> str:
    """ASCII table like the reference CLI's aligned output."""
    cols = [str(c) for c in column_names]
    rendered = [
        ["NULL" if v is None else str(v) for v in row] for row in rows
    ]
    widths = [len(c) for c in cols]
    for row in rendered:
        for i, v in enumerate(row):
            widths[i] = max(widths[i], len(v))
    sep = "-+-".join("-" * w for w in widths)
    out = [
        " | ".join(c.ljust(w) for c, w in zip(cols, widths)),
        sep,
    ]
    for row in rendered:
        out.append(" | ".join(v.ljust(w) for v, w in zip(row, widths)))
    out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


class _RemoteBackend:
    def __init__(self, uri: str):
        from trino_tpu_torch.client import Client

        self._client = Client(uri)

    def execute(self, sql: str):
        r = self._client.execute(sql)
        return r.column_names, r.rows


class _LocalBackend:
    def __init__(self, catalog: str, schema: str, device=None):
        from trino_tpu_torch.connectors.blackhole import create_blackhole_connector
        from trino_tpu_torch.connectors.memory import create_memory_connector
        from trino_tpu_torch.connectors.tpcds import create_tpcds_connector
        from trino_tpu_torch.connectors.tpch import create_tpch_connector
        from trino_tpu_torch.engine import LocalQueryRunner, Session

        self._runner = LocalQueryRunner(
            Session(catalog=catalog, schema=schema), device=device
        )
        self._runner.register_catalog("tpch", create_tpch_connector())
        self._runner.register_catalog("tpcds", create_tpcds_connector())
        self._runner.register_catalog("memory", create_memory_connector())
        self._runner.register_catalog("blackhole", create_blackhole_connector())

    def execute(self, sql: str):
        r = self._runner.execute(sql)
        return r.column_names, r.rows


def run_statement(backend, sql: str, out) -> bool:
    try:
        names, rows = backend.execute(sql)
        print(format_table(names, rows), file=out)
        return True
    except Exception as e:
        print(f"Query failed: {e}", file=out)
        return False


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu")
    ap.add_argument("--server", help="coordinator URI (remote mode)")
    ap.add_argument("--catalog", default="tpch")
    ap.add_argument("--schema", default="tiny")
    ap.add_argument("--execute", "-e", help="run one statement and exit")
    ap.add_argument("--device", default=None,
                    help="in-process engine's device (default: the CUDA card)")
    args = ap.parse_args(argv)

    backend = (
        _RemoteBackend(args.server)
        if args.server
        else _LocalBackend(args.catalog, args.schema, args.device)
    )
    if args.execute:
        ok = run_statement(backend, args.execute, sys.stdout)
        return 0 if ok else 1

    # REPL: statements end with ';'
    buffer: List[str] = []
    print("trino-tpu> ", end="", flush=True)
    for line in sys.stdin:
        buffer.append(line)
        text = "".join(buffer).strip()
        if text.lower() in ("quit", "exit", "quit;", "exit;"):
            break
        if text.endswith(";"):
            buffer = []
            if text.strip("; \n"):
                run_statement(backend, text, sys.stdout)
        print("trino-tpu> ", end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
