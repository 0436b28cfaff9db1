"""The system under test: the port's memory connector loaded with the
generated tables, a LocalQueryRunner on the device and a CoordinatorServer
in front of it, all at their default settings. The only module of the
harness that imports the port; from it the harness reads the server's
answers, the runner's query-completed events and the kernel wrappers'
launch counters.
"""

from __future__ import annotations

import re
import sys
import threading
import time
from typing import Dict, List, Tuple

from portbench.data import Table


def _port_type(sql_type: str):
    from trino_tpu_torch import types as T

    m = re.fullmatch(r"decimal\((\d+),(\d+)\)", sql_type)
    if m:
        return T.decimal(int(m.group(1)), int(m.group(2)))
    return {"bigint": T.BIGINT, "integer": T.INTEGER, "date": T.DATE,
            "varchar": T.VARCHAR}[sql_type]


class Completed:
    """A query-completed listener: (monotonic time, sql, wall_s, state)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.events: List[Tuple[float, str, float, str]] = []

    def listener(self):
        from trino_tpu_torch.runtime.events import EventListener

        outer = self

        class _L(EventListener):
            def query_completed(self, event) -> None:
                with outer.lock:
                    outer.events.append((time.monotonic(), event.sql, event.wall_s,
                                         event.state))

        return _L()

    def take(self) -> List[Tuple[float, str, float, str]]:
        with self.lock:
            out, self.events = self.events, []
        return out


class Sut:
    def __init__(self, tables: Dict[str, Table], session: dict, device):
        from trino_tpu_torch.block import Dictionary
        from trino_tpu_torch.connectors.memory import create_memory_connector
        from trino_tpu_torch.connectors.spi import ColumnMetadata
        from trino_tpu_torch.engine import LocalQueryRunner, Session

        conn = create_memory_connector()
        for name, t in tables.items():
            conn.load_table(
                session["schema"], name,
                [ColumnMetadata(c, _port_type(ty)) for c, ty in t.columns],
                [t.arrays[c] for c, _ in t.columns],
                dictionaries=[Dictionary(t.dictionaries[c]) if c in t.dictionaries else None
                              for c, _ in t.columns])
        self.runner = LocalQueryRunner(
            Session(catalog=session["catalog"], schema=session["schema"]), device=device)
        self.runner.register_catalog(session["catalog"], conn)
        self.completed = Completed()
        self.runner.event_listeners.add(self.completed.listener())
        self.server = None

    def start_server(self) -> str:
        """A CoordinatorServer with default settings; returns its URI."""
        from trino_tpu_torch.runtime.server import CoordinatorServer

        self.server = CoordinatorServer(self.runner)
        return self.server.uri

    def stop_server(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None

    @staticmethod
    def launches() -> int:
        """The sum of every kernel wrapper's `launches` counter."""
        seen = {}
        for name, mod in list(sys.modules.items()):
            if not name.startswith("trino_tpu_torch.ops.") or mod is None:
                continue
            for obj in vars(mod).values():
                n = getattr(obj, "launches", None)
                if callable(obj) and isinstance(n, int):
                    seen[id(obj)] = n  # a wrapper imported by several modules counts once
        return sum(seen.values())
