"""In-process query engine: SQL text in, rows out.

Counterpart of trino_tpu/engine.py (LocalQueryRunner: plan and execute
SQL fully in-process with real operators). The parse -> analyze ->
optimize chain is the reference's host code (copied under sql/); the
physical plan runs on one torch device.

Device selection: `LocalQueryRunner(session, device=None)` runs on the
CUDA card and raises when there is none; the CPU is used only when the
caller passes device="cpu". There is no fallback between the two.

Not ported yet (ROADMAP §1 items 8 and 13): DDL/DML,
transactions, prepared statements, EXPLAIN, SHOW, the plan cache, and
the resident, adaptive, recovery, serving, compile-cache, tracing and
metrics tiers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.spi import CatalogManager, Connector
from trino_tpu_torch.exec import CollectorSink, Driver, Pipeline
from trino_tpu_torch.sql import ast
from trino_tpu_torch.sql.analyzer import (
    Analyzer,
    set_session_info,
    set_session_zone,
)
from trino_tpu_torch.sql.local_planner import LocalPlanner
from trino_tpu_torch.sql.optimizer import canonicalize_tstz_keys, optimize
from trino_tpu_torch.sql.parser import parse


@dataclasses.dataclass
class Session:
    """Per-query context: the fields the ported query path reads.
    `batch_rows` counts source rows per scan chunk (orders for the
    lineitem generator), as in the reference."""

    catalog: str = "tpch"
    schema: str = "tiny"
    user: str = "user"
    timezone: str = "UTC"
    batch_rows: int = 1 << 20
    target_splits: int = 1
    enable_optimizer: bool = True
    join_reordering_strategy: str = "automatic"
    enable_pushdown: bool = True
    # the join-project route (ops/mxu_join.py) for a grouped aggregate
    # over a high-fanout inner equi-join, and its work threshold
    mxu_join_enabled: bool = False
    mxu_join_min_work: float = 16.0


@dataclasses.dataclass
class MaterializedResult:
    rows: List[list]
    column_names: List[str]
    column_types: List[T.DataType]


def resolve_device(device=None) -> torch.device:
    """None -> the CUDA card (raises when there is none); anything else
    is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: LocalQueryRunner runs on the card; pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class LocalQueryRunner:
    def __init__(self, session: Optional[Session] = None, device=None):
        self.session = session or Session()
        self.device = resolve_device(device)
        self.catalogs = CatalogManager()

    def register_catalog(self, name: str, connector: Connector) -> None:
        self.catalogs.register(name, connector)

    def execute(self, sql: str) -> MaterializedResult:
        stmt = parse(sql)
        if not isinstance(stmt, ast.Query):
            raise NotImplementedError(
                f"{type(stmt).__name__}: trino_tpu_torch runs SELECT only so far"
                " (the statement surface: ROADMAP §1 item 8)"
            )
        output = self._analyze(stmt)
        planner = LocalPlanner(
            self.catalogs, self.device,
            batch_rows=self.session.batch_rows,
            target_splits=self.session.target_splits,
            mxu_join=self.session.mxu_join_enabled,
            mxu_join_min_work=self.session.mxu_join_min_work,
        )
        physical = planner.plan(output)
        ctx: dict = {}
        sink = CollectorSink()
        pipelines, chain = physical.instantiate(ctx)
        # build pipelines first, in plan order: each fills the bridge
        # that a later pipeline or the main chain probes
        for ops in pipelines:
            Driver(Pipeline(ops)).run()
        Driver(Pipeline(chain + [sink])).run()
        rows = sink.rows()
        for flag, msg in ctx.get("deferred_checks", ()):
            if bool(flag):
                raise RuntimeError(msg)
        return MaterializedResult(
            rows, list(output.names), [f.type for f in output.fields]
        )

    def _analyze(self, q: ast.Query):
        set_session_zone(self.session.timezone)
        set_session_info(
            self.session.catalog, self.session.schema, self.session.user
        )
        analyzer = Analyzer(
            self.catalogs, self.session.catalog, self.session.schema
        )
        root = optimize(analyzer.plan(q), self.catalogs, self.session)
        return canonicalize_tstz_keys(root)
