"""In-process query engine: SQL text in, rows out.

Counterpart of trino_tpu/engine.py (LocalQueryRunner: plan and execute
SQL fully in-process with real operators). The parse -> analyze ->
optimize chain is the reference's host code (copied under sql/); the
physical plan runs on one torch device.

Device selection: `LocalQueryRunner(session, device=None)` runs on the
CUDA card and raises when there is none; the CPU is used only when the
caller passes device="cpu". There is no fallback between the two.

The write side (the reference's engine.py:336-529, :687-1205): CREATE
TABLE, CREATE TABLE AS, INSERT, DELETE, UPDATE, MERGE, DROP TABLE and
START TRANSACTION / COMMIT / ROLLBACK. INSERT and CTAS stream a query
into the connector's page sink (TableWriterOperator, through
ScaledWriterSink for autocommit writes); DELETE, UPDATE and MERGE are
read-rewrites whose result batches replace the table's rows. Every
query they run plans on the runner's device.

The statement surface (the reference's engine.py:380-685, :1289-1373):
PREPARE, EXECUTE ... USING (parameters checked by serving/params.py),
DEALLOCATE, EXPLAIN, SET SESSION, SHOW SESSION/FUNCTIONS/SCHEMAS/
TABLES/COLUMNS, access control (security.py) on every statement and
scan, and plan validation (sql/validate.py). A query keyed by its
canonical text (sql/formatter.py), the plan-shaping properties and the
bound dtypes hits the plan cache (serving/plan_cache.py): the cached
physical plan's operators are instantiated afresh and launch the same
kernels, with no parse, analysis or planning. A write drops the cached
plans over its table.

Memory and EXPLAIN ANALYZE (the reference's engine.py:1375-1387,
:1491-1601): with `memory_pool_bytes` set, each execution gets its own
MemoryPool (runtime/memory.py) and a spill directory; the aggregation,
sort and hash build spill into it under pool pressure (a spilled build
finishes as a grace hash join), and the directory is removed when the
execution ends, also when it fails. EXPLAIN ANALYZE runs the plan with
instrumented operators (exec/stats.py) and renders the plan text, then
each pipeline's per-operator rows, batches and device-inclusive walls.

Query events, metrics and spans (the reference's engine.py:1207-1290):
every query runs under a span tree (runtime/tracing.py), counts into
METRICS (runtime/metrics.py) and fires QueryCreated/QueryCompleted to
`event_listeners` (runtime/events.py); EXPLAIN ANALYZE ends with the
engine counters' deltas. A query's compile_count is the programs and
kernel libraries built on its thread (compile/cache.py,
`programs_built`).

The compile regime (the reference's engine.py:1389-1420, :1556-1590):
the session's ShapeStabilizer pads scans onto its capacity ladder,
`warmup_mode` (off | background | block) drives the plan's warmup
entries on all-dead batches before or beside the execution
(compile/warmup.py; the last service is `_last_warmup`), and EXPLAIN
ANALYZE ends with the shape census (expected against observed classes),
`programs_built_this_query=`, the warmup line and the program and
kernel-cache lines. Writes bump the resident tier's table generations
and evict or re-key its pins (resident/); an INSERT into a pinned table
tees its rows through the fast lane's DeltaTap.

The adaptive tier (the reference's engine.py:1330-1348, :1589-1592):
between analysis and physical planning an AdaptiveController
(adaptive/controller.py) materializes shared subtrees and completed
build sides on the runner's device, re-plans the rest when observed rows
diverge from the estimates, and records what it did in
`_last_adaptive_report` (rendered by EXPLAIN ANALYZE); a plan it
transformed embeds data and never enters the plan cache. A write also
drops the mesh checkpoints over its table (recovery/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
import uuid
from typing import Dict, List, Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.config import SYSTEM_PROPERTIES, check_session
from trino_tpu_torch.connectors.spi import CatalogManager, ColumnMetadata, Connector
from trino_tpu_torch.exec import (
    CollectorSink,
    Driver,
    Pipeline,
    ScaledWriterSink,
    TableWriterOperator,
)
from trino_tpu_torch.expr import ir
from trino_tpu_torch.expr.registry import REGISTRY
from trino_tpu_torch.security import AllowAllAccessControl, Identity
from trino_tpu_torch.serving.params import check_parameters
from trino_tpu_torch.serving.plan_cache import PlanCache, plan_tables
from trino_tpu_torch.sql import ast
from trino_tpu_torch.sql import plan as P
from trino_tpu_torch.sql.analyzer import (
    AnalysisError,
    Analyzer,
    plan_is_volatile,
    reset_volatile_plan,
    resolve_type,
    set_session_info,
    set_session_zone,
)
from trino_tpu_torch.sql.formatter import format_statement
from trino_tpu_torch.sql.local_planner import LocalPlanner
from trino_tpu_torch.sql.optimizer import canonicalize_tstz_keys, optimize
from trino_tpu_torch.sql.parser import parse
from trino_tpu_torch.sql.validate import check_plan_determinism, validate_logical
from trino_tpu_torch.transaction import TransactionError, TransactionManager

_SHOWS = (ast.ShowSession, ast.ShowFunctions, ast.ShowSchemas, ast.ShowTables,
          ast.ShowColumns)


@dataclasses.dataclass
class Session:
    """Per-query context: every field of the reference's Session
    (config.SYSTEM_PROPERTIES names one property per field), with its
    default. `batch_rows` counts source rows per scan chunk (orders for
    the lineitem generator), as in the reference. The fields read only by
    the reference's distributed, retry, mesh, replica, scheduler and
    fabric runtimes are stored and read by nothing here; a field whose
    reader is an unported tier raises away from its default
    (config.UNPORTED_READERS)."""

    catalog: str = "tpch"
    schema: str = "tiny"
    user: str = "user"
    # session time zone: fixes literal parsing, timestamp<->tstz
    # casts, now()/current_date
    timezone: str = "UTC"
    batch_rows: int = 1 << 20
    target_splits: int = 1
    retry_policy: str = "none"
    query_retry_count: int = 2
    task_retries: int = 3
    memory_pool_bytes: Optional[int] = None
    hash_partition_count: int = 4
    # a join build's keys filter its probe (LocalPlanner.dynamic_filtering)
    enable_dynamic_filtering: bool = True
    broadcast_join_threshold: int = 1_000_000
    mesh_execution: bool = True
    mesh_chunk_rows: int = 0
    # the iterative rule pipeline and the cost-based join reorderer
    enable_optimizer: bool = True
    join_reordering_strategy: str = "automatic"
    # connector scan pushdown (the apply_filter/apply_projection SPI hooks)
    enable_pushdown: bool = True
    speculation_enabled: bool = True
    speculation_quantile: float = 2.0
    # writers per autocommit bulk write (ScaledWriterSink); 1 = one sink
    task_concurrency: int = 2
    request_max_error_duration_s: float = 30.0
    node_breaker_threshold: int = 3
    node_breaker_cooldown_s: float = 1.0
    low_memory_killer_enabled: bool = True
    query_max_planning_time_s: float = 0.0
    query_max_execution_time_s: float = 0.0
    query_max_run_time_s: float = 0.0
    query_max_cpu_time_s: float = 0.0
    client_timeout_s: float = 300.0
    stuck_task_interrupt_s: float = 0.0
    speculation_percentile: float = 0.75
    # plan sanity checking (sql/validate.py): "off" | "passes" (after
    # each optimizer pass) | "rules" (also after every rule, and the
    # plan planned twice for determinism)
    plan_validation: str = "passes"
    compile_churn_warn_threshold: int = 32
    shape_stabilization: bool = True
    capacity_ladder_base: int = 2
    warmup_mode: str = "off"
    stuck_task_interrupt_warm_s: float = 0.0
    query_trace: str = "off"
    # the plan cache's LRU bound (serving/plan_cache.py)
    plan_cache_entries: int = 256
    micro_batch_window_ms: float = 0.0
    micro_batch_max: int = 16
    admission_fast_depth: int = 64
    admission_general_depth: int = 256
    admission_retry_after_s: float = 1.0
    resident_tables: str = ""
    resident_pin_budget_mb: int = 64
    resident_delta_max_rows: int = 4096
    adaptive_execution: bool = False
    adaptive_replan_threshold: float = 4.0
    shared_subtree_materialization: bool = False
    skewed_join_salting: bool = False
    skew_hot_key_threshold: float = 0.2
    skew_spill_min_rows: int = 1 << 18
    # the join-project route (ops/mxu_join.py) for a grouped aggregate
    # over a high-fanout inner equi-join, and its work threshold
    mxu_join_enabled: bool = False
    mxu_join_min_work: float = 16.0
    mesh_checkpoint_interval_chunks: int = 0
    mesh_resume_attempts: int = 2
    recovery_spool_stages: bool = False
    mesh_replicas: int = 1
    replica_failover_enabled: bool = True
    replica_breaker_threshold: int = 3
    replica_breaker_cooldown_s: float = 1.0
    mesh_scheduler: bool = True
    preemption_enabled: bool = True
    park_max_bytes: int = 256 << 20
    mesh_scheduler_weights: str = ""
    mesh_scheduler_min_slice_chunks: int = 1
    mesh_scheduler_group: str = ""
    mesh_steal_enabled: bool = True
    mesh_park_max_bytes: int = 0
    fabric_peers: str = ""
    fabric_queue_depth: int = 8
    fabric_max_error_duration_s: float = 5.0

    def set_property(self, name: str, value) -> None:
        """SET SESSION entry point — validated through the typed
        registry (config.SYSTEM_PROPERTIES)."""
        from trino_tpu_torch.config import bind_session

        bind_session(self, {name: value})


@dataclasses.dataclass
class MaterializedResult:
    rows: List[list]
    column_names: List[str]
    column_types: List[T.DataType]
    # transaction protocol surface (StatementClientV1's
    # X-Trino-Started-Transaction-Id / Clear-Transaction-Id headers)
    started_transaction_id: Optional[str] = None
    cleared_transaction: bool = False
    # prepared-statement protocol surface (X-Trino-Added-Prepare /
    # X-Trino-Deallocated-Prepare response headers)
    added_prepare: Optional[tuple] = None
    deallocated_prepare: Optional[str] = None
    # the data plane that ran the query: "local" for LocalQueryRunner,
    # "http" for the distributed runner's page exchange (the reference's
    # name for it, in process or not)
    data_plane: str = "local"

    def only_value(self):
        assert len(self.rows) == 1 and len(self.rows[0]) == 1, self.rows
        return self.rows[0][0]


def _raise_deferred_checks(ctx: dict) -> None:
    """Assertions deferred to the end of the query (the results are
    already materialized, so these bools are cheap)."""
    for flag, msg in ctx.get("deferred_checks", ()):
        if bool(flag):
            raise RuntimeError(msg)


def _done() -> MaterializedResult:
    return MaterializedResult([[True]], ["result"], [T.BOOLEAN])


def _count(n: int) -> MaterializedResult:
    return MaterializedResult([[n]], ["rows"], [T.BIGINT])


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
    def __init__(self, session: Optional[Session] = None, access_control=None,
                 device=None):
        self.session = session or Session()
        self.device = resolve_device(device)
        self.catalogs = CatalogManager()
        self.transactions = TransactionManager(self.catalogs)
        self._current_txn: Optional[str] = None
        # per-statement active transaction (explicit protocol threading)
        self._stmt_txn = threading.local()
        self.access_control = access_control or AllowAllAccessControl()
        # per-request identity override (a front end passes the
        # authenticated principal; the runner is shared across threads)
        self._identity_override = threading.local()
        # PREPARE store: name -> (ast statement, formatted text)
        self._prepared: Dict[str, tuple] = {}
        self._request_prepared: Optional[Dict[str, str]] = None
        # canonical text + plan-shaping properties + parameter dtypes ->
        # (OutputNode, PhysicalPlan) planned on this runner's device: a
        # hit instantiates the cached plan's operators afresh and plans
        # nothing
        self._plan_cache = PlanCache(max_entries=self.session.plan_cache_entries)
        # dtype vector of the current EXECUTE's bound parameters (part of
        # the plan-cache key), per thread like the identity
        self._bound_dtypes_tls = threading.local()
        # the memory pool of the last query (None without a pool)
        self._last_pool = None
        # the WarmupService of the last execution that started one
        self._last_warmup = None
        # what the adaptive controller did to the last planned query
        # (None: adaptive off, or a plan-cache hit)
        self._last_adaptive_report = None
        from trino_tpu_torch.runtime.events import EventListenerManager

        self.event_listeners = EventListenerManager()
        self.event_listeners.register_metrics()
        self._query_seq = 0
        # the last completed query's span tree
        self._last_trace: Optional[tuple] = None

    @property
    def identity(self) -> Identity:
        override = getattr(self._identity_override, "value", None)
        return override or Identity(self.session.user)

    def _check_scans(self, plan) -> None:
        """AccessControl over every table the plan reads (the analyzer
        already resolved views and CTEs away, so the ScanNodes are the
        whole read set)."""
        if isinstance(plan, P.ScanNode):
            h = plan.handle
            self.access_control.check_can_select(
                self.identity, h.catalog, h.schema, h.table, plan.columns)
        for c in plan.children():
            self._check_scans(c)

    def register_catalog(self, name: str, connector: Connector) -> None:
        self.catalogs.register(name, connector)

    # -- entry point --
    def execute(self, sql: str, identity=None, transaction_id: Optional[str] = None,
                prepared: Optional[Dict[str, str]] = None) -> MaterializedResult:
        """`identity` overrides the session user for this statement.

        `transaction_id` selects EXPLICIT transaction threading — the
        protocol model, where each client carries its own transaction id
        and the shared runner holds no cross-client state. Pass "NONE"
        for an autocommit statement in explicit mode. When None, the
        runner's own session transaction applies.

        `prepared` maps names to the statement texts the client carries
        (the protocol's prepared-statement headers); EXECUTE looks there
        before the runner's own PREPARE store."""
        check_session(self.session)
        stmt = parse(sql)
        explicit = transaction_id is not None
        active = None if transaction_id in (None, "NONE") else transaction_id
        if not explicit:
            active = self._current_txn
        if identity is not None:
            self._identity_override.value = identity
        self._stmt_txn.value = active
        self._request_prepared = prepared
        try:
            return self._dispatch(stmt, sql, active, explicit)
        finally:
            self._stmt_txn.value = None
            self._request_prepared = None
            if identity is not None:
                self._identity_override.value = None

    def _active_txn(self) -> Optional[str]:
        return getattr(self._stmt_txn, "value", None)

    def _check_writable(self) -> None:
        txn = self._active_txn()
        if txn is not None and self.transactions.is_read_only(txn):
            raise TransactionError(
                "READ_ONLY_VIOLATION: cannot write in a read-only transaction"
            )

    def _dispatch(self, stmt, sql: str, active: Optional[str],
                  explicit: bool) -> MaterializedResult:
        self.access_control.check_can_execute_query(self.identity)
        if isinstance(stmt, ast.Prepare):
            try:
                text = format_statement(stmt.statement)
            except Exception:  # noqa: BLE001 - the reference keeps the raw text
                text = stmt.sql or ""
            self._prepared[stmt.name] = (stmt.statement, text)
            return dataclasses.replace(_done(), added_prepare=(stmt.name, text))
        if isinstance(stmt, ast.ExecuteStmt):
            # request-carried statements take precedence: they are the
            # client's session state, the store is shared by every caller
            hit = None
            if self._request_prepared:
                text = self._request_prepared.get(stmt.name)
                if text is not None:
                    hit = (parse(text), text)
            if hit is None:
                hit = self._prepared.get(stmt.name)
            if hit is None:
                raise ValueError(f"Prepared statement not found: {stmt.name}")
            # arity and dtypes checked before substitution
            dtypes = check_parameters(hit[0], stmt.parameters, self.catalogs,
                                      self.session.catalog, self.session.schema)
            body = ast.substitute_parameters(hit[0], stmt.parameters)
            # the cache key canonicalizes the BOUND statement, and the
            # dtype vector rides along as its own component
            prior = getattr(self._bound_dtypes_tls, "value", None)
            self._bound_dtypes_tls.value = tuple(dtypes)
            try:
                return self._dispatch(body, sql, active, explicit)
            finally:
                self._bound_dtypes_tls.value = prior
        if isinstance(stmt, ast.Deallocate):
            if stmt.name not in self._prepared:
                raise ValueError(f"Prepared statement not found: {stmt.name}")
            del self._prepared[stmt.name]
            return dataclasses.replace(_done(), deallocated_prepare=stmt.name)
        if isinstance(stmt, ast.StartTransaction):
            if active is not None:
                raise TransactionError("transaction already in progress")
            new_txn = self.transactions.begin(stmt.read_only)
            if not explicit:
                self._current_txn = new_txn
            return dataclasses.replace(_done(), started_transaction_id=new_txn)
        if isinstance(stmt, (ast.Commit, ast.Rollback)):
            if active is None:
                raise TransactionError("NOT_IN_TRANSACTION: no transaction in progress")
            try:
                if isinstance(stmt, ast.Commit):
                    self.transactions.commit(active)
                else:
                    self.transactions.rollback(active)
            finally:
                # a failed commit still ends the transaction (the
                # reference's semantics): never wedge the session
                if not explicit:
                    self._current_txn = None
                if isinstance(stmt, ast.Commit):
                    self._invalidate_plans()
            return dataclasses.replace(_done(), cleared_transaction=True)
        if isinstance(stmt, ast.Query):
            return self._run_tracked(sql, stmt)
        if isinstance(stmt, ast.ExplainStatement):
            if stmt.analyze:
                return self._explain_analyze(stmt.query)
            plan = self._analyze(stmt.query)
            return MaterializedResult([[P.explain_text(plan)]], ["Query Plan"], [T.VARCHAR])
        if isinstance(stmt, ast.CreateTable):
            cat, conn, schema, table = self._resolve_target(stmt.table)
            self.access_control.check_can_create_table(self.identity, conn.name, schema, table)
            self._check_writable()
            cols = [ColumnMetadata(n, resolve_type(t)) for n, t in stmt.columns]
            conn.metadata.create_table(schema, table, cols)
            self._invalidate_plans(table=(cat, schema, table))
            return _done()
        if isinstance(stmt, ast.CreateTableAs):
            return self._execute_ctas(stmt)
        if isinstance(stmt, ast.Insert):
            return self._execute_insert(stmt.table, stmt.columns, stmt.query)
        if isinstance(stmt, ast.Delete):
            return self._execute_rewrite_dml(stmt.table, stmt.where, None)
        if isinstance(stmt, ast.Merge):
            return self._execute_merge(stmt)
        if isinstance(stmt, ast.Update):
            names = [c for c, _ in stmt.assignments]
            if len(set(names)) != len(names):
                raise AnalysisError("multiple assignments for the same column")
            return self._execute_rewrite_dml(stmt.table, stmt.where, dict(stmt.assignments))
        if isinstance(stmt, ast.DropTable):
            cat, conn, schema, table = self._resolve_target(stmt.table)
            self.access_control.check_can_drop_table(self.identity, conn.name, schema, table)
            self._check_writable()
            handle = conn.metadata.get_table_handle(schema, table)
            if handle is None:
                raise AnalysisError(f"table {schema}.{table} does not exist")
            conn.metadata.drop_table(handle)
            self._invalidate_plans(table=(cat, schema, table))
            return _done()
        if isinstance(stmt, ast.SetSession):
            self.access_control.check_can_set_session_property(self.identity, stmt.name)
            # plan-shaping properties are part of the plan-cache key, so
            # SET SESSION invalidates nothing
            self.session.set_property(stmt.name, stmt.value)
            return _done()
        if isinstance(stmt, _SHOWS):
            return self._show(stmt)
        raise AnalysisError(f"cannot execute {type(stmt).__name__}")

    def _show(self, stmt) -> MaterializedResult:
        """SHOW SESSION, FUNCTIONS, SCHEMAS, TABLES and COLUMNS."""
        if isinstance(stmt, ast.ShowSession):
            rows = []
            for meta in SYSTEM_PROPERTIES.all():
                current = getattr(self.session, meta.name, None)
                if meta.name == "memory_pool_bytes":
                    current = self.session.memory_pool_bytes or 0
                rows.append([meta.name, str(current), str(meta.default), meta.description])
            return MaterializedResult(rows, ["Name", "Value", "Default", "Description"],
                                      [T.VARCHAR] * 4)
        if isinstance(stmt, ast.ShowFunctions):
            rows = []
            for m in REGISTRY.all():
                arity = (str(m.min_arity) if m.max_arity == m.min_arity
                         else f"{m.min_arity}..{m.max_arity or 'N'}")
                # one row per callable name and per concrete overload
                for nm in (m.name, *m.aliases):
                    for sig in m.overloads or (m.returns,):
                        rows.append([nm, sig, arity, m.category, m.description])
            rows.sort(key=lambda r: (r[3], r[0], r[1]))
            return MaterializedResult(
                rows, ["Function", "Return Type", "Arity", "Function Type", "Description"],
                [T.VARCHAR] * 5)
        if isinstance(stmt, ast.ShowSchemas):
            conn = self.catalogs.get(stmt.catalog or self.session.catalog)
            return MaterializedResult([[s] for s in conn.metadata.list_schemas()],
                                      ["Schema"], [T.VARCHAR])
        if isinstance(stmt, ast.ShowTables):
            cat, schema = self.session.catalog, self.session.schema
            if stmt.schema:
                if len(stmt.schema) == 2:
                    cat, schema = stmt.schema
                else:
                    schema = stmt.schema[0]
            conn = self.catalogs.get(cat)
            return MaterializedResult([[t] for t in conn.metadata.list_tables(schema)],
                                      ["Table"], [T.VARCHAR])
        cat, _, schema, table = self._resolve_target(stmt.table)
        conn, handle = self.catalogs.resolve_table(cat, schema, table)
        meta = conn.metadata.get_table_metadata(handle)
        return MaterializedResult([[c.name, str(c.type)] for c in meta.columns],
                                  ["Column", "Type"], [T.VARCHAR, T.VARCHAR])

    def _analyze(self, q: ast.Query):
        set_session_zone(self.session.timezone)
        set_session_info(self.session.catalog, self.session.schema, self.identity.user)

        def plan_once():
            analyzer = Analyzer(self.catalogs, self.session.catalog, self.session.schema)
            root = optimize(analyzer.plan(q), self.catalogs, self.session)
            # correctness pass: runs regardless of enable_optimizer
            return canonicalize_tstz_keys(root)

        root = plan_once()
        mode = self.session.plan_validation
        if mode != "off":
            validate_logical(root, stage="canonicalize_tstz_keys")
        if mode == "rules":
            # replanning the same AST must give byte-identical EXPLAIN
            # text (a fresh analyzer each time: the plan cache would
            # hide a nondeterministic rule)
            check_plan_determinism(plan_once)
        return root

    def _planner(self) -> LocalPlanner:
        return LocalPlanner(
            self.catalogs, self.device,
            batch_rows=self.session.batch_rows,
            target_splits=self.session.target_splits,
            dynamic_filtering=self.session.enable_dynamic_filtering,
            mxu_join=self.session.mxu_join_enabled,
            mxu_join_min_work=self.session.mxu_join_min_work,
            stabilizer=self._make_stabilizer(),
        )

    def _make_stabilizer(self):
        """The session's capacity policy (compile/shapes.py); None when
        shape stabilization is off."""
        if not self.session.shape_stabilization:
            return None
        from trino_tpu_torch.compile.shapes import CapacityLadder, ShapeStabilizer

        return ShapeStabilizer(CapacityLadder(base=self.session.capacity_ladder_base),
                               batch_rows=self.session.batch_rows)

    def _start_warmup(self, physical):
        """Start the plan's warmup per `warmup_mode`; returns the started
        WarmupService, or None. Mode block waits here, so the execution
        starts with every entry driven."""
        mode = self.session.warmup_mode
        entries = physical.warmup_entries
        if mode == "off" or not entries:
            return None
        from trino_tpu_torch.compile.warmup import WarmupService

        svc = WarmupService(entries, mode=mode).start()
        if mode == "block":
            svc.wait()
        self._last_warmup = svc
        return svc

    def _plan(self, q: ast.Query, sql_key: Optional[str]):
        """(OutputNode, PhysicalPlan) of `q`: from the plan cache when
        `sql_key` is given and the key hits, else planned on the runner's
        device (and stored, unless analysis folded a volatile value or
        the adaptive controller transformed the plan). Access control
        re-checks the scans either way."""
        self._last_adaptive_report = None  # set again if adaptive runs
        cache_key = None
        if sql_key is not None:
            # the formatter's canonical text, the plan-shaping properties
            # and the bound parameters' dtypes
            try:
                canonical = format_statement(q)
            except Exception:  # noqa: BLE001 - the reference keys on the raw text
                canonical = sql_key
            cache_key = self._plan_cache.key(
                canonical, self.session, getattr(self._bound_dtypes_tls, "value", None) or ())
        cached = self._plan_cache.lookup(cache_key) if cache_key else None
        if cached is not None:
            # a cached plan is no grant: the scans re-check every time
            self._check_scans(cached[0])
            return cached
        # snapshot the generation BEFORE planning: a write landing while
        # this plans must win over the store below
        generation = self._plan_cache.generation
        reset_volatile_plan()
        output = self._analyze(q)
        self._check_scans(output)
        # adaptive execution: observe materialization barriers (on this
        # runner's device) and re-plan the remainder BEFORE physical
        # planning; transformed plans embed data snapshots, so they
        # never enter the plan cache
        from trino_tpu_torch.adaptive import AdaptiveController

        controller = AdaptiveController(
            self.catalogs, self.session, stabilizer=self._make_stabilizer(),
            device=self.device,
        )
        adaptive_report = None
        if controller.enabled():
            output = controller.prepare(output)
            adaptive_report = controller.report
        self._last_adaptive_report = adaptive_report
        physical = self._planner().plan(output)
        if (cache_key and not plan_is_volatile()
                and not (adaptive_report is not None and adaptive_report.transformed)):
            self._plan_cache.store(cache_key, (output, physical), generation=generation,
                                   tables=plan_tables(output))
        return output, physical

    def _execution_ctx(self) -> dict:
        """A fresh per-execution context: with `memory_pool_bytes` set,
        its own MemoryPool and a spill directory (made by the first
        spill), and the resident tier's pins charged to the pool and
        registered revocable, so a reservation that cannot fit reclaims
        warm state before the pool considers killing a query."""
        ctx: dict = {}
        if self.session.memory_pool_bytes is not None:
            from trino_tpu_torch.resident import RESIDENT
            from trino_tpu_torch.runtime.memory import MemoryPool

            ctx["memory_pool"] = MemoryPool(self.session.memory_pool_bytes)
            ctx["spill_dir"] = os.path.join(
                tempfile.gettempdir(), f"trino-tpu-torch-spill-{uuid.uuid4().hex}")
            RESIDENT.attach_pool(ctx["memory_pool"])
        return ctx

    @staticmethod
    def _release(ctx: dict) -> None:
        """End of an execution: close its memory contexts, detach the
        resident pins from its pool (the reference leaves them charged
        to a pool whose query has ended, so a later pin is refused by
        that pool) and remove its spill directory with every file an
        operator left there."""
        for mc in ctx.get("memory_contexts", ()):
            mc.close()
        if "memory_pool" in ctx:
            from trino_tpu_torch.resident import RESIDENT

            RESIDENT.release_pool(ctx["memory_pool"])
        if "spill_dir" in ctx:
            shutil.rmtree(ctx["spill_dir"], ignore_errors=True)

    def _drive(self, instance: tuple, sink) -> None:
        """Run an instantiated plan into `sink`: build pipelines first,
        in plan order (each fills the bridge that a later pipeline or
        the main chain probes)."""
        ctx, pipelines, chain = instance
        try:
            for ops in pipelines:
                Driver(Pipeline(ops)).run()
            Driver(Pipeline(chain + [sink])).run()
            _raise_deferred_checks(ctx)
        finally:
            self._release(ctx)

    def _instance(self, physical) -> tuple:
        """(ctx, pipelines, chain): fresh operators for one execution;
        the join bridges and the memory pool live in `ctx`, so two
        executions of one cached plan share no state."""
        ctx = self._execution_ctx()
        pipelines, chain = physical.instantiate(ctx)
        return ctx, pipelines, chain

    def _run(self, node, sink) -> None:
        self._drive(self._instance(self._planner().plan(node)), sink)

    def _execute_query(self, q: ast.Query, sql_key: Optional[str] = None,
                       query_id: Optional[str] = None) -> MaterializedResult:
        from trino_tpu_torch.runtime.metrics import (
            compile_attribution,
            set_compile_attribution,
        )

        # builds are charged to the tracked query; an internal subquery
        # (a DML rewrite) inherits its statement's attribution, if any
        prev = set_compile_attribution(query_id or compile_attribution())
        try:
            output, physical = self._plan(q, sql_key)
            self._start_warmup(physical)
            sink = CollectorSink()
            instance = self._instance(physical)
            self._last_pool = instance[0].get("memory_pool")
            self._drive(instance, sink)
        finally:
            set_compile_attribution(prev)
        return MaterializedResult(
            sink.rows(), list(output.names), [f.type for f in output.fields]
        )

    def _run_tracked(self, sql: str, stmt: ast.Query) -> MaterializedResult:
        """Query lifecycle: span tree + event listener dispatch around
        the execution (SqlQueryExecution's tracing shape)."""
        import time as _time

        from trino_tpu_torch.runtime.events import QueryCreatedEvent
        from trino_tpu_torch.runtime.metrics import METRICS
        from trino_tpu_torch.runtime.tracing import KIND_QUERY, QueryTrace

        self._query_seq += 1
        query_id = f"local-{self._query_seq}"
        trace = QueryTrace(query_id)
        qspan = trace.span(f"query {query_id}", KIND_QUERY, sql=sql[:500])
        counters_before = METRICS.snapshot()
        self.event_listeners.query_created(
            QueryCreatedEvent(query_id, sql, _time.time())
        )
        status, failure, rows_n = "finished", None, 0
        try:
            result = self._execute_query(stmt, sql_key=sql, query_id=query_id)
            rows_n = len(result.rows)
            return result
        except BaseException as e:
            status, failure = "failed", repr(e)
            if not qspan.ended:
                qspan.event("exception", error=repr(e)[:300])
                qspan.set(error=True)
            raise
        finally:
            self._finalize_query(
                query_id, sql, trace, qspan, status, failure, rows_n,
                counters_before,
            )

    def _finalize_query(self, query_id, sql, trace, qspan, status,
                        failure, rows_n, counters_before):
        """Close the span tree and fire the enriched completion event.
        Observability finalization must never mask the query's own
        verdict, so it swallows."""
        try:
            from trino_tpu_torch.exec.stats import engine_counters_delta
            from trino_tpu_torch.runtime.events import QueryCompletedEvent
            from trino_tpu_torch.runtime.metrics import METRICS, retire_query_compiles

            qspan.set(state=status)
            qspan.end()
            trace.end_open_spans(qspan.end_s)
            wall = qspan.duration_s
            METRICS.observe("query_wall_s", wall)
            counters = engine_counters_delta(counters_before, METRICS.snapshot())
            peak = 0
            if self._last_pool is not None:
                peaks = self._last_pool.query_peaks()
                peak = int(max(peaks.values(), default=0))
            self._last_trace = (query_id, trace)
            self.event_listeners.query_completed(
                QueryCompletedEvent(
                    query_id, sql, status, wall,
                    rows=rows_n, failure=failure,
                    peak_memory_bytes=peak,
                    rows_scanned=int(counters.get("rows_scanned", 0)),
                    bytes_scanned=int(counters.get("bytes_scanned", 0)),
                    rows_shuffled=int(counters.get("rows_shuffled", 0)),
                    compile_count=int(retire_query_compiles(query_id)),
                )
            )
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "query finalization failed for %s", query_id, exc_info=True
            )

    def query_trace_export(self, query_id: Optional[str] = None):
        """Span tree of the most recent query (the local runner keeps
        only the last trace); None when the id does not match."""
        if self._last_trace is None:
            return None
        qid, trace = self._last_trace
        if query_id is not None and query_id != qid:
            return None
        return trace.export()

    def query_chrome_trace(self, query_id: Optional[str] = None):
        from trino_tpu_torch.runtime.tracing import chrome_trace

        export = self.query_trace_export(query_id)
        if export is None:
            return None
        return {"traceEvents": chrome_trace(export)}

    def _explain_analyze(self, q: ast.Query) -> MaterializedResult:
        """EXPLAIN ANALYZE: run the plan with instrumented operators and
        render the plan, then per-operator statistics, each operator
        section closed by a device barrier (ExplainAnalyzeOperator)."""
        from trino_tpu_torch.compile import cache as compile_cache
        from trino_tpu_torch.exec.stats import engine_counters_delta, instrument, render_stats
        from trino_tpu_torch.runtime.metrics import (
            METRICS,
            retire_query_compiles,
            set_compile_attribution,
        )
        from trino_tpu_torch.sql.validate import census_text, shape_census

        qid = f"local-explain-{uuid.uuid4().hex[:8]}"
        prev = set_compile_attribution(qid)
        try:
            output, physical = self._plan(q, sql_key=None)
            stabilizer = self._make_stabilizer()
            classes = shape_census(
                output, self.catalogs, batch_rows=self.session.batch_rows,
                dynamic_filtering=self.session.enable_dynamic_filtering,
                ladder=stabilizer.ladder if stabilizer is not None else None,
            )
            warmup_svc = self._start_warmup(physical)
            before = METRICS.snapshot()
            ctx, pipelines, chain = self._instance(physical)
            groups, wrapped, ledger = [], [], set()
            for ops in pipelines + [chain + [CollectorSink()]]:
                w, stats = instrument(ops, device_sync=True, device=self.device,
                                      shape_ledger=ledger)
                groups.append(stats)
                wrapped.append(w)
            self._drive((ctx, wrapped[:-1], wrapped[-1][:-1]), wrapped[-1][-1])
        finally:
            set_compile_attribution(prev)
        for ops in wrapped:
            for op in ops:
                op.flush_counts()
        counters = engine_counters_delta(before, METRICS.snapshot())
        # the compile-regime lines ride under the census: the programs
        # and kernel libraries this query built, warmup's hits and
        # misses, the caches, then what the adaptive controller observed
        # and did
        census = census_text(classes, warn_threshold=self.session.compile_churn_warn_threshold,
                             observed=len(ledger))
        census += f"\nprograms_built_this_query={int(retire_query_compiles(qid))}"
        if warmup_svc is not None:
            if warmup_svc.mode == "background":
                warmup_svc.wait(timeout=60.0)  # settle the entry statuses
            census += "\n" + warmup_svc.report_line(ledger)
        ps = compile_cache.PROGRAM_CACHE.stats()
        census += (f"\nprogram_cache: entries={ps['entries']} hits={ps['hits']} "
                   f"misses={ps['misses']} evictions={ps['evictions']}")
        kc = compile_cache.ACTIVE_PERSISTENT_CACHE
        if kc is not None:
            cs = kc.stats()
            census += (f"\npersistent_cache: entries={cs['entries']} bytes={cs['bytes']} "
                       f"scrubbed={cs['scrubbed']} evicted={cs['evicted']}")
        report = self._last_adaptive_report
        if report is not None:
            census += "\n" + "\n".join(report.lines())
        # the census goes after the runtime stats: its class lines name
        # operators too, and readers grep for an operator's first line
        text = (P.explain_text(output) + "\n\n" + render_stats(groups, counters)
                + "\n\n" + census)
        return MaterializedResult([[text]], ["Query Plan"], [T.VARCHAR])

    def _invalidate_plans(self, table=None, appended: bool = False, tap=None) -> None:
        """Cached physical plans capture split lists (data snapshots) at
        plan time, so a write drops them: only the plans that read the
        written table when the write names it (`table` = (catalog,
        schema, table), the registered catalog name), all of them
        otherwise (COMMIT). The resident tier follows the same protocol:
        a named write bumps the table's generation and evicts its pins,
        or, for an INSERT whose rows a DeltaTap captured
        (`appended`/`tap`), re-keys them onto their delta side; COMMIT
        bumps every generation and evicts every pin. Mesh checkpoints
        over the written table (all of them on COMMIT) are dropped too:
        the generation guard already makes them unreachable, this
        reclaims their host memory at write time."""
        from trino_tpu_torch.recovery import CHECKPOINTS
        from trino_tpu_torch.resident import GENERATIONS, RESIDENT
        from trino_tpu_torch.resident import fastlane
        from trino_tpu_torch.resident.manager import table_key

        if table is None:
            self._plan_cache.invalidate()
            GENERATIONS.bump_all()
            RESIDENT.evict_all()
            CHECKPOINTS.clear()
            return
        tkey = table_key(*table)
        self._plan_cache.invalidate_tables([tkey])
        GENERATIONS.bump(tkey)
        fastlane.table_written(*tkey, appended=appended, tap=tap)
        CHECKPOINTS.invalidate_table(*tkey)

    # -- DML (BeginTableWrite/TableWriter/TableFinish path) --
    def _resolve_target(self, parts):
        """(registered catalog name, connector, schema, table)."""
        cat, schema = self.session.catalog, self.session.schema
        table = parts[-1]
        if len(parts) == 2:
            schema = parts[0]
        elif len(parts) == 3:
            cat, schema = parts[0], parts[1]
        return cat, self.catalogs.get(cat), schema, table

    def _execute_ctas(self, stmt: ast.CreateTableAs) -> MaterializedResult:
        output = self._analyze(stmt.query)
        self._check_scans(output)
        cat, conn, schema, table = self._resolve_target(stmt.table)
        self.access_control.check_can_create_table(self.identity, conn.name, schema, table)
        self._check_writable()  # before the table is created
        cols = [
            ColumnMetadata(n or f"_col{i}", f.type)
            for i, (n, f) in enumerate(zip(output.names, output.fields))
        ]
        conn.metadata.create_table(schema, table, cols)
        return self._write_into(cat, conn, schema, table, output, list(output.names))

    def _execute_insert(self, parts, columns, query: ast.Query) -> MaterializedResult:
        cat, conn, schema, table = self._resolve_target(parts)
        self.access_control.check_can_insert(self.identity, conn.name, schema, table)
        output = self._analyze(query)
        self._check_scans(output)
        return self._write_into(
            cat, conn, schema, table, output, list(columns) if columns else None
        )

    def _table(self, conn, schema: str, table: str):
        handle = conn.metadata.get_table_handle(schema, table)
        if handle is None:
            raise AnalysisError(f"table {schema}.{table} does not exist")
        return handle, conn.metadata.get_table_metadata(handle)

    def _execute_rewrite_dml(self, parts, where, assignments: Optional[dict]) -> MaterializedResult:
        """DELETE (assignments=None) / UPDATE as a read-rewrite: scan
        the surviving/updated rows into device batches and swap them in
        as the table's rows — the memory-connector analogue of the
        reference's row-level delete/update pushdown. The affected-row
        count comes from a matched-rows count pass."""
        cat, conn, schema, table = self._resolve_target(parts)
        check = (self.access_control.check_can_delete if assignments is None
                 else self.access_control.check_can_update)
        check(self.identity, conn.name, schema, table)
        self._check_writable()
        if self._active_txn() is not None:
            raise TransactionError(
                "DELETE/UPDATE inside an explicit transaction is not supported"
            )
        handle, meta = self._table(conn, schema, table)
        if assignments is not None:
            known = {c.name for c in meta.columns}
            for col in assignments:
                if col not in known:
                    raise AnalysisError(f"unknown column {col} in UPDATE")
        rel = ast.TableRef(parts)
        matched = where if where is not None else ast.BooleanLiteral(True)
        count_q = ast.Query(ast.QuerySpec(
            (ast.SelectItem(ast.FunctionCall("count", (ast.Star(),))),),
            from_=rel, where=where,
        ))
        affected = self._execute_query(count_q).only_value()
        if assignments is None:
            if where is None:  # unconditional DELETE = truncate
                conn.metadata.truncate_table(handle)
                self._invalidate_plans(table=(cat, schema, table))
                return _count(affected)
            # keep rows where the predicate is NOT TRUE
            keep = ast.UnaryOp(
                "not", ast.FunctionCall("coalesce", (where, ast.BooleanLiteral(False)))
            )
            select = tuple(ast.SelectItem(ast.Identifier((c.name,))) for c in meta.columns)
            rewrite_q = ast.Query(ast.QuerySpec(select, from_=rel, where=keep))
        else:
            # per column: CASE WHEN pred THEN new ELSE old END
            items = []
            for c in meta.columns:
                old = ast.Identifier((c.name,))
                e = old
                if c.name in assignments:
                    new = assignments[c.name]
                    e = (ast.Case(None, (ast.WhenClause(matched, new),), old)
                         if where is not None else new)
                items.append(ast.SelectItem(e, c.name))
            rewrite_q = ast.Query(ast.QuerySpec(tuple(items), from_=rel))
        self._replace_table_from_queries(cat, conn, handle, meta, [rewrite_q])
        return _count(affected)

    def _coerced(self, output, meta, sources) -> P.ProjectNode:
        """`output`'s rows projected onto the table schema: column i
        takes source channel sources[i] (None: a NULL), cast where the
        types differ."""
        exprs = []
        for col, i in zip(meta.columns, sources):
            if i is None:
                exprs.append(ir.Cast(ir.Literal(None, T.UNKNOWN), col.type))
                continue
            e: ir.Expr = ir.InputRef(i, output.fields[i].type)
            if output.fields[i].type != col.type:
                e = ir.Cast(e, col.type)
            exprs.append(e)
        fields = tuple(P.Field(c.name, c.type) for c in meta.columns)
        return P.ProjectNode(output.child, tuple(exprs), fields)

    def _replace_table_from_queries(self, cat, conn, handle, meta, queries) -> List[int]:
        """Materialize each rewrite query, coerce onto the table schema,
        and swap the combined batches in as the table's new contents
        (shared by DELETE/UPDATE/MERGE; MERGE runs survivors and inserts
        as separate queries so their string columns keep independent
        dictionaries). Returns the per-query row counts (MERGE reads the
        insert count)."""
        batches = []
        counts = []
        for rewrite_q in queries:
            output = self._analyze(rewrite_q)
            # a rewrite may scan other tables: SELECT checks as any query
            self._check_scans(output)
            sink = CollectorSink()
            self._run(self._coerced(output, meta, range(len(meta.columns))), sink)
            counts.append(sum(b.row_count() for b in sink.batches))
            batches.extend(sink.batches)
        replace = getattr(conn, "replace_rows", None)
        if replace is not None:  # atomic: stage, then swap
            replace(handle, batches)
        else:  # truncate + append: NOT crash-atomic
            conn.metadata.truncate_table(handle)
            writer_sink = conn.page_sink(handle)
            for b in batches:
                writer_sink.append(b)
            writer_sink.finish()
        self._invalidate_plans(table=(cat, handle.schema, handle.table))
        return counts

    def _execute_merge(self, stmt: ast.Merge) -> MaterializedResult:
        """MERGE as a read-rewrite over the query machinery
        (parser/sql/tree/Merge.java): survivors and inserts become the
        table's new contents, as for DELETE/UPDATE.

        - survivors: target LEFT JOIN source; per column a CASE chain
          applies the FIRST matching WHEN MATCHED arm; rows whose first
          arm is DELETE drop.
        - inserts: source rows with NO target match (NOT EXISTS) and a
          matching WHEN NOT MATCHED arm.
        - a target row matching >1 source rows is an error (Trino's
          MERGE cardinality rule), checked with a row_number-keyed
          grouped count before the rewrite."""
        cat, conn, schema, table = self._resolve_target(stmt.table)
        # each privilege gates only the arms present (Trino checks UPDATE,
        # DELETE and INSERT per MERGE case kind)
        if any(c.action == "update" for c in stmt.clauses):
            self.access_control.check_can_update(self.identity, conn.name, schema, table)
        if any(not c.matched for c in stmt.clauses):
            self.access_control.check_can_insert(self.identity, conn.name, schema, table)
        if any(c.action == "delete" for c in stmt.clauses):
            self.access_control.check_can_delete(self.identity, conn.name, schema, table)
        self._check_writable()
        if self._active_txn() is not None:
            raise TransactionError("MERGE inside an explicit transaction is not supported")
        handle, meta = self._table(conn, schema, table)
        known = {c.name for c in meta.columns}
        for cl in stmt.clauses:
            set_names = [c for c, _ in cl.assignments]
            if len(set(set_names)) != len(set_names):
                raise AnalysisError("multiple assignments for the same column in MERGE")
            for col in set_names:
                if col not in known:
                    raise AnalysisError(f"unknown column {col} in MERGE")
            if cl.action == "insert":
                cols = cl.insert_columns or tuple(c.name for c in meta.columns)
                if len(cols) != len(cl.insert_values):
                    raise AnalysisError("MERGE INSERT column/value count mismatch")
                for col in cols:
                    if col not in known:
                        raise AnalysisError(f"unknown column {col} in MERGE INSERT")

        t_alias = stmt.target_alias or table
        s_alias = getattr(stmt.source, "alias", None)
        if s_alias is None and isinstance(stmt.source, ast.TableRef):
            s_alias = stmt.source.name[-1]
        if s_alias is None:
            raise AnalysisError("MERGE source requires an alias")
        target_rel = ast.TableRef(stmt.table, alias=t_alias)
        true_lit = ast.BooleanLiteral(True)
        false_lit = ast.BooleanLiteral(False)
        count_star = ast.SelectItem(ast.FunctionCall("count", (ast.Star(),)))

        def tcol(name: str) -> ast.Identifier:
            return ast.Identifier((t_alias, name))

        def any_of(clauses):
            out = None
            for cl in clauses:
                c = cl.condition or true_lit
                out = c if out is None else ast.BinaryOp("or", out, c)
            return out

        m_clauses = [c for c in stmt.clauses if c.matched]
        nm_clauses = [c for c in stmt.clauses if not c.matched]
        # cardinality rule: no target row may match more than one
        # source row (io.trino MERGE_TARGET_ROW_MULTIPLE_MATCHES)
        rid_target = ast.SubqueryRelation(
            ast.Query(ast.QuerySpec(
                (ast.SelectItem(ast.Star()),
                 ast.SelectItem(ast.WindowCall("row_number", (), ast.WindowSpec()),
                                "__merge_rid")),
                from_=ast.TableRef(stmt.table),
            )),
            alias=t_alias,
        )
        dup_q = ast.Query(ast.QuerySpec(
            (count_star,),
            from_=ast.SubqueryRelation(
                ast.Query(ast.QuerySpec(
                    (ast.SelectItem(tcol("__merge_rid")),),
                    from_=ast.Join("inner", rid_target, stmt.source, stmt.on),
                    group_by=(tcol("__merge_rid"),),
                    having=ast.BinaryOp(
                        "gt", ast.FunctionCall("count", (ast.Star(),)),
                        ast.NumberLiteral("1"),
                    ),
                )),
                alias="__merge_dups",
            ),
        ))
        if m_clauses and self._execute_query(dup_q).only_value() > 0:
            raise RuntimeError("One MERGE target table row matched more than one source row")

        # the matched flag rides the source side of the LEFT JOIN
        flagged_source = ast.SubqueryRelation(
            ast.Query(ast.QuerySpec(
                (ast.SelectItem(ast.Star()), ast.SelectItem(true_lit, "__merge_m")),
                from_=stmt.source,
            )),
            alias=s_alias,
        )
        matched = ast.FunctionCall(
            "coalesce", (ast.Identifier((s_alias, "__merge_m")), false_lit)
        )
        # survivors: per column, the FIRST matching arm's value. With no
        # WHEN MATCHED arm the target is untouched and must NOT join (a
        # LEFT JOIN would fan out on multiple source matches, which
        # insert-only MERGE legally allows)
        if not m_clauses:
            survivors = ast.QuerySpec(
                tuple(ast.SelectItem(tcol(c.name), c.name) for c in meta.columns),
                from_=target_rel,
            )
        else:
            items = []
            for col in meta.columns:
                old = tcol(col.name)
                whens = []
                for cl in m_clauses:
                    cond = cl.condition or true_lit
                    val = (dict(cl.assignments).get(col.name, old)
                           if cl.action == "update" else old)
                    whens.append(ast.WhenClause(ast.BinaryOp("and", matched, cond), val))
                items.append(ast.SelectItem(ast.Case(None, tuple(whens), old), col.name))
            # a row drops iff matched AND its first applicable arm is DELETE
            del_whens = [
                ast.WhenClause(cl.condition or true_lit,
                               true_lit if cl.action == "delete" else false_lit)
                for cl in m_clauses
            ]
            drop = ast.BinaryOp("and", matched, ast.Case(None, tuple(del_whens), false_lit))
            survivors = ast.QuerySpec(
                tuple(items),
                from_=ast.Join("left", target_rel, flagged_source, stmt.on),
                where=ast.UnaryOp("not", drop),
            )
        # affected rows: matched pairs whose first arm applies + inserts
        updated = 0
        if m_clauses:
            updated = self._execute_query(ast.Query(ast.QuerySpec(
                (count_star,),
                from_=ast.Join("inner", target_rel, stmt.source, stmt.on),
                where=any_of(m_clauses),
            ))).only_value()
        queries = [ast.Query(survivors)]
        if nm_clauses:
            anti = ast.Exists(ast.Query(ast.QuerySpec(
                (ast.SelectItem(ast.NumberLiteral("1")),),
                from_=target_rel, where=stmt.on,
            )), negated=True)
            ins_items = []
            for col in meta.columns:
                whens = []
                for cl in nm_clauses:
                    cols = cl.insert_columns or tuple(c.name for c in meta.columns)
                    val = dict(zip(cols, cl.insert_values)).get(col.name, ast.NullLiteral())
                    whens.append(ast.WhenClause(cl.condition or true_lit, val))
                ins_items.append(ast.SelectItem(
                    ast.Case(None, tuple(whens), ast.NullLiteral()), col.name))
            queries.append(ast.Query(ast.QuerySpec(
                tuple(ins_items), from_=stmt.source,
                where=ast.BinaryOp("and", anti, any_of(nm_clauses)),
            )))
        counts = self._replace_table_from_queries(cat, conn, handle, meta, queries)
        # the insert rewrite IS the anti join: its row count is the
        # inserted count (no third join execution)
        inserted = counts[1] if nm_clauses else 0
        return _count(updated + inserted)

    def _write_into(self, cat: str, conn, schema: str, table: str, output,
                    insert_columns: Optional[List[str]]) -> MaterializedResult:
        """Coerce the source onto the table schema and stream it into
        the connector page sink (TableWriterOperator)."""
        handle, meta = self._table(conn, schema, table)
        src_fields = output.fields
        if insert_columns is None:
            insert_columns = [c.name for c in meta.columns[: len(src_fields)]]
        if len(insert_columns) != len(src_fields):
            raise AnalysisError(
                f"INSERT has {len(src_fields)} columns but {len(insert_columns)} targets"
            )
        if len(set(insert_columns)) != len(insert_columns):
            raise AnalysisError("duplicate target column names in INSERT/CTAS")
        src_of = {name: i for i, name in enumerate(insert_columns)}
        instance = self._instance(self._planner().plan(
            self._coerced(output, meta, [src_of.get(c.name) for c in meta.columns])))
        self._check_writable()
        active = self._active_txn()
        txn_handle = (self.transactions.join(active, conn.name, conn)
                      if active is not None else None)
        if txn_handle is None and self.session.task_concurrency > 1:
            # autocommit bulk writes scale out with observed volume;
            # transactional writes keep ONE sink so the commit stays a
            # single handshake
            sink_impl = ScaledWriterSink(lambda: conn.page_sink(handle),
                                         max_writers=self.session.task_concurrency)
        else:
            sink_impl = conn.page_sink(handle, transaction=txn_handle)
        # a resident pin over this table absorbs an autocommit insert on
        # its delta side: tee the written rows through a DeltaTap. Rows
        # written inside a transaction are not visible before COMMIT, so
        # that insert evicts the pin instead (the reference taps it too)
        from trino_tpu_torch.resident import fastlane

        tap = None
        if txn_handle is None:
            tap = fastlane.delta_tap(cat, schema, table, [c.name for c in meta.columns])
        if tap is not None:
            sink_impl = fastlane.TeeSink(sink_impl, tap)
        writer = TableWriterOperator(sink_impl)
        self._drive(instance, writer)
        self._invalidate_plans(table=(cat, schema, table), appended=True, tap=tap)
        return _count(writer.rows_written)
