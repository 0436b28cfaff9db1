"""Coordinator: distributed planning + pipelined all-at-once scheduling.

Counterpart of trino_tpu/runtime/coordinator.py: the page-exchange path
(QueryScheduler over in-process Workers), retry_policy="query", the plan
cache over analyze -> optimize -> fragment, access control, the embedded
LocalQueryRunner for every non-query statement, drain, the cluster
memory manager over the workers' pools, EXPLAIN (the fragments) and
EXPLAIN ANALYZE (the stages), QueryInfo and the trace exports.
`DistributedQueryRunner(..., device=None)` runs its workers and its
embedded runner on the CUDA card and raises when there is none; the CPU
is used only when the caller passes device="cpu".

retry_policy="task" runs the FaultTolerantQueryScheduler (runtime/fte.py)
over the spooled exchange; worker handles may be HttpWorkerClients
(runtime/http.py), whose tasks pull pages over HTTP. Arms of later items
raise, naming the item, and never fall back to the page plane or to the
CPU: the mesh data plane (mesh_execution with in-process workers,
ROADMAP §1 item 12) and recovery_spool_stages (item 13). The reference's census
annotations, the adaptive controller's report and per-stage
estimated-vs-observed lines, and the resident, recovery, skew, replica,
scheduler, membership and concurrency lines of EXPLAIN ANALYZE belong to
items 12-13 and are left out.

Analogue of SqlQueryExecution (planQuery/planDistribution,
SqlQueryExecution.java:457/503) + PipelinedQueryScheduler.java:155
(StageManager creating every stage up front, tasks streaming pages
between stages through pull+ack buffers — SURVEY.md §3.1–§3.4).
The DistributedQueryRunner facade mirrors
testing/trino-testing/DistributedQueryRunner.java:84: one coordinator +
N workers in one process, real exchange data plane between tasks.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.config import check_session
from trino_tpu_torch.connectors.spi import CatalogManager, Connector
from trino_tpu_torch.engine import MaterializedResult, Session
from trino_tpu_torch.runtime.task import TaskId, TaskSpec
from trino_tpu_torch.runtime.worker import Worker
from trino_tpu_torch.sql import ast
from trino_tpu_torch.sql.analyzer import Analyzer
from trino_tpu_torch.sql.fragmenter import SubPlan, explain_distributed, plan_distributed
from trino_tpu_torch.sql.parser import parse
from trino_tpu_torch.exec.serde import Page

_query_counter = itertools.count(1)


class QueryScheduler:
    """Schedules one query's SubPlan over the workers (pipelined mode:
    every stage starts immediately; pages stream between running stages)."""

    def __init__(
        self,
        query_id: str,
        subplan: SubPlan,
        workers: List[Worker],
        catalogs: CatalogManager,
        session: Session,
        hash_partitions: Optional[int] = None,
        collect_stats: bool = False,
        trace=None,
        query_span=None,
        deadline_epoch_s: Optional[float] = None,
        *,
        device,
    ):
        self.device = device
        self.query_id = query_id
        self.subplan = subplan
        self.workers = workers
        self.catalogs = catalogs
        self.session = session
        self.collect_stats = collect_stats
        self.deadline_epoch_s = deadline_epoch_s
        self.hash_partitions = hash_partitions or min(
            len(workers), session.hash_partition_count
        )
        # fragment id -> [(worker handle, task id string)]
        self.tasks: Dict[int, List] = {}
        self._schemas: Dict[int, list] = {}
        # tracing (runtime/tracing.py): one stage span per fragment and
        # one task span per launch, all hanging off `query_span`; tasks
        # get wire_context on TaskSpec so worker operator spans graft in
        self.trace = trace
        self.query_span = query_span
        self.stage_spans: Dict[int, object] = {}
        self.task_spans: Dict[str, object] = {}

    def start(self):
        """Create all tasks bottom-up (producers first so consumers can
        reference their buffers); returns the root task."""
        from trino_tpu_torch.runtime.stages import (
            fragment_schema,
            stage_task_count,
            topo_order,
        )

        order = topo_order(self.subplan)
        task_counts: Dict[int, int] = {}
        consumer_counts: Dict[int, int] = {}
        # first pass: task counts; consumer partition counts per producer
        for sp in order:
            task_counts[sp.fragment.id] = stage_task_count(
                sp, len(self.workers), self.hash_partitions
            )
        for sp in order:
            for c in sp.children:
                consumer_counts[c.fragment.id] = task_counts[sp.fragment.id]
        from trino_tpu_torch.runtime.node_scheduler import (
            TopologyAwareNodeSelector,
            UniformNodeSelector,
        )

        # least-loaded placement with a per-node cap (NodeScheduler /
        # UniformNodeSelector analogue; replaces blind round-robin).
        # Workers carrying a `location` ("rack/host" — the ICI-island
        # coordinate on a TPU pod) upgrade to tiered topology-aware
        # selection (TopologyAwareNodeSelector.java)
        cap = max(
            2,
            (sum(task_counts.values()) + len(self.workers) - 1)
            // max(len(self.workers), 1),
        )
        locations = {
            id(w): getattr(w, "location")
            for w in self.workers
            if getattr(w, "location", None)
        }
        selector = (
            TopologyAwareNodeSelector(locations, max_tasks_per_node=cap)
            if locations
            else UniformNodeSelector(max_tasks_per_node=cap)
        )
        tracing = self.trace is not None and self.query_span is not None
        if tracing:
            from trino_tpu_torch.runtime.tracing import (
                KIND_STAGE,
                KIND_TASK,
                wire_context,
            )
        for sp in order:
            f = sp.fragment
            tc = task_counts[f.id]
            n_out = consumer_counts.get(f.id, 1)
            if tracing:
                self.stage_spans[f.id] = self.query_span.child(
                    f"stage {f.id}", KIND_STAGE, fragment_id=f.id, tasks=tc
                )
            remote = {
                c.fragment.id: self._schemas[c.fragment.id]
                for c in sp.children
            }
            self._schemas[f.id] = fragment_schema(
                self.catalogs, self.session, sp, remote, self.device
            )
            input_locations = {
                c.fragment.id: [
                    handle.results_location(tid)
                    for handle, tid in self.tasks[c.fragment.id]
                ]
                for c in sp.children
            }
            created = []
            for p in range(tc):
                task_id = TaskId(self.query_id, f.id, p)
                spec = TaskSpec(
                    task_id=task_id,
                    fragment=f,
                    n_output_partitions=n_out,
                    remote_schemas=remote,
                    scan_slice=(p, tc) if f.partitioning == "source" else None,
                    input_locations=input_locations,
                    batch_rows=self.session.batch_rows,
                    target_splits=max(self.session.target_splits, tc),
                    dynamic_filtering=self.session.enable_dynamic_filtering,
                    collect_stats=self.collect_stats,
                    task_concurrency=self.session.task_concurrency,
                    deadline_epoch_s=self.deadline_epoch_s,
                )
                if tracing:
                    tspan = self.stage_spans[f.id].child(
                        f"task {task_id}", KIND_TASK, partition=p
                    )
                    self.task_spans[str(task_id)] = tspan
                    if self.collect_stats:
                        # operator spans only under query_trace=on —
                        # the traced-off run stays an honest baseline
                        spec.trace_ctx = wire_context(tspan)
                first_loc = (
                    locations.get(id(created[0][0]))
                    if locations and created else None
                )
                if first_loc is not None:
                    # co-schedule a fragment's tasks on the FIRST
                    # task's ISLAND (rack tier, not the host — stacking
                    # a fragment on one host would serialize it): its
                    # exchanges then ride ICI, not DCN. A location-less
                    # first task keeps uniform selection.
                    worker = selector.select(
                        self.workers,
                        location=TopologyAwareNodeSelector._rack(
                            first_loc
                        ),
                    )
                else:
                    worker = selector.select(self.workers)
                worker.create_task(spec)
                created.append((worker, str(task_id)))
            self.tasks[f.id] = created
        return self.tasks[self.subplan.fragment.id][0]

    def failed_tasks(self) -> List[str]:
        out = []
        for ts in self.tasks.values():
            for handle, tid in ts:
                try:
                    st = handle.task_state(tid)
                except Exception as e:
                    out.append(f"{tid}: status fetch failed ({e})")
                    continue
                if st["state"] == "failed":
                    out.append(f"{tid}: {st.get('failure')}")
        return out

    def finalize(self) -> Dict[int, List]:
        """Terminal status sweep, run BEFORE abort() (remove_task
        destroys the span/stats data): pull each task's final status,
        graft its operator spans into the trace, and close the task and
        stage spans with worker-reported wall bounds. Returns
        fragment id -> [(task id, status dict)] for QueryInfo."""
        # settle: draining the root output races the root task's own
        # state flip by a few ms — wait for every task to go terminal
        # so QueryInfo/EXPLAIN ANALYZE never snapshot a "running" task
        # with half-flushed stats (bounded: failure paths have already
        # flipped their tasks to failed before finalize runs)
        deadline = time.time() + 2.0
        while time.time() < deadline:
            settled = True
            for ts in self.tasks.values():
                for handle, tid in ts:
                    try:
                        st = handle.task_state(tid)
                    except Exception:
                        continue
                    if st.get("state") == "running":
                        settled = False
            if settled:
                break
            time.sleep(0.005)
        states: Dict[int, List] = {}
        for fid, ts in self.tasks.items():
            lst = []
            for handle, tid in ts:
                try:
                    st = handle.task_state(tid)
                except Exception as e:
                    st = {"state": "unknown",
                          "failure": f"status fetch failed ({e})",
                          "cpu_s": 0.0}
                lst.append((tid, st))
                span = self.task_spans.get(tid)
                if span is not None:
                    if st.get("start_time"):
                        span.start_s = st["start_time"]
                    span.set(state=st.get("state"),
                             cpu_s=st.get("cpu_s") or 0.0)
                    if st.get("failure"):
                        span.set(error=True)
                        span.event("task_failed",
                                   message=str(st["failure"])[:500])
                    span.end(st.get("end_time"))
                if self.trace is not None:
                    self.trace.graft(st.get("spans") or [])
            states[fid] = lst
        for span in self.stage_spans.values():
            span.end()
        return states

    def abort(self) -> None:
        for ts in self.tasks.values():
            for handle, tid in ts:
                try:
                    handle.remove_task(tid)
                except Exception:
                    pass


class DistributedQueryRunner:
    """Multi-worker engine in one process (DistributedQueryRunner.java:84
    analogue): same SQL surface as LocalQueryRunner, but every query runs
    through fragments, tasks and the page exchange."""

    def __init__(
        self,
        session: Optional[Session] = None,
        n_workers: int = 2,
        hash_partitions: Optional[int] = None,
        worker_handles: Optional[List] = None,
        access_control=None,
        device=None,
    ):
        """Default topology: N in-process Workers sharing the coordinator
        CatalogManager, each on `device` (None: the CUDA card, raising
        without one). `worker_handles` schedules over Workers the caller
        built instead (their catalogs registered by the caller), in-process
        Workers or HttpWorkerClients of WorkerServers. `access_control`
        guards distributed Query statements AND the embedded single-node
        runner (same policy object on both paths)."""
        from trino_tpu_torch.engine import resolve_device
        from trino_tpu_torch.security import AllowAllAccessControl

        self.device = resolve_device(device)
        self.session = session or Session()
        self.access_control = access_control or AllowAllAccessControl()
        self.catalogs = CatalogManager()
        if worker_handles is not None:
            self.workers = list(worker_handles)
            self._in_process_workers = False
        else:
            self.workers = [
                Worker(
                    f"worker-{i}", self.catalogs,
                    memory_pool_bytes=self.session.memory_pool_bytes,
                    stuck_task_interrupt_s=getattr(
                        self.session, "stuck_task_interrupt_s", 0.0
                    ) or None,
                    stuck_task_interrupt_warm_s=getattr(
                        self.session, "stuck_task_interrupt_warm_s", 0.0
                    ) or None,
                    device=self.device,
                )
                for i in range(n_workers)
            ]
            self._in_process_workers = True
        self.hash_partitions = hash_partitions
        # the reference registers the recovery tier's counters here
        # (ROADMAP §1 item 13)
        # resiliency plane: every worker is registered with a
        # NodeManager whose per-node circuit breakers graylist
        # misbehaving workers (ping loop NOT started here — call
        # .node_manager.start() for live heartbeats, or ping_once() for
        # deterministic tests)
        from trino_tpu_torch.runtime.discovery import NodeManager

        self.node_manager = NodeManager(
            breaker_threshold=self.session.node_breaker_threshold,
            breaker_cooldown_s=self.session.node_breaker_cooldown_s,
        )
        for w in self.workers:
            self.node_manager.register(w)
            # remote handles (HttpWorkerClient): bind the session's
            # retry budget and the breaker listener unless the caller
            # already chose them explicitly
            if getattr(w, "retry_policy", False) is None:
                from trino_tpu_torch.runtime.error_tracker import RetryPolicy

                w.retry_policy = RetryPolicy(
                    max_error_duration_s=(
                        self.session.request_max_error_duration_s
                    ),
                )
            if (
                hasattr(w, "failure_listener")
                and w.failure_listener is None
            ):
                w.failure_listener = self.node_manager
        # how many whole-query attempts the last statement took
        # (retry_policy=QUERY observability; 1 = no retry happened)
        self.last_query_attempts: int = 0
        # retry_policy=TASK observability: retries, speculation and
        # attempts per partition of the last FTE query
        self.last_fte_stats: Optional[dict] = None
        # cluster memory arbiter over the in-process workers' SHARED
        # pools: on exhaustion kill the largest query, not the worker
        self.memory_manager = None
        if (
            self._in_process_workers
            and self.session.memory_pool_bytes
            and self.session.low_memory_killer_enabled
        ):
            from trino_tpu_torch.runtime.memory import ClusterMemoryManager

            self.memory_manager = ClusterMemoryManager(
                [w.memory_pool for w in self.workers],
                fail_query=self._fail_query_on_workers,
            )
            self.memory_manager.install()
        # deadline hierarchy (runtime/query_tracker.py): every Query
        # statement registers here; the enforcement tick thread starts
        # lazily, on the first query that actually carries limits
        from trino_tpu_torch.runtime.query_tracker import QueryTracker

        self.query_tracker = QueryTracker()
        # observability plane: event listener SPI (QueryCreated/
        # QueryCompleted with resource enrichment), the bounded
        # completed-query registry behind GET /v1/query/{id} and
        # /v1/query/{id}/trace, and in-flight traces for live lookups
        from trino_tpu_torch.runtime.events import EventListenerManager

        self.event_listeners = EventListenerManager()
        self.event_listeners.register_metrics()
        # the reference also installs its XLA compile listener and
        # registers the mesh plane's (ROADMAP §1 item 12) and the
        # analysis tier's (item 13) gauges here
        # serving tier: canonical-text plan cache over the distributed
        # planning pipeline (analyze -> optimize -> fragment). DDL/DML
        # through the embedded runner and catalog registration
        # invalidate wholesale — fragments capture table handles whose
        # split listings describe a data snapshot.
        from trino_tpu_torch.serving.plan_cache import PlanCache

        self._plan_cache = PlanCache(
            max_entries=getattr(self.session, "plan_cache_entries", 256)
        )
        import collections

        self._completed_queries = collections.OrderedDict()
        self._completed_queries_cap = 200
        self.last_query_id: Optional[str] = None
        self._active_traces: Dict[str, tuple] = {}
        self._lock = threading.Lock()  # DistributedQueryRunner._lock

    def _fail_query_on_workers(self, query_id: str, message: str) -> None:
        for w in self.workers:
            try:
                w.fail_query(query_id, message)
            except Exception:
                pass

    def drain(self, worker_id: str, timeout_s: float = 30.0) -> bool:
        """Gracefully drain a worker: it leaves the placement pool
        immediately, refuses new task launches, and this call returns
        True once everything running on it reached a terminal state
        (committed, or re-placed elsewhere by the scheduler). False on
        timeout — the worker stays out of rotation, still serving its
        spooled output."""
        return self.node_manager.drain(worker_id, timeout_s=timeout_s)

    def _schedulable_workers(self) -> List:
        """Placement pool for new launches: breaker-closed active nodes,
        degrading to the full set rather than refusing to run."""
        nm = self.node_manager
        return (
            nm.schedulable_workers() or nm.active_workers() or self.workers
        )

    def _mesh_colocated(self) -> bool:
        """The reference's mesh plane applies when every task would run
        in THIS process (in-process workers sharing the host's devices);
        caller-built worker handles keep the page exchange."""
        return self._in_process_workers

    def register_catalog(self, name: str, connector: Connector) -> None:
        self.catalogs.register(name, connector)
        # a new catalog can shadow names any cached plan resolved
        # against: wholesale, not table-granular. The reference also
        # bumps the resident tier's generations here (ROADMAP §1 item 13)
        self._plan_cache.invalidate()

    def _dml_target(self, stmt):
        """(catalog, schema, table) a non-Query statement writes, via
        the session defaults (the embedded runner's _resolve_target
        rule); None = cannot name one (COMMIT/ROLLBACK — wholesale)."""
        parts = getattr(stmt, "table", None)
        if not parts or not isinstance(parts, (tuple, list)):
            return None
        cat, schema = self.session.catalog, self.session.schema
        if len(parts) == 2:
            schema = parts[0]
        elif len(parts) == 3:
            cat, schema = parts[0], parts[1]
        # canonical (catalog, schema, table): case-folded like the
        # analyzer's identifier resolution
        return (str(cat).lower(), str(schema).lower(), str(parts[-1]).lower())

    def _embedded_runner(self):
        if getattr(self, "_embedded", None) is None:
            from trino_tpu_torch.engine import LocalQueryRunner

            lqr = LocalQueryRunner(
                self.session, access_control=self.access_control,
                device=self.device,
            )
            lqr.catalogs = self.catalogs
            self._embedded = lqr
        return self._embedded

    def _check_access(self, output, identity) -> None:
        """AccessControl for distributed Query statements (the
        LocalQueryRunner._check_scans policy applied to the same plan
        the fragmenter will cut)."""
        from trino_tpu_torch.security import Identity
        from trino_tpu_torch.sql.plan import ScanNode

        ident = identity or Identity(self.session.user)
        self.access_control.check_can_execute_query(ident)

        def walk(node):
            if isinstance(node, ScanNode):
                h = node.handle
                self.access_control.check_can_select(
                    ident, h.catalog, h.schema, h.table, node.columns
                )
            for c in node.children():
                walk(c)

        walk(output)

    # -- entry point --
    def execute(
        self, sql: str, identity=None, transaction_id=None,
        prepared=None, cancel=None,
    ) -> MaterializedResult:
        """`cancel` is a zero-arg callable polled while the query runs
        (the client-abandonment reaper's hook): once it returns True the
        query is torn down — tasks aborted, memory released — instead of
        computing a result nobody will read."""
        import time as _time

        t_parse0 = _time.time()
        stmt = parse(sql)
        t_parse1 = _time.time()
        if isinstance(stmt, (ast.ExplainStatement, ast.Query, ast.ExecuteStmt)):
            # a property whose reader is an unported tier (the adaptive
            # controller, the shape census, ...) raises, naming its item
            check_session(self.session)
        if isinstance(stmt, ast.ExplainStatement):
            output = self._analyze(stmt.query)
            self._check_access(output, identity)
            subplan = plan_distributed(
                output, self.catalogs,
                broadcast_threshold=self.session.broadcast_join_threshold,
                target_splits=self.session.target_splits,
                validation=getattr(self.session, "plan_validation", "passes"),
            )
            if stmt.analyze:
                return self._explain_analyze(subplan)
            return MaterializedResult(
                [[self._explain_text(subplan)]], ["Query Plan"], [T.VARCHAR]
            )
        param_dtypes: tuple = ()
        if isinstance(stmt, ast.ExecuteStmt):
            # EXECUTE of a prepared Query runs DISTRIBUTED: resolve the
            # text (request-carried headers take precedence over the
            # shared embedded store, mirroring LocalQueryRunner), check
            # the binding up front (typed arity/dtype errors instead of
            # analyzer failures deep in the substituted tree), then fall
            # through with the bound statement and its dtype vector as a
            # plan-cache key component
            text = (prepared or {}).get(stmt.name)
            if text is None:
                hit = self._embedded_runner()._prepared.get(stmt.name)
                text = hit[1] if hit else None
            if text is not None:
                from trino_tpu_torch.serving.params import check_parameters

                body = parse(text)
                dtypes = check_parameters(
                    body, stmt.parameters, self.catalogs,
                    self.session.catalog, self.session.schema,
                )
                bound = ast.substitute_parameters(body, stmt.parameters)
                if isinstance(bound, ast.Query):
                    stmt = bound
                    param_dtypes = tuple(dtypes)
            # unknown name / non-Query body: the embedded path below
            # reports or runs it
        if not isinstance(stmt, ast.Query):
            # metadata/DML/transaction statements take the single-node
            # path — through ONE persistent embedded runner, so
            # transaction state survives across statements (a throwaway
            # runner per statement would silently autocommit)
            result = self._embedded_runner().execute(
                sql, identity=identity,
                transaction_id=transaction_id, prepared=prepared,
            )
            if isinstance(stmt, (
                ast.CreateTable, ast.CreateTableAs, ast.Insert,
                ast.Delete, ast.Update, ast.Merge, ast.DropTable,
                ast.Commit, ast.Rollback,
            )):
                # cached plans captured split listings over data this
                # statement may have changed. The embedded runner already
                # drove the resident-tier protocol (generation bump /
                # delta re-key) — here only the DISTRIBUTED plan cache
                # needs dropping, table-granular when the statement names
                # its target
                tkey = self._dml_target(stmt)
                if tkey is not None:
                    self._plan_cache.invalidate_tables([tkey])
                else:
                    self._plan_cache.invalidate()
            return result
        from trino_tpu_torch.runtime.query_tracker import DeadlineLimits, PLANNING

        limits = DeadlineLimits.from_session(self.session)
        # retry_policy=QUERY deterministic replay: every attempt re-runs
        # the SAME plan under a fresh internal task namespace (qN, qNr1,
        # qNr2, ...) — create_task is idempotent BY ID, so reusing the
        # first attempt's ids would hand back its dead TaskExecutions.
        # No dot in the suffix: task keys are matched by the
        # `query_id + "."` prefix and attempts must never cross-match.
        base_qid = f"q{next(_query_counter)}"
        tracker = self.query_tracker
        tq = tracker.register(base_qid, limits, phase=PLANNING)
        # bound late: the kill must target whichever ATTEMPT namespace is
        # live when the tick fires (live_query_id tracks qN/qNr1/...)
        tq.kill = lambda msg: self._fail_query_on_workers(
            tq.live_query_id, msg
        )
        if limits.any():
            tracker.start()
        # every distributed query gets a coordinator-side span tree
        # (query/phases/stages/tasks — a handful of spans); worker
        # OPERATOR spans and row counting only under query_trace=on
        from trino_tpu_torch.runtime.events import QueryCreatedEvent
        from trino_tpu_torch.runtime.metrics import METRICS
        from trino_tpu_torch.runtime.tracing import (
            KIND_PHASE,
            KIND_QUERY,
            QueryTrace,
        )

        trace = QueryTrace(base_qid)
        qspan = trace.span(f"query {base_qid}", KIND_QUERY, sql=sql[:500])
        qspan.start_s = t_parse0
        pspan = qspan.child("parse", KIND_PHASE)
        pspan.start_s = t_parse0
        pspan.end(t_parse1)
        with self._lock:
            self._active_traces[base_qid] = trace
        counters_before = METRICS.snapshot()
        self.event_listeners.query_created(
            QueryCreatedEvent(base_qid, sql, _time.time())
        )
        self._last_stage_infos = None
        self._last_data_plane = "http"
        status, failure_txt, rows_n = "finished", None, 0
        try:
            result = self._execute_query(
                stmt, identity, base_qid, tq, limits, cancel,
                trace=trace, query_span=qspan, param_dtypes=param_dtypes,
            )
            rows_n = len(result.rows)
            return result
        except BaseException as e:
            status, failure_txt = "failed", repr(e)
            if not qspan.ended:
                qspan.event("exception", type=type(e).__name__,
                            message=str(e)[:500])
                qspan.set(error=True)
            raise
        finally:
            tracker.complete(base_qid)
            self._finalize_query(
                base_qid, sql, trace, qspan, status, failure_txt,
                rows_n, counters_before,
            )

    def _execute_query(
        self, stmt, identity, base_qid, tq, limits, cancel,
        trace=None, query_span=None, param_dtypes=(),
    ) -> MaterializedResult:
        from trino_tpu_torch.runtime.query_tracker import (
            EXECUTING,
            QueryDeadlineError,
            deadline_code,
            deadline_error,
        )
        from trino_tpu_torch.runtime.tracing import KIND_PHASE

        def phase(name):
            if query_span is None:
                import contextlib

                return contextlib.nullcontext()
            return query_span.child(name, KIND_PHASE)

        tracker = self.query_tracker
        cache_key = None
        try:
            from trino_tpu_torch.sql.formatter import format_statement

            cache_key = self._plan_cache.key(
                format_statement(stmt), self.session, param_dtypes
            )
        except Exception:
            pass  # unformattable statement: plan uncached
        cached = self._plan_cache.lookup(cache_key) if cache_key else None
        if cached is not None:
            output, subplan = cached
            # access control is NOT part of the key: the cached logical
            # plan is re-checked under THIS caller's identity
            self._check_access(output, identity)
            if query_span is not None:
                query_span.event("plan_cache_hit")
        else:
            from trino_tpu_torch.sql.analyzer import (
                plan_is_volatile,
                reset_volatile_plan,
            )

            # snapshot BEFORE planning: a catalog change racing the
            # analyze/optimize/fragment work below must void this store
            cache_generation = self._plan_cache.generation
            reset_volatile_plan()
            output = self._analyze(stmt, query_span=query_span)
            self._check_access(output, identity)
            # the reference's adaptive controller re-plans here when
            # adaptive_execution is on; config.check_session refused
            # that property (ROADMAP §1 item 13) before planning began
            with phase("fragment"):
                subplan = plan_distributed(
                    output,
                    self.catalogs,
                    broadcast_threshold=self.session.broadcast_join_threshold,
                    target_splits=self.session.target_splits,
                    validation=getattr(
                        self.session, "plan_validation", "passes"
                    ),
                )
            if cache_key is not None and not plan_is_volatile():
                from trino_tpu_torch.serving.plan_cache import plan_tables

                self._plan_cache.store(
                    cache_key, (output, subplan),
                    generation=cache_generation,
                    tables=plan_tables(output),
                )
        # planning is over: surface a planning-limit kill latched during
        # the analyze/optimize/fragment work before any task launches.
        # Enforce synchronously first — a planning phase that finishes
        # between background ticks must not outrun its own budget
        tracker.enforce_now(base_qid)
        tracker.check(base_qid)
        tracker.transition(base_qid, EXECUTING)
        # worker-local deadline: translate the query's remaining wall
        # budget into the epoch-seconds deadline every TaskSpec carries,
        # so workers self-terminate between batches instead of waiting
        # for the coordinator's enforcement tick to reach them
        deadline_epoch_s = None
        if limits is not None:
            import time as _time

            budgets = []
            if limits.max_execution_time_s:
                budgets.append(limits.max_execution_time_s)
            if limits.max_run_time_s:
                budgets.append(max(
                    0.0,
                    limits.max_run_time_s
                    - (_time.monotonic() - tq.created_at),
                ))
            if budgets:
                deadline_epoch_s = _time.time() + min(budgets)
        result_meta = (list(output.names), [f.type for f in output.fields])
        # the reference's recovery tier: with recovery_spool_stages on,
        # every stage records its output pages and a retry substitutes
        # the failed attempt's finished fragments for recomputing them
        # (in the FTE scheduler and the QUERY retry loop alike)
        if getattr(self.session, "recovery_spool_stages", False):
            raise NotImplementedError(
                "recovery_spool_stages: stage-output recovery is ROADMAP §1 item 13"
            )
        if self.session.retry_policy == "task":
            self._last_data_plane = "fte"
            rows = self._execute_fte(
                subplan, query_id=base_qid, cancel=cancel, tq=tq,
                trace=trace, query_span=query_span,
                deadline_epoch_s=deadline_epoch_s,
            )
            return MaterializedResult(rows, *result_meta, data_plane="fte")
        if self.session.mesh_execution and self._mesh_colocated():
            # the reference runs this query on the device mesh (exchanges
            # as collectives); the port raises rather than run the page
            # plane in its place
            raise NotImplementedError(
                "mesh_execution with in-process workers: the multi-GPU mesh "
                "plane is ROADMAP §1 item 12 (pass mesh_execution=False for "
                "the page exchange)"
            )
        attempts = (
            1 + self.session.query_retry_count
            if self.session.retry_policy == "query"
            else 1
        )
        last_error: Optional[BaseException] = None
        accrued_cpu = 0.0  # CPU spent by completed attempts
        for attempt in range(attempts):
            query_id = base_qid if attempt == 0 else f"{base_qid}r{attempt}"
            self.last_query_attempts = attempt + 1
            tracker.set_live_query_id(base_qid, query_id)
            # a deadline kill latched between attempts ends the query
            # here — resubmitting a spent budget can only spend it again
            tracker.check(base_qid)
            if cancel is not None and cancel():
                # nobody is waiting for this result: don't launch (or
                # re-launch) tasks for it
                from trino_tpu_torch.runtime.query_tracker import (
                    QueryAbandonedError,
                )

                raise QueryAbandonedError(
                    f"Query {base_qid} abandoned: client stopped "
                    "polling results"
                )
            attempt_subplan = subplan
            if attempt > 0:
                # a stale cached split listing may be WHY the last
                # attempt died (files compacted/deleted under it):
                # re-list before replaying
                self.catalogs.invalidate_split_listings()
                if query_span is not None:
                    query_span.event(
                        "query_retry", attempt=attempt,
                        error=str(last_error)[:300],
                    )
            scheduler = QueryScheduler(
                query_id,
                attempt_subplan,
                self._schedulable_workers(),
                self.catalogs,
                self.session,
                self.hash_partitions,
                collect_stats=(
                    getattr(self.session, "query_trace", "off") == "on"
                ),
                trace=trace,
                query_span=query_span,
                deadline_epoch_s=deadline_epoch_s,
                device=self.device,
            )
            # the CPU budget reads the live attempt's task ledgers on
            # top of what earlier attempts already burned
            tq.cpu_time_fn = (
                lambda s=scheduler, base=accrued_cpu:
                base + _scheduler_cpu_s(s)
            )
            try:
                # start() inside the try: a mid-launch failure must still
                # abort the tasks already created, and counts as a
                # retryable attempt under retry_policy=QUERY. Worker
                # crashes surface as OSError/URLError, not RuntimeError,
                # so catch broadly here — analysis errors were raised
                # before this loop.
                with phase("schedule"):
                    root_handle, root_tid = scheduler.start()
                rows = self._collect(
                    scheduler, root_handle, root_tid,
                    cancel=cancel, base_qid=base_qid,
                )
                return MaterializedResult(
                    rows, *result_meta, data_plane="http"
                )
            except QueryDeadlineError:
                raise  # non-retryable by classification
            except Exception as e:
                if deadline_code(str(e)) is not None:
                    # a deadline kill that travelled as a task-failure
                    # string (HTTP 500 body, buffer-abort unwind):
                    # re-type it so it stays non-retryable
                    raise deadline_error(str(e)) from e
                # retry_policy=QUERY: whole-query re-run
                accrued_cpu += _scheduler_cpu_s(scheduler)
                last_error = e
            finally:
                # terminal sweep BEFORE abort (remove_task destroys the
                # span/stats data): grafts worker spans, closes stage/
                # task spans, snapshots task states for QueryInfo
                try:
                    self._last_stage_infos = self._stage_infos(
                        scheduler.finalize()
                    )
                except Exception:
                    pass  # observability must never mask the verdict
                scheduler.abort()
        raise last_error

    def _execute_fte(
        self, subplan, query_id=None, cancel=None, tq=None,
        trace=None, query_span=None, deadline_epoch_s=None,
    ) -> List[list]:
        """retry_policy=TASK: FTE over the spooled exchange."""
        import os
        import shutil
        import tempfile

        from trino_tpu_torch.runtime.fte import (
            FaultTolerantQueryScheduler,
            TaskRetriesExceeded,
        )
        from trino_tpu_torch.runtime.spool import read_spool

        query_id = query_id or f"q{next(_query_counter)}"
        spool_dir = tempfile.mkdtemp(prefix=f"trino-tpu-torch-spool-{query_id}-")
        scheduler = None
        try:
            scheduler = FaultTolerantQueryScheduler(
                query_id,
                subplan,
                self.workers,
                self.catalogs,
                self.session,
                spool_dir,
                self.hash_partitions,
                max_task_retries=self.session.task_retries,
                node_manager=self.node_manager,
                trace=trace,
                query_span=query_span,
                collect_stats=(
                    getattr(self.session, "query_trace", "off") == "on"
                ),
                deadline_epoch_s=deadline_epoch_s,
                device=self.device,
            )
            if tq is not None:
                # CPU budget over the FTE attempt ledgers (polled task
                # states carry cpu_s; finished attempts keep their last
                # reading in the scheduler's per-task dict)
                tq.cpu_time_fn = scheduler.cpu_time_s
            try:
                _, root_key = scheduler.run(cancel=cancel)
            except TaskRetriesExceeded as e:
                if "ExceededMemoryLimitError" in str(e) or (
                    "low-memory killer" in str(e)
                ):
                    from trino_tpu_torch.runtime.memory import (
                        ExceededMemoryLimitError,
                    )

                    raise ExceededMemoryLimitError(str(e)) from e
                raise
            finally:
                # bounded-attempt observability, success or failure
                self.last_fte_stats = {
                    "retries": scheduler.retries,
                    "speculative_hits": scheduler.speculative_hits,
                    "speculation_wins": scheduler.speculation_wins,
                    "speculation_losses": scheduler.speculation_losses,
                    "attempts_per_partition": dict(
                        scheduler.attempts_per_partition
                    ),
                    # which quantile sized the straggler threshold, and
                    # the per-fragment wall-time estimates it produced
                    "speculation_percentile": (
                        scheduler.speculation_percentile
                    ),
                    "speculation_estimates": dict(
                        scheduler.speculation_estimates
                    ),
                }
                # QueryInfo stage rollups from the FTE attempt snapshots
                # (taken at each attempt's terminal observation); the
                # reference's estimated-vs-observed divergence lines are
                # the adaptive tier's (ROADMAP §1 item 13)
                try:
                    self._last_stage_infos = self._stage_infos(
                        scheduler.task_snapshots()
                    )
                except Exception:
                    pass
            root_dir = os.path.join(spool_dir, root_key)
            rows: List[list] = []
            token = 0
            while True:
                pages, token, complete = read_spool(root_dir, 0, token)
                for page in pages:
                    rows.extend(_page_rows(page))
                if complete:
                    return rows
        finally:
            if scheduler is not None:
                scheduler.release()
            shutil.rmtree(spool_dir, ignore_errors=True)

    def _explain_text(self, subplan) -> str:
        """The fragments (the reference also annotates each with its
        census of expected XLA lowerings: ROADMAP §1 item 13)."""
        return explain_distributed(subplan)

    def _explain_analyze(self, subplan) -> MaterializedResult:
        """Distributed EXPLAIN ANALYZE: run the query with operator
        instrumentation on, pull each task's OperatorStats from its
        status (the TaskInfo aggregation path, Driver -> Task -> Stage),
        and render the fragment plan annotated with per-stage operator
        lines summed across that stage's tasks."""
        from trino_tpu_torch.runtime.queryinfo import stage_text

        query_id = f"q{next(_query_counter)}"
        scheduler = QueryScheduler(
            query_id, subplan, self.workers, self.catalogs, self.session,
            self.hash_partitions, collect_stats=True, device=self.device,
        )
        try:
            root_handle, root_tid = scheduler.start()
            self._collect(scheduler, root_handle, root_tid)
            # the TaskInfo aggregation path (runtime/queryinfo.py):
            # merged per-stage operator lines through the shared
            # OperatorStats formatter PLUS the per-task summary lines
            # distributed EXPLAIN ANALYZE used to lose
            stages = self._stage_infos(scheduler.finalize())
            lines = [self._explain_text(subplan)]
            for stage in stages:
                lines.append(stage_text(stage))
            # the reference goes on with the data-plane, resident,
            # recovery, skew, replica, scheduler, membership and
            # concurrency lines of items 12-13
            return MaterializedResult(
                [["\n".join(lines)]], ["Query Plan"], [T.VARCHAR]
            )
        finally:
            scheduler.abort()

    def _analyze(self, q: ast.Query, query_span=None):
        import contextlib

        from trino_tpu_torch.sql.optimizer import (
            canonicalize_tstz_keys,
            optimize,
        )

        from trino_tpu_torch.sql.analyzer import (
            set_session_info,
            set_session_zone,
        )

        def phase(name):
            if query_span is None:
                return contextlib.nullcontext()
            from trino_tpu_torch.runtime.tracing import KIND_PHASE

            return query_span.child(name, KIND_PHASE)

        set_session_zone(self.session.timezone)
        set_session_info(
            self.session.catalog, self.session.schema, self.session.user
        )
        analyzer = Analyzer(
            self.catalogs, self.session.catalog, self.session.schema
        )
        with phase("analyze"):
            root = analyzer.plan(q)
        with phase("optimize"):
            root = optimize(root, self.catalogs, self.session)
            # correctness pass (was missing here while present on the
            # single-node path — found by the exchange-key validator:
            # distributed plans hashed tstz join/group keys with the
            # packed zone bits still set, splitting equal instants
            # across tasks)
            root = canonicalize_tstz_keys(root)
        if getattr(self.session, "plan_validation", "passes") != "off":
            from trino_tpu_torch.sql.validate import validate_logical

            with phase("validate"):
                validate_logical(root, stage="canonicalize_tstz_keys")
        return root

    def _collect(
        self, scheduler: QueryScheduler, handle, tid,
        cancel=None, base_qid=None,
    ) -> List[list]:
        """Pull the root stage's single output partition (the
        Query.getNextResult / removePagesFromExchange path,
        server/protocol/Query.java:450)."""
        import time as _time

        from trino_tpu_torch.runtime.metrics import METRICS

        rows: List[list] = []
        token = 0
        while True:
            if cancel is not None and cancel():
                # client abandonment: raising here unwinds into the
                # retry loop's finally — scheduler.abort() removes every
                # task, whose own finally closes its memory contexts, so
                # the pools ledger drains back to zero
                raise RuntimeError(
                    f"Query {scheduler.query_id} abandoned: client "
                    "stopped polling results"
                )
            # the status sweep is the pipelined scheduler's "tick" —
            # its duration distribution is the control-loop health gauge
            t_tick = _time.monotonic()
            if base_qid is not None:
                # deadline kills latch on the tracker before the failed
                # task states propagate — surface the typed error first
                self.query_tracker.check(base_qid)
            self._raise_if_failed(scheduler)
            METRICS.observe(
                "scheduler_tick_s", _time.monotonic() - t_tick
            )
            try:
                pages, token, complete = handle.get_results(
                    tid, 0, token, max_pages=16, wait=0.2
                )
            except Exception:
                # the root buffer can be aborted (low-memory kill, task
                # failure, DELETE /v1/query kill) BETWEEN the failure
                # check above and this fetch — surfacing as RuntimeError
                # in-process or as an HTTP 500 from a remote worker;
                # re-read task states so the query-level verdict carries
                # the real cause, not "buffer aborted"
                self._raise_if_failed(scheduler)
                raise
            for page in pages:
                rows.extend(_page_rows(page))
            if complete:
                # a kill can land between the sweep above and this
                # fetch's completion: a latched tracker error or a
                # failed task must win over a racy 'complete' — on the
                # pipelined plane a failed task always dooms the query,
                # so returning here would hand back a truncated result
                if base_qid is not None:
                    self.query_tracker.check(base_qid)
                self._raise_if_failed(scheduler)
                return rows

    # -- observability plane (QueryInfo registry + trace export) --

    def _stage_infos(self, states) -> List[dict]:
        """fragment id -> [(tid, status)] into StageInfo rollups, with
        per-stage wall-time histogram samples."""
        from trino_tpu_torch.runtime.metrics import METRICS
        from trino_tpu_torch.runtime.queryinfo import (
            build_stage_info,
            build_task_info,
        )

        infos = []
        for fid in sorted(states):
            task_infos = [
                build_task_info(tid, st) for tid, st in states[fid]
            ]
            info = build_stage_info(fid, task_infos)
            if info["wall_s"] is not None:
                METRICS.observe("stage_wall_s", info["wall_s"])
            infos.append(info)
        return infos

    def _drain_query_peaks(self, base_qid: str) -> int:
        """Sum per-worker peak-memory watermarks for this query (every
        attempt namespace: qN, qNr1, ...) and retire them from in-process
        pools. Sum-of-per-worker-peaks is an upper bound on any single
        instant's cluster total — exact when one worker dominates."""
        total = 0
        for w in self.workers:
            pool = getattr(w, "memory_pool", None)
            if pool is not None:
                peaks = pool.query_peaks()
            else:
                try:
                    peaks = (w.status() or {}).get("query_peak_bytes")
                except Exception:
                    peaks = None
            if not peaks:
                continue
            keys = [
                k for k in peaks
                if k == base_qid or k.startswith(base_qid + "r")
            ]
            vals = [peaks[k] for k in keys]
            if vals:
                # attempts are sequential, so the query's peak in this
                # pool is the max attempt watermark, not their sum
                total += max(vals)
            if pool is not None:
                for k in keys:
                    pool.drop_query_peak(k)
        return total

    def _finalize_query(
        self, base_qid, sql, trace, qspan, status, failure_txt,
        rows_n, counters_before,
    ) -> None:
        """Close out the observability plane for one query (success OR
        failure): end the span tree, record histograms, retire per-query
        compile counters and memory watermarks, build the final
        QueryInfo into the bounded registry, and fire the enriched
        QueryCompletedEvent. Never raises — observability must not mask
        the query verdict."""
        try:
            from trino_tpu_torch.exec.stats import engine_counters_delta
            from trino_tpu_torch.runtime.events import QueryCompletedEvent
            from trino_tpu_torch.runtime.metrics import (
                METRICS,
                retire_query_compiles,
            )
            from trino_tpu_torch.runtime.query_tracker import deadline_code
            from trino_tpu_torch.runtime.queryinfo import build_query_info

            qspan.set(state=status)
            qspan.end()
            trace.end_open_spans(qspan.end_s)
            wall = qspan.duration_s
            METRICS.observe("query_wall_s", wall)
            stages = self._last_stage_infos or []
            compile_count = int(retire_query_compiles(base_qid))
            peak = self._drain_query_peaks(base_qid)
            counters = engine_counters_delta(
                counters_before, METRICS.snapshot()
            )
            err_code = None
            if failure_txt:
                err_code = deadline_code(failure_txt)
                if err_code is None and (
                    "ExceededMemoryLimitError" in failure_txt
                    or "low-memory killer" in failure_txt
                ):
                    err_code = "EXCEEDED_MEMORY_LIMIT"
            retry_count = max(0, self.last_query_attempts - 1)
            attempt_count = 1
            is_fte = (
                getattr(self.session, "retry_policy", "none") == "task"
            )
            if is_fte and self.last_fte_stats:
                app = (
                    self.last_fte_stats.get("attempts_per_partition")
                    or {}
                )
                attempt_count = sum(app.values()) or 1
            info = build_query_info(
                base_qid, status, sql=sql, wall_s=wall, stages=stages,
                peak_memory_bytes=peak, compile_count=compile_count,
                counters=counters, error_code=err_code,
                failure=failure_txt, retry_count=retry_count,
                attempt_count=attempt_count,
                data_plane=getattr(
                    self, "_last_data_plane", None
                ) or ("fte" if is_fte else "http"),
            )
            with self._lock:
                self._active_traces.pop(base_qid, None)
                self.last_query_id = base_qid
                self._completed_queries[base_qid] = {
                    "info": info, "trace": trace,
                }
                while (
                    len(self._completed_queries)
                    > self._completed_queries_cap
                ):
                    self._completed_queries.popitem(last=False)
            self.event_listeners.query_completed(QueryCompletedEvent(
                base_qid, sql, status, wall, rows=rows_n,
                failure=failure_txt,
                peak_memory_bytes=peak,
                rows_scanned=int(counters.get("rows_scanned", 0)),
                bytes_scanned=int(counters.get("bytes_scanned", 0)),
                rows_shuffled=int(counters.get("rows_shuffled", 0)),
                compile_count=compile_count,
                cpu_s=sum(s.get("cpu_s") or 0.0 for s in stages),
                error_code=err_code,
                retry_count=retry_count,
                attempt_count=attempt_count,
            ))
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "query observability finalization failed", exc_info=True
            )

    def query_info(self, query_id: str) -> Optional[dict]:
        """GET /v1/query/{id}: the final aggregated QueryInfo."""
        with self._lock:
            entry = self._completed_queries.get(query_id)
        return dict(entry["info"]) if entry else None

    def query_trace_export(self, query_id: str) -> Optional[dict]:
        """Structured span-list export (completed registry first, then
        in-flight traces — a running query serves a partial tree)."""
        with self._lock:
            entry = self._completed_queries.get(query_id)
            trace = (
                entry["trace"] if entry
                else self._active_traces.get(query_id)
            )
        return trace.export() if trace is not None else None

    def query_chrome_trace(self, query_id: str) -> Optional[dict]:
        """Perfetto-loadable Chrome trace-event rendering."""
        from trino_tpu_torch.runtime.tracing import chrome_trace

        export = self.query_trace_export(query_id)
        if export is None:
            return None
        return {"traceEvents": chrome_trace(export)}

    @staticmethod
    def _raise_if_failed(scheduler: QueryScheduler) -> None:
        failed = scheduler.failed_tasks()
        if not failed:
            return
        msg = "; ".join(failed)
        from trino_tpu_torch.runtime.query_tracker import (
            deadline_code,
            deadline_error,
        )

        if deadline_code(msg) is not None:
            # a QueryTracker kill message embeds its error code — the
            # query-level verdict is the typed, NON-RETRYABLE error, not
            # a generic task failure the retry layers would replay
            raise deadline_error("query failed: " + msg)
        if "ExceededMemoryLimitError" in msg or "low-memory killer" in msg:
            # memory kill is a QUERY-level verdict: the caller sees the
            # typed error while other queries (and the worker) keep
            # running
            from trino_tpu_torch.runtime.memory import ExceededMemoryLimitError

            raise ExceededMemoryLimitError("query failed: " + msg)
        raise RuntimeError("query failed: " + msg)


def _scheduler_cpu_s(scheduler) -> float:
    """Aggregate a pipelined attempt's task CPU ledgers (the `cpu_s`
    field every status poll carries) — the query_max_cpu_time_s input."""
    total = 0.0
    for ts in scheduler.tasks.values():
        for handle, tid in ts:
            try:
                total += float(
                    handle.task_state(tid).get("cpu_s") or 0.0
                )
            except Exception:
                pass  # vanished task: its CPU is unknowable, not fatal
    return total


def _page_rows(page: Page) -> List[list]:
    """Decode a wire page to python rows (host-side, no device round
    trip) via the shared decode rules."""
    import numpy as np

    from trino_tpu_torch.block import decode_values

    from trino_tpu_torch.exec.serde import HostNested

    cols = []
    for t, data, valid, dvals in zip(
        page.types, page.columns, page.valids, page.dictionaries
    ):
        if isinstance(data, HostNested):
            cols.append(data.to_pylist())
            continue
        ok = valid if valid is not None else np.ones(len(data), dtype=bool)
        cols.append(decode_values(t, data, ok, dvals))
    return [list(r) for r in zip(*cols)] if cols else []
