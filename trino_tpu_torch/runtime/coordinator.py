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
(runtime/http.py), whose tasks pull pages over HTTP. With in-process
workers and mesh_execution on (the default) a query runs on the mesh
data plane (parallel/mesh_plan.py: its exchanges as collectives over
`mesh_devices`, by default every visible card); a plan the mesh cannot
run, or a stuck or lost mesh device, falls back to the page plane
observably (`last_mesh_fallback`, the fallbacks counter, a span event).
Any other mesh failure propagates: the reference's catch-all rerun on
the page plane is deliberately not carried (ROADMAP §3).

The replica and scheduler arms: a mesh wider than one shard runs behind
a weighted-fair run queue (runtime/scheduler.py; `mesh_scheduler` off
takes a bare lock instead), where a point lookup
(serving/admission.is_fast_lane) parks a running analytic at its next
chunk boundary. With `mesh_replicas` = N >= 2 the shard device list is
carved into N replicas (runtime/replicas.py): a query is placed on the
least-loaded healthy one under an exactly-one-owner claim; a replica
that loses a device or drains mid-run hands the query to a sibling,
which resumes from the host checkpoint (pulled from a fabric peer,
runtime/fabric.py, when the local store lost it), and a drain may split
the unstarted chunks between two siblings (`_try_steal_dispatch`).
EXPLAIN ANALYZE prints the replicas=, scheduler=, membership= and
concurrency= lines (the last from the port's analysis/: named locks,
order edges, registered threads and witness violations).

The adaptive and recovery tiers: with adaptive_execution or
shared_subtree_materialization on, an AdaptiveController materializes
barriers on the coordinator's device and re-plans before fragmenting
(`_last_adaptive_report`); every stage's output rows are recorded
against the optimizer's estimate (`estimated_vs_observed`, adaptive off
too). With recovery_spool_stages on, every recordable non-root task tees
its output pages into the stage-output recorder, and a QUERY retry
banks the failed attempt's finished fragments in the subtree spool and
replays them instead of recomputing them (the FTE scheduler does the
same from its committed spool files). EXPLAIN ANALYZE ends with the
adaptive section and the recovery and skew lines.

Analogue of SqlQueryExecution (planQuery/planDistribution,
SqlQueryExecution.java:457/503) + PipelinedQueryScheduler.java:155
(StageManager creating every stage up front, tasks streaming pages
between stages through pull+ack buffers — SURVEY.md §3.1–§3.4).
The DistributedQueryRunner facade mirrors
testing/trino-testing/DistributedQueryRunner.java:84: one coordinator +
N workers in one process, real exchange data plane between tasks.
"""

from __future__ import annotations

import dataclasses
import itertools
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
from trino_tpu_torch.analysis import threadreg
from trino_tpu_torch.analysis.witness import named_lock

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
        record_stages = bool(
            getattr(self.session, "recovery_spool_stages", False)
        )
        if record_stages:
            from trino_tpu_torch.recovery import RECORDER, fragment_recordable
        root_fid = self.subplan.fragment.id
        for sp in order:
            f = sp.fragment
            tc = task_counts[f.id]
            record_this = (
                record_stages
                and fragment_recordable(sp, f.id == root_fid)
            )
            if record_this:
                RECORDER.expect(self.query_id, f.id, tc)
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
                    shape_stabilization=self.session.shape_stabilization,
                    capacity_ladder_base=self.session.capacity_ladder_base,
                    deadline_epoch_s=self.deadline_epoch_s,
                    record_output=record_this,
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
        mesh_devices=None,
    ):
        """Default topology: N in-process Workers sharing the coordinator
        CatalogManager, each on `device` (None: the CUDA card, raising
        without one). `worker_handles` schedules over Workers the caller
        built instead (their catalogs registered by the caller), in-process
        Workers or HttpWorkerClients of WorkerServers. `access_control`
        guards distributed Query statements AND the embedded single-node
        runner (same policy object on both paths). `mesh_devices` lists
        the mesh plane's shard devices, repeats allowed (the reference's
        `devices`); None is every visible card of `device`'s type, one
        shard on the CPU."""
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
        self.mesh_devices = None if mesh_devices is None else list(mesh_devices)
        # why the last query left the mesh plane (None = it didn't)
        self.last_mesh_fallback: Optional[str] = None
        # the replica plane (runtime/replicas.py), carved on the first
        # mesh dispatch with mesh_replicas >= 2
        self._replicas = None
        # a full-width mesh wider than one shard runs one query at a
        # time: behind the run queue (runtime/scheduler.py, built on
        # first use) with mesh_scheduler on, behind this lock with it
        # off. _sched_steals counts completed work-stealing dispatches
        # (the EXPLAIN scheduler= line)
        self._mesh_exec_lock = named_lock("DistributedQueryRunner._mesh_exec_lock")
        self._mesh_scheduler = None
        self._sched_steals = 0
        # concurrent first dispatches carve one replica plane and build
        # one run queue (the reference races here and may build two)
        self._carve_lock = named_lock("DistributedQueryRunner._carve_lock")
        # recovery tier: surface the recovery.* counters in /v1/metrics
        # at zero from process start (a counter only materializes on
        # first bump otherwise)
        from trino_tpu_torch.recovery import register_recovery_metrics

        register_recovery_metrics()
        # what the adaptive controller did to the last planned query
        self._last_adaptive_report = None
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
        from trino_tpu_torch.parallel.mesh_plan import register_mesh_metrics

        register_mesh_metrics()
        # concurrency soundness plane gauges (analysis.locks /
        # analysis.threads_live / analysis.witness_violations); the
        # reference also installs its XLA compile listener here, and
        # the port counts builds without one
        from trino_tpu_torch.analysis import register_analysis_metrics

        register_analysis_metrics()
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
        self._lock = named_lock("DistributedQueryRunner._lock")

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
        # a new catalog can shadow names any cached state resolved
        # against: a wholesale epoch bump, not table-granular
        from trino_tpu_torch.resident import GENERATIONS, RESIDENT

        self._plan_cache.invalidate()
        GENERATIONS.bump_all()
        RESIDENT.evict_all()

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
            # EXPLAIN ANALYZE runs the adaptive controller exactly like
            # execute would, so the rendered plan/adaptive section shows
            # what a plain run of the statement does
            from trino_tpu_torch.adaptive import AdaptiveController

            self._last_adaptive_report = None
            controller = AdaptiveController(self.catalogs, self.session,
                                            device=self.device)
            if stmt.analyze and controller.enabled():
                output = controller.prepare(output)
                self._last_adaptive_report = controller.report
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
        # reset BEFORE any plane decision: a stale reason from an earlier
        # query must not read as applying to this one
        self.last_mesh_fallback = None
        self._last_adaptive_report = None
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
            # adaptive execution: materialize barriers on the
            # coordinator's catalogs and device and re-plan the
            # remainder before fragmenting. tracker.check at every
            # barrier keeps a kill latched mid-re-plan typed
            # (EXCEEDED_TIME_LIMIT, not a retryable transport error).
            adaptive_report = None
            from trino_tpu_torch.adaptive import AdaptiveController

            controller = AdaptiveController(
                self.catalogs, self.session, span=query_span,
                preempt=lambda: tracker.check(base_qid),
                device=self.device,
            )
            if controller.enabled():
                with phase("adaptive"):
                    output = controller.prepare(output)
                adaptive_report = controller.report
            self._last_adaptive_report = adaptive_report
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
            if (
                cache_key is not None
                and not plan_is_volatile()
                and not (
                    adaptive_report is not None
                    and adaptive_report.transformed
                )
            ):
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
        if self.session.retry_policy == "task":
            self._last_data_plane = "fte"
            rows = self._execute_fte(
                subplan, query_id=base_qid, cancel=cancel, tq=tq,
                trace=trace, query_span=query_span,
                deadline_epoch_s=deadline_epoch_s,
            )
            return MaterializedResult(rows, *result_meta, data_plane="fte")
        if self.session.mesh_execution and self._mesh_colocated():
            # tasks share this process's devices: exchanges ride
            # collectives over the shard mesh in chunked programs
            # (parallel/mesh_chunk.py) with preemption checks at every
            # program boundary, so deadline-bearing queries run here
            # too, killed between chunks with the page plane's typed
            # errors. Unsupported plan shapes fall back to the page
            # exchange, observably.
            from trino_tpu_torch.parallel.mesh_chunk import MeshDeviceLost, MeshStuck
            from trino_tpu_torch.parallel.mesh_plan import MeshUnsupported
            from trino_tpu_torch.runtime.query_tracker import preemption_check

            preempt = preemption_check(
                tracker, base_qid, cancel=cancel, deadline_epoch_s=deadline_epoch_s,
            )
            from trino_tpu_torch.runtime.metrics import set_compile_attribution

            # a point lookup (possibly joined to one dimension) rides
            # the mesh scheduler's fast lane: it parks a running
            # analytic at its next chunk boundary
            from trino_tpu_torch.serving.admission import is_fast_lane

            fast_lane = is_fast_lane(stmt)
            prev_attr = set_compile_attribution(base_qid)
            try:
                rows = self._execute_mesh(subplan, preempt, query_span, fast=fast_lane,
                                          query_id=base_qid)
                self._last_data_plane = "mesh"
                return MaterializedResult(rows, *result_meta, data_plane="mesh")
            except MeshUnsupported as ex:
                # fallback must be OBSERVABLE, not silent: count it and
                # record why, whether raised statically or mid-run
                self._record_mesh_fallback(str(ex), query_span)
            except (MeshStuck, MeshDeviceLost) as ex:
                # retryable by classification: a program hung (or lost
                # its device) after exhausting in-run checkpoint resumes
                # may succeed on the page plane, so fall back observably.
                # The mesh checkpoint survives: the next mesh execution
                # of this plan resumes from it.
                self._record_mesh_fallback(str(ex), query_span)
            except QueryDeadlineError:
                raise  # the preemption hook fired: typed, no fallback
            except Exception as e:
                if deadline_code(str(e)) is not None:
                    # a latched kill that travelled as a failure string:
                    # re-type it so it stays non-retryable
                    raise deadline_error(str(e)) from e
                # no catch-all rerun on the page plane (ROADMAP §3): on
                # the card it would hide a kernel or device failure
                raise
            finally:
                set_compile_attribution(prev_attr)
        attempts = (
            1 + self.session.query_retry_count
            if self.session.retry_policy == "query"
            else 1
        )
        # recovery tier: with recovery_spool_stages on, every non-root
        # task tees its wire pages into the stage-output recorder; a
        # failed attempt's fully-finished fragments are harvested into
        # the subtree spool and the NEXT attempt substitutes them as
        # literal sources (only the work that failed is recomputed)
        spool_stages = attempts > 1 and bool(
            getattr(self.session, "recovery_spool_stages", False)
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
                if spool_stages:
                    from trino_tpu_torch.recovery import (
                        harvest_recorded_stages,
                        substitute_spooled_fragments,
                    )

                    prev_qid = (
                        base_qid if attempt == 1
                        else f"{base_qid}r{attempt - 1}"
                    )
                    banked = harvest_recorded_stages(prev_qid, subplan)
                    attempt_subplan, spooled = (
                        substitute_spooled_fragments(
                            subplan, span=query_span
                        )
                    )
                    if query_span is not None and (banked or spooled):
                        query_span.event(
                            "stage_recovery", banked=banked,
                            substituted=spooled,
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
                    self._record_stage_divergences(
                        attempt_subplan, self._last_stage_infos,
                        query_span,
                    )
                except Exception:
                    pass  # observability must never mask the verdict
                scheduler.abort()
        raise last_error

    def _replica_manager(self):
        """The replica plane, carved on the first mesh dispatch: with
        session.mesh_replicas >= 2 the shard device list splits into
        that many identical sub-meshes. None (the one full-width mesh)
        with replication off or fewer devices than replicas."""
        n = int(getattr(self.session, "mesh_replicas", 1) or 1)
        if n < 2:
            return None
        from trino_tpu_torch.parallel.mesh import ShardMesh
        from trino_tpu_torch.runtime.replicas import ReplicaManager

        with self._carve_lock:
            rm = self._replicas
            if rm is not None and rm.n_replicas == n:
                return rm
            devices = ShardMesh.resolve(self.mesh_devices, self.device).devices
            if len(devices) < n:
                rm = None  # fewer devices than replicas: keep one mesh
            else:
                rm = ReplicaManager(
                    n, devices=devices,
                    breaker_threshold=int(getattr(self.session, "replica_breaker_threshold", 3)),
                    breaker_cooldown_s=float(getattr(self.session, "replica_breaker_cooldown_s",
                                                     1.0)),
                    scheduler_kw=self._scheduler_kw())
            self._replicas = rm
            return rm

    def _scheduler_kw(self) -> dict:
        from trino_tpu_torch.runtime.scheduler import parse_group_weights

        return {
            "min_slice_chunks": int(getattr(self.session, "mesh_scheduler_min_slice_chunks", 1)
                                    or 1),
            "preemption_enabled": bool(getattr(self.session, "preemption_enabled", True)),
            "weights": parse_group_weights(str(getattr(self.session, "mesh_scheduler_weights",
                                                       "") or "")),
        }

    def _tune_scheduler(self, sched) -> None:
        """A live scheduler's knobs from the current session: SET SESSION
        between queries takes effect without rebuilding the queue."""
        kw = self._scheduler_kw()
        sched.min_slice_chunks = max(1, int(kw["min_slice_chunks"]))
        sched.preemption_enabled = bool(kw["preemption_enabled"])
        sched.weights = dict(kw["weights"])

    def _mesh_scheduler_for(self):
        with self._carve_lock:
            if self._mesh_scheduler is None:
                from trino_tpu_torch.runtime.scheduler import MeshScheduler

                self._mesh_scheduler = MeshScheduler(name="mesh", **self._scheduler_kw())
            return self._mesh_scheduler

    def _sched_group(self) -> str:
        return str(getattr(self.session, "mesh_scheduler_group", "") or "") or "default"

    def _mesh_executor(self, rm=None, rep=None):
        """A MeshExecutor over `mesh_devices`, or over replica `rep`'s
        row with its drain check."""
        from trino_tpu_torch.parallel.mesh_plan import MeshExecutor

        if rep is None:
            return MeshExecutor(self.catalogs, self.session, devices=self.mesh_devices,
                                device=self.device)
        return MeshExecutor(self.catalogs, self.session, devices=rep.devices,
                            device=self.device, replica_id=rep.replica_id,
                            drain_check=rm.drain_check(rep))

    def _scheduled(self, sched, ex, subplan, preempt, query_span, query_id, group, fast,
                   aux_check=None):
        """`subplan` on `ex` under a seat of `sched`: the chunk runner
        acquires it at device-phase entry (host planning and the feed
        builds run before the grant) and consults it at every boundary."""
        self._tune_scheduler(sched)
        job = sched.submit(query_id or "q?", group=group, fast=fast, poll=preempt)
        # a drain surfacing while queued or parked raises
        # MeshReplicaDraining out of the wait: failover, not a grant
        job.aux_check = aux_check
        ex.sched_job = job
        try:
            return ex.execute(subplan, preempt=preempt, query_span=query_span)
        finally:
            sched.finish(job)

    def _execute_mesh(self, subplan, preempt, query_span, fast=False,
                      query_id="") -> List[list]:
        """Mesh dispatch with replica placement and chunk-granular
        failover. Without a replica plane: one MeshExecutor over
        `mesh_devices`; a width-1 mesh runs no collective and keeps its
        concurrency, a wider one runs behind the run queue (or the bare
        lock with mesh_scheduler off). With one: place the least-loaded
        healthy replica; when it dies (MeshStuck, MeshDeviceLost) or
        drains mid-run, place again on a sibling, whose runner finds the
        host checkpoint under the device-free key. Only when no sibling
        is left (or failover is off) does the fault reach the caller's
        page-plane fallback."""
        import contextlib

        from trino_tpu_torch.parallel.mesh_chunk import (
            MeshDeviceLost,
            MeshReplicaDraining,
            MeshStuck,
        )
        from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS
        from trino_tpu_torch.runtime.fabric import (
            MembershipEpochError,
            active_fabric,
            maybe_start_fabric,
        )

        use_sched = bool(getattr(self.session, "mesh_scheduler", True))
        group = self._sched_group()
        # the checkpoint fabric (no-op unless fabric_peers is set):
        # checkpoints stream to peer coordinators, and failover below
        # can pull the last pushed snapshot
        maybe_start_fabric(self.session)
        rm = self._replica_manager()
        if rm is None:
            ex = self._mesh_executor()
            if ex.n > 1 and use_sched:
                return self._scheduled(self._mesh_scheduler_for(), ex, subplan, preempt,
                                       query_span, query_id, group, fast)
            guard = self._mesh_exec_lock if ex.n > 1 else contextlib.nullcontext()
            with guard:
                return ex.execute(subplan, preempt=preempt, query_span=query_span)
        failover_on = bool(getattr(self.session, "replica_failover_enabled", True))
        steal_on = use_sched and bool(getattr(self.session, "mesh_steal_enabled", True))
        tried: set = set()
        # a failover remembers the epoch it faulted under; a target that
        # left and rejoined since is fenced and the query restarts fresh
        fault_key = None
        fault_epoch = rm.membership_epoch
        while True:
            rep = rm.place(exclude=tried)
            if rep is None:
                raise MeshDeviceLost(
                    f"no schedulable replica (tried {sorted(tried)} of {rm.n_replicas})")
            # exactly one owner: a query never runs on two replicas at
            # once, across a membership flap too
            if not rm.claim(query_id, rep):
                rm.release(rep)
                raise MeshDeviceLost(f"query {query_id!r} already owned by another replica; "
                                     "refusing double placement")
            if fault_key is not None:
                try:
                    rm.require_epoch(rep, fault_epoch)
                except MembershipEpochError:
                    # drop the stale checkpoint: this attempt restarts
                    CHECKPOINTS.discard(fault_key)
                    fault_key = None
            try:
                ex = self._mesh_executor(rm, rep)
                if use_sched:
                    rows = self._scheduled(rep.scheduler, ex, subplan, preempt, query_span,
                                           query_id, group, fast, aux_check=rm.drain_check(rep))
                else:
                    with rep.exec_lock:
                        rows = ex.execute(subplan, preempt=preempt, query_span=query_span)
                rm.report_success(rep)
                return rows
            except (MeshStuck, MeshDeviceLost) as e:
                # a drain is a lifecycle maneuver, not a health signal
                if not isinstance(e, MeshReplicaDraining):
                    rm.report_failure(rep)
                tried.add(rep.replica_id)
                fault_key = getattr(e, "ckpt_key", None)
                fault_epoch = rm.membership_epoch
                # host loss: when the local store lost the checkpoint,
                # pull the last pushed snapshot from a fabric peer
                fab = active_fabric()
                if fault_key is not None and fab is not None and CHECKPOINTS.get(fault_key) is None:
                    fab.try_pull(fault_key)
                have_sibling = any(r.state == "active" and r.replica_id not in tried
                                   for r in rm.replicas)
                if not failover_on or not have_sibling:
                    raise
                rm.note_failover(rep)
                if query_span is not None:
                    query_span.event("replica_failover", from_replica=rep.replica_id,
                                     error=type(e).__name__, reason=str(e)[:300])
                if (steal_on and isinstance(e, MeshReplicaDraining)
                        and getattr(e, "steal_ok", False) and fault_key is not None):
                    rows = self._try_steal_dispatch(subplan, preempt, query_span, fault_key, rm,
                                                    tried, fast, query_id, group)
                    if rows is not None:
                        return rows
            finally:
                rm.unclaim(query_id, rep)
                rm.release(rep)

    def _try_steal_dispatch(self, subplan, preempt, query_span, key, rm, tried, fast,
                            query_id, group):
        """Drain-failover work stealing: split the drained query's
        unstarted chunks [k0, K) at mid; the primary sibling resumes
        [k0, mid) from the host checkpoint while a helper sibling runs
        [mid, K) from empty carries, and the primary appends the
        helper's rows at its mid boundary. None (the caller resumes the
        query whole on one sibling) when two siblings are not free, the
        range is under two chunks, or the primary meets a mesh fault;
        a faulted primary is then reported and tried as the caller's
        own placements are. The helper is called off and joined before
        its replica is released; an error of it that is not
        mesh_chunk.STEAL_DECLINABLE propagates (from the primary's
        merge, or from here when the primary never merged)."""
        from trino_tpu_torch.parallel.mesh_chunk import (
            STEAL_DECLINABLE,
            MeshDeviceLost,
            MeshReplicaDraining,
            MeshStuck,
            StealContext,
        )
        from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS

        ck = CHECKPOINTS.get(key)
        if ck is None or ck.n_chunks - ck.next_chunk < 2:
            return None
        prim = rm.place(exclude=tried)
        if prim is None:
            return None
        helper = rm.place(exclude=set(tried) | {prim.replica_id})
        if helper is None:
            rm.release(prim)
            return None
        k0, K = ck.next_chunk, ck.n_chunks
        mid = k0 + (K - k0 + 1) // 2
        emit = StealContext("emit", mid, ("steal",) + tuple(key), dict(ck.resolved_caps))
        merge = dataclasses.replace(emit, mode="merge")
        thread, rows = None, None
        try:
            ex_h = self._mesh_executor(rm, helper)
            ex_h.steal_ctx = emit

            def run_helper():
                hjob = helper.scheduler.submit(f"{query_id or 'q?'}-steal", group=group)
                try:
                    helper.scheduler.acquire(hjob, aux_check=emit.check_cancel)
                    ex_h.execute(subplan)
                except BaseException as e:  # kept for the merge or the dispatcher
                    emit.errors.append(e)
                finally:
                    helper.scheduler.finish(hjob)
                    emit.done.set()

            thread = threadreg.spawn("trino-tpu-steal-helper", run_helper,
                                     owner="DistributedQueryRunner")
            ex_p = self._mesh_executor(rm, prim)
            ex_p.steal_ctx = merge
            rows = self._scheduled(prim.scheduler, ex_p, subplan, preempt, query_span, query_id,
                                   group, fast, aux_check=rm.drain_check(prim))
            rm.report_success(prim)
            stolen = int(ex_p.last_run.get("steals", 0) or 0)
            self._sched_steals += stolen
            if query_span is not None and stolen:
                query_span.event("work_steal", primary=prim.replica_id,
                                 helper=helper.replica_id, split_at=mid, of=K)
        except (MeshStuck, MeshDeviceLost) as e:
            # the split itself faulted: the primary is a failed
            # placement like any other (a drain is no health signal),
            # and the caller's loop resumes the query whole on a
            # sibling from the checkpoint, which is still live
            if not isinstance(e, MeshReplicaDraining):
                rm.report_failure(prim)
            tried.add(prim.replica_id)
            if any(r.state == "active" and r.replica_id not in tried for r in rm.replicas):
                rm.note_failover(prim)
            if query_span is not None:
                query_span.event("replica_failover", from_replica=prim.replica_id,
                                 error=type(e).__name__, reason=str(e)[:300])
        finally:
            if thread is not None:
                emit.cancel.set()
                thread.join()
            CHECKPOINTS.discard(emit.key)
            rm.release(helper)
            rm.release(prim)
        for e in emit.errors:
            if not isinstance(e, STEAL_DECLINABLE):
                raise e
        return rows

    def _record_mesh_fallback(self, reason: str, query_span=None) -> None:
        """One mesh->page fallback: bump the aggregate counter, latch
        the reason for QueryInfo/EXPLAIN, export a per-reason counter
        (mesh_fallbacks.{slug}) and drop an instant event on the query
        span so the trace timeline shows where the plane switched."""
        import re

        from trino_tpu_torch.parallel.mesh_plan import bump_mesh_counter
        from trino_tpu_torch.runtime.metrics import METRICS

        bump_mesh_counter("fallbacks")
        self.last_mesh_fallback = reason
        slug = re.sub(r"[^a-z0-9]+", "_", reason.lower()).strip("_")[:40]
        if slug:
            METRICS.increment(f"mesh_fallbacks.{slug}")
        if query_span is not None:
            query_span.event("mesh_fallback", reason=reason[:300])

    def _resident_line(self) -> str:
        """The EXPLAIN ANALYZE resident-tier line: the pins held now and
        the process's counter totals."""
        from trino_tpu_torch.resident import RESIDENT

        s = RESIDENT.stats()
        return (
            f"resident= entries={s['entries']} "
            f"pinned_bytes={s['pinned_bytes']} hits={s['hits']} "
            f"misses={s['misses']} pins={s['pins']} "
            f"evictions={s['evictions']} revocations={s['revocations']} "
            f"compactions={s['compactions']}"
        )


    def _recovery_line(self) -> str:
        """The EXPLAIN ANALYZE recovery-tier line: lifetime
        checkpoint/resume counters from the process singletons, plus
        the most recent mesh run's resume position when it resumed."""
        from trino_tpu_torch.parallel.mesh_chunk import last_run_info
        from trino_tpu_torch.recovery import CHECKPOINTS
        from trino_tpu_torch.runtime.metrics import METRICS

        line = (
            f"recovery= checkpoints={CHECKPOINTS.taken} "
            f"resumes={CHECKPOINTS.resumed} "
            f"invalidations={CHECKPOINTS.invalidated} "
            f"spooled_stage_hits="
            f"{int(METRICS.counter('recovery.spooled_stage_hits'))}"
        )
        info = last_run_info()
        resumed = info.get("resumed_from_chunk")
        if resumed is not None:
            line += (
                f" resumed_from_chunk={resumed}/"
                f"{info.get('chunks')}"
            )
        return line

    def _skew_line(self) -> str:
        """The EXPLAIN ANALYZE skew-tier line: lifetime skew-plane
        counters — how often observed stats flagged a hot build key,
        how many exchange edges ran salted, MXU join-project
        selections, and build-overflow spill-mode re-plans."""
        from trino_tpu_torch.runtime.metrics import METRICS

        s = METRICS.snapshot()

        def c(name):
            return int(s.get(f"skew.{name}", 0.0))

        return (
            f"skew= heavy_hitters_detected={c('heavy_hitters_detected')} "
            f"salted_exchanges={c('salted_exchanges')} "
            f"mxu_join_selected={c('mxu_join_selected')} "
            f"spill_mode_replans={c('spill_mode_replans')}"
        )
    def _replica_line(self) -> str:
        """The EXPLAIN ANALYZE replica-plane line: grid shape, each
        replica's state (first letter) and this runner's placement and
        failover counters."""
        rm = self._replicas
        if rm is None:
            n = int(getattr(self.session, "mesh_replicas", 1) or 1)
            return f"replicas= n={n} (single mesh)"
        return rm.stats_line()

    def _scheduler_line(self) -> str:
        """The EXPLAIN ANALYZE scheduler line: parks, resumes,
        preemptions and park refusals summed over this runner's run
        queues, and its completed work-stealing dispatches."""
        scheds = [] if self._mesh_scheduler is None else [self._mesh_scheduler]
        if self._replicas is not None:
            scheds.extend(r.scheduler for r in self._replicas.replicas)
        return (f"scheduler= parks={sum(s.parks for s in scheds)} "
                f"resumes={sum(s.resumes for s in scheds)} "
                f"preemptions={sum(s.preemptions for s in scheds)} "
                f"park_refusals={sum(s.park_refusals for s in scheds)} "
                f"steals={self._sched_steals}")

    def _membership_line(self) -> str:
        """The EXPLAIN ANALYZE membership line (runtime/fabric.py)."""
        if self._replicas is None:
            return "membership= epoch=0 (single mesh)"
        return self._replicas.membership_line()

    def _concurrency_line(self) -> str:
        """The EXPLAIN ANALYZE concurrency line (analysis/): registered
        witness locks, observed order edges, registered background
        threads, and lifetime witness violations (0 on a sound engine)."""
        from trino_tpu_torch.analysis import concurrency_summary

        s = concurrency_summary()
        return (
            f"concurrency= locks={s['locks']} "
            f"order_edges={s['order_edges']} "
            f"threads_live={s['threads_live']} "
            f"threads_spawned={s['threads_spawned']} "
            f"witness={'on' if s['witness'] else 'off'} "
            f"violations={s['witness_violations']}"
        )

    def _mesh_plane_line(self, subplan) -> str:
        """The EXPLAIN ANALYZE data-plane line: which plane `execute`
        would pick for this plan, decided statically (structural
        eligibility + collective census, no second execution)."""
        if getattr(self.session, "retry_policy", "none") == "task":
            return "data_plane=fte"
        if not (self.session.mesh_execution and self._mesh_colocated()):
            return "data_plane=http"
        from trino_tpu_torch.parallel.mesh_plan import MeshUnsupported, mesh_eligibility

        try:
            info = mesh_eligibility(subplan)
        except MeshUnsupported as ex:
            self._record_mesh_fallback(str(ex))
            return f"data_plane=http (mesh fallback: {ex})"
        chunk_rows = int(getattr(self.session, "mesh_chunk_rows", 0) or 0)
        chunking = f"chunk_rows={chunk_rows}" if chunk_rows > 0 else "unchunked"
        return (f"data_plane=mesh (all_to_all={info['all_to_all']}, "
                f"all_gather={info['all_gather']}, {chunking})")

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
                # (taken at each attempt's terminal observation)
                try:
                    self._last_stage_infos = self._stage_infos(
                        scheduler.task_snapshots()
                    )
                    self._record_stage_divergences(
                        subplan, self._last_stage_infos, query_span
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
        """The fragments, each annotated with its shape census summary
        (sql/validate.py)."""
        return explain_distributed(
            subplan, catalogs=self.catalogs, batch_rows=self.session.batch_rows,
            dynamic_filtering=self.session.enable_dynamic_filtering,
            warn_threshold=self.session.compile_churn_warn_threshold)

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
            self._record_stage_divergences(subplan, stages)
            lines = [self._explain_text(subplan)]
            for stage in stages:
                lines.append(stage_text(stage))
            report = self._last_adaptive_report
            if report is not None:
                lines.append("\n" + "\n".join(report.lines()))
            # which plane a plain `execute` of this statement would take
            # (the ANALYZE instrumentation itself runs the page
            # scheduler above either way, for the operator stats)
            lines.append(self._mesh_plane_line(subplan))
            lines.append(self._resident_line())
            lines.append(self._recovery_line())
            lines.append(self._skew_line())
            lines.append(self._replica_line())
            lines.append(self._scheduler_line())
            lines.append(self._membership_line())
            lines.append(self._concurrency_line())
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
            expected = max((int(st.get("expected_shape_classes") or 0)
                            for _, st in states[fid]), default=0)
            info = build_stage_info(fid, task_infos, expected_lowerings=expected)
            if info["wall_s"] is not None:
                METRICS.observe("stage_wall_s", info["wall_s"])
            infos.append(info)
        return infos

    @staticmethod
    def _stage_output_rows(stage: dict) -> Optional[int]:
        """Rows leaving the stage: what entered the terminal output/sink
        operator of the final pipeline (sinks emit no batches, so their
        input side IS the fragment's output)."""
        groups = stage.get("operator_summaries") or []
        for group in reversed(groups):
            if not group:
                continue
            last = group[-1]
            name = str(last.get("operator") or "")
            if "Output" in name or "Sink" in name:
                return int(last.get("input_rows") or 0)
            return int(last.get("output_rows") or 0)
        return None

    def _record_stage_divergences(
        self, subplan, stages, query_span=None
    ) -> None:
        """Per-fragment estimated_vs_observed: annotate the stage
        rollups (QueryInfo + distributed EXPLAIN ANALYZE render them),
        drop tracer instant events, and count adaptive.divergences.
        Recording is unconditional — divergence observability does not
        depend on adaptive_execution being on."""
        if not stages:
            return
        try:
            from trino_tpu_torch.adaptive.observer import (
                estimated_vs_observed_line,
                fragment_estimates,
                record_observation,
            )

            estimates = fragment_estimates(self.catalogs, [subplan])
            threshold = float(
                getattr(self.session, "adaptive_replan_threshold", 4.0)
                or 4.0
            )
            for stage in stages:
                fid = stage.get("fragment_id")
                est = estimates.get(fid)
                observed = self._stage_output_rows(stage)
                if est is None or observed is None:
                    continue
                site = f"fragment:{fid}"
                ratio = record_observation(
                    site, est, observed, threshold, span=query_span
                )
                stage["estimated_vs_observed"] = estimated_vs_observed_line(
                    site, est, observed, ratio
                )
        except Exception:
            pass  # observability must never mask the verdict

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
            # recovery tier: a finished query's stage recordings (every
            # attempt namespace) are dead weight — drop them so the
            # recorder stays bounded by in-flight queries
            from trino_tpu_torch.recovery import RECORDER

            RECORDER.purge(base_qid)
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
                mesh_fallback=self.last_mesh_fallback,
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
