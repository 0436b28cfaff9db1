"""Worker-side task runtime: plan a fragment, run its drivers, feed the
output buffer.

Counterpart of trino_tpu/runtime/task.py. A task plans its fragment with
the port's LocalPlanner on its worker's device and drives the operators
from its own thread, so its CUDA kernels launch from that thread (on the
device's current stream, which every task shares). An input location is
an in-process fetch callable, or a wire descriptor: ("http", uri,
task_id) pulls pages from a WorkerServer (runtime/http.py), ("spool",
base_dir, task_key) reads a committed FTE attempt (runtime/spool.py).
Pages from either arrive as host bytes; the RemoteSourceOperator puts
them on the task's device. With `spool_dir` set the task spools its
output instead of buffering it (SpoolingExchangeSink). The
reference's shape stabilization and shape census (the capacity ladder,
the warm-class registry) are the compile tier's, item 13: a port task
plans without a ladder, and its `shapes_warm` stays False, so the
stuck-task watchdog keeps its conservative threshold.

Analogue of main/execution/SqlTask / SqlTaskExecution.java:84 (drivers
from DriverFactories per split/task lifecycle) + SqlTaskManager.updateTask
(SqlTaskManager.java:466 — LocalExecutionPlanner.plan at task creation,
:520). One thread per task runs its pipelines in dependency order (build
sides before probes); blocking on exchange input and buffer
backpressure happens inside operators, so Trino's 1-second cooperative
quanta are unnecessary: device kernels are the quanta.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
import traceback
import uuid
from typing import Callable, Dict, List, Optional, Tuple

import torch

from trino_tpu_torch.exec.driver import Driver, Pipeline
from trino_tpu_torch.exec.exchange_ops import PartitionedOutputOperator
from trino_tpu_torch.runtime.buffers import OutputBuffer
from trino_tpu_torch.runtime.exchange import DirectExchangeClient, ExchangeLocation
from trino_tpu_torch.sql.fragmenter import PlanFragment
from trino_tpu_torch.sql.local_planner import LocalPlanner, Schema


@dataclasses.dataclass(frozen=True)
class TaskId:
    query_id: str
    fragment_id: int
    partition: int
    attempt: int = 0  # FTE retries re-run a partition as attempt+1

    def __str__(self) -> str:
        base = f"{self.query_id}.{self.fragment_id}.{self.partition}"
        return f"{base}.a{self.attempt}" if self.attempt else base


@dataclasses.dataclass
class TaskSpec:
    """Everything a worker needs to run one task (TaskUpdateRequest
    analogue: fragment + splits + output buffer layout + input
    locations). `input_locations` maps producer fragment id -> list of
    fetch callables (one per producer task)."""

    task_id: TaskId
    fragment: PlanFragment
    n_output_partitions: int
    remote_schemas: Dict[int, Schema]
    scan_slice: Optional[Tuple[int, int]]  # (task_index, task_count)
    input_locations: Dict[int, List[Callable]]  # fid -> [fetch]
    batch_rows: int = 1 << 20
    target_splits: int = 1
    # FTE: spool output to this directory instead of a live buffer
    # (SpoolingExchangeOutputBuffer path, SURVEY.md §3.5)
    spool_dir: Optional[str] = None
    dynamic_filtering: bool = True
    # EXPLAIN ANALYZE: wrap operators with timing/row instrumentation
    # and report OperatorStats in task status (TaskInfo.getStats path).
    # Off by default — row counting forces a per-batch device sync.
    collect_stats: bool = False
    # intra-task pipeline parallelism (LocalExchange): run hash-build
    # pipelines concurrently and overlap remote-page pulls with the
    # compute chain (task.concurrency analogue)
    task_concurrency: int = 2
    # query tracing (runtime/tracing.py wire_context dict): when set the
    # task records one operator span per operator, parented on the
    # coordinator's task-attempt span, shipped back in terminal status
    trace_ctx: Optional[dict] = None
    # worker-LOCAL deadline (wall-clock epoch seconds, so the value
    # survives crossing a process boundary): the driver checks it at
    # every batch boundary and fails the task itself instead of waiting
    # for the coordinator's enforcement tick to reach across the wire.
    # Carries the EXCEEDED_TIME_LIMIT code so the coordinator re-types
    # the travelled string as non-retryable. None = no local deadline.
    deadline_epoch_s: Optional[float] = None


def _resolve_fetch(location):
    """An input location is either a direct fetch callable (in-process
    topology) or a descriptor — ("http", uri, task_id) for live pull
    between processes, ("spool", base_dir, task_key) for a committed
    FTE attempt — the wire forms a codec-encoded TaskSpec carries."""
    if callable(location):
        return location
    kind, a, b = location
    if kind == "http":
        from trino_tpu_torch.runtime.http import http_fetch

        return http_fetch(a, b)
    if kind != "spool":
        raise ValueError(f"unknown input location kind {kind!r}")
    from trino_tpu_torch.runtime.spool import spool_fetch

    return spool_fetch(a, b)


class _MidFailureBuffer:
    """Buffer proxy that lets the FailureInjector kill a task AFTER it
    produced output (the partially-spooled retry path of
    BaseFailureRecoveryTest)."""

    def __init__(self, inner, injector, task_id):
        self._inner = inner
        self._injector = injector
        self._task_id = task_id
        self._produced = False

    def enqueue(self, partition, page):
        self._inner.enqueue(partition, page)
        if not self._produced:
            self._produced = True
            self._injector.check(self._task_id, "mid")

    def set_no_more_pages(self):
        self._inner.set_no_more_pages()


class TaskExecution:
    """One running task: plans the fragment, runs drivers on a thread,
    exposes its OutputBuffer for consumers (TaskStateMachine states
    collapsed to PLANNED/RUNNING/FINISHED/FAILED)."""

    def __init__(self, spec: TaskSpec, catalogs, failure_injector=None,
                 memory_pool=None, *, device):
        self.spec = spec
        if spec.spool_dir is not None:
            from trino_tpu_torch.runtime.spool import SpoolingExchangeSink

            self.buffer = SpoolingExchangeSink(
                spec.spool_dir, str(spec.task_id), spec.n_output_partitions
            )
        else:
            self.buffer = OutputBuffer(spec.n_output_partitions)
        self.device = torch.device(device)
        # listener-driven lifecycle (TaskStateMachine analogue,
        # runtime/state_machine.py); `.state` stays the string API the
        # worker/coordinator protocol reads
        from trino_tpu_torch.runtime.state_machine import task_state_machine

        self._state_machine = task_state_machine(str(spec.task_id))
        self.failure: Optional[str] = None
        self._clients: List[DirectExchangeClient] = []
        self._catalogs = catalogs
        self._injector = failure_injector
        self._memory_pool = memory_pool
        self._thread: Optional[threading.Thread] = None
        self._producers: List[threading.Thread] = []
        self._stat_groups = None  # [[OperatorStats]] when collect_stats
        # stuck-task watchdog surface: drivers heartbeat per batch
        # (Driver observer -> _on_batch); the watchdog compares
        # last_progress_at against stuck_task_interrupt_s and the
        # diagnostic names current_operator
        self.last_progress_at: Optional[float] = None
        self.current_operator: Optional[str] = None
        # per-task CPU ledger (thread CPU seconds across this task's
        # driver threads) — the coordinator QueryTracker aggregates
        # these into the query_max_cpu_time_s budget
        self._cpu_base: Dict[int, float] = {}
        self._cpu_by_thread: Dict[int, float] = {}
        # the reference sets this once every shape class the census
        # predicts is warm, letting the watchdog apply the tighter warm
        # threshold; the census is the compile tier's (item 13)
        self.shapes_warm: bool = False
        # observability: wall-clock bounds for TaskInfo; the remote span
        # recorder + wrapped operators when tracing is on
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self._trace = None
        self._instrumented: list = []

    def operator_stats(self):
        """JSON-ready [[dict]] per pipeline, or None."""
        import dataclasses as _dc

        if self._stat_groups is None:
            return None
        if self.state != "running":
            # terminal: resolve deferred row counts so the final
            # TaskInfo carries exact numbers even on the failure path,
            # where the success-path close_span sweep never ran
            for op in self._instrumented:
                op.flush_counts()
        return [
            [_dc.asdict(s) for s in group] for group in self._stat_groups
        ]

    def trace_spans(self):
        """Exported operator span dicts (None when tracing is off).
        The worker ships these only for TERMINAL tasks so the
        coordinator never grafts a still-open span."""
        if self._trace is None:
            return None
        return self._trace.export()["spans"]

    def heartbeat(self) -> None:
        """Operator-internal liveness beat (InstrumentedOperator fires
        this at entry AND exit of every add_input/get_output/finish):
        refreshes watchdog freshness at tens-of-ms granularity without
        naming an operator, so it never ARMS the watchdog — arming
        still requires a completed batch (_on_batch)."""
        import time

        self.last_progress_at = time.monotonic()

    @property
    def state(self) -> str:
        return self._state_machine.get()

    @state.setter
    def state(self, value: str) -> None:
        self._state_machine.set(value)

    def add_state_listener(self, fn) -> None:
        self._state_machine.add_listener(fn)

    # -- lifecycle --
    def start(self) -> None:
        self.state = "running"
        self._thread = threading.Thread(
            target=self._run, name=f"task-{self.spec.task_id}", daemon=True
        )
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the task's thread and its pipeline threads."""
        if self._thread is not None:
            self._thread.join(timeout)
        for t in list(self._producers):
            t.join(timeout)
        for c in list(self._clients):
            c.join(timeout)

    def abort(self) -> None:
        # terminal states latch: aborting an already-finished/failed
        # task keeps its verdict (TaskStateMachine.abort contract)
        self._state_machine.set("aborted")
        self.buffer.abort()
        for c in self._clients:
            c.close()

    # -- progress / CPU accounting (watchdog + deadline surfaces) --
    def _stopping(self) -> bool:
        return self.state in ("aborted", "failed")

    def _on_batch(self, op_name: str, moved: bool) -> None:
        """Driver observer: refresh the heartbeat and the CPU ledger.
        `moved=False` marks a blocked wait (starved on input — upstream's
        watchdog problem, not ours), which refreshes freshness without
        consulting the injector's "batch" site."""
        import time

        if moved:
            # only a COMPLETED batch arms the watchdog and names the
            # operator; a blocked wait refreshes freshness but proves
            # nothing about this task's own progress
            self.current_operator = op_name
        self.last_progress_at = time.monotonic()
        tid = threading.get_ident()
        ct = time.thread_time()
        base = self._cpu_base.setdefault(tid, ct)
        self._cpu_by_thread[tid] = ct - base
        deadline = self.spec.deadline_epoch_s
        if deadline is not None and time.time() > deadline:
            # worker-local enforcement: kill between batches without a
            # coordinator round trip; fail() is idempotent on terminal
            # states so racing the coordinator's own kill is safe
            from trino_tpu_torch.runtime.query_tracker import (
                EXCEEDED_TIME_LIMIT,
            )

            self.fail(
                f"Task {self.spec.task_id}: worker-local deadline "
                f"passed ({time.time() - deadline:.3f}s over) "
                f"[{EXCEEDED_TIME_LIMIT}]"
            )
            return
        if moved and self._injector is not None:
            # the hung-operator chaos site: a stall here models an
            # operator wedged mid-batch; abort-polling lets a
            # watchdog-failed task wake and unwind promptly
            self._injector.check(
                self.spec.task_id, "batch", abort=self._stopping
            )

    def cpu_time_s(self) -> float:
        return sum(self._cpu_by_thread.values())

    def interrupt_if_stuck(
        self, timeout_s: float, now: Optional[float] = None
    ) -> Optional[str]:
        """Watchdog entry: if this RUNNING task has made no batch
        progress for longer than timeout_s, fail it with a diagnostic
        naming the stuck operator and its last batch timestamp, and
        return the diagnostic. The failure carries NO deadline code —
        stuck-task interrupts are RETRYABLE (a hung split on this worker
        may succeed elsewhere), unlike QueryTracker deadline kills.

        The watchdog arms at the FIRST batch boundary: startup work
        before any batch (a first kernel build, cold split
        materialization, connector data generation) is legitimate unbounded compute the
        batch-granularity heartbeat cannot see inside, so killing on it
        would interrupt healthy tasks — and each retry would re-block on
        the same warm-up and die the same way. "No progress" means "was
        progressing, then stopped"; a task wedged before its first batch
        is the coordinator deadline hierarchy's kill, not ours."""
        import time

        if self.state != "running" or self.last_progress_at is None:
            return None
        if self.current_operator is None:
            return None  # still in startup: not yet armed
        now = time.monotonic() if now is None else now
        age = now - self.last_progress_at
        if age <= timeout_s:
            return None
        diag = (
            f"Stuck task {self.spec.task_id}: no progress for {age:.3f}s "
            f"(stuck_task_interrupt_s={timeout_s}) in operator "
            f"{self.current_operator or 'task startup'}; last batch at "
            f"t={self.last_progress_at:.3f}"
        )
        self.fail(diag)
        return diag

    def fail(self, message: str) -> None:
        """External kill (low-memory killer, DELETE /v1/query,
        speculation-loser cancellation): latch a FAILED verdict carrying
        `message`, then abort the buffer and exchange clients so the
        task's driver stops cooperatively at its next batch boundary.
        Terminal tasks keep their existing verdict."""
        if self.state in ("finished", "failed", "aborted"):
            return
        self.failure = message
        self.state = "failed"
        self.abort()

    # -- execution --
    def _injected_fetch(self, fetch):
        """Chaos hook: the injector is consulted per exchange fetch (the
        "fetch" site) so fault schedules can drop a bounded number of
        page pulls — absorbed by the exchange client's retry loop."""

        def wrapped(partition, token, max_pages, wait):
            self._injector.check(self.spec.task_id, "fetch")
            return fetch(partition, token, max_pages, wait)

        return wrapped

    def _make_remote_source(self, fragment_ids) -> DirectExchangeClient:
        locations = []
        my_partition = self.spec.task_id.partition
        for fid in fragment_ids:
            for i, loc in enumerate(self.spec.input_locations.get(fid, [])):
                fetch = _resolve_fetch(loc)
                if self._injector is not None:
                    fetch = self._injected_fetch(fetch)
                dest = (
                    f"{loc[0]}:{loc[1]}" if isinstance(loc, tuple)
                    else f"local:f{fid}.{i}"
                )
                locations.append(
                    ExchangeLocation(fetch, my_partition, destination=dest)
                )
        client = DirectExchangeClient(locations)
        self._clients.append(client)
        return client

    def _run(self) -> None:
        import time

        spec = self.spec
        ctx: dict = {
            "make_remote_source": self._make_remote_source,
            "query_id": spec.task_id.query_id,
        }
        # heartbeat starts at task start, not first batch: a task hung
        # before producing anything is still watchdog-visible
        self.last_progress_at = time.monotonic()
        self.start_time = time.time()
        if spec.trace_ctx is not None:
            from trino_tpu_torch.runtime.tracing import QueryTrace

            self._trace = QueryTrace.remote(
                spec.trace_ctx, query_id=spec.task_id.query_id
            )
        try:
            if self._injector is not None:
                # abort-polling: remove_task joins this thread, so a
                # stalled attempt that lost to its speculative twin must
                # wake when it is removed
                self._injector.check(spec.task_id, "start", abort=self._stopping)
            planner = LocalPlanner(
                self._catalogs,
                self.device,
                batch_rows=spec.batch_rows,
                target_splits=spec.target_splits,
                remote_schemas=spec.remote_schemas,
                scan_slice=spec.scan_slice,
                dynamic_filtering=spec.dynamic_filtering,
            )
            physical = planner.plan(spec.fragment.root)
            if self._memory_pool is not None:
                ctx["memory_pool"] = self._memory_pool
                ctx["spill_dir"] = os.path.join(
                    tempfile.gettempdir(),
                    f"trino-tpu-torch-spill-{uuid.uuid4().hex}",
                )
            pipelines, chain = physical.instantiate(ctx)
            sink_buffer = self.buffer
            if self._injector is not None:
                sink_buffer = _MidFailureBuffer(
                    self.buffer, self._injector, spec.task_id
                )
            chain.append(
                PartitionedOutputOperator(
                    sink_buffer,
                    spec.fragment.output_kind,
                    spec.fragment.output_channels,
                    spec.n_output_partitions,
                )
            )
            # instrumentation is ALWAYS on: wall/batch counts and the
            # operator-internal heartbeat are cheap (no device sync).
            # Row counting (count_rows) forces a per-batch host sync, so
            # it stays gated on collect_stats — EXPLAIN ANALYZE and
            # query_trace=on set it.
            from trino_tpu_torch.exec.stats import instrument

            span_factory = None
            if self._trace is not None:
                parent_id = spec.trace_ctx.get("span_id")
                from trino_tpu_torch.runtime.tracing import KIND_OPERATOR

                def span_factory(op_name, _pid=parent_id):
                    return self._trace.span(
                        op_name, KIND_OPERATOR, parent=_pid,
                        task=str(spec.task_id),
                    )

            def _wrap(ops):
                wrapped, stats = instrument(
                    ops,
                    count_rows=spec.collect_stats,
                    heartbeat=self.heartbeat,
                    span_factory=span_factory,
                )
                self._instrumented.extend(wrapped)
                return wrapped, stats

            stat_groups = []
            wrapped_pipelines = []
            for ops in pipelines:
                ops, stats = _wrap(ops)
                wrapped_pipelines.append(Pipeline(ops))
                stat_groups.append(stats)
            pipelines = wrapped_pipelines
            chain, stats = _wrap(chain)
            stat_groups.append(stats)
            self._stat_groups = stat_groups
            self._run_pipelines(pipelines, chain, spec.task_concurrency)
            for op in self._instrumented:
                op.close_span()
            from trino_tpu_torch.engine import _raise_deferred_checks

            _raise_deferred_checks(ctx)
            self.state = "finished"
        except BaseException as e:
            # full traceback, not just the message: TaskInfo failures
            # travel to the coordinator and are the only evidence a
            # remote crash leaves behind (TaskStatus.getFailures). An
            # externally-killed task already carries its verdict (the
            # low-memory killer's message) — don't overwrite it with the
            # TaskAbortedError unwind.
            if self.failure is None:
                self.failure = "".join(
                    traceback.format_exception(type(e), e, e.__traceback__)
                ).strip()
            self.state = "failed"
            self.buffer.abort()
        finally:
            self.end_time = time.time()
            if self._trace is not None:
                # a failed/killed task still exports a fully-closed
                # span set (the invariant checker rejects open spans)
                self._trace.end_open_spans()
            # release every operator reservation: on a SHARED worker
            # pool a failed/killed task would otherwise leak its bytes
            # and poison the pool for every later query
            for mc in ctx.get("memory_contexts", ()):
                try:
                    mc.close()
                except Exception:
                    pass
            for c in self._clients:
                c.close()
            if "spill_dir" in ctx:
                shutil.rmtree(ctx["spill_dir"], ignore_errors=True)

    def _run_pipelines(self, pipelines, chain, concurrency: int) -> None:
        """Drive the task's pipelines. concurrency > 1 enables the
        intra-task parallel form (LocalExchange.java:67 discipline): a
        chain headed by a remote source splits at a LocalExchange so
        page pulls + deserialization (host) overlap the device compute
        downstream. Build pipelines run sequentially in planner order —
        they can be DEPENDENT (a join-on-join build side embeds the
        inner join's probe; see _visit_JoinNode), so concurrent starts
        need a bridge-readiness protocol the operators don't have."""
        from trino_tpu_torch.exec.exchange_ops import RemoteSourceOperator
        from trino_tpu_torch.exec.local_exchange import (
            LocalExchange,
            LocalExchangeSinkOperator,
            LocalExchangeSourceOperator,
        )

        def stop() -> bool:
            # fail_query / abort flip the state machine externally; the
            # driver polls it at batch boundaries so a killed task stops
            # instead of grinding through grace-join spill work
            return self._state_machine.get() in ("aborted", "failed")

        def drive(p):
            Driver(p, should_stop=stop, observer=self._on_batch).run()

        # build pipelines run SEQUENTIALLY: the local planner emits them
        # in dependency order (a join-on-join build side embeds the
        # inner join's probe, which reads the inner build's bridge —
        # concurrent starts would probe an unfinished lookup source)
        for p in pipelines:
            drive(p)
        head = chain[0] if chain else None
        # the head is wrapped by InstrumentedOperator — the concurrency
        # split keys on the REAL operator underneath
        head_inner = getattr(head, "inner", head)
        if (
            concurrency > 1
            and len(chain) > 1
            and isinstance(head_inner, RemoteSourceOperator)
        ):
            # overlap remote-page pulls/deserialization with the device
            # compute downstream (the LocalExchange split)
            ex = LocalExchange(n_consumers=1, mode="arbitrary")
            producer = Pipeline([head, LocalExchangeSinkOperator(ex)])
            consumer = Pipeline(
                [LocalExchangeSourceOperator(ex)] + list(chain[1:])
            )
            perr: List[BaseException] = []

            def run_producer():
                try:
                    drive(producer)
                except BaseException as e:
                    perr.append(e)
                    # unblock the consumer by FAILING the exchange, not
                    # finishing it: a clean producer_finished() here
                    # would let the consumer treat the truncated stream
                    # as end-of-input and publish an empty 'complete'
                    # result while the upstream failure is still in
                    # flight (the killed-query-returns-empty race)
                    ex.producer_failed(e)

            t = threading.Thread(
                target=run_producer, name=f"pipeline-producer-{self.spec.task_id}",
                daemon=True,
            )
            self._producers.append(t)
            t.start()
            try:
                drive(consumer)
            except BaseException:
                # a failed consumer must not abandon the producer
                # blocked in put(): abort drops buffered pages and
                # makes further puts no-ops, and closing the exchange
                # clients ends its remote source
                ex.abort()
                for c in self._clients:
                    c.close()
                t.join()
                if perr:
                    # the producer died first — its error is the root
                    # cause; the consumer unwind is secondary noise
                    raise perr[0]
                raise
            t.join()
            if perr:
                raise perr[0]
        else:
            drive(Pipeline(chain))
