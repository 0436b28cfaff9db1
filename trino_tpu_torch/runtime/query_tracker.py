"""Query deadline hierarchy: the coordinator's time-bounding authority.

Analogue of main/execution/QueryTracker.java (enforceTimeLimits +
failAbandonedQueries — SURVEY.md §runtime): a periodic tick walks every
live query and enforces

  - query_max_planning_time_s   while the query is PLANNING
  - query_max_execution_time_s  while the query is EXECUTING
  - query_max_run_time_s        from submission (QUEUED + PLANNING +
                                EXECUTING — the end-to-end wall bound)
  - query_max_cpu_time_s        aggregated from task-level CPU ledgers
                                (Worker.task_state "cpu_s")

A breached limit kills the query's remote tasks through the registered
kill callback (the DELETE /v1/query/{id} path on HTTP topologies) and
latches a TYPED, NON-RETRYABLE error — EXCEEDED_TIME_LIMIT /
EXCEEDED_CPU_LIMIT are user errors: resubmitting a query that already
spent its budget can only spend it again, so QUERY retry and FTE task
retry must both refuse to replay them. Contrast the worker-side
stuck-task watchdog (runtime/worker.py): a hung split on one node may
well succeed elsewhere, so watchdog interrupts stay RETRYABLE.

The tick is explicit (`tick()`) for deterministic tests and can run on
a background thread (`start()`) for live coordinators, mirroring the
NodeManager's ping_once/start discipline."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# error codes carried INSIDE kill messages so they survive the trip
# through task failure strings and HTTP 500 bodies: any layer can
# re-classify a stringly failure back into the typed error
EXCEEDED_TIME_LIMIT = "EXCEEDED_TIME_LIMIT"
EXCEEDED_CPU_LIMIT = "EXCEEDED_CPU_LIMIT"


class QueryDeadlineError(RuntimeError):
    """A query exceeded one of its time budgets. NON-RETRYABLE by
    design (`retryable = False`): the budget is a property of the query,
    not of the node that ran it."""

    code = EXCEEDED_TIME_LIMIT
    retryable = False


class ExceededTimeLimitError(QueryDeadlineError):
    code = EXCEEDED_TIME_LIMIT


class ExceededCpuLimitError(QueryDeadlineError):
    code = EXCEEDED_CPU_LIMIT


def deadline_code(message: Optional[str]) -> Optional[str]:
    """Extract a deadline error code from a failure message (the
    classification hook for QUERY retry, FTE retry and _raise_if_failed:
    a kill message embeds its code in square brackets)."""
    if not message:
        return None
    for code in (EXCEEDED_TIME_LIMIT, EXCEEDED_CPU_LIMIT):
        if code in message:
            return code
    return None


def deadline_error(message: str) -> QueryDeadlineError:
    """Rehydrate the typed error from a coded failure message."""
    cls = (
        ExceededCpuLimitError
        if deadline_code(message) == EXCEEDED_CPU_LIMIT
        else ExceededTimeLimitError
    )
    return cls(message)


class QueryAbandonedError(RuntimeError):
    """The client stopped polling results; the query is torn down
    instead of computing a result nobody will read. Not a deadline kill
    (no bracketed code) and not retryable — resubmitting an abandoned
    query would just abandon it again."""

    retryable = False


def preemption_check(tracker, base_qid, cancel=None, deadline_epoch_s=None,
                     clock=None):
    """Build the chunk-boundary preemption hook for in-process data
    planes (the mesh chunk loop). The returned callable mirrors what the
    page plane enforces between batches — latched tracker kills, client
    abandonment, the worker-local wall deadline — so a mesh query under
    limits dies with the same typed errors, just at chunk granularity.

    Signature: check(done, total) — the caller's progress through its
    preemption boundaries, embedded in the kill message for
    observability. A checkpoint-resumed run (recovery tier) sets
    `check.resumed_from` — and, after a replica failover, the replica
    that picked the run up via `check.resumed_on` — so a deadline kill
    mid-resume names where the run restarted — the error stays typed
    and non-retryable either way: resuming does not refresh a spent
    budget."""
    import time as _time

    clock = clock or _time.time

    def _resume_ctx() -> str:
        resumed = getattr(check, "resumed_from", None)
        if resumed is None:
            return ""
        replica = getattr(check, "resumed_on", None)
        on = f" on replica {replica}" if replica is not None else ""
        return f" (resumed from chunk {resumed}{on})"

    def _park_ctx() -> str:
        # the scheduler's wait loops update `check.parked_s` while the
        # query sits parked or queued — a deadline firing there names
        # the time spent preempted. Deliberately counted against the
        # budget: parking does not stop a query's wall clock, so a
        # parked query that exceeds its deadline dies typed and never
        # resumes.
        parked = float(getattr(check, "parked_s", 0.0) or 0.0)
        if parked <= 0.0:
            return ""
        return f" (parked {parked:.2f}s)"

    def check(done: int, total: int) -> None:
        # a kill latched by the enforcement tick (planning/run/cpu
        # limits) surfaces here as its typed error — after a checkpoint
        # restore it must still name the resume point, whichever
        # enforcement path landed the kill first
        try:
            tracker.check(base_qid)
        except QueryDeadlineError as e:
            ctx = _resume_ctx() + _park_ctx()
            if not ctx:
                raise
            raise type(e)(
                f"{e} at mesh chunk {done}/{total}{ctx}"
            ) from None
        if cancel is not None and cancel():
            raise QueryAbandonedError(
                f"Query {base_qid} abandoned: client stopped "
                "polling results"
            )
        if deadline_epoch_s is not None and clock() > deadline_epoch_s:
            raise ExceededTimeLimitError(
                "Query exceeded the execution-time limit at mesh chunk "
                f"{done}/{total}{_resume_ctx()}{_park_ctx()} "
                f"[{EXCEEDED_TIME_LIMIT}]"
            )

    check.resumed_from = None
    check.resumed_on = None
    check.parked_s = 0.0
    return check


@dataclasses.dataclass(frozen=True)
class DeadlineLimits:
    """Per-query budgets; 0 (or None) disables a limit."""

    max_planning_time_s: float = 0.0
    max_execution_time_s: float = 0.0
    max_run_time_s: float = 0.0
    max_cpu_time_s: float = 0.0

    @classmethod
    def from_session(cls, session) -> "DeadlineLimits":
        g = lambda n: float(getattr(session, n, 0.0) or 0.0)
        return cls(
            max_planning_time_s=g("query_max_planning_time_s"),
            max_execution_time_s=g("query_max_execution_time_s"),
            max_run_time_s=g("query_max_run_time_s"),
            max_cpu_time_s=g("query_max_cpu_time_s"),
        )

    def any(self) -> bool:
        return any(
            v > 0
            for v in (
                self.max_planning_time_s,
                self.max_execution_time_s,
                self.max_run_time_s,
                self.max_cpu_time_s,
            )
        )


# query lifecycle phases the limits key on
QUEUED = "queued"
PLANNING = "planning"
EXECUTING = "executing"
DONE = "done"


class TrackedQuery:
    def __init__(
        self,
        query_id: str,
        limits: DeadlineLimits,
        kill: Optional[Callable[[str], None]],
        cpu_time_fn: Optional[Callable[[], float]],
        now: float,
    ):
        self.query_id = query_id
        self.limits = limits
        self.kill = kill
        self.cpu_time_fn = cpu_time_fn
        self.created_at = now
        self.phase = QUEUED
        self.planning_started_at: Optional[float] = None
        self.executing_started_at: Optional[float] = None
        self.error: Optional[QueryDeadlineError] = None
        # QUERY retry runs attempts under qN / qNr1 / ... namespaces;
        # the kill must target whichever attempt is live RIGHT NOW
        self.live_query_id = query_id


class QueryTracker:
    """Registry + enforcement tick. `kill` callbacks receive the coded
    kill message; the owner (DistributedQueryRunner / CoordinatorServer)
    routes it to Worker.fail_query / DELETE /v1/query/{id}."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 tick_interval_s: float = 0.05):
        self._clock = clock
        self.tick_interval_s = tick_interval_s
        self._queries: Dict[str, TrackedQuery] = {}
        self._lock = threading.Lock()  # QueryTracker._lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # observability: (query_id, code, message) per enforcement kill
        self.kills: List[Tuple[str, str, str]] = []

    # -- registry --
    def register(
        self,
        query_id: str,
        limits: DeadlineLimits,
        kill: Optional[Callable[[str], None]] = None,
        cpu_time_fn: Optional[Callable[[], float]] = None,
        phase: str = QUEUED,
    ) -> TrackedQuery:
        now = self._clock()
        tq = TrackedQuery(query_id, limits, kill, cpu_time_fn, now)
        with self._lock:
            self._queries[query_id] = tq
        if phase != QUEUED:
            self.transition(query_id, phase)
        return tq

    def transition(self, query_id: str, phase: str) -> None:
        tq = self._queries.get(query_id)
        if tq is None:
            return
        now = self._clock()
        tq.phase = phase
        if phase == PLANNING and tq.planning_started_at is None:
            tq.planning_started_at = now
        if phase == EXECUTING and tq.executing_started_at is None:
            tq.executing_started_at = now

    def set_live_query_id(self, query_id: str, live: str) -> None:
        tq = self._queries.get(query_id)
        if tq is not None:
            tq.live_query_id = live

    def complete(self, query_id: str) -> None:
        with self._lock:
            self._queries.pop(query_id, None)

    def check(self, query_id: str) -> None:
        """Raise the query's latched deadline error, if any — the
        synchronous surface for phases with no tasks to kill (queued,
        planning, between retry attempts)."""
        tq = self._queries.get(query_id)
        if tq is not None and tq.error is not None:
            raise tq.error

    def enforce_now(self, query_id: str) -> None:
        """One synchronous enforcement sweep for one query. Phase
        boundaries call this so a budget blown inside a sub-tick phase
        (planning that finishes before the first background tick fires)
        still latches its typed kill — identical to a tick landing at
        this instant."""
        with self._lock:
            tq = self._queries.get(query_id)
            if tq is None or tq.error is not None or tq.phase == DONE:
                return
        err = self._enforce(tq, self._clock())
        if err is None:
            return
        tq.error = err
        self.kills.append((tq.query_id, err.code, str(err)))
        if tq.kill is not None:
            try:
                tq.kill(str(err))
            except Exception:
                pass  # the latched error still fails the query

    # -- enforcement --
    def _enforce(self, tq: TrackedQuery, now: float) -> Optional[QueryDeadlineError]:
        lim = tq.limits
        if lim.max_run_time_s > 0 and now - tq.created_at > lim.max_run_time_s:
            return ExceededTimeLimitError(
                f"Query {tq.query_id} exceeded the maximum run time limit "
                f"of {lim.max_run_time_s}s [{EXCEEDED_TIME_LIMIT}]"
            )
        if (
            tq.phase == PLANNING
            and lim.max_planning_time_s > 0
            and tq.planning_started_at is not None
            and now - tq.planning_started_at > lim.max_planning_time_s
        ):
            return ExceededTimeLimitError(
                f"Query {tq.query_id} exceeded the maximum planning time "
                f"limit of {lim.max_planning_time_s}s [{EXCEEDED_TIME_LIMIT}]"
            )
        if (
            tq.phase == EXECUTING
            and lim.max_execution_time_s > 0
            and tq.executing_started_at is not None
            and now - tq.executing_started_at > lim.max_execution_time_s
        ):
            return ExceededTimeLimitError(
                f"Query {tq.query_id} exceeded the maximum execution time "
                f"limit of {lim.max_execution_time_s}s [{EXCEEDED_TIME_LIMIT}]"
            )
        if lim.max_cpu_time_s > 0 and tq.cpu_time_fn is not None:
            try:
                cpu = tq.cpu_time_fn()
            except Exception:
                cpu = 0.0
            if cpu > lim.max_cpu_time_s:
                return ExceededCpuLimitError(
                    f"Query {tq.query_id} exceeded the CPU time limit of "
                    f"{lim.max_cpu_time_s}s (used {cpu:.3f}s) "
                    f"[{EXCEEDED_CPU_LIMIT}]"
                )
        return None

    def tick(self, now: Optional[float] = None) -> List[Tuple[str, str]]:
        """One enforcement sweep; returns [(query_id, code)] for every
        kill issued this tick. A query already carrying an error is not
        re-killed (the kill latches)."""
        now = self._clock() if now is None else now
        t_tick = time.monotonic()
        with self._lock:
            live = [
                tq for tq in self._queries.values()
                if tq.error is None and tq.phase != DONE
            ]
        fired: List[Tuple[str, str]] = []
        for tq in live:
            err = self._enforce(tq, now)
            if err is None:
                continue
            tq.error = err
            self.kills.append((tq.query_id, err.code, str(err)))
            fired.append((tq.query_id, err.code))
            if tq.kill is not None:
                try:
                    tq.kill(str(err))
                except Exception:
                    pass  # the latched error still fails the query
        from trino_tpu_torch.runtime.metrics import METRICS

        METRICS.observe("tracker_tick_s", time.monotonic() - t_tick)
        return fired

    # -- background tick loop (live coordinators) --
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.tick_interval_s):
                self.tick()

        self._thread = threading.Thread(
            target=loop, name="query-tracker", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(1.0)
            self._thread = None
