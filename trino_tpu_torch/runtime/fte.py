"""Fault-tolerant (task-retry) query scheduling over spooled exchange.

Counterpart of trino_tpu/runtime/fte.py: retry_policy="task". Every
attempt of a partition is a new task on a worker (in-process or behind
a WorkerServer), which plans and runs its fragment on that worker's
device; a failed attempt is re-run as a task again, never as a CPU run
in its place. The reference's recovery hooks (substituting and
recording whole stage outputs) sit behind recovery_spool_stages, which
the coordinator refuses before this scheduler is built (ROADMAP §1
item 13). Unlike the reference, the scheduler removes every attempt it
launched from its worker once the query is over (`release`): a worker
that serves many queries keeps no finished task.

Analogue of EventDrivenFaultTolerantQueryScheduler.java:160 (SURVEY.md
§3.5): stages execute bottom-up; every task's output is spooled through
the external exchange (runtime/spool.py) so tasks are idempotent and
individually re-runnable. On failure a partition is re-launched as
attempt+1 — on a different active worker when one exists (the
BinPackingNodeAllocator's re-placement, reduced to avoid-the-failed-
node) — and consumers read exactly one committed attempt per partition
(ExchangeSourceOutputSelector de-duplication). Workers joining between
rounds are picked up because the active set is re-read per launch
(FTE elasticity, §5.3).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.runtime.task import TaskId, TaskSpec
from trino_tpu_torch.sql.fragmenter import SubPlan


class TaskRetriesExceeded(RuntimeError):
    pass


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated quantile of an ascending list (the numpy
    default method, done by hand — no device round trip for a handful
    of wall times)."""
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class _LaunchFailed(Exception):
    def __init__(self, handle, exc):
        self.handle = handle
        self.exc = exc


class FaultTolerantQueryScheduler:
    def __init__(
        self,
        query_id: str,
        subplan: SubPlan,
        workers: List,  # worker handles (or a NodeManager via active_fn)
        catalogs,
        session,
        spool_dir: str,
        hash_partitions: Optional[int] = None,
        max_task_retries: int = 3,
        active_workers_fn=None,
        node_manager=None,
        trace=None,
        query_span=None,
        collect_stats: bool = False,
        deadline_epoch_s: Optional[float] = None,
        *,
        device,
    ):
        # the coordinator's device: fragment schemas are planned on it,
        # as each task plans its fragment on its worker's
        self.device = device
        self.query_id = query_id
        self.deadline_epoch_s = deadline_epoch_s
        self.subplan = subplan
        self.workers = workers
        self.catalogs = catalogs
        self.session = session
        self.spool_dir = spool_dir
        self.hash_partitions = hash_partitions or min(len(workers), 4)
        self.max_task_retries = max_task_retries
        self.node_manager = node_manager
        if active_workers_fn is not None:
            self._active_fn = active_workers_fn
        elif node_manager is not None:
            # circuit-breaker-aware placement: graylisted workers get no
            # launches while their breaker is open; if EVERY node is
            # graylisted, fall back to the active set rather than starve
            # (trying a gray node beats failing the query outright)
            self._active_fn = (
                lambda: node_manager.schedulable_workers()
                or node_manager.active_workers()
            )
        else:
            self._active_fn = lambda: self.workers
        self._schemas: Dict[int, list] = {}
        # (fragment, partition) -> committed task key
        self.committed: Dict[Tuple[int, int], str] = {}
        self.retries = 0
        # memory-aware placement (BinPackingNodeAllocatorService +
        # PartitionMemoryEstimator analogues, runtime/node_scheduler.py)
        from trino_tpu_torch.runtime.node_scheduler import (
            BinPackingNodeAllocator,
            PartitionMemoryEstimator,
        )

        self.allocator = BinPackingNodeAllocator(node_manager=node_manager)
        self.estimator = PartitionMemoryEstimator()
        # straggler mitigation: duplicate attempts for tasks running
        # `speculation_quantile`x beyond the stage's PER-FRAGMENT p75
        # (speculation_percentile) of committed-attempt wall times,
        # provided a spare schedulable worker exists; first attempt to
        # commit wins (the one-committed-attempt-per-partition
        # selector), the loser is cancelled cooperatively. The upper
        # quantile beats the old median on skewed stages: half the tasks
        # being "slow-ish" no longer drags the threshold down and
        # triggers duplicate storms.
        self.enable_speculation = getattr(session, "speculation_enabled", True)
        self.speculation_quantile = float(
            getattr(session, "speculation_quantile", 2.0)
        )
        self.speculation_percentile = float(
            getattr(session, "speculation_percentile", 0.75)
        )
        # fragment id -> the quantile wall-time estimate last used to
        # size its straggler threshold (surfaced in last_fte_stats)
        self.speculation_estimates: Dict[int, float] = {}
        self.speculative_hits = 0  # speculative attempts launched
        self.speculation_wins = 0  # ...that committed first
        self.speculation_losses = 0  # ...cancelled or failed
        # task id -> last polled thread-CPU seconds (Worker.task_state
        # "cpu_s"): summed into the query_max_cpu_time_s budget
        self.cpu_by_task: Dict[str, float] = {}
        # "fragment.partition" -> attempts ever launched (observability:
        # chaos/bench assert attempt counts stay bounded per partition)
        self.attempts_per_partition: Dict[str, int] = {}
        self._speculative_tids: set = set()
        # every attempt launched: (worker handle, task id string)
        self._launched: List[Tuple[object, str]] = []
        # tracing (runtime/tracing.py): one stage span per _run_stage,
        # one task span per attempt (keyed by tid string — the running
        # 5-tuples stay untouched); retry/speculation/deadline/watchdog/
        # chaos events annotate the owning span. collect_stats rides
        # TaskSpec so traced queries get row counts + operator spans.
        self.trace = trace
        self.query_span = query_span
        self.collect_stats = collect_stats
        self._task_spans: Dict[str, object] = {}
        # tid -> (fragment id, last observed status dict) for the
        # QueryInfo stage rollup (losers get a best-effort final fetch
        # in settle, BEFORE remove_task destroys their status)
        self._snapshots: Dict[str, Tuple[int, dict]] = {}

    def _report(self, handle, ok: bool) -> None:
        """Feed the node's circuit breaker: in-process handles have no
        HTTP layer reporting for them, so the scheduler reports its own
        control-plane outcomes (launches, state polls)."""
        if self.node_manager is None:
            return
        wid = getattr(handle, "worker_id", None)
        if wid is None:
            return
        if ok:
            self.node_manager.report_success(wid)
        else:
            self.node_manager.report_failure(wid)

    def cpu_time_s(self) -> float:
        """Query-wide CPU spent, from the last polled per-task ledgers
        (finished/failed attempts keep their final reading)."""
        return sum(self.cpu_by_task.values())

    def task_snapshots(self) -> Dict[int, List[Tuple[str, dict]]]:
        """fragment id -> [(tid, last observed status)] across every
        attempt — the QueryInfo stage-rollup input (same shape as
        QueryScheduler.finalize)."""
        out: Dict[int, List[Tuple[str, dict]]] = {}
        for tid, (fid, st) in self._snapshots.items():
            out.setdefault(fid, []).append((tid, st))
        return out

    def _observe(self, fid: int, tid: str, st: dict) -> None:
        """Record an attempt's latest status; graft its operator spans
        once terminal (the worker only ships spans for terminal tasks;
        graft dedups by span_id so repeat polls are safe)."""
        self._snapshots[tid] = (fid, st)
        if self.trace is not None:
            self.trace.graft(st.get("spans") or [])
            if st.get("state") in ("finished", "failed", "aborted"):
                span = self._task_spans.get(tid)
                if span is not None and not span.ended:
                    if st.get("failure"):
                        # classified failure annotation: a chaos run
                        # must read as one timeline (deadline /
                        # watchdog_interrupt / chaos_fault / task_failed)
                        span.event(self._failure_kind(st["failure"]),
                                   error=str(st["failure"])[:300])
                        span.set(error=True)
                    if st.get("start_time"):
                        span.start_s = st["start_time"]
                    span.set(state=st.get("state"),
                             cpu_s=st.get("cpu_s") or 0.0)
                    span.end(st.get("end_time"))

    @staticmethod
    def _failure_kind(msg: Optional[str]) -> str:
        """Classify a task-failure string into the annotation vocabulary
        (works across HTTP topologies, where only the string travels)."""
        from trino_tpu_torch.runtime.query_tracker import deadline_code

        msg = msg or ""
        if deadline_code(msg) is not None:
            return "deadline"
        if "Stuck task" in msg:
            return "watchdog_interrupt"
        if "injected" in msg.lower():
            return "chaos_fault"
        return "task_failed"

    # scheduling is stage-by-stage: children complete before parents run
    def run(self, cancel=None) -> Tuple[object, str]:
        """Execute every stage; returns (root worker handle, root task
        key) for result fetching (root output is spooled too, so any
        handle can serve it — we return the one that ran it). `cancel`
        is polled between scheduling rounds: client abandonment tears
        the query down instead of finishing work nobody reads."""
        from trino_tpu_torch.runtime.stages import stage_task_count, topo_order

        order = topo_order(self.subplan)
        task_counts = {
            sp.fragment.id: stage_task_count(
                sp, len(self.workers), self.hash_partitions
            )
            for sp in order
        }
        consumer_counts: Dict[int, int] = {}
        for sp in order:
            for c in sp.children:
                consumer_counts[c.fragment.id] = task_counts[sp.fragment.id]
        root_handle = None
        root_id = self.subplan.fragment.id
        for sp in order:
            fid = sp.fragment.id
            n_out = consumer_counts.get(fid, 1)
            root_handle = self._run_stage(
                sp, task_counts[fid], n_out, cancel=cancel,
            )
        root_key = self.committed[(root_id, 0)]
        return root_handle, root_key

    def release(self) -> None:
        """Remove every attempt this query launched from its worker
        (committed ones included: their output is in the spool)."""
        for handle, tid in self._launched:
            try:
                handle.remove_task(tid)
            except Exception:
                pass  # a vanished worker holds nothing more
        self._launched.clear()

    @staticmethod
    def _abort_running(running: Dict[int, List[Tuple]]) -> None:
        """Cooperatively cancel every in-flight attempt (deadline kill /
        abandonment unwind): remove_task flips each task's state machine
        so its driver stops at the next batch boundary and its memory
        contexts close."""
        for entries in running.values():
            for h, tid, _, _, _ in entries:
                try:
                    h.remove_task(tid)
                except Exception:
                    pass

    def _run_stage(self, sp: SubPlan, tc: int, n_out: int, cancel=None):
        from trino_tpu_torch.runtime.stages import fragment_schema

        f = sp.fragment
        stage_span = None
        if self.trace is not None and self.query_span is not None:
            from trino_tpu_torch.runtime.tracing import KIND_STAGE

            stage_span = self.query_span.child(
                f"stage {f.id}", KIND_STAGE, fragment_id=f.id, tasks=tc
            )
        remote = {
            c.fragment.id: self._schemas[c.fragment.id] for c in sp.children
        }
        self._schemas[f.id] = fragment_schema(
            self.catalogs, self.session, sp, remote, self.device
        )
        input_locations = {
            c.fragment.id: [
                ("spool", self.spool_dir, self.committed[(c.fragment.id, p)])
                for p in range(
                    len([
                        k for k in self.committed if k[0] == c.fragment.id
                    ])
                )
            ]
            for c in sp.children
        }
        pending = {p: 0 for p in range(tc)}  # partition -> attempt
        # partition -> [(handle, tid, attempt, started_at, est_bytes)];
        # entry 0 is the primary, entry 1 (if any) the speculative dup
        running: Dict[int, List[Tuple]] = {}
        # highest attempt number ever assigned per partition: retry and
        # speculative numbers must never collide with a FAILED attempt's
        # id — create_task is idempotent by id and would hand back the
        # dead TaskExecution
        attempt_hwm: Dict[int, int] = {p: 0 for p in range(tc)}
        durations: List[float] = []  # completed-task wall times
        last_handle = None
        avoid: Dict[int, object] = {}  # partition -> failed handle

        def launch(p: int, attempt: int, avoid_h=None):
            active = list(self._active_fn())
            if not active:
                raise TaskRetriesExceeded("no active workers")
            # memory-aware bin packing; the estimate is re-read PER
            # LAUNCH so register_failure's growth affects the retry
            est_bytes = self.estimator.estimate(f.id)
            handle = self.allocator.acquire(active, est_bytes, avoid=avoid_h)
            attempt_hwm[p] = max(attempt_hwm[p], attempt)
            pkey = f"{f.id}.{p}"
            self.attempts_per_partition[pkey] = (
                self.attempts_per_partition.get(pkey, 0) + 1
            )
            task_id = TaskId(self.query_id, f.id, p, attempt)
            tspan = None
            if stage_span is not None:
                from trino_tpu_torch.runtime.tracing import KIND_TASK, wire_context

                tspan = stage_span.child(
                    f"task {task_id}", KIND_TASK,
                    partition=p, attempt=attempt,
                    worker=getattr(handle, "worker_id", None),
                )
                self._task_spans[str(task_id)] = tspan
            spec = TaskSpec(
                task_id=task_id,
                fragment=f,
                n_output_partitions=n_out,
                remote_schemas=remote,
                scan_slice=(p, tc) if f.partitioning == "source" else None,
                input_locations=input_locations,
                batch_rows=self.session.batch_rows,
                target_splits=max(self.session.target_splits, tc),
                spool_dir=self.spool_dir,
                dynamic_filtering=self.session.enable_dynamic_filtering,
                task_concurrency=self.session.task_concurrency,
                collect_stats=self.collect_stats,
                deadline_epoch_s=self.deadline_epoch_s,
            )
            if tspan is not None and self.collect_stats:
                # operator spans only under query_trace=on: the wire
                # context is what tells the worker to record them
                spec.trace_ctx = wire_context(tspan)
            try:
                handle.create_task(spec)
            except Exception as exc:
                self.allocator.release(handle, est_bytes)
                self._report(handle, ok=False)
                if tspan is not None and not tspan.ended:
                    tspan.event("launch_failed", error=str(exc)[:300])
                    tspan.set(error=True, state="launch_failed")
                    tspan.end()
                raise _LaunchFailed(handle, exc)
            self._report(handle, ok=True)
            self._launched.append((handle, str(task_id)))
            return (handle, str(task_id), attempt, time.monotonic(), est_bytes)

        def settle(p: int, winner, losers):
            """Commit the winner; cancel+release live sibling attempts.
            Entries that already FAILED were released in the poll loop
            and must not be passed here (double-release would corrupt
            the allocator's reservations)."""
            handle, tid, _, t0, est = winner
            durations.append(time.monotonic() - t0)
            self.committed[(f.id, p)] = tid
            self.allocator.release(handle, est)
            if tid in self._speculative_tids:
                self.speculation_wins += 1
                wspan = self._task_spans.get(tid)
                if wspan is not None:
                    wspan.event("speculation_won", partition=p)
            for h, other_tid, _, _, other_est in losers:
                self.allocator.release(h, other_est)
                was_speculative = other_tid in self._speculative_tids
                if was_speculative:
                    self.speculation_losses += 1
                lspan = self._task_spans.get(other_tid)
                if lspan is not None:
                    lspan.event(
                        "speculation_lost" if was_speculative
                        else "lost_to_speculation"
                    )
                # last look at the loser's status BEFORE remove_task
                # destroys it: the stage rollup keeps every attempt, and
                # a just-finished loser may have spans worth grafting
                try:
                    self._observe(f.id, other_tid, h.task_state(other_tid))
                except Exception:
                    pass
                if lspan is not None and not lspan.ended:
                    lspan.set(state="aborted")
                    lspan.end()
                # cooperative cancel: remove_task aborts the loser's
                # state machine, so its Driver stops at the next batch
                # boundary; consumers only ever read the committed
                # attempt, so a racing loser cannot add duplicate rows
                try:
                    h.remove_task(other_tid)
                except Exception:
                    pass
            return handle

        while pending or running:
            if cancel is not None and cancel():
                self._abort_running(running)
                raise RuntimeError(
                    f"Query {self.query_id} abandoned: client stopped "
                    "polling results"
                )
            if not list(self._active_fn()):
                raise TaskRetriesExceeded("no active workers")
            # launch
            for p in sorted(pending):
                attempt = pending.pop(p)
                try:
                    running[p] = [launch(p, attempt, avoid.get(p))]
                except _LaunchFailed as lf:
                    # launch failure == task failure: re-queue on another
                    # node, same retry budget (the status-failure path)
                    if attempt + 1 > self.max_task_retries:
                        raise TaskRetriesExceeded(
                            f"task {self.query_id}.{f.id}.{p} could not "
                            f"launch after {attempt + 1} attempts: {lf.exc}"
                        )
                    self.retries += 1
                    avoid[p] = lf.handle
                    pending[p] = attempt_hwm[p] + 1
                    if stage_span is not None:
                        stage_span.event("task_retry", partition=p,
                                         attempt=pending[p],
                                         reason="launch_failed")
            # poll
            time.sleep(0.01)
            now = time.monotonic()
            # straggler threshold: the per-fragment p75 (or whatever
            # speculation_percentile says) of committed wall times. The
            # availability gate is a QUARTER of the stage (min 1): an
            # upper quantile stabilizes on fewer samples than the old
            # median-of-half, so skewed stages speculate sooner — and a
            # 2-task stage must still speculate off its single committed
            # sibling, exactly the case where one straggler IS half the
            # stage.
            est_wall = None
            if len(durations) >= max(1, -(-tc // 4)):
                est_wall = _quantile(
                    sorted(durations), self.speculation_percentile
                )
                self.speculation_estimates[f.id] = est_wall
            for p, entries in list(running.items()):
                finished_entry = None
                next_entries = []
                for entry in entries:
                    handle, tid, attempt, t0, est = entry
                    try:
                        st = handle.task_state(tid)
                        self._report(handle, ok=True)
                    except Exception as e:
                        self._report(handle, ok=False)
                        st = {
                            "state": "failed",
                            "failure": f"worker unreachable: {e}",
                        }
                    if "cpu_s" in st:
                        self.cpu_by_task[tid] = float(st["cpu_s"] or 0.0)
                    self._observe(f.id, tid, st)
                    if st["state"] == "finished":
                        if finished_entry is None:
                            finished_entry = entry
                        else:  # both attempts finished: keep the first
                            next_entries.append(entry)
                        continue
                    if st["state"] == "failed":
                        self.allocator.release(handle, est)
                        fmsg = st.get("failure")
                        from trino_tpu_torch.runtime.query_tracker import (
                            deadline_code,
                            deadline_error,
                        )

                        if deadline_code(fmsg) is not None:
                            # deadline kill: NON-RETRYABLE by contract —
                            # replaying a task of a query whose budget
                            # is spent can only spend it again. Contrast
                            # watchdog interrupts (no code), which stay
                            # in the normal retry path below.
                            if stage_span is not None:
                                stage_span.event("deadline_kill", task=tid)
                            self._abort_running(running)
                            raise deadline_error(f"task {tid}: {fmsg}")
                        if tid in self._speculative_tids:
                            self.speculation_losses += 1
                        self.estimator.register_failure(f.id, fmsg)
                        if len(entries) == 1 and attempt + 1 > self.max_task_retries:
                            raise TaskRetriesExceeded(
                                f"task {tid} failed after {attempt + 1} "
                                f"attempts: {fmsg}"
                            )
                        self.retries += 1
                        avoid[p] = handle
                        continue  # drop this attempt, keep any sibling
                    next_entries.append(entry)
                if finished_entry is not None:
                    last_handle = settle(p, finished_entry, next_entries)
                    del running[p]
                    continue
                if not next_entries:
                    del running[p]
                    next_attempt = attempt_hwm[p] + 1
                    if next_attempt > self.max_task_retries:
                        raise TaskRetriesExceeded(
                            f"partition {p} of fragment {f.id} failed "
                            f"after {next_attempt} attempts"
                        )
                    pending[p] = next_attempt
                    if stage_span is not None:
                        stage_span.event("task_retry", partition=p,
                                         attempt=next_attempt,
                                         reason="task_failed")
                    continue
                running[p] = next_entries
                # speculation: the stage is mostly done, this partition
                # is a straggler, and no duplicate is in flight yet
                if (
                    self.enable_speculation
                    and len(next_entries) == 1
                    and est_wall is not None
                    and now - next_entries[0][3]
                    > max(self.speculation_quantile * est_wall, 0.25)
                    and attempt_hwm[p] < self.max_task_retries
                ):
                    handle = next_entries[0][0]
                    # only speculate when a SPARE worker exists: a dup on
                    # the straggler's own node races the same slowness
                    spare = [
                        h for h in list(self._active_fn()) if h is not handle
                    ]
                    if not spare:
                        continue
                    try:
                        dup = launch(p, attempt_hwm[p] + 1, avoid_h=handle)
                        running[p].append(dup)
                        self.speculative_hits += 1
                        self._speculative_tids.add(dup[1])
                        dspan = self._task_spans.get(dup[1])
                        if dspan is not None:
                            dspan.set(speculative=True)
                            dspan.event("speculative_launch",
                                        straggler=next_entries[0][1])
                    except _LaunchFailed:
                        pass  # speculation is best-effort
        if stage_span is not None:
            # abnormal exits (deadline, retries exceeded, abandonment)
            # leave the stage span open; the coordinator's finalize
            # sweep (end_open_spans) closes it with the query
            stage_span.end()
        return last_handle
