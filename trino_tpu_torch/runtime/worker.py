"""Worker: the per-host task manager.

Counterpart of trino_tpu/runtime/worker.py. A Worker owns one torch
device: `Worker(..., device=None)` takes the CUDA card and raises when
there is none; the CPU is used only when the caller passes
device="cpu". Every task it runs plans its fragment on that device and
launches its kernels from the task's own thread. Its HTTP form is a
WorkerServer (runtime/http.py) around the same Worker. The watchdog's
tighter threshold for tasks whose shape classes are all warm needs the
shape census (the compile tier, item 13): no port task is ever warm, so
the conservative stuck_task_interrupt_s applies to every task.

Analogue of main/execution/SqlTaskManager.java:109 (updateTask:466 —
idempotent task creation, local planning, driver execution) plus the
results side of TaskResource. The same object serves the in-process
topology (coordinator holds a direct reference — the tier-3
DistributedQueryRunner arrangement) and the HTTP server (worker_http
wraps these methods behind /v1/task endpoints).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.connectors.spi import CatalogManager
from trino_tpu_torch.runtime.task import TaskExecution, TaskSpec


class WorkerShuttingDownError(RuntimeError):
    """Raised by create_task on a draining worker. Schedulers treat it
    like any launch failure and re-place the task on another node; it is
    NOT transient (the worker will never accept the launch), so the HTTP
    layer maps it to a non-retryable status code."""


class Worker:
    def __init__(
        self,
        worker_id: str,
        catalogs: Optional[CatalogManager] = None,
        failure_injector=None,
        memory_pool_bytes: Optional[int] = None,
        location: Optional[str] = None,
        stuck_task_interrupt_s: Optional[float] = None,
        stuck_task_interrupt_warm_s: Optional[float] = None,
        device=None,
    ):
        from trino_tpu_torch.engine import resolve_device

        self.device = resolve_device(device)
        self.worker_id = worker_id
        # "rack/host" network coordinate; workers carrying one get
        # topology-aware placement
        self.location = location
        # lifecycle (DiscoveryNodeManager's ACTIVE/SHUTTING_DOWN): a
        # draining worker refuses new task launches while running tasks
        # finish and already-produced output stays readable
        self.state = "active"  # active | shutting_down
        self.catalogs = catalogs or CatalogManager()
        self.failure_injector = failure_injector
        self.memory_pool = None
        if memory_pool_bytes is not None:
            from trino_tpu_torch.runtime.memory import MemoryPool

            self.memory_pool = MemoryPool(memory_pool_bytes)
        self._tasks: Dict[str, TaskExecution] = {}
        self._lock = threading.Lock()  # Worker._lock
        # stuck-task watchdog (StuckSplitTasksInterrupter analogue):
        # interrupt any RUNNING task whose per-batch heartbeat is older
        # than this; the failure is RETRYABLE (unlike deadline kills)
        self.stuck_task_interrupt_s = stuck_task_interrupt_s
        # tighter threshold for tasks whose predicted shape classes are
        # all warm (warmup/cache hits or a prior completed run): no
        # first-batch compile stall is possible, so a shorter silence
        # already proves the task is stuck
        self.stuck_task_interrupt_warm_s = stuck_task_interrupt_warm_s
        self.watchdog_interrupts: List[Tuple[str, str]] = []
        self._watchdog_thread: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()

    # -- graceful drain (GracefulShutdownHandler analogue) --
    def shutdown_gracefully(self) -> None:
        """Enter SHUTTING_DOWN: every later create_task is refused (the
        scheduler re-places those partitions); tasks already running
        finish normally and their results/spool stay readable."""
        with self._lock:
            self.state = "shutting_down"

    def running_tasks(self) -> int:
        """Tasks not yet in a terminal state — the drain waiter's
        completion condition (finished/failed/aborted tasks stay
        registered so status and results remain readable)."""
        with self._lock:
            tasks = list(self._tasks.values())
        return sum(
            1 for t in tasks
            if t.state not in ("finished", "failed", "aborted")
        )

    # -- stuck-task watchdog (StuckSplitTasksInterrupter analogue) --
    def watchdog_once(self, now: Optional[float] = None) -> List[str]:
        """One watchdog sweep: interrupt every running task whose batch
        heartbeat is staler than stuck_task_interrupt_s. Returns the
        diagnostics raised this sweep; they also accumulate in
        `watchdog_interrupts` as (task_id, diagnostic) for tests and the
        chaos harness. Explicit-tick twin of start_watchdog, mirroring
        NodeManager.ping_once."""
        if not (self.stuck_task_interrupt_s or self.stuck_task_interrupt_warm_s):
            return []
        with self._lock:
            tasks = list(self._tasks.values())
        fired: List[str] = []
        for t in tasks:
            timeout = self._watchdog_timeout(t)
            if not timeout:
                continue
            diag = t.interrupt_if_stuck(timeout, now=now)
            if diag is not None:
                fired.append(diag)
                self.watchdog_interrupts.append((str(t.spec.task_id), diag))
        return fired

    def _watchdog_timeout(self, task) -> Optional[float]:
        """Per-task threshold: the warm threshold applies only when the
        task's predicted shape classes are ALL warm; otherwise fall back
        to the conservative stuck_task_interrupt_s (which may be unset —
        then warm-only watching still works)."""
        if self.stuck_task_interrupt_warm_s and getattr(
            task, "shapes_warm", False
        ):
            return self.stuck_task_interrupt_warm_s
        return self.stuck_task_interrupt_s

    def start_watchdog(self, poll_s: float = 0.01) -> None:
        if self._watchdog_thread is not None or not (
            self.stuck_task_interrupt_s or self.stuck_task_interrupt_warm_s
        ):
            return
        self._watchdog_stop.clear()

        def loop():
            while not self._watchdog_stop.wait(poll_s):
                self.watchdog_once()

        self._watchdog_thread = threading.Thread(
            target=loop, name=f"watchdog-{self.worker_id}", daemon=True
        )
        self._watchdog_thread.start()

    def stop_watchdog(self) -> None:
        if self._watchdog_thread is None:
            return
        self._watchdog_stop.set()
        self._watchdog_thread.join(5)
        self._watchdog_thread = None

    # -- task lifecycle (SqlTaskManager.updateTask) --
    def create_task(self, spec: TaskSpec) -> TaskExecution:
        key = str(spec.task_id)
        with self._lock:
            if self.state != "active":
                raise WorkerShuttingDownError(
                    f"worker {self.worker_id} is shutting down"
                )
            existing = self._tasks.get(key)
            if existing is not None:
                return existing  # idempotent re-delivery
            task = TaskExecution(
                spec, self.catalogs, self.failure_injector, self.memory_pool,
                device=self.device,
            )
            self._tasks[key] = task
        task.start()
        return task

    def get_task(self, task_id) -> TaskExecution:
        return self._tasks[str(task_id)]

    def task_state(self, task_id) -> dict:
        t = self._tasks[str(task_id)]
        # cpu_s rides along in every status poll so the coordinator's
        # QueryTracker can sum per-task CPU ledgers into the
        # query_max_cpu_time_s budget without an extra endpoint
        out = {"state": t.state, "failure": t.failure,
               "cpu_s": t.cpu_time_s()}
        stats = t.operator_stats()
        if stats is not None:
            out["stats"] = stats
        # TaskInfo observability surface: wall bounds (the reference's
        # lowering counts are the compile tier's, ROADMAP §1 item 13)
        if t.start_time is not None:
            out["start_time"] = t.start_time
        if t.end_time is not None:
            out["end_time"] = t.end_time
        # operator spans ship only once the task is TERMINAL: grafting a
        # still-open span would poison the coordinator's closed tree
        if t.state in ("finished", "failed", "aborted"):
            spans = t.trace_spans()
            if spans is not None:
                out["spans"] = spans
        return out

    def get_results(
        self, task_id, partition: int, token: int,
        max_pages: int = 16, wait: float = 0.0,
    ):
        return self._tasks[str(task_id)].buffer.get_pages(
            partition, token, max_pages, wait
        )

    def remove_task(self, task_id) -> None:
        """Abort the task and join its threads: no task thread outlives
        the removal."""
        with self._lock:
            t = self._tasks.pop(str(task_id), None)
        if t is not None:
            t.abort()
            t.join()

    def abort_query(self, query_id: str) -> None:
        with self._lock:
            doomed = [
                k for k in self._tasks if k.startswith(query_id + ".")
            ]
            tasks = [self._tasks.pop(k) for k in doomed]
        for t in tasks:
            t.abort()
        for t in tasks:
            t.join()

    def fail_query(self, query_id: str, message: str) -> None:
        """Low-memory-killer entry point: mark every task of the query
        FAILED with the kill message (so the coordinator's poll sees a
        query-level memory error, not a vanished task) and abort their
        buffers to unblock consumers. Tasks stay registered until
        remove_task/abort_query — status must remain readable."""
        with self._lock:
            tasks = [
                t for k, t in self._tasks.items()
                if k.startswith(query_id + ".")
            ]
        for t in tasks:
            t.fail(message)

    def task_ids(self) -> List[str]:
        with self._lock:
            return list(self._tasks)

    # -- handle API shared with HttpWorkerClient --
    def results_location(self, task_id):
        """Fetch handle consumers put into TaskSpec.input_locations:
        in-process = the buffer's bound method (zero-copy)."""
        return self._tasks[str(task_id)].buffer.get_pages

    def status(self) -> dict:
        out = {
            "worker_id": self.worker_id,
            "state": self.state,
            "tasks": len(self.task_ids()),
            "running": self.running_tasks(),
        }
        if self.memory_pool is not None:
            # per-query peak watermarks for QueryInfo.peak_memory_bytes
            out["query_peak_bytes"] = self.memory_pool.query_peaks()
        return out


def install_sigterm_self_drain(workers) -> Optional[object]:
    """Route SIGTERM into graceful drain (GracefulShutdownHandler wired
    to the JVM shutdown hook): on the signal every worker in `workers`
    flips to SHUTTING_DOWN — new launches refused, running tasks finish,
    results stay readable — instead of dying mid-task. Returns the
    previous handler (restore it in tests), or None when not on the main
    thread (signal.signal is main-thread-only; embedded runners then
    call shutdown_gracefully directly)."""
    import signal

    workers = list(workers)

    def handler(signum, frame):
        for w in workers:
            w.shutdown_gracefully()

    try:
        return signal.signal(signal.SIGTERM, handler)
    except ValueError:
        return None
