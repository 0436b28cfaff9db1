"""Failure injection for fault-tolerance tests.

Analogue of main/execution/FailureInjector.java:40 (injected per
(stage, partition, attempt); types incl. TASK_FAILURE and request
failures — SURVEY.md §5.3, BaseFailureRecoveryTest.java:53). The
injector lives on the Worker; TaskExecution consults it at task start
("start"), after the first output page ("mid"), and per exchange page
pull ("fetch") so retries exercise the nothing-produced, partially-
produced, and lost-fetch paths. Rules carry a failure KIND so the chaos
harness (runtime/chaos.py) can map fault classes onto the error surface
each one exercises: a crash is a generic task failure, fetch loss is a
transient network error the retry layer absorbs, an OOM is a memory-
classed failure that grows the partition memory estimate on retry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.analysis.witness import named_lock


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureRule:
    fragment_id: Optional[int] = None  # None = any
    partition: Optional[int] = None
    attempts: Tuple[int, ...] = (0,)  # which attempt numbers fail
    # "start" | "mid" | "fetch" | "batch" — "batch" fires at a driver
    # batch boundary (TaskExecution._on_batch), where a stall models a
    # HUNG OPERATOR the stuck-task watchdog must interrupt
    where: str = "start"
    max_hits: int = 1_000_000
    # straggler simulation: sleep this long instead of raising
    # (drives the speculative-execution path in tests)
    stall_s: float = 0.0
    # failure surface: "crash" raises InjectedFailure (task failure),
    # "fetch_loss" raises ConnectionError (transient, absorbed by the
    # exchange retry loop), "oom" raises ExceededMemoryLimitError
    # (memory-classed: the FTE estimator doubles before the retry)
    kind: str = "crash"

    def raise_failure(self, task_id, where: str) -> None:
        if self.kind == "fetch_loss":
            raise ConnectionError(
                f"injected fetch loss at {task_id}"
            )
        if self.kind == "oom":
            from trino_tpu_torch.runtime.memory import ExceededMemoryLimitError

            raise ExceededMemoryLimitError(
                f"injected out-of-memory at {task_id}"
            )
        raise InjectedFailure(f"injected {where} failure at {task_id}")


class FailureInjector:
    def __init__(self):
        self._rules: List[FailureRule] = []
        self._hits: Dict[int, int] = {}
        self._lock = named_lock("FailureInjector._lock")

    def inject(self, **kw) -> FailureRule:
        rule = FailureRule(**kw)
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()
            self._hits.clear()

    def check(self, task_id, where: str, abort=None) -> None:
        """Raise InjectedFailure if a rule matches (task_id carries
        fragment/partition/attempt). A matching STALL sleeps in small
        chunks polling `abort` (zero-arg callable): a stalled task the
        watchdog already failed wakes promptly instead of pinning its
        thread for the full stall."""
        with self._lock:
            for i, r in enumerate(self._rules):
                if r.where != where:
                    continue
                if r.fragment_id is not None and r.fragment_id != task_id.fragment_id:
                    continue
                if r.partition is not None and r.partition != task_id.partition:
                    continue
                if getattr(task_id, "attempt", 0) not in r.attempts:
                    continue
                if self._hits.get(i, 0) >= r.max_hits:
                    continue
                self._hits[i] = self._hits.get(i, 0) + 1
                if r.stall_s > 0:
                    stall = r.stall_s
                    break  # sleep outside the lock
                r.raise_failure(task_id, where)
            else:
                return
        import time

        deadline = time.monotonic() + stall
        while True:
            if abort is not None and abort():
                return
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(0.01, left))
