"""Request error tracking: bounded exponential backoff for inter-node calls.

Analogue of main/server/remotetask/RequestErrorTracker.java (SURVEY.md
§5.3): every coordinator->worker and worker->worker request retries
transient failures with exponential backoff + jitter, accumulates the
failures it saw, and — once a per-destination error budget or the hard
deadline is spent — fails the REQUEST with the full failure history
attached. The caller (remote-task client, exchange puller) then fails
the TASK, never the whole query: FTE re-placement and query-retry
policies decide what happens next.

Determinism: jitter draws from a per-tracker `random.Random` seeded from
the destination string unless an explicit seed is given, so the chaos
harness (runtime/chaos.py) replays identical backoff schedules for a
fixed seed.
"""

from __future__ import annotations

import dataclasses
import random
import time
import urllib.error
from typing import Callable, List, Optional

from trino_tpu_torch.analysis.witness import named_lock


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs for one class of inter-node request (config surface
    documented in README "Fault tolerance")."""

    # hard deadline: total seconds of accumulated failure before the
    # request is declared dead (query.remote-task.max-error-duration)
    max_error_duration_s: float = 30.0
    # error budget: max failures per destination per request loop
    # (0 = unbounded within the deadline)
    max_errors: int = 0
    min_backoff_s: float = 0.01
    max_backoff_s: float = 1.0
    backoff_factor: float = 2.0
    # each sleep is scaled by a uniform draw from [1-jitter, 1+jitter]
    jitter: float = 0.25


# a fast-test policy the in-process topologies use; HTTP clients default
# to the production-shaped one above
FAST_RETRY = RetryPolicy(
    max_error_duration_s=5.0, min_backoff_s=0.005, max_backoff_s=0.1
)


class RequestFailedError(RuntimeError):
    """Raised when a request's error budget/deadline is exhausted. The
    receiving scheduler fails the task (and re-places it), not the
    query."""

    def __init__(self, destination: str, failures: List[BaseException]):
        self.destination = destination
        self.failures = list(failures)
        summary = "; ".join(
            f"{type(e).__name__}: {e}" for e in self.failures[-3:]
        )
        super().__init__(
            f"request to {destination} failed after "
            f"{len(self.failures)} attempts: {summary}"
        )


def is_transient(exc: BaseException) -> bool:
    """Retryable failure classification: network-level errors and
    service-unavailable responses retry. Plain 500s carry engine
    application errors (a failed plan re-fails identically) and 4xx are
    protocol errors — retrying fixes neither."""
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in (429, 502, 503, 504)
    return isinstance(
        exc, (urllib.error.URLError, ConnectionError, OSError, TimeoutError)
    )


class RequestErrorTracker:
    """Per-request retry loop state for one destination.

    Usage::

        tracker = RequestErrorTracker("http://w1", policy)
        while True:
            try:
                resp = do_request()
                tracker.on_success()
                return resp
            except Exception as e:
                tracker.on_failure(e)   # sleeps, or raises
                                        # RequestFailedError when spent
    """

    def __init__(
        self,
        destination: str,
        policy: Optional[RetryPolicy] = None,
        seed: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        listener=None,
    ):
        self.destination = destination
        self.policy = policy or RetryPolicy()
        self._rng = random.Random(
            seed if seed is not None else hash(destination) & 0xFFFFFFFF
        )
        self._clock = clock
        self._sleep = sleep
        self._listener = listener  # e.g. a NodeManager breaker hook
        self.failures: List[BaseException] = []
        self._started: Optional[float] = None
        self._attempt = 0

    def backoff_s(self) -> float:
        p = self.policy
        base = min(
            p.max_backoff_s,
            p.min_backoff_s * (p.backoff_factor ** max(self._attempt - 1, 0)),
        )
        if p.jitter <= 0:
            return base
        return base * self._rng.uniform(1 - p.jitter, 1 + p.jitter)

    def on_success(self) -> None:
        self.failures.clear()
        self._started = None
        self._attempt = 0
        if self._listener is not None:
            self._listener.report_success(self.destination)

    def on_failure(self, exc: BaseException) -> None:
        """Record a failure; either sleep the next backoff or raise
        RequestFailedError once the budget/deadline is spent. Protocol
        (non-transient) errors propagate immediately."""
        if self._listener is not None:
            self._listener.report_failure(self.destination)
        if not is_transient(exc):
            raise exc
        now = self._clock()
        if self._started is None:
            self._started = now
        self.failures.append(exc)
        self._attempt += 1
        p = self.policy
        spent_budget = p.max_errors and len(self.failures) >= p.max_errors
        spent_time = now - self._started >= p.max_error_duration_s
        if spent_budget or spent_time:
            raise RequestFailedError(self.destination, self.failures) from exc
        self._sleep(self.backoff_s())


class DestinationErrorStats:
    """Cluster-wide per-destination error counters (observability: the
    /v1/cluster surface and the chaos harness read these to assert
    bounded attempt counts)."""

    def __init__(self):
        self._lock = named_lock("DestinationErrorStats._lock")
        self._errors: dict = {}
        self._requests: dict = {}

    def record(self, destination: str, ok: bool) -> None:
        with self._lock:
            self._requests[destination] = self._requests.get(destination, 0) + 1
            if not ok:
                self._errors[destination] = self._errors.get(destination, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                d: {"requests": self._requests.get(d, 0),
                    "errors": self._errors.get(d, 0)}
                for d in self._requests
            }


#: process-wide stats instance the HTTP client and exchange pullers feed
REQUEST_STATS = DestinationErrorStats()


def run_with_retry(
    destination: str,
    fn: Callable[[], object],
    policy: Optional[RetryPolicy] = None,
    seed: Optional[int] = None,
    listener=None,
):
    """The standard retry loop: call `fn` until success, transient
    failures backing off per `policy`; raises RequestFailedError when
    the budget/deadline is spent, or the original error when it is not
    retryable."""
    tracker = RequestErrorTracker(
        destination, policy, seed=seed, listener=listener
    )
    while True:
        try:
            out = fn()
        except BaseException as e:
            REQUEST_STATS.record(destination, ok=False)
            tracker.on_failure(e)
            continue
        REQUEST_STATS.record(destination, ok=True)
        tracker.on_success()
        return out
