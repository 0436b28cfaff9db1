"""Consumer-side exchange client: concurrent pullers over producer tasks.

Counterpart of trino_tpu/runtime/exchange.py, host code only. Analogue of main/operator/DirectExchangeClient.java:57 +
HttpPageBufferClient.java:99 (SURVEY.md §3.4): one puller per producer
location long-polls pages with an advancing token (each request acks the
previous batch), feeding a memory-bounded shared queue the
RemoteSourceOperator drains. Backpressure: pullers pause while the local
queue is over budget (scheduleRequestIfNecessary's memory gate).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from trino_tpu_torch.exec.serde import Page
from trino_tpu_torch.runtime.metrics import METRICS
from trino_tpu_torch.runtime.error_tracker import (
    REQUEST_STATS,
    RequestErrorTracker,
    RetryPolicy,
)
from trino_tpu_torch.analysis import threadreg
from trino_tpu_torch.analysis.witness import named_condition

# fetch(partition, token, max_pages, wait) -> (pages, next_token, complete)
Fetch = Callable[[int, int, int, float], tuple]


class ExchangeLocation:
    """One producer task's result partition. `destination` labels the
    producer for error tracking (per-destination budgets/stats)."""

    def __init__(self, fetch: Fetch, partition: int,
                 destination: Optional[str] = None):
        self.fetch = fetch
        self.partition = partition
        self.destination = destination or f"exchange:{id(fetch):x}"


class DirectExchangeClient:
    """Pulls pages from every location into one queue. poll() never
    blocks; is_finished() is true once every location completed and the
    queue drained."""

    def __init__(
        self,
        locations: List[ExchangeLocation],
        max_buffered_pages: int = 64,
        long_poll_s: float = 0.5,
        retry_policy: Optional[RetryPolicy] = None,
        retry_seed: Optional[int] = None,
        failure_listener=None,
    ):
        self._locations = list(locations)
        self._retry_policy = retry_policy or RetryPolicy()
        self._retry_seed = retry_seed
        self._failure_listener = failure_listener
        self._queue: List[Page] = []
        self._lock = named_condition("DirectExchangeClient._lock")
        self._open = 0
        self._max_buffered = max_buffered_pages
        self._long_poll_s = long_poll_s
        self._failure: Optional[BaseException] = None
        self._closed = False
        self._threads: List[threading.Thread] = []
        for loc in self._locations:
            t = threadreg.spawn(
                f"exchange-pull-{loc.destination}", self._pull_loop, args=(loc,),
                owner="DirectExchangeClient", start=False,
            )
            self._open += 1
            self._threads.append(t)
        for t in self._threads:
            t.start()

    def _pull_loop(self, loc: ExchangeLocation) -> None:
        # Retrying here is safe because the token only advances on a
        # successful fetch: a replayed request re-reads un-acked pages,
        # so transient fetch loss never drops or duplicates a page. Once
        # the tracker's budget is spent, RequestFailedError surfaces via
        # poll() and the CONSUMING task fails (FTE re-places it).
        token = 0
        tracker = RequestErrorTracker(
            loc.destination, self._retry_policy, seed=self._retry_seed,
            listener=self._failure_listener,
        )
        try:
            while not self._closed:
                with self._lock:
                    while (
                        len(self._queue) >= self._max_buffered
                        and not self._closed
                    ):
                        self._lock.wait(timeout=0.1)
                    if self._closed:
                        return
                t_pull = time.monotonic()
                try:
                    pages, token, complete = loc.fetch(
                        loc.partition, token, 16, self._long_poll_s
                    )
                except BaseException as e:
                    REQUEST_STATS.record(loc.destination, ok=False)
                    tracker.on_failure(e)  # sleeps, or raises when spent
                    continue
                REQUEST_STATS.record(loc.destination, ok=True)
                tracker.on_success()
                if pages:
                    # data pulls only: an empty long-poll round measures
                    # the poll timeout, not exchange latency
                    METRICS.observe(
                        "exchange_page_pull_s", time.monotonic() - t_pull
                    )
                    with self._lock:
                        self._queue.extend(pages)
                        self._lock.notify_all()
                if complete:
                    return
        except BaseException as e:  # surfaced to the driver via poll()
            with self._lock:
                self._failure = e
        finally:
            with self._lock:
                self._open -= 1
                self._lock.notify_all()

    def poll(self) -> Optional[Page]:
        with self._lock:
            if self._failure is not None:
                raise RuntimeError("exchange pull failed") from self._failure
            if self._queue:
                page = self._queue.pop(0)
                self._lock.notify_all()
                return page
            return None

    def is_finished(self) -> bool:
        with self._lock:
            if self._failure is not None:
                raise RuntimeError("exchange pull failed") from self._failure
            return self._open == 0 and not self._queue

    def close(self) -> None:
        self._closed = True
        with self._lock:
            self._lock.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the pull threads (they end once the client is closed
        or every location completed)."""
        for t in self._threads:
            t.join(timeout)
