"""Intra-task local exchange.

Counterpart of trino_tpu/exec/local_exchange.py (LocalExchange with its
sink and source operators): a bounded in-memory crossing between
pipelines of one task, each driven on its own thread, so host work
(page decoding, spill reads) on one thread overlaps the device pipeline
on another. Modes: "arbitrary" (the least-loaded consumer queue takes
the next batch), "broadcast" (every consumer sees every batch),
"round_robin" (strict rotation). A producer blocks while the queue it
would grow is full (back pressure); a failed producer latches its error
so consumers raise instead of reading a truncated stream as its end.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

from trino_tpu_torch.exec.operators import Operator


class LocalExchange:
    """One exchange between producer and consumer pipelines of a task:
    a queue per consumer, at most `max_buffered_batches` in the queue a
    put would grow."""

    def __init__(
        self,
        n_consumers: int = 1,
        mode: str = "arbitrary",
        max_buffered_batches: int = 4,
    ):
        if mode not in ("arbitrary", "broadcast", "round_robin"):
            raise ValueError(f"unknown local exchange mode {mode!r}")
        self.mode = mode
        self._queues: List[deque] = [deque() for _ in range(n_consumers)]
        self._lock = threading.Lock()  # LocalExchange._lock
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._max = max_buffered_batches
        self._producers = 0
        self._producers_done = False
        self._aborted = False
        self._error: Optional[BaseException] = None
        self._rr = 0

    def abort(self) -> None:
        """Tear down (consumer failed): drop buffered batches, unblock
        producers (put becomes a no-op), finish consumers."""
        with self._lock:
            self._aborted = True
            self._producers_done = True
            for q in self._queues:
                q.clear()
            self._not_full.notify_all()
            self._not_empty.notify_all()

    # -- producer side --
    def add_producer(self) -> None:
        with self._lock:
            self._producers += 1

    def producer_finished(self) -> None:
        with self._lock:
            self._producers -= 1
            if self._producers <= 0:
                self._producers_done = True
                self._not_empty.notify_all()

    def producer_failed(self, error: BaseException) -> None:
        """A producer pipeline died mid-stream: latch its error so
        consumers RAISE instead of reading the truncated stream as a
        clean end-of-input. Without the latch, a killed upstream lets
        the consumer half finish the task's sink normally and the task
        publishes an empty 'complete' result — a wrong answer, not a
        failure."""
        with self._lock:
            if self._error is None:
                self._error = error
            self._producers_done = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def put(self, batch) -> None:
        with self._not_full:
            # the gate must watch the queue(s) this put will grow:
            # broadcast appends to EVERY queue (bound = fullest);
            # round_robin appends to a specific queue (bound = that one);
            # arbitrary appends to the shortest (bound = min). Gating
            # everything on min would let a slow consumer's queue grow
            # without limit while a fast consumer keeps the min small.
            def _level() -> int:
                if self.mode == "broadcast":
                    return max(len(q) for q in self._queues)
                if self.mode == "round_robin":
                    return len(self._queues[self._rr % len(self._queues)])
                return min(len(q) for q in self._queues)

            while not self._aborted and _level() >= self._max:
                self._not_full.wait(0.1)
            if self._aborted:
                return
            if self.mode == "broadcast":
                for q in self._queues:
                    q.append(batch)
            elif self.mode == "round_robin":
                self._queues[self._rr % len(self._queues)].append(batch)
                self._rr += 1
            else:  # arbitrary: least-loaded queue (local skew rebalance)
                target = min(
                    range(len(self._queues)), key=lambda i: len(self._queues[i])
                )
                self._queues[target].append(batch)
            self._not_empty.notify_all()

    # -- consumer side --
    def get(self, consumer: int, timeout: float = 0.1):
        """(batch | None, done). done=True only when producers finished
        AND this consumer's queue drained."""
        with self._not_empty:
            if self._error is not None:
                raise RuntimeError(
                    "local exchange producer failed"
                ) from self._error
            q = self._queues[consumer]
            if not q and not self._producers_done:
                self._not_empty.wait(timeout)
            if self._error is not None:
                raise RuntimeError(
                    "local exchange producer failed"
                ) from self._error
            if q:
                batch = q.popleft()
                self._not_full.notify_all()
                return batch, False
            return None, self._producers_done


class LocalExchangeSinkOperator(Operator):
    """Terminal operator of a producer pipeline: pushes into the
    exchange (LocalExchangeSinkOperator.java)."""

    def __init__(self, exchange: LocalExchange):
        self._ex = exchange
        self._finished = False
        exchange.add_producer()

    def needs_input(self) -> bool:
        return not self._finished

    def add_input(self, batch) -> None:
        self._ex.put(batch)

    def get_output(self):
        return None

    def finish(self) -> None:
        if not self._finished:
            self._finished = True
            self._ex.producer_finished()

    def is_finished(self) -> bool:
        return self._finished

    def is_blocked(self) -> bool:
        return False


class LocalExchangeSourceOperator(Operator):
    """Leaf operator of a consumer pipeline: pulls from the exchange
    (LocalExchangeSourceOperator.java)."""

    def __init__(self, exchange: LocalExchange, consumer: int = 0):
        self._ex = exchange
        self._consumer = consumer
        self._done = False
        self._pending = None

    def needs_input(self) -> bool:
        return False

    def add_input(self, batch) -> None:
        raise RuntimeError("source operator takes no input")

    def get_output(self):
        if self._pending is not None:
            out, self._pending = self._pending, None
            return out
        if self._done:
            return None
        batch, done = self._ex.get(self._consumer, timeout=0.05)
        if done:
            self._done = True
        return batch

    def finish(self) -> None:
        pass

    def is_finished(self) -> bool:
        return self._done and self._pending is None

    def is_blocked(self) -> bool:
        # blocked while waiting for producers (lets the Driver yield)
        if self._done or self._pending is not None:
            return False
        batch, done = self._ex.get(self._consumer, timeout=0.0)
        if done:
            self._done = True
            return False
        if batch is not None:
            self._pending = batch
            return False
        return True
