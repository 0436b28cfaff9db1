"""Task output buffers with token-based pull+ack semantics.

Counterpart of trino_tpu/runtime/buffers.py, host code only: pages are
host arrays (exec/serde.Page), so a buffer never holds device memory.
Analogue of main/execution/buffer/OutputBuffer.java:24 and TaskResource's
results protocol (GET /v1/task/{id}/results/{buffer}/{token} :321,
acknowledge :364 — SURVEY.md §3.4): the consumer pulls pages starting at
a token; requesting token T acknowledges everything below T (at-least-
once delivery with resume). Producer-side backpressure: enqueue blocks
once buffered bytes exceed the limit until consumers drain
(OutputBufferMemoryManager's blocked future, collapsed to a wait).
"""

from __future__ import annotations

import threading
from typing import List, Tuple

from trino_tpu_torch.exec.serde import Page


class OutputBuffer:
    """Per-task producer buffer, one logical queue per output partition."""

    def __init__(self, n_partitions: int, max_bytes: int = 128 << 20):
        self._n = n_partitions
        self._max_bytes = max_bytes
        self._lock = threading.Condition()  # OutputBuffer._lock
        # per partition: pages kept from first_token onward
        self._pages: List[List[Page]] = [[] for _ in range(n_partitions)]
        self._first_token: List[int] = [0] * n_partitions
        self._bytes = 0
        self._no_more = False
        self._aborted = False

    @property
    def n_partitions(self) -> int:
        return self._n

    # -- producer side --
    def enqueue(self, partition: int, page: Page) -> None:
        with self._lock:
            while (
                self._bytes >= self._max_bytes
                and not self._aborted
            ):
                self._lock.wait(timeout=0.1)
            if self._aborted:
                return
            self._pages[partition].append(page)
            self._bytes += page.size_bytes()
            self._lock.notify_all()

    def set_no_more_pages(self) -> None:
        with self._lock:
            self._no_more = True
            self._lock.notify_all()

    def abort(self) -> None:
        """Tear down (query failure/cancel): unblock producers, drop data."""
        with self._lock:
            self._aborted = True
            self._pages = [[] for _ in range(self._n)]
            self._bytes = 0
            self._lock.notify_all()

    # -- consumer side (the /results/{partition}/{token} protocol) --
    def get_pages(
        self,
        partition: int,
        token: int,
        max_pages: int = 16,
        wait: float = 0.0,
    ) -> Tuple[List[Page], int, bool]:
        """Pages starting at `token`; requesting token T acks (drops)
        every page below T. Returns (pages, next_token, complete).
        `wait` > 0 long-polls until data/finish/timeout."""
        deadline = None
        with self._lock:
            while True:
                if self._aborted:
                    # consumers must fail fast, not drain silence
                    raise RuntimeError("output buffer aborted (task failed)")
                q = self._pages[partition]
                first = self._first_token[partition]
                if token < first:
                    # below the acked watermark: the data is gone; spinning
                    # would hang the consumer (Trino's results protocol
                    # rejects rewinds past the acknowledged token)
                    raise RuntimeError(
                        f"token {token} below acknowledged watermark {first}"
                    )
                # ack: drop pages below the requested token
                if token > first:
                    drop = min(token - first, len(q))
                    for pg in q[:drop]:
                        self._bytes -= pg.size_bytes()
                    del q[:drop]
                    self._first_token[partition] = first = first + drop
                    self._lock.notify_all()
                start = token - first
                available = q[start : start + max_pages] if start >= 0 else []
                end_token = first + len(q)
                complete = self._no_more and token >= end_token
                if available or complete or wait <= 0:
                    return list(available), token + len(available), complete
                import time

                if deadline is None:
                    deadline = time.monotonic() + wait
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], token, False
                self._lock.wait(timeout=remaining)

    def is_fully_consumed(self) -> bool:
        with self._lock:
            return self._no_more and all(not q for q in self._pages)
