"""Event listener SPI.

Analogue of spi/eventlistener/EventListener.java:16 (queryCreated /
queryCompleted / splitCompleted; plugins like trino-http-event-listener
— SURVEY.md §5.5). Listeners are registered on the engine/coordinator;
failures in listeners never fail queries (dispatch swallows + records)."""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class QueryCreatedEvent:
    query_id: str
    sql: str
    create_time: float


@dataclasses.dataclass
class QueryCompletedEvent:
    """Completion record (QueryCompletedEvent.java's QueryStatistics/
    QueryFailureInfo payload, flattened). The resource fields default to
    zero so cheap paths can fire a minimal event; the coordinator and
    engine fill them from the final QueryInfo."""

    query_id: str
    sql: str
    state: str  # finished | failed
    wall_s: float
    rows: int = 0
    failure: Optional[str] = None
    # -- QueryStatistics analogue --
    peak_memory_bytes: int = 0
    rows_scanned: int = 0
    bytes_scanned: int = 0
    rows_shuffled: int = 0
    compile_count: int = 0
    cpu_s: float = 0.0
    # -- QueryFailureInfo / retry accounting --
    error_code: Optional[str] = None  # EXCEEDED_*_LIMIT etc.
    retry_count: int = 0   # query-level resubmissions
    attempt_count: int = 1  # task attempts launched (FTE), else 1


@dataclasses.dataclass
class SplitCompletedEvent:
    query_id: str
    task_id: str
    wall_s: float


class EventListener:
    """Subclass and override; unimplemented events are ignored."""

    def query_created(self, event: QueryCreatedEvent) -> None:
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:
        pass

    def split_completed(self, event: SplitCompletedEvent) -> None:
        pass


class JsonlEventListener(EventListener):
    """Append one JSON line per completed query to `path` — the
    http-event-listener analogue with a file sink instead of a POST.
    Line schema is the QueryCompletedEvent field set plus `event` and
    `emit_time`; writes are locked so concurrent completions from the
    server's submit threads never interleave."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()  # JsonlEventListener._lock

    def query_completed(self, event: QueryCompletedEvent) -> None:
        record: Dict[str, Any] = {"event": "query_completed",
                                  "emit_time": time.time()}
        record.update(dataclasses.asdict(event))
        line = json.dumps(record, default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class EventListenerManager:
    def __init__(self):
        self._listeners: List[EventListener] = []
        self.dispatch_failures = 0

    def add(self, listener: EventListener) -> None:
        self._listeners.append(listener)

    def register_metrics(
        self, name: str = "event_listener_dispatch_failures"
    ) -> None:
        """Expose dispatch_failures as a gauge on the process metrics
        registry (swallowed listener exceptions are otherwise
        invisible)."""
        from trino_tpu_torch.runtime.metrics import METRICS

        METRICS.register_gauge(name, lambda: self.dispatch_failures)

    def _fire(self, method: str, event) -> None:
        for lst in self._listeners:
            try:
                getattr(lst, method)(event)
            except Exception:
                self.dispatch_failures += 1

    def query_created(self, event: QueryCreatedEvent) -> None:
        self._fire("query_created", event)

    def query_completed(self, event: QueryCompletedEvent) -> None:
        self._fire("query_completed", event)

    def split_completed(self, event: SplitCompletedEvent) -> None:
        self._fire("split_completed", event)
