"""Query tracing: explicit-parent spans, cluster-wide, Perfetto-exportable.

Analogue of the reference's OpenTelemetry integration (TracingMetadata,
ScopedSpan, spans per planning phase in SqlQueryExecution, and the
W3C-traceparent propagation coordinator->worker via TaskResource —
SURVEY.md §5.1), reduced to an in-process recorder with the same tree
shape and propagation discipline:

- NO globals and NO thread-local ambient context: a span is created from
  an explicit parent handle (``parent.child(...)`` or
  ``trace.span(..., parent=...)``), so spans opened on scheduler poll
  threads, FTE retry loops, and worker pipelines land under the right
  parent regardless of which thread touches them.
- Span context crosses the coordinator->worker boundary as plain data
  (``wire_context(span)`` -> dict on ``TaskSpec.trace_ctx``); the worker
  records its operator spans against the remote parent id and ships them
  back flat in task status, where ``QueryTrace.graft`` re-attaches them.
- Export is a flat OTel-style span list (``export()``) plus a Chrome
  trace-event rendering (``chrome_trace``) loadable in Perfetto /
  chrome://tracing; annotations (retry, speculation, drain, deadline,
  watchdog, chaos faults) become instant events on the owning span's
  track so a chaos run reads as one timeline.

Span kinds form the tree contract the invariant checker enforces:
``query`` roots the trace; ``phase`` (parse/analyze/optimize/validate/
fragment/schedule) and ``stage`` spans hang off it; ``task`` spans hang
off stages (one per attempt); ``operator`` spans hang off tasks.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional, Union

from trino_tpu_torch.analysis.witness import named_lock

# span kinds, in tree order (parent kind of each child kind)
KIND_QUERY = "query"
KIND_PHASE = "phase"
KIND_STAGE = "stage"
KIND_TASK = "task"
KIND_OPERATOR = "operator"

_PARENT_KIND = {
    KIND_PHASE: KIND_QUERY,
    KIND_STAGE: KIND_QUERY,
    KIND_TASK: KIND_STAGE,
    KIND_OPERATOR: KIND_TASK,
}


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed node. Created via QueryTrace.span / Span.child only;
    the explicit parent handle IS the propagation mechanism."""

    __slots__ = (
        "name", "kind", "span_id", "trace_id", "parent_id",
        "start_s", "end_s", "attributes", "events", "_trace",
    )

    def __init__(self, trace: "QueryTrace", name: str, kind: str,
                 parent_id: Optional[str], **attributes):
        self.name = name
        self.kind = kind
        self.span_id = _new_id()
        self.trace_id = trace.trace_id
        self.parent_id = parent_id
        self.start_s = time.time()
        self.end_s: Optional[float] = None
        self.attributes: Dict[str, Any] = dict(attributes)
        self.events: List[dict] = []
        self._trace = trace

    def child(self, name: str, kind: str, **attributes) -> "Span":
        return self._trace.span(name, kind, parent=self, **attributes)

    def event(self, name: str, **attributes) -> None:
        """Timestamped annotation on this span (otel addEvent)."""
        self.events.append({
            "ts": time.time(), "name": name,
            "attributes": dict(attributes),
        })

    def set(self, **attributes) -> None:
        self.attributes.update(attributes)

    def end(self, end_s: Optional[float] = None) -> None:
        if self.end_s is None:
            self.end_s = time.time() if end_s is None else end_s

    @property
    def ended(self) -> bool:
        return self.end_s is not None

    @property
    def duration_s(self) -> float:
        return (self.end_s or time.time()) - self.start_s

    # `with parent.child("analyze", KIND_PHASE):` — exceptions annotate
    # the span and it still closes, so no failure path leaks open spans
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and not self.ended:
            self.event("exception", type=type(exc).__name__,
                       message=str(exc)[:500])
            self.attributes.setdefault("error", True)
        self.end()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "span_id": self.span_id,
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "start_s": self.start_s,
            "end_s": self.end_s,
            "duration_ms": round(self.duration_s * 1000, 3),
            "attributes": dict(self.attributes),
            "events": [dict(e) for e in self.events],
        }


def wire_context(span: Span) -> dict:
    """Plain-data span context for TaskSpec (traceparent analogue).
    Strings only, so the wire codec ships it with no schema change."""
    return {"trace_id": span.trace_id, "span_id": span.span_id}


class QueryTrace:
    """All spans of one query. Coordinator-side it holds the full tree;
    worker-side (``QueryTrace.remote``) it holds only the spans recorded
    in that process, parented on the remote context, for export back."""

    def __init__(self, query_id: str, trace_id: Optional[str] = None):
        self.query_id = query_id
        self.trace_id = trace_id or _new_id()
        self._lock = named_lock("QueryTrace._lock")
        self._spans: List[Span] = []
        self._grafted: List[dict] = []

    @classmethod
    def remote(cls, ctx: dict, query_id: str = "") -> "QueryTrace":
        """Worker-side recorder attached to a coordinator's context."""
        return cls(query_id, trace_id=ctx.get("trace_id"))

    def span(self, name: str, kind: str,
             parent: Union[Span, str, None] = None, **attributes) -> Span:
        pid = parent.span_id if isinstance(parent, Span) else parent
        s = Span(self, name, kind, pid, **attributes)
        with self._lock:
            self._spans.append(s)
        return s

    def graft(self, span_dicts: List[dict]) -> int:
        """Attach already-exported foreign spans (a worker's operator
        spans) into this trace. They carry their own parent ids — the
        coordinator handed those ids out via wire_context, so the tree
        closes. Duplicate span_ids (a task polled twice) are dropped."""
        with self._lock:
            seen = {s.span_id for s in self._spans}
            seen.update(d.get("span_id") for d in self._grafted)
            added = 0
            for d in span_dicts or []:
                if d.get("span_id") in seen:
                    continue
                seen.add(d.get("span_id"))
                d = dict(d)
                d["trace_id"] = self.trace_id
                self._grafted.append(d)
                added += 1
            return added

    def end_open_spans(self, end_s: Optional[float] = None) -> int:
        """Close every still-open span (abnormal-completion sweep so a
        failed/killed query still exports a fully-closed tree). Grafted
        worker spans are swept too: a task killed mid-stall ships its
        spans before its driver thread's own finally can close them."""
        n = 0
        stamp = time.time() if end_s is None else end_s
        with self._lock:
            spans = list(self._spans)
            for d in self._grafted:
                if d.get("end_s") is None:
                    d["end_s"] = max(stamp, d.get("start_s") or stamp)
                    d["duration_ms"] = round(
                        (d["end_s"] - (d.get("start_s") or d["end_s"]))
                        * 1000, 3,
                    )
                    n += 1
        for s in spans:
            if not s.ended:
                s.end(end_s)
                n += 1
        return n

    def export(self) -> dict:
        with self._lock:
            dicts = [s.to_dict() for s in self._spans]
            dicts += [dict(d) for d in self._grafted]
        dicts.sort(key=lambda d: (d.get("start_s") or 0.0))
        return {
            "trace_id": self.trace_id,
            "query_id": self.query_id,
            "spans": dicts,
        }


# -- exports ------------------------------------------------------------


def chrome_trace(export: dict) -> List[dict]:
    """Render a QueryTrace.export() as Chrome trace-event JSON (the
    `traceEvents` list — load in Perfetto or chrome://tracing).

    Complete events (ph "X") carry each span; span annotations become
    instant events (ph "i") on the same track. Track (tid) assignment
    keeps the rendering readable: coordinator work (query + phases) on
    tid 0, each stage on its own track, each task attempt (plus its
    operator spans) on its own track — parallel attempts never overlap
    on one row, which "X" nesting cannot express."""
    spans = export.get("spans", [])
    if not spans:
        return []
    t0 = min(s.get("start_s") or 0.0 for s in spans)
    by_id = {s["span_id"]: s for s in spans}
    tids: Dict[str, int] = {}
    names: Dict[int, str] = {0: "coordinator"}
    next_tid = [1]

    def tid_of(span: dict) -> int:
        sid = span["span_id"]
        if sid in tids:
            return tids[sid]
        if span.get("kind") in (KIND_STAGE, KIND_TASK):
            t = next_tid[0]
            next_tid[0] += 1
            names[t] = span.get("name", span.get("kind"))
        else:
            parent = by_id.get(span.get("parent_id") or "")
            t = tid_of(parent) if parent is not None else 0
        tids[sid] = t
        return t

    events: List[dict] = []
    for s in spans:
        tid = tid_of(s)
        start = s.get("start_s") or t0
        end = s.get("end_s") or start
        events.append({
            "name": s.get("name", "?"),
            "cat": s.get("kind", "span"),
            "ph": "X",
            "ts": round((start - t0) * 1e6, 1),
            "dur": round(max(0.0, end - start) * 1e6, 1),
            "pid": 1,
            "tid": tid,
            "args": dict(s.get("attributes") or {},
                         span_id=s["span_id"]),
        })
        for ev in s.get("events") or []:
            events.append({
                "name": ev.get("name", "event"),
                "cat": "annotation",
                "ph": "i",
                "s": "t",
                "ts": round(((ev.get("ts") or start) - t0) * 1e6, 1),
                "pid": 1,
                "tid": tid,
                "args": dict(ev.get("attributes") or {}),
            })
    meta = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
         "args": {"name": n}}
        for t, n in sorted(names.items())
    ]
    return meta + events


def check_span_invariants(export: dict) -> List[str]:
    """Structural invariants on an exported trace; returns violations
    (empty == healthy). Enforced by tests and `bench.py --trace-smoke`:

    - exactly one root, and it is the query span
    - every non-root parent_id resolves to a span in the trace
    - kind hierarchy holds: phase/stage under query, task under stage,
      operator under task
    - no span is left open (end_s set, end >= start)
    """
    spans = export.get("spans", [])
    violations: List[str] = []
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if not s.get("parent_id")]
    if len(roots) != 1:
        violations.append(
            f"expected exactly 1 root span, found {len(roots)}: "
            f"{[r.get('name') for r in roots]}"
        )
    for r in roots:
        if r.get("kind") != KIND_QUERY:
            violations.append(
                f"root span {r.get('name')!r} has kind "
                f"{r.get('kind')!r}, expected {KIND_QUERY!r}"
            )
    for s in spans:
        label = f"{s.get('kind')}:{s.get('name')}({s['span_id']})"
        pid = s.get("parent_id")
        parent = by_id.get(pid) if pid else None
        if pid and parent is None:
            violations.append(f"orphan span {label}: parent {pid} "
                              f"not in trace")
        want = _PARENT_KIND.get(s.get("kind"))
        if want is not None and parent is not None \
                and parent.get("kind") != want:
            violations.append(
                f"span {label} parented on kind "
                f"{parent.get('kind')!r}, expected {want!r}"
            )
        if s.get("end_s") is None:
            violations.append(f"unclosed span {label}")
        elif s.get("start_s") is not None \
                and s["end_s"] < s["start_s"] - 1e-6:
            violations.append(f"span {label} ends before it starts")
    return violations
