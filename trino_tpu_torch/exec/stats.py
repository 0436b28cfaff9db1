"""Operator statistics and their EXPLAIN ANALYZE rendering.

Counterpart of trino_tpu/exec/stats.py (OperatorStats/OperationTimer:
per-operator calls, batches, rows and wall time, recorded on every
add_input/get_output/finish). Two timing modes:

- default: wall time measures host dispatch; CUDA runs asynchronously,
  so device time surfaces at the host-sync points;
- device_sync (EXPLAIN ANALYZE): `torch.cuda.synchronize` closes every
  timed section on a CUDA device, so each operator's wall includes the
  device time of the work it launched (a no-op on the CPU).

Two hooks ride the recording path, as in the reference: `heartbeat`
(zero-arg callable) fires at entry and exit of every add_input/
get_output/finish (a distributed task's watchdog freshness), and `span`
(runtime/tracing.py) is anchored at the operator's first activity and
ended by `close_span` with the final stats attached. EXPLAIN ANALYZE's
"Engine counters:" line reads the METRICS deltas of ENGINE_COUNTERS.

Left out: the shape ledger that EXPLAIN ANALYZE's census reads and the
`xla_compiles` engine counter; both count XLA programs (ROADMAP §1 item
13).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List

import torch


@dataclasses.dataclass
class OperatorStats:
    operator: str = ""
    add_input_calls: int = 0
    get_output_calls: int = 0
    input_batches: int = 0
    output_batches: int = 0
    input_rows: int = 0
    output_rows: int = 0
    add_input_s: float = 0.0
    get_output_s: float = 0.0
    finish_s: float = 0.0
    # True when the timings above close with a device barrier
    device_synced: bool = False

    @property
    def total_s(self) -> float:
        return self.add_input_s + self.get_output_s + self.finish_s

    def line(self) -> str:
        return (
            f"{self.operator}: in={self.input_rows} rows/"
            f"{self.input_batches} batches, out={self.output_rows} rows/"
            f"{self.output_batches} batches, "
            f"wall={self.total_s * 1000:.1f}ms "
            f"(add={self.add_input_s * 1000:.1f} "
            f"get={self.get_output_s * 1000:.1f} "
            f"finish={self.finish_s * 1000:.1f})"
        )


def _device_barrier(device) -> None:
    """Block until every kernel launched on `device` has finished; the
    CPU runs eagerly, so nothing is waited for there."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class InstrumentedOperator:
    """Transparent timing wrapper around one operator (the
    OperationTimer discipline without touching operator code)."""

    def __init__(self, inner, stats: OperatorStats, count_rows: bool,
                 device_sync: bool = False, device=None, heartbeat=None,
                 span=None):
        self.inner = inner
        self._heartbeat = heartbeat
        self._span = span
        self._span_anchored = False
        self.stats = stats
        self.stats.operator = type(inner).__name__
        self.stats.device_synced = device_sync
        self._count_rows = count_rows
        self._device_sync = device_sync
        self._device = device
        # deferred row counts: a masked batch enqueues a device-side sum
        # instead of a host sync per batch; flush_counts() resolves them
        self._pending_counts: list = []
        self._pending_lock = threading.Lock()  # InstrumentedOperator._pending_lock

    def _barrier(self) -> None:
        if self._device_sync:
            _device_barrier(self._device)

    def _beat(self) -> None:
        if self._heartbeat is not None:
            self._heartbeat()
        if self._span is not None and not self._span_anchored:
            # span start = first activity, not wrap time: operators deep
            # in a pipeline idle until data reaches them
            self._span_anchored = True
            self._span.start_s = time.time()

    def _count(self, attr: str, batch) -> None:
        live = getattr(batch, "live", None)
        if live is None:
            setattr(self.stats, attr, getattr(self.stats, attr) + batch.capacity)
            return
        with self._pending_lock:
            self._pending_counts.append((attr, torch.sum(live)))

    def flush_counts(self) -> None:
        """Resolve deferred row counts into the stats."""
        with self._pending_lock:
            pending, self._pending_counts = self._pending_counts, []
        for attr, v in pending:
            setattr(self.stats, attr, getattr(self.stats, attr) + int(v))

    def close_span(self) -> None:
        """Flush the deferred row counts, then end the operator span
        with the final stats attached (called by the task when its
        pipelines complete)."""
        self.flush_counts()
        if self._span is None:
            return
        self._span.set(**{
            k: v for k, v in dataclasses.asdict(self.stats).items()
            if k != "operator"
        })
        self._span.end()

    def needs_input(self) -> bool:
        return self.inner.needs_input()

    def add_input(self, batch) -> None:
        self._beat()
        t0 = time.monotonic()
        self.inner.add_input(batch)
        self._barrier()
        self.stats.add_input_s += time.monotonic() - t0
        self.stats.add_input_calls += 1
        self.stats.input_batches += 1
        if self._count_rows:
            self._count("input_rows", batch)
        self._beat()

    def get_output(self):
        self._beat()
        t0 = time.monotonic()
        out = self.inner.get_output()
        if out is not None:
            # a None poll launched nothing: no barrier for it
            self._barrier()
        self.stats.get_output_s += time.monotonic() - t0
        self.stats.get_output_calls += 1
        if out is not None:
            self.stats.output_batches += 1
            if self._count_rows:
                self._count("output_rows", out)
            self._beat()
        return out

    def finish(self) -> None:
        self._beat()
        t0 = time.monotonic()
        self.inner.finish()
        self._barrier()
        self.stats.finish_s += time.monotonic() - t0
        self._beat()

    def is_finished(self) -> bool:
        return self.inner.is_finished()

    def is_blocked(self) -> bool:
        return self.inner.is_blocked()

    def __getattr__(self, name):
        # the operator's own surface (e.g. CollectorSink.rows)
        return getattr(self.inner, name)


def instrument(operators, count_rows: bool = True, device_sync: bool = False,
               device=None, heartbeat=None, span_factory=None):
    """Wrap a pipeline's operators; returns (wrapped, [OperatorStats]).
    `device_sync=True` closes every timed section with a barrier on
    `device` (EXPLAIN ANALYZE's device-inclusive attribution);
    `heartbeat` is beaten around every call; `span_factory(operator
    name) -> Span` opens one trace span per operator."""
    stats = [OperatorStats() for _ in operators]
    wrapped = [
        InstrumentedOperator(
            op, st, count_rows, device_sync, device, heartbeat=heartbeat,
            span=(span_factory(type(op).__name__)
                  if span_factory is not None else None),
        )
        for op, st in zip(operators, stats)
    ]
    return wrapped, stats


ENGINE_COUNTERS = (
    "rows_scanned",
    "bytes_scanned",
    "rows_shuffled",
    "exchanges_elided",
)


def engine_counters_delta(before: dict, after: dict) -> dict:
    """Per-query view of the METRICS singleton's cumulative engine
    counters: snapshot() before and after the run, subtract."""
    return {
        k: after.get(k, 0.0) - before.get(k, 0.0) for k in ENGINE_COUNTERS
    }


def render_stats(groups: List[List[OperatorStats]], counters=None) -> str:
    lines = []
    if any(st.device_synced for g in groups for st in g):
        lines.append(
            "Timings are DEVICE-INCLUSIVE (each operator section "
            "closed by a device barrier; async pipelining disabled "
            "for attribution)"
        )
    for i, group in enumerate(groups):
        lines.append(f"Pipeline {i}:")
        for st in group:
            lines.append("  " + st.line())
    if counters is not None:
        lines.append(
            "Engine counters: "
            + " ".join(f"{k}={counters.get(k, 0.0):.0f}" for k in ENGINE_COUNTERS)
        )
    return "\n".join(lines)
