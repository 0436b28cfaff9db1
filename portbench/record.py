"""What one run recorded, as the metric readers see it."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from portbench.trace import DeviceTrace


@dataclasses.dataclass
class Statement:
    stream: int
    id: str
    t0: float  # monotonic, sent
    t1: float  # monotonic, last row received
    rows: Optional[list]
    error: Optional[str]

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class RunRecord:
    start: float  # monotonic, window open
    end: float  # monotonic, window close
    statements: List[Statement]
    sql_of: Dict[str, str]
    events: List[Tuple[float, str, float, str]]  # (monotonic done, sql, wall_s, state)
    launches: int  # kernel launches from window open until the last statement ended
    memory_peak_bytes: int
    setup_s: float
    trace: Optional[DeviceTrace]
    kernel_names: List[str]

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def in_window(self) -> List[Statement]:
        """Statements that completed, with an answer, inside the window."""
        return [s for s in self.statements if s.ok and self.start <= s.t1 <= self.end]

    def done(self) -> List[Statement]:
        """Every statement that completed with an answer, the ones still in
        flight at the close included (the span the trace and the launch
        counters cover)."""
        return [s for s in self.statements if s.ok]

    def matched(self) -> List[Tuple[Statement, float]]:
        """(statement completed in the window, the engine's wall_s of it):
        the query-completed event of the same text that fired while the
        client waited for it."""
        free = sorted(self.events)
        out = []
        for s in sorted(self.in_window(), key=lambda s: s.t1):
            sql = self.sql_of[s.id]
            for k, (t, text, wall, state) in enumerate(free):
                if text == sql and s.t0 <= t <= s.t1 and state == "finished":
                    out.append((s, wall))
                    del free[k]
                    break
        return out
