"""Driver: the host loop moving batches through an operator pipeline.

Counterpart of trino_tpu/exec/driver.py (Driver.processInternal: for
each adjacent operator pair, page = current.getOutput();
next.addInput(page); then the finish cascade). The loop never touches
data; operators run their device work eagerly. A pipeline whose
operators wait on another thread (a local exchange) is blocked, not
stalled: the driver yields until one of them moves.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

from trino_tpu_torch.exec.operators import Operator


@dataclasses.dataclass
class Pipeline:
    """An ordered operator chain ending in a sink, run in dependency
    order."""

    operators: List[Operator]


class TaskAbortedError(RuntimeError):
    """Raised by Driver.run when `should_stop` says the owning task was
    aborted: cancellation is checked at every batch boundary."""


class Driver:
    """Runs one pipeline to completion. `should_stop()` (optional) is
    polled at every batch move; `observer(op_name, moved)` (optional) is
    called after each batch move (moved=True) and on each blocked wait
    (moved=False)."""

    def __init__(self, pipeline: Pipeline, should_stop=None, observer=None):
        self.ops = pipeline.operators
        self._finish_signalled = [False] * len(self.ops)
        self._should_stop = should_stop
        self._observer = observer

    def _check_stop(self) -> None:
        if self._should_stop is not None and self._should_stop():
            raise TaskAbortedError("task aborted")

    def run(self) -> None:
        ops = self.ops
        n = len(ops)
        while not ops[-1].is_finished():
            self._check_stop()
            progressed = False
            for i in range(n - 1):
                cur, nxt = ops[i], ops[i + 1]
                if nxt.is_finished():
                    continue
                while nxt.needs_input():
                    self._check_stop()
                    out = cur.get_output()
                    if out is None:
                        break
                    nxt.add_input(out)
                    progressed = True
                    if self._observer is not None:
                        self._observer(type(cur).__name__, True)
                if cur.is_finished() and not self._finish_signalled[i + 1]:
                    nxt.finish()
                    self._finish_signalled[i + 1] = True
                    progressed = True
            if not progressed and not ops[-1].is_finished():
                blocked = [o for o in ops if o.is_blocked()]
                if blocked:
                    # waiting on another thread's batches or buffer space:
                    # yield (Driver.java's blocked futures as a poll)
                    if self._observer is not None:
                        self._observer(type(blocked[0]).__name__, False)
                    time.sleep(0.001)
                    continue
                raise RuntimeError(
                    "pipeline stalled: "
                    + ", ".join(
                        f"{type(o).__name__}(fin={o.is_finished()})" for o in ops
                    )
                )


def run_pipelines(pipelines: Sequence[Pipeline]) -> None:
    """Run pipelines one after another, in dependency order."""
    for p in pipelines:
        Driver(p).run()
