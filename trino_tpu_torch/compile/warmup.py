"""Census-driven warmup.

Counterpart of trino_tpu/compile/warmup.py. At plan time the
LocalPlanner records a WarmupEntry for every fused filter/project stage
and every aggregation and hash join it plans over a scan whose capacity
classes the shape census predicts (the stabilized scan classes: the main
class, plus the tail class of a table larger than batch_rows). The
WarmupService drives each entry once per predicted capacity on an
all-dead zero batch on the query's device, as the reference does.

What that warms in the port: the hand-written kernels are built by nvcc
and loaded at their first launch (ops/cuda_build.py), and the caching
allocator holds blocks of the sizes the query will ask for. A dead batch
reaches the same kernels a live one does (grouped_sum over rows that
are all dead, the join probe's bounds into an empty build), so the first
live batch pays neither the build nor the load. There is no
torch.compile and no CUDA graph here: the reference has no such feature.

Failure policy, as in the reference: a warmup failure marks the entry
"failed", keeps the error's text in `entry.detail`, counts METRICS
`warmup_failures`, and never fails the query (the query then meets the
same kernel cold). Whoever must not miss a failed entry reads the
entries (chip_smoke.py's serve phase fails its run on one).

WARM_CLASSES is the process-wide registry of (operator, capacity,
dtype-sig) classes known warm, fed by warmup and by completed tasks; the
stuck-task watchdog applies its tighter warm threshold only to tasks
whose predicted classes are all in it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Optional, Sequence, Set, Tuple

import torch

from trino_tpu_torch.analysis import threadreg
from trino_tpu_torch.analysis.witness import named_lock

# (operator, capacity, dtype-sig) classes proven warm in this process:
# the vocabulary of the shape ledger (exec/stats.py) and the census
# (sql/validate.py Lowering)
WARM_CLASSES: Set[Tuple] = set()
_warm_lock = named_lock("warmup._warm_lock")


def note_classes_warm(keys: Iterable[Tuple]) -> None:
    """Record classes as warm (warmup success or task completion)."""
    with _warm_lock:
        WARM_CLASSES.update(keys)


def classes_warm(keys: Iterable[Tuple]) -> bool:
    """True when every key is registered warm and there is at least one
    (an empty prediction proves nothing)."""
    ks = set(keys)
    if not ks:
        return False
    with _warm_lock:
        return ks <= WARM_CLASSES


def reset_warm_classes() -> None:
    """Forget every class (a fresh process)."""
    with _warm_lock:
        WARM_CLASSES.clear()



def warm_manifest() -> list:
    """The warm-class registry as JSON-ready lists, sorted: what a
    serving host hands a joining replica (runtime/fabric.py warm join)."""
    with _warm_lock:
        keys = sorted(WARM_CLASSES)
    return [[op, int(cap), list(dts)] for op, cap, dts in keys]


def apply_manifest(manifest) -> int:
    """Register the classes of a `warm_manifest` from another host.
    An item that is not (operator, capacity, dtypes) is skipped (its
    unpacking or conversion raises TypeError or ValueError); returns the
    number of classes applied."""
    keys = []
    for item in manifest or []:
        try:
            op, cap, dts = item
            keys.append((str(op), int(cap), tuple(str(d) for d in dts)))
        except (TypeError, ValueError):
            continue
    note_classes_warm(keys)
    return len(keys)

@dataclasses.dataclass
class WarmupEntry:
    """One stage to warm across its predicted capacities."""

    operator: str  # ledger/census operator name ("FilterProjectOperator")
    fn: object  # batch -> anything; called on each dead batch
    in_schema: Sequence  # [(DataType, Dictionary|None)] feeding fn
    out_dtypes: Tuple[str, ...]  # output column type strs (ledger sig)
    capacities: Tuple[int, ...]
    device: object = "cpu"  # where the dead batches are made
    status: str = "pending"  # pending | compiled | failed | skipped
    detail: str = ""

    def keys(self) -> Set[Tuple]:
        return {(self.operator, c, self.out_dtypes) for c in self.capacities}


def zeros_batch(schema, capacity: int, device="cpu"):
    """All-dead batch of `schema` at `capacity` on `device`: zero data,
    live mask all False. Raises NotImplementedError for nested types
    (their zero layouts are operator-specific; such entries are
    skipped)."""
    from trino_tpu_torch.block import Column, RelBatch, phys_zeros

    cols = []
    for typ, d in schema:
        if getattr(typ, "is_nested", False):
            raise NotImplementedError(f"nested warmup unsupported: {typ}")
        cols.append(Column(typ, phys_zeros(typ, capacity, device), None, d))
    return RelBatch(cols, torch.zeros(capacity, dtype=torch.bool, device=device))


class WarmupService:
    """Drives a list of WarmupEntry to "compiled".

    mode="background": on a daemon thread while the query runs.
    mode="block": the same work, and the caller wait()s before the query
    starts (deterministic cold starts, tests)."""

    def __init__(self, entries: Sequence[WarmupEntry], mode: str = "background"):
        self.entries = list(entries)
        self.mode = mode
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WarmupService":
        if self.mode == "off" or not self.entries:
            self._done.set()
            return self
        self._thread = threadreg.spawn(
            "trino-tpu-warmup", self._run, owner="WarmupService"
        )
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def _run(self) -> None:
        try:
            for entry in self.entries:
                self._warm_entry(entry)
        finally:
            self._done.set()

    def _warm_entry(self, entry: WarmupEntry) -> None:
        from trino_tpu_torch.runtime.metrics import METRICS

        compiled = 0
        for cap in entry.capacities:
            key = (entry.operator, cap, entry.out_dtypes)
            try:
                batch = zeros_batch(entry.in_schema, cap, entry.device)
            except NotImplementedError as ex:
                entry.status = "skipped"
                entry.detail = str(ex)
                METRICS.increment("warmup_skipped")
                return
            try:
                entry.fn(batch)
            except Exception as ex:  # noqa: BLE001 - a warmup never fails the query
                entry.status = "failed"
                entry.detail = f"cap={cap}: {type(ex).__name__}: {ex}"
                METRICS.increment("warmup_failures")
                return
            note_classes_warm([key])
            compiled += 1
            METRICS.increment("warmup_compiles")
        entry.status = "compiled"
        entry.detail = f"{compiled} capacities"

    def warmed_keys(self) -> Set[Tuple]:
        out: Set[Tuple] = set()
        for e in self.entries:
            if e.status == "compiled":
                out |= e.keys()
        return out

    def status_counts(self):
        counts = {"compiled": 0, "failed": 0, "skipped": 0, "pending": 0}
        for e in self.entries:
            counts[e.status] = counts.get(e.status, 0) + 1
        return counts

    def failures(self) -> list:
        """(operator, detail) of every failed entry."""
        return [(e.operator, e.detail) for e in self.entries if e.status == "failed"]

    def report_line(self, ledger: Optional[Set[Tuple]] = None) -> str:
        """EXPLAIN ANALYZE line, printed under the census. Hits are
        warmed classes the query executed; misses are observed classes
        warmup did not cover."""
        c = self.status_counts()
        line = (
            f"warmup: mode={self.mode} entries={len(self.entries)} "
            f"compiled={c['compiled']} failed={c['failed']} "
            f"skipped={c['skipped']}"
        )
        if ledger is not None:
            warmed = self.warmed_keys()
            line += f" hits={len(warmed & ledger)} misses={len(ledger - warmed)}"
        return line
