"""Admission pipeline: lane-based overload control in front of the
resource groups.

Counterpart of trino_tpu/serving/admission.py (host code only). The
reference's replica-plane stats (`attach_replicas`) and the mesh
scheduler's fast-lane shape test (`is_fast_lane`) belong to the replica
and scheduler tiers, ROADMAP §1 items 12 and 13.3, and are left out.

Every submission is classified into one of two lanes before it touches
the executor:

- **fast** — point lookups whose plan is already in the plan cache.
  These cost microseconds of planning and one small device step; they
  ride a short dedicated lane so a burst of heavy analytics cannot
  queue them behind itself (the reference's per-group concurrency
  carve-outs, made automatic).
- **general** — everything else.

Each lane has a bounded depth (submissions admitted-or-waiting). A
submission arriving at a full lane is SHED synchronously — the HTTP
front answers 429 with Retry-After — instead of joining an unbounded
queue: under sustained overload an open-loop client population grows
the queue without bound and every queued query eventually misses its
deadline anyway (goodput collapse). Shedding keeps the served fraction
fast and makes the overload observable (`admission.<lane>.shed`).

Inside its lane a submission still goes through the EXISTING resource
groups (weighted fairness, per-group caps) — the pipeline passes the
lane as the selector `source`, so operators can route lanes to
dedicated groups; with no selector configured both lanes share the
root group and the lane depth is the only new bound.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

LANES = ("fast", "general")


class OverloadSheddedError(RuntimeError):
    """Submission rejected at admission: the lane (or the resource-group
    queue behind it) is full. Maps to HTTP 429 + Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 lane: str = "general"):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.lane = lane


@dataclasses.dataclass
class AdmissionReservation:
    """One submission's place in its lane, held from the synchronous
    admission check until the query releases (finish/fail/abandon)."""

    lane: str
    lease: Any = None  # resource-group lease, once wait() returns
    released: bool = False


class AdmissionPipeline:
    """reserve() is the synchronous shed point (runs on the HTTP
    thread); wait() blocks for a resource-group slot (runs on the
    executor); release() returns both."""

    def __init__(
        self,
        resource_groups=None,
        fast_depth: int = 64,
        general_depth: int = 256,
        retry_after_s: float = 1.0,
    ):
        from trino_tpu_torch.runtime.metrics import METRICS

        self.resource_groups = resource_groups
        self.retry_after_s = retry_after_s
        self._max = {"fast": fast_depth, "general": general_depth}
        self._depth = {lane: 0 for lane in LANES}
        self.sheds = {lane: 0 for lane in LANES}
        self.admitted = {lane: 0 for lane in LANES}
        self._lock = threading.Lock()  # AdmissionPipeline._lock
        for lane in LANES:
            METRICS.register_gauge(
                f"admission.{lane}.queue_depth",
                lambda lane=lane: float(self._depth[lane]),
            )

    def reserve(self, fast: bool = False) -> AdmissionReservation:
        from trino_tpu_torch.runtime.metrics import METRICS

        lane = "fast" if fast else "general"
        with self._lock:
            if self._depth[lane] >= self._max[lane]:
                self.sheds[lane] += 1
                METRICS.increment(f"admission.{lane}.shed")
                raise OverloadSheddedError(
                    f"admission lane '{lane}' is full "
                    f"({self._max[lane]} in flight); retry after "
                    f"{self.retry_after_s:g}s",
                    retry_after_s=self.retry_after_s,
                    lane=lane,
                )
            self._depth[lane] += 1
            self.admitted[lane] += 1
            METRICS.increment(f"admission.{lane}.admitted")
        return AdmissionReservation(lane)

    def wait(self, reservation: AdmissionReservation, user: str = "user",
             cancelled=None, timeout: float = 60.0) -> None:
        """Acquire the resource-group slot for a reserved submission.
        Raises whatever the group manager raises (queue-full, killed
        while queued); the caller still must release() — release is
        idempotent on the lease being absent."""
        if self.resource_groups is None:
            return
        reservation.lease = self.resource_groups.acquire(
            user=user, source=reservation.lane,
            timeout=timeout, cancelled=cancelled,
        )

    def release(self, reservation: Optional[AdmissionReservation]) -> None:
        if reservation is None or reservation.released:
            return
        reservation.released = True
        with self._lock:
            self._depth[reservation.lane] -= 1
        if reservation.lease is not None and self.resource_groups is not None:
            self.resource_groups.release(reservation.lease)
            reservation.lease = None

    def stats(self) -> dict:
        with self._lock:
            return {
                lane: {
                    "depth": self._depth[lane],
                    "max_depth": self._max[lane],
                    "shed": self.sheds[lane],
                    "admitted": self.admitted[lane],
                }
                for lane in LANES
            }


# -- fast-path classification -------------------------------------------------

def is_point_lookup(stmt) -> bool:
    """Loose point-lookup shape test for lane routing: one base table,
    a WHERE with at least one equality/IN against a column, no joins.
    (The micro-batcher applies its own, stricter, test.)"""
    from trino_tpu_torch.sql import ast

    if not isinstance(stmt, ast.Query):
        return False
    spec = stmt.body
    if not isinstance(spec, ast.QuerySpec):
        return False
    if not isinstance(spec.from_, ast.TableRef):
        return False
    if spec.where is None:
        return False

    def has_key_predicate(e) -> bool:
        if isinstance(e, ast.BinaryOp):
            if e.op in ("and", "AND"):
                return has_key_predicate(e.left) or has_key_predicate(e.right)
            if e.op in ("eq", "="):
                return isinstance(e.left, ast.Identifier) or isinstance(
                    e.right, ast.Identifier
                )
            return False
        if isinstance(e, ast.InList):
            return isinstance(e.value, ast.Identifier)
        return False

    return has_key_predicate(spec.where)


def fast_path_probe(runner, sql: str, prepared=None) -> bool:
    """True iff `sql` is a point lookup whose plan the runner already
    holds — the submission can skip the general lane. Never raises:
    any surprise (unparsable text, missing prepared statement, arity
    error) classifies as NOT fast and the real dispatch reports it."""
    from trino_tpu_torch.serving.plan_cache import PlanCache

    cache = getattr(runner, "_plan_cache", None)
    session = getattr(runner, "session", None)
    if not isinstance(cache, PlanCache) or session is None:
        return False
    try:
        from trino_tpu_torch.serving.params import bound_dtypes
        from trino_tpu_torch.sql import ast
        from trino_tpu_torch.sql.formatter import format_statement
        from trino_tpu_torch.sql.parser import parse

        stmt = parse(sql)
        dtypes = ()
        if isinstance(stmt, ast.ExecuteStmt):
            text = (prepared or {}).get(stmt.name)
            if text is None:
                store = getattr(runner, "_prepared", None)
                if store is None and hasattr(runner, "_embedded_runner"):
                    store = runner._embedded_runner()._prepared
                hit = (store or {}).get(stmt.name)
                text = hit[1] if hit else None
            if text is None:
                return False
            body = ast.substitute_parameters(parse(text), stmt.parameters)
            dtypes = tuple(bound_dtypes(stmt.parameters))
            stmt = body
        if not is_point_lookup(stmt):
            return False
        key = cache.key(format_statement(stmt), session, dtypes)
        return cache.contains(key)
    except Exception:
        return False
