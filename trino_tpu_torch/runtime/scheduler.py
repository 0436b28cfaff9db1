"""Chunk-granular weighted-fair mesh scheduling with park/resume.

Counterpart of trino_tpu/runtime/scheduler.py, host code only. One
MeshScheduler guards one mesh resource: the coordinator owns one for
the full-width mesh, and each Replica (runtime/replicas.py) owns one as
its run queue. A mesh holds one query's chunk loop at a time. In the
reference that guards collective rendezvous on a device set; the port's
collectives are Python functions over per-shard tensors and cannot
deadlock that way, but the semantics stay the reference's: one holder
per mesh, fairness between groups, preemption by point lookups. The
chunk loop (parallel/mesh_chunk.py) hands the host control at every
chunk boundary, and the scheduler decides there whether the holder
keeps the mesh or hands it over:

- **weighted fairness**: per resource group virtual-time accounting
  (stride scheduling, as in runtime/resource_groups.py): each completed
  chunk charges `dt / weight` to the holder's group; a waiting group
  whose virtual time lags the holder's gets the next slice. An idle
  group rejoins at the current global pass, so sleeping never banks
  credit.
- **fast lane**: point lookups (serving/admission.is_fast_lane) are
  granted ahead of any analytic waiter, and their arrival preempts the
  running analytic at its next boundary.
- **park/resume**: a preempted analytic is parked: its carries are
  copied to the host checkpoint store (recovery/checkpoint.py,
  accounted against `park_max_bytes`), its device tensors are dropped,
  and it resumes later from chunk k on the same capacity rungs, with no
  chunk executed twice and no program built. An unparkable program
  (uncacheable identity, unchunked) yields in place instead (carries
  stay, the grant rotates); a park the budget refuses runs to
  completion.
- **bounded slice**: the holder runs at least `min_slice_chunks`
  between preemptions, so a stream of fast arrivals cannot live-lock
  the analytic.

The wait loops poll the caller's preemption hook (deadline and
abandonment: a parked query past its budget dies typed and never
resumes) and the replica drain check (a drain surfacing while parked
raises MeshReplicaDraining out of the wait; the parked snapshot is
host-portable, so the query resumes from chunk k on a sibling).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from trino_tpu_torch.analysis.witness import named_lock

# /v1/metrics counter names (registered at zero by
# register_scheduler_metrics — same surface protocol as the recovery
# and replica counters)
PARKS = "scheduler.parks"
RESUMES = "scheduler.resumes"
PREEMPTIONS = "scheduler.preemptions"
STEALS = "scheduler.steals"
YIELDS = "scheduler.yields"
PARK_REFUSALS = "scheduler.park_refusals"

_COUNTERS = (PARKS, RESUMES, PREEMPTIONS, STEALS, YIELDS, PARK_REFUSALS)

# wait-loop tick: how often a blocked job re-polls its preemption hook
# (deadline/abandonment) and drain check while queued or parked
_WAIT_TICK_S = 0.02
# cap on the fast-arrival courtesy hold: how long a boundary will pause
# (seat kept) for a submitted-but-still-prepping fast query to become
# ready before streaming resumes. Bounds the damage if the arrival dies
# before ever reaching acquire (finish() wakes the hold early).
_FAST_ARRIVAL_HOLD_S = 0.1

# vtime comparison slack: a waiter must lag the holder by more than
# this before fairness alone rotates the grant (suppresses thrash
# between groups whose accounts are effectively even)
_VTIME_EPS = 1e-9


def register_scheduler_metrics() -> None:
    from trino_tpu_torch.runtime.metrics import METRICS

    for name in _COUNTERS:
        METRICS.increment(name, 0.0)


class MeshJob:
    """One query's seat in a MeshScheduler: identity, lane, group
    accounting hooks, and the blocking park/yield state machine the
    chunk loop drives through `boundary()` / `park_wait()`."""

    # states: waiting -> running -> (waiting | parked -> running)* -> done
    def __init__(self, scheduler: "MeshScheduler", query_id: str,
                 group: str, weight: float, fast: bool, seq: int,
                 poll=None):
        self.scheduler = scheduler
        self.query_id = query_id
        self.group = group
        self.weight = max(float(weight), 1e-6)
        self.fast = bool(fast)
        self.seq = seq
        # poll(done, total): the coordinator's preemption hook —
        # latched deadline kills / client abandonment fire typed OUT OF
        # the wait loops, so a queued or parked query never outlives
        # its budget just because it isn't running
        self.poll = poll
        # aux_check(): replica drain hook; raises MeshReplicaDraining
        # when the mesh under this job leaves rotation
        self.aux_check = None
        self.state = "waiting"
        # ready: the job is blocked in acquire() and can use a grant
        # RIGHT NOW. Jobs are submitted before their host planning and
        # feed builds run (so the fast lane sees arrivals early), but
        # the dispatcher must never seat a query that is still
        # prepping — it would hold the mesh idle against real waiters.
        # Flipped by _wait_for_grant; synthetic waiters (tests, chaos)
        # that never acquire must set it themselves to exert pressure.
        self.ready = False
        self.no_park = False  # latched on park-budget refusal
        self.chunks_in_slice = 0
        self.parked_s = 0.0  # cumulative wall spent parked
        self._park_t0 = None  # start of the park in flight, if any
        self.progress = (0, 0)  # (done, total) for wait-loop polls

    # convenience passthroughs --------------------------------------
    def boundary(self, done: int, total: int, dt: float,
                 parkable: bool = False) -> str:
        return self.scheduler.boundary(self, done, total, dt, parkable)

    def park_wait(self, done: int, total: int) -> None:
        self.scheduler.park_wait(self, done, total)

    def park_refused(self) -> None:
        self.scheduler.park_refused(self)


class MeshScheduler:
    """Weighted-fair run queue over one mesh resource.

    Counters are INSTANCE-scoped (the EXPLAIN `scheduler=` line reads
    them deterministically) and mirrored into the process-global
    METRICS registry for /v1/metrics."""

    def __init__(self, name: str = "mesh", min_slice_chunks: int = 1,
                 preemption_enabled: bool = True,
                 weights: Optional[Dict[str, float]] = None):
        self.name = name
        self.min_slice_chunks = max(1, int(min_slice_chunks))
        self.preemption_enabled = bool(preemption_enabled)
        self.weights = dict(weights or {})
        self._lock = named_lock("MeshScheduler._lock")
        self._cond = threading.Condition(self._lock)
        self._holder: Optional[MeshJob] = None  # guarded_by: _lock
        self._waiting: List[MeshJob] = []  # guarded_by: _lock
        self._seq = 0  # guarded_by: _lock
        # per-group virtual time (stride scheduling: vtime grows by
        # chunk_wall / weight; the group with the smallest account runs)
        self._vtime: Dict[str, float] = {}  # guarded_by: _lock
        self._gpass = 0.0  # guarded_by: _lock — high-water pass idle groups rejoin at
        # instance counters (EXPLAIN line) — mirrored to METRICS
        self.parks = 0
        self.resumes = 0
        self.preemptions = 0
        self.yields = 0
        self.park_refusals = 0
        self.submitted = 0
        self.fast_submitted = 0  # fast-lane share of `submitted`
        self.fast_holds = 0
        register_scheduler_metrics()

    # -- submission / grant lifecycle --------------------------------
    def submit(self, query_id: str, group: str = "default",
               weight: Optional[float] = None, fast: bool = False,
               poll=None) -> MeshJob:
        """Enqueue a query. `weight` defaults to the scheduler's
        per-group weight table (scheduling_weight analogue), else 1."""
        with self._lock:
            self._seq += 1
            w = weight if weight is not None else self.weights.get(group, 1.0)
            job = MeshJob(self, query_id, group, w, fast, self._seq, poll)
            # rejoin-at-current-pass starvation guard: an idle group
            # must not have banked credit while it slept
            v = self._vtime.get(job.group)
            self._vtime[job.group] = (
                self._gpass if v is None else max(v, 0.0)
            )
            self._waiting.append(job)
            self.submitted += 1
            if job.fast:
                self.fast_submitted += 1
            self._cond.notify_all()
            return job

    def acquire(self, job: MeshJob, aux_check=None) -> None:
        """Block until the mesh is granted to `job`. The wait loop
        polls the job's preemption hook and the drain check, so queued
        queries die typed (deadline/abandonment) or fail over (drain)
        instead of waiting out a grant they can never use."""
        if aux_check is not None:
            job.aux_check = aux_check
        self._wait_for_grant(job)

    def finish(self, job: MeshJob) -> None:
        """Release the job's seat whatever state it died or finished
        in; the next grant dispatches immediately."""
        with self._lock:
            job.state = "done"
            if self._holder is job:
                self._holder = None
            if job in self._waiting:
                self._waiting.remove(job)
            self._dispatch_locked()
            self._cond.notify_all()

    # -- chunk-boundary protocol -------------------------------------
    def boundary(self, job: MeshJob, done: int, total: int, dt: float,
                 parkable: bool = False) -> str:
        """Called by the chunk loop after each completed chunk-step.
        Charges `dt / weight` to the holder's group, then decides:

        - "run"  — keep the mesh (possibly after an in-place yield to
          a lagging group or an unparkable fast preemption: the call
          blocks through the handover and returns once regranted);
        - "park" — a fast-lane waiter preempts and the program can
          park: the caller snapshots its carries, drops device refs,
          and calls park_wait().
        """
        from trino_tpu_torch.runtime.metrics import METRICS

        wants_yield = False
        with self._lock:
            if self._holder is not job:
                return "run"  # not holding (width-1 bypass): no-op
            self._charge_locked(job, dt)
            job.chunks_in_slice += 1
            job.progress = (done, total)
            if not self._waiting or done >= total:
                return "run"
            if job.chunks_in_slice < self.min_slice_chunks:
                return "run"
            # only READY waiters exert preemption pressure: parking for
            # a query still in host prep would idle the mesh
            fast_waiter = any(w.fast and w.ready for w in self._waiting)
            holder_v = self._vtime.get(job.group, 0.0)
            lagging = any(
                w.ready
                and (not w.fast)
                and w.group != job.group
                and self._vtime.get(w.group, 0.0)
                < holder_v - _VTIME_EPS
                for w in self._waiting
            )
            if not fast_waiter and not lagging:
                fast_waiter = self._hold_for_fast_arrival_locked()
                if not fast_waiter:
                    return "run"
            self.preemptions += 1
            if (
                fast_waiter
                and self.preemption_enabled
                and parkable
                and not job.no_park
            ):
                METRICS.increment(PREEMPTIONS)
                return "park"
            # in-place yield: rotate the grant, carries stay resident
            self.yields += 1
            self._release_locked(job)
            wants_yield = True
        METRICS.increment(PREEMPTIONS)
        if wants_yield:
            METRICS.increment(YIELDS)
            self._wait_for_grant(job)
        return "run"

    def park_wait(self, job: MeshJob, done: int, total: int) -> None:
        """The caller has snapshotted its carries and released device
        memory: give up the grant, count the park, and block until
        regranted. Typed kills and drain checks fire out of the wait;
        the caller owns checkpoint cleanup on either exit."""
        from trino_tpu_torch.runtime.metrics import METRICS

        t0 = time.monotonic()
        with self._lock:
            self.parks += 1
            job.progress = (done, total)
            job.state = "parked"
            job._park_t0 = t0
            self._release_locked(job)
        METRICS.increment(PARKS)
        try:
            self._wait_for_grant(job)
        finally:
            job.parked_s += time.monotonic() - t0
            job._park_t0 = None
        with self._lock:
            self.resumes += 1
        METRICS.increment(RESUMES)

    def park_budget_for(self, job: MeshJob, total_bytes: int) -> int:
        """Admission-weighted park budget: `total_bytes` (the
        mesh_park_max_bytes pool) apportioned across the groups this
        scheduler has seen by their scheduling weight — the park-store
        analogue of the vtime share. A group over its share gets its
        park refused (the chunk loop degrades to an in-place yield via
        the latched no_park, never to failure). A single-group
        scheduler keeps the whole pool; an unbounded pool (< 0) passes
        through."""
        if total_bytes < 0:
            return int(total_bytes)
        with self._lock:
            groups = set(self._vtime) | set(self.weights) | {job.group}
            if len(groups) <= 1:
                return int(total_bytes)
            wsum = sum(self.weights.get(g, 1.0) for g in groups)
            share = (
                self.weights.get(job.group, 1.0) / wsum
                if wsum > 0 else 1.0
            )
        return int(total_bytes * share)

    def park_refused(self, job: MeshJob) -> None:
        """The park budget refused the snapshot: latch no_park so the
        scheduler stops proposing parks — the query runs to completion
        (degradation is never query failure)."""
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            job.no_park = True
            self.park_refusals += 1
        METRICS.increment(PARK_REFUSALS)

    # -- internals ---------------------------------------------------
    def _hold_for_fast_arrival_locked(self) -> bool:
        """Fast-arrival courtesy hold (runs under self._lock; returns
        whether a READY fast waiter now exists). A fast query has been
        submitted but is still in host prep, so it can't take a grant
        yet — but streaming more chunks at full speed would convoy its
        planning behind this loop's per-chunk dispatch work (the prep
        is pure host code contending for the interpreter). Pause at
        THIS boundary instead, seat kept: cond.wait drops the lock, the
        arrival preps at solo speed, and the park/yield handoff happens
        here rather than several chunk gaps later. Bounded by
        _FAST_ARRIVAL_HOLD_S; a prep that dies before acquire wakes the
        hold via finish()'s notify."""
        if not any(w.fast and not w.ready for w in self._waiting):
            return False
        self.fast_holds += 1
        deadline = time.monotonic() + _FAST_ARRIVAL_HOLD_S
        while time.monotonic() < deadline:
            if any(w.fast and w.ready for w in self._waiting):
                return True
            if not any(w.fast and not w.ready for w in self._waiting):
                return False  # arrival died (or was granted elsewhere)
            self._cond.wait(0.002)
        return any(w.fast and w.ready for w in self._waiting)

    def _charge_locked(self, job: MeshJob, dt: float) -> None:
        g = job.group
        v = self._vtime.get(g, self._gpass) + max(dt, 0.0) / job.weight
        self._vtime[g] = v
        self._gpass = max(self._gpass, v)

    def _release_locked(self, job: MeshJob) -> None:
        if self._holder is job:
            self._holder = None
        if job.state != "parked":
            job.state = "waiting"
        if job not in self._waiting:
            self._waiting.append(job)
        self._dispatch_locked()
        self._cond.notify_all()

    def _pick_locked(self) -> Optional[MeshJob]:
        ready = [w for w in self._waiting if w.ready]
        if not ready:
            return None
        fast = [w for w in ready if w.fast]
        if fast:
            return min(fast, key=lambda w: w.seq)  # fast lane: FIFO
        return min(
            ready,
            key=lambda w: (self._vtime.get(w.group, 0.0), w.seq),
        )

    def _dispatch_locked(self) -> None:
        if self._holder is not None:
            return
        nxt = self._pick_locked()
        if nxt is None:
            return
        self._waiting.remove(nxt)
        # rejoin-at-current-pass: a group granted after lagging far
        # behind must not monopolize the mesh paying back history
        self._vtime[nxt.group] = max(
            self._vtime.get(nxt.group, 0.0), 0.0
        )
        nxt.state = "running"
        nxt.chunks_in_slice = 0
        self._holder = nxt

    def _wait_for_grant(self, job: MeshJob) -> None:
        """Block until `job` holds the mesh, polling its typed-kill and
        drain hooks every tick. On a hook raise the seat is released
        (the job will never run) and the error propagates."""
        job.ready = True
        while True:
            with self._lock:
                if self._holder is None:
                    self._dispatch_locked()
                if self._holder is job:
                    job.state = "running"
                    return
                self._cond.wait(_WAIT_TICK_S)
                if self._holder is job:
                    job.state = "running"
                    return
            try:
                if job.poll is not None:
                    done, total = job.progress
                    # live parked wall: a kill DURING the first park
                    # must already carry the parked context, not just
                    # kills after a completed park/resume cycle
                    parked = job.parked_s
                    t0 = job._park_t0
                    if t0 is not None:
                        parked += time.monotonic() - t0
                    try:
                        job.poll.parked_s = parked
                    except AttributeError:
                        pass  # bare-callable hooks (tests) are fine
                    job.poll(done, total)
                if job.aux_check is not None:
                    job.aux_check()
            except BaseException:
                self.finish(job)
                raise

    # -- observability -----------------------------------------------
    def waiting_count(self, fast: Optional[bool] = None) -> int:
        """READY waiters only — a submitted job still in host prep is
        not waiting for the mesh yet (park-forcing pollers rely on
        this: once the count is visible, the next boundary parks)."""
        with self._lock:
            if fast is None:
                return len([w for w in self._waiting if w.ready])
            return len([
                w for w in self._waiting if w.ready and w.fast == fast
            ])

    def holder_query(self) -> Optional[str]:
        with self._lock:
            return None if self._holder is None else self._holder.query_id

    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "fast_submitted": self.fast_submitted,
                "parks": self.parks,
                "resumes": self.resumes,
                "preemptions": self.preemptions,
                "yields": self.yields,
                "park_refusals": self.park_refusals,
                "fast_holds": self.fast_holds,
                "waiting": len(self._waiting),
                "vtime": dict(self._vtime),
            }


def parse_group_weights(spec: str) -> Dict[str, float]:
    """`mesh_scheduler_weights` session property: "etl=1,serving=4"
    (scheduling_weight analogue). Malformed entries are skipped — a
    typo must not fail query dispatch."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            w = float(val.strip())
        except ValueError:
            continue
        if name.strip() and w > 0:
            out[name.strip()] = w
    return out
