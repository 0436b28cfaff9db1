"""Replicated serving meshes: the shard device list carved into sub-meshes.

Counterpart of trino_tpu/runtime/replicas.py. The mesh plane
(parallel/mesh_plan.py) runs one shard mesh over every device of the
runner's `mesh_devices` list: one fault domain, one queue. With
`mesh_replicas` = N >= 2 the list is carved into N rows of `len // N`
shards each (a leftover tail stays out, so every replica has the same
width and a checkpoint taken on one restores on another). Each row runs
the same chunked programs, unchanged: a program only ever sees its
row's shards. The list may repeat a device (`[cuda:0] * 4` on one card
gives 2 replicas of 2 shards), as the ShardMesh allows.

The ReplicaManager is the coordinator's placement layer over the grid:

- **health**: each replica carries a CircuitBreaker (runtime/discovery,
  applied to a fault domain instead of a worker). Mesh-run failures
  trip it; a success closes it; an open breaker sits out `cooldown_s`
  before a half-open probe placement may try the replica again.
- **placement**: `place()` picks the least-loaded healthy replica
  (round-robin on ties). The program cache is process-wide, so a query
  on any replica reuses the records the others built.
- **lifecycle**: `request_drain` flips a replica to shutting_down; new
  placements skip it, and its in-flight chunk loops raise
  MeshReplicaDraining at their next boundary, handing the query to the
  coordinator's failover dispatch.
- **failover**: the dying replica's chunked queries resume on a sibling
  from the host checkpoint store (recovery/checkpoint.py), keyed by the
  program identity without the replica id or the device list, so the
  sibling's ChunkedMeshRunner finds the snapshot as its own.
- **membership**: leave and join under a monotonic epoch (driven by
  runtime/fabric.MembershipDriver), the exactly-one-owner claims, and
  `require_epoch`, which fences a resume whose target left and rejoined.

The reference's `maybe_initialize_distributed` (joining a JAX pod) has
no counterpart: the port's mesh is one process's devices, and hosts
meet through the checkpoint fabric (ROADMAP §3). `global_mesh` returns
the replica x shard grid itself. A warm replay that `join` runs keeps a
failed entry's error in the entry, as the warmup service does; any
other error from it propagates and leaves the replica out of the pool
(the reference joins whatever the warm-up raised).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from trino_tpu_torch.runtime.discovery import CircuitBreaker
from trino_tpu_torch.analysis.witness import named_lock

# /v1/metrics counter names (registered at zero by
# register_replica_metrics, so the surface shows before the first event)
PLACEMENTS = "replica.placements"
FAILOVERS = "replica.failovers"
DRAINS = "replica.drains"
BREAKER_OPENS = "replica.breaker_opens"

_COUNTERS = (PLACEMENTS, FAILOVERS, DRAINS, BREAKER_OPENS)


def register_replica_metrics() -> None:
    from trino_tpu_torch.runtime.metrics import METRICS

    for name in _COUNTERS:
        METRICS.increment(name, 0.0)


class Replica:
    """One row of the replica x shard grid: its shard devices, breaker
    health, lifecycle state and live depth."""

    def __init__(self, replica_id: int, devices: Sequence,
                 breaker: CircuitBreaker, scheduler_kw=None):
        self.replica_id = replica_id
        self.devices = list(devices)
        self.breaker = breaker
        # one mesh run at a time per replica when mesh_scheduler is off
        self.exec_lock = named_lock("Replica.exec_lock")
        # the replica's run queue (runtime/scheduler.py): the same one
        # holder, chunk-granular, so a fast arrival parks the running
        # analytic instead of queueing behind its whole run
        from trino_tpu_torch.runtime.scheduler import MeshScheduler

        self.scheduler = MeshScheduler(name=f"replica-{replica_id}", **(scheduler_kw or {}))
        # active -> shutting_down (drain requested) -> drained (nothing
        # in flight). "left" is the membership tier's verdict (host lost
        # or flapped): out of the pool like a drain, back through join()
        # under a new epoch
        self.state = "active"
        # the membership epoch this replica (re)joined under: a rejoin
        # moves it, which is what fences stale resumes
        self.join_epoch = 0
        self.inflight = 0
        self.served = 0  # lifetime placements onto this replica


class ReplicaManager:
    """Placement, health and failover bookkeeping over N identical
    sub-meshes. Counters are instance-scoped (the EXPLAIN `replicas=`
    line reads them) and mirrored into METRICS for /v1/metrics.
    `devices` is the shard device list to carve; None is every visible
    card of `device` (None: the CUDA card, raising without one)."""

    def __init__(self, n_replicas: int, devices=None, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0, scheduler_kw=None, device=None):
        if devices is None:
            from trino_tpu_torch.engine import resolve_device
            from trino_tpu_torch.parallel.mesh import ShardMesh

            devices = ShardMesh.resolve(None, resolve_device(device)).devices
        devs = list(devices)
        if n_replicas < 1:
            raise ValueError(f"mesh_replicas must be >= 1, got {n_replicas}")
        per = len(devs) // n_replicas
        if per < 1:
            raise ValueError(f"mesh_replicas={n_replicas} needs at least one device "
                             f"per replica ({len(devs)} listed)")
        # the replica x shard grid; row r is replica r's sub-mesh. An
        # object array keeps each device as given (torch.device or name)
        grid = np.empty((n_replicas, per), dtype=object)
        for r in range(n_replicas):
            for s in range(per):
                grid[r, s] = devs[r * per + s]
        self.grid = grid
        self.n_replicas = n_replicas
        self.partition_width = per
        self._lock = named_lock("ReplicaManager._lock")
        self._rr = 0  # guarded_by: _lock (round-robin tiebreak cursor)
        self.placements = 0
        self.failovers = 0
        self.drains = 0
        self.breaker_opens = 0
        # live membership (runtime/fabric.py drives it): every join or
        # leave advances the epoch; require_epoch fences a resume whose
        # target moved on
        self.membership_epoch = 1
        self.joins = 0
        self.leaves = 0
        self.epoch_fences = 0
        # exactly-one-owner ledger: query_id -> (replica_id, epoch)
        self._owners: Dict[str, tuple] = {}  # guarded_by: _lock
        self.replicas = [
            Replica(r, list(grid[r]),
                    CircuitBreaker(breaker_threshold, breaker_cooldown_s,
                                   on_open=self._on_breaker_open),
                    scheduler_kw=scheduler_kw)
            for r in range(n_replicas)
        ]
        for rep in self.replicas:
            rep.join_epoch = self.membership_epoch
        register_replica_metrics()
        from trino_tpu_torch.runtime.fabric import register_fabric_metrics
        from trino_tpu_torch.runtime.metrics import METRICS

        register_fabric_metrics()
        for rep in self.replicas:
            METRICS.register_gauge(f"replica.{rep.replica_id}.queue_depth",
                                   lambda rep=rep: float(rep.inflight))

    def _on_breaker_open(self) -> None:
        from trino_tpu_torch.runtime.metrics import METRICS

        self.breaker_opens += 1
        METRICS.increment(BREAKER_OPENS)

    def global_mesh(self) -> np.ndarray:
        """The whole replica x shard grid (the reference's 2-D jax Mesh;
        the port has no mesh object beyond the device list)."""
        return self.grid

    # -- placement ----------------------------------------------------
    def _candidates(self, exclude) -> List[Replica]:
        """Healthy first (active, breaker closed), then cooled-down
        half-open probes, then any active replica: degrade rather than
        refuse, as the coordinator's _schedulable_workers does."""
        active = [r for r in self.replicas
                  if r.state == "active" and r.replica_id not in exclude]
        for r in active:
            r.breaker.mark_probing()
        closed = [r for r in active if not r.breaker.is_open]
        if closed:
            return closed
        probing = [r for r in active if r.breaker.state == "half_open"]
        return probing or active

    def place(self, exclude=()) -> Optional[Replica]:
        """The least-loaded healthy replica not in `exclude`, or None
        when every replica is excluded or out of rotation. Bumps the
        placement counters and the replica's depth; the caller must
        release() it."""
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            cands = self._candidates(set(exclude))
            if not cands:
                return None
            depth = min(r.inflight for r in cands)
            tied = [r for r in cands if r.inflight == depth]
            rep = tied[self._rr % len(tied)]
            self._rr += 1
            rep.inflight += 1
            rep.served += 1
            self.placements += 1
        METRICS.increment(PLACEMENTS)
        return rep

    def release(self, replica: Replica) -> None:
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)

    def note_failover(self, from_replica: Replica,
                      to_replica: Optional[Replica] = None) -> None:
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            self.failovers += 1
        METRICS.increment(FAILOVERS)

    # -- health --------------------------------------------------------
    def report_failure(self, replica: Replica) -> None:
        replica.breaker.record_failure()

    def report_success(self, replica: Replica) -> None:
        replica.breaker.record_success()

    # -- lifecycle -----------------------------------------------------
    def request_drain(self, replica_id: int) -> Replica:
        """Start draining a replica: placements skip it at once, and its
        in-flight chunk loops raise MeshReplicaDraining at their next
        boundary (drain_check)."""
        from trino_tpu_torch.runtime.metrics import METRICS

        rep = self.replicas[replica_id]
        with self._lock:
            if rep.state in ("shutting_down", "drained"):
                return rep
            rep.state = "shutting_down"
            self.drains += 1
        METRICS.increment(DRAINS)
        return rep

    def drain(self, replica_id: int, timeout_s: float = 30.0, poll_s: float = 0.01) -> bool:
        """request_drain, then wait until nothing is in flight on the
        replica. True once drained; False on timeout (the replica stays
        shutting_down, out of rotation)."""
        rep = self.request_drain(replica_id)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if rep.inflight == 0:
                with self._lock:
                    if rep.inflight == 0:
                        rep.state = "drained"
                        return True
                continue
            time.sleep(poll_s)
        return rep.inflight == 0

    def undrain(self, replica_id: int) -> None:
        """Return a drained replica to rotation."""
        rep = self.replicas[replica_id]
        with self._lock:
            rep.state = "active"

    # -- live membership -----------------------------------------------
    def leave(self, replica_id: int) -> Replica:
        """The replica leaves the placement pool under a new epoch. The
        Replica object (breaker, counters) survives, so a flap never
        resets health history; its in-flight chunk loops fail over at
        their next boundary, as under a drain."""
        from trino_tpu_torch.runtime.fabric import LEAVES
        from trino_tpu_torch.runtime.metrics import METRICS

        rep = self.replicas[replica_id]
        with self._lock:
            if rep.state == "left":
                return rep
            rep.state = "left"
            self.membership_epoch += 1
            self.leaves += 1
        METRICS.increment(LEAVES)
        return rep

    def join(self, replica_id: int, warm=None) -> Replica:
        """(Re)admit a replica under a new epoch. `warm` runs before the
        replica enters the pool (runtime/fabric.warm_join_replay). A
        warm-up entry that fails is kept in the entry (the replica still
        joins); any error `warm` raises propagates and the replica stays
        out of the pool."""
        from trino_tpu_torch.runtime.fabric import JOINS
        from trino_tpu_torch.runtime.metrics import METRICS

        rep = self.replicas[replica_id]
        if rep.state == "active":
            return rep
        if warm is not None:
            warm()
        with self._lock:
            self.membership_epoch += 1
            rep.state = "active"
            rep.join_epoch = self.membership_epoch
            self.joins += 1
        METRICS.increment(JOINS)
        return rep

    # -- ownership ledger ----------------------------------------------
    def claim(self, query_id: str, replica: Replica) -> bool:
        """Record `replica` as the single owner of `query_id`. Refused
        while another replica's claim is live, even if that replica has
        left since (its chunk loop may still be unwinding). A re-claim
        by the owner refreshes it."""
        if not query_id:
            return True
        with self._lock:
            cur = self._owners.get(query_id)
            if cur is not None and cur[0] != replica.replica_id:
                return False
            self._owners[query_id] = (replica.replica_id, self.membership_epoch)
            return True

    def unclaim(self, query_id: str, replica: Replica) -> None:
        if not query_id:
            return
        with self._lock:
            cur = self._owners.get(query_id)
            if cur is not None and cur[0] == replica.replica_id:
                del self._owners[query_id]

    def owner_of(self, query_id: str):
        """(replica_id, epoch) of the live claim, or None."""
        with self._lock:
            return self._owners.get(query_id)

    def require_epoch(self, replica: Replica, expected_epoch: int) -> None:
        """Fence a resume: MembershipEpochError when the target's epoch
        moved past `expected_epoch` or it is out of the pool (it left
        and rejoined: stale state must not land on what is in effect a
        new host). The caller discards the checkpoint and restarts."""
        from trino_tpu_torch.runtime.fabric import EPOCH_FENCES, MembershipEpochError
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            moved = replica.join_epoch > expected_epoch or replica.state != "active"
            if moved:
                self.epoch_fences += 1
        if moved:
            METRICS.increment(EPOCH_FENCES)
            raise MembershipEpochError(
                f"replica {replica.replica_id} membership epoch moved "
                f"({expected_epoch} -> {replica.join_epoch}, state={replica.state}): "
                "resume refused, restart fresh",
                replica_id=replica.replica_id, expected_epoch=expected_epoch,
                actual_epoch=replica.join_epoch)

    def membership_line(self) -> str:
        """The EXPLAIN ANALYZE membership line."""
        with self._lock:
            return (f"membership= epoch={self.membership_epoch} "
                    f"joins={self.joins} leaves={self.leaves} "
                    f"epoch_fences={self.epoch_fences} "
                    f"owners={len(self._owners)}")

    def drain_check(self, replica: Replica):
        """The chunk-boundary hook a MeshExecutor carries: raises
        MeshReplicaDraining once the replica leaves the active state."""
        def check() -> None:
            if replica.state != "active":
                from trino_tpu_torch.parallel.mesh_chunk import MeshReplicaDraining

                raise MeshReplicaDraining(
                    f"replica {replica.replica_id} is {replica.state}; failing over "
                    "at this chunk boundary")

        return check

    # -- observability -------------------------------------------------
    def breaker_states(self) -> Dict[int, str]:
        return {r.replica_id: r.breaker.state for r in self.replicas}

    def healthy_count(self) -> int:
        with self._lock:
            return len([r for r in self.replicas
                        if r.state == "active" and not r.breaker.is_open])

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": self.n_replicas,
                "partition_width": self.partition_width,
                "placements": self.placements,
                "failovers": self.failovers,
                "drains": self.drains,
                "breaker_opens": self.breaker_opens,
                "per_replica": {
                    r.replica_id: {"state": r.state, "breaker": r.breaker.state,
                                   "depth": r.inflight, "served": r.served}
                    for r in self.replicas
                },
            }

    def stats_line(self) -> str:
        s = self.stats()
        states = "".join(p["state"][0] for p in s["per_replica"].values())
        return (f"replicas= n={s['replicas']}x{s['partition_width']} "
                f"states={states} placements={s['placements']} "
                f"failovers={s['failovers']} drains={s['drains']} "
                f"breaker_opens={s['breaker_opens']}")
