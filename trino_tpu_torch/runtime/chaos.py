"""Deterministic seeded chaos harness for the cluster resiliency layer.

Counterpart of trino_tpu/runtime/chaos.py. Every runner, worker and
harness takes the port's `device` (None: the CUDA card, raising without
one) and the mesh plane's `mesh_devices`; the replica, preempt and
fabric cases build their replicas from that shard device list
(`["cpu"] * 4` in the tests, `[cuda:0] * 4` on the card), so they
always run, where the reference skips them below two devices.
preempt_park_resume doubles as chaos_smoke's lock-witness gate: run_mesh_case
runs it with the port's order witness (analysis/witness.py) on and
mesh_case_failures fails it on any violation recorded during the run.

Analogue of the reference's BaseFailureRecoveryTest matrix run as a
harness instead of hand-written cases: a fixed seed generates a fault
schedule (which partitions crash where, how many exchange fetches drop,
who stalls, who OOMs), the schedule is installed into the shared
FailureInjector, and TPC-H queries run through the fault-tolerant
scheduler. Because every random draw — schedule generation AND the
retry layer's backoff jitter (error_tracker seeds its RNG from the
destination) — is seeded, a failing run replays exactly from its seed.

Fault classes map onto distinct recovery paths:

- task_crash_start: task dies before producing output (clean re-run)
- task_crash_mid:   task dies AFTER its first output page (the
                    partially-spooled path; spool commit manifests keep
                    replayed attempts duplicate-free)
- fetch_loss:       exchange page pulls fail transiently (absorbed by
                    the RequestErrorTracker loop, no task retry at all)
- straggler:        a task stalls; FTE speculation races a duplicate
- oom:              a task raises ExceededMemoryLimitError (memory-
                    classed: the partition memory estimator doubles
                    before re-placement)

Lifecycle scenarios (LIFECYCLE_CLASSES) exercise the cluster-lifecycle
layer end to end: drain_mid_query / drain_all_but_one gracefully drain
workers while a query is in flight (oracle-equal result, zero accepted
launches on the drained node after the drain, drain completes), and
straggler_speculation demands a recorded speculative WIN, not just a
launched duplicate.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.analysis import threadreg, witness
from trino_tpu_torch.analysis.witness import named_lock


FAULT_CLASSES = (
    "task_crash_start",
    "task_crash_mid",
    "fetch_loss",
    "straggler",
    "oom",
)

# cluster-lifecycle scenarios: not injector schedules but whole-
# cluster maneuvers — graceful drains racing a live query, and a
# straggler that speculation must beat. Run via run_lifecycle_case.
LIFECYCLE_CLASSES = (
    "drain_mid_query",
    "drain_all_but_one",
    "straggler_speculation",
)

# time-bounding scenarios: a hung operator the worker watchdog
# must interrupt (and FTE must retry elsewhere — query still correct),
# and a client that vanishes mid-query (reaper must cancel the query,
# free its resource-group slot, and drain its memory reservations to
# zero). Run via run_hung_operator_case / run_abandoned_client_case.
TIMEBOUND_CLASSES = (
    "hung_operator",
    "abandoned_client",
)

# serving scenarios: faults injected while a POPULATION of
# concurrent HTTP clients is mid-traffic, not around one query in
# isolation — recovery must stay correct when retries contend with
# live load for workers, memory, and admission slots. Every query must
# end oracle-equal, shed (429), or as a TYPED failure, and every client
# thread must come back (no hangs). Run via run_loaded_cluster_case.
SERVING_CLASSES = (
    "loaded_cluster",
)

# adaptive scenarios: the loaded-cluster fault burst + the
# mid-traffic drain, on a population whose session runs ADAPTIVELY — a
# query mix seeded with a misestimated join so the coordinator is
# re-planning mid-query while workers crash and drain out from under
# it. Re-planned queries must stay oracle-equal and the run must record
# at least one re-plan (otherwise the scenario proved nothing). Run via
# run_adaptive_drain_case.
ADAPTIVE_CLASSES = (
    "adaptive_loaded_drain",
)

# recovery scenarios: chunk-granular checkpoint/resume for the
# mesh plane (trino_tpu/recovery/). The injector schedules above land
# on the page/FTE planes; these land INSIDE the mesh chunk loop via
# parallel.mesh_chunk.MESH_FAULT_HOOK — a seeded chunk boundary raises
# MeshStuck (the watchdog classification) or MeshDeviceLost (device
# loss), and the run must RESUME from its last checkpoint: oracle-equal
# rows AND strictly fewer re-executed chunks than restarting from chunk
# 0. Run via run_mesh_recovery_case.
RECOVERY_CLASSES = (
    "mesh_fault_mid_chunk",
    "device_lost_resume",
)

REPLICA_CLASSES = (
    "replica_down_mid_serve",
    "replica_drain_under_load",
)

# preemptive multi-tenancy scenarios: the chunk-granular mesh
# scheduler (runtime/scheduler.py) under adversity. A fast-lane point
# lookup parks a streaming analytic at a seeded chunk boundary, then a
# device loss lands AFTER the resume — the checkpoint machinery must
# compose with parked state (park -> resume -> fault -> in-run resume,
# all in one run, byte-identical, nothing re-executed). And a replica
# drain surfacing while a query sits PARKED must raise out of the
# parked wait and resume the query from its parked host-portable
# snapshot on the sibling sub-mesh. Run via run_preempt_park_resume_case
# / run_preempt_under_drain_case.
PREEMPT_CLASSES = (
    "preempt_park_resume",
    "preempt_under_drain",
)

# multi-host fabric scenarios: the checkpoint transport and
# membership tier (runtime/fabric.py) under adversity. host_lost_mid_
# chunk wipes the local checkpoint store at a seeded boundary (the
# whole "host" dies, not just a sub-mesh) — failover must PULL the last
# pushed snapshot from a fabric peer and resume with zero re-executed
# chunk-steps. membership_flap leaves-and-rejoins the sibling replica
# mid-fault — the membership epoch must advance, a second claim on an
# owned query must be refused (no double placement across epochs), and
# the query still completes oracle-equal. transport_corruption serves
# bit-flipped payloads from the peer — the digest check must reject
# them (fabric.digest_rejects) so failover degrades to a clean restart,
# never a resume from corrupt carries. Run via run_host_lost_case /
# run_membership_flap_case / run_transport_corruption_case.
FABRIC_CLASSES = (
    "host_lost_mid_chunk",
    "membership_flap",
    "transport_corruption",
)

# the chaos smoke's statements (the reference's bench.py --chaos-smoke
# runs these): the replica scenarios' client population draws from them
CHAOS_QUERIES = {
    "agg": (
        "select l_returnflag, l_linestatus, sum(l_quantity), count(*) "
        "from lineitem where l_shipdate <= date '1998-09-02' "
        "group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus"
    ),
    "join": (
        "select n_name, count(*) c from supplier, nation "
        "where s_nationkey = n_nationkey group by n_name order by n_name"
    ),
}


def generate_schedule(
    seed: int,
    fault_class: str,
    n_partitions: int = 2,
    n_rules: int = 2,
    stall_s: float = 1.0,
) -> List[dict]:
    """Deterministic fault schedule: FailureRule kwargs drawn from
    random.Random(seed). Same (seed, fault_class) -> same schedule."""
    if fault_class not in FAULT_CLASSES:
        raise ValueError(f"unknown fault class: {fault_class}")
    rng = random.Random(seed)
    rules: List[dict] = []
    for _ in range(n_rules):
        p = rng.randrange(n_partitions)
        if fault_class == "task_crash_start":
            rules.append(dict(
                where="start", kind="crash", partition=p,
                attempts=(0,), max_hits=1,
            ))
        elif fault_class == "task_crash_mid":
            rules.append(dict(
                where="mid", kind="crash", partition=p,
                attempts=(0,), max_hits=1,
            ))
        elif fault_class == "fetch_loss":
            rules.append(dict(
                where="fetch", kind="fetch_loss", partition=p,
                attempts=(0, 1), max_hits=rng.randint(1, 3),
            ))
        elif fault_class == "straggler":
            # one stall is enough to drive speculation; more would just
            # serialize the test
            if not rules:
                rules.append(dict(
                    where="start", partition=p, attempts=(0,),
                    stall_s=stall_s + rng.random(), max_hits=1,
                ))
        elif fault_class == "oom":
            rules.append(dict(
                where="start", kind="oom", partition=p,
                attempts=(0,), max_hits=1,
            ))
    return rules


def schedule_max_failures(rules: List[dict]) -> int:
    """Upper bound on injected failures a schedule can cause — the
    bounded-attempt assertion compares observed retries against this."""
    return sum(r.get("max_hits", 0) for r in rules if r.get("stall_s", 0) == 0)


def run_mesh_recovery_case(
    sql: str, fault_class: str, seed: int,
    checkpoint_interval: int = 1, mesh_chunk_rows: int = 256,
    device=None, mesh_devices=None,
) -> Tuple[List[list], dict]:
    """One seeded mesh fault mid-chunk against an in-process (mesh-
    colocated) runner with chunk checkpointing on. The fault chunk is
    drawn deterministically from the seed once the chunk count is known
    (same seed -> same boundary), fires exactly once, and the run must
    resume from its last checkpoint rather than restart: the report's
    executed_chunk_steps counts every chunk step across attempts, so
    `executed_chunk_steps - chunks` is the number of RE-executed chunks
    (a restart-from-zero re-executes all `fault_chunk` completed ones)."""
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.runtime.coordinator import DistributedQueryRunner

    if fault_class not in RECOVERY_CLASSES:
        raise ValueError(f"unknown recovery fault class: {fault_class}")
    exc = (
        mesh_chunk.MeshStuck
        if fault_class == "mesh_fault_mid_chunk"
        else mesh_chunk.MeshDeviceLost
    )
    runner = DistributedQueryRunner(
        Session(
            catalog="tpch", schema="tiny",
            mesh_chunk_rows=mesh_chunk_rows,
            mesh_checkpoint_interval_chunks=checkpoint_interval,
        ),
        n_workers=2, hash_partitions=2, device=device, mesh_devices=mesh_devices,
    )
    runner.register_catalog("tpch", create_tpch_connector())
    expected = runner.execute(sql).rows  # warm run doubles as oracle
    mesh_clean = runner._last_data_plane == "mesh"
    rng = random.Random(seed)
    state = {"target": None, "fired": 0}

    def hook(k: int, K: int) -> None:
        if state["target"] is None:
            # any boundary but 0: chunk 0 never has a checkpoint below
            # it (tests/test_recovery.py covers the k=0 degenerate)
            state["target"] = 1 + rng.randrange(max(K - 1, 1))
        if k == state["target"] and not state["fired"]:
            state["fired"] = 1
            raise exc(f"chaos[{fault_class}]: injected at chunk {k}/{K}")

    mesh_chunk.MESH_FAULT_HOOK = hook
    try:
        rows = runner.execute(sql).rows
    finally:
        mesh_chunk.MESH_FAULT_HOOK = None
    info = mesh_chunk.last_run_info()
    report = {
        "mesh_clean_plane": mesh_clean,
        "mesh_fault_plane": runner._last_data_plane,
        "fault_chunk": state["target"],
        "fired": state["fired"],
        "chunks": info.get("chunks"),
        "executed_chunk_steps": info.get("executed_chunk_steps"),
        "resumes": info.get("resumes"),
        "resumed_from_chunk": info.get("resumed_from_chunk"),
        "expected": expected,
    }
    return rows, report


def run_preempt_park_resume_case(
    sql: str, seed: int, mesh_chunk_rows: int = 256,
    device=None, mesh_devices=None,
) -> Tuple[List[list], dict]:
    """Park/resume composed with checkpoint recovery in ONE run: a
    fast-lane point lookup arrives at a seeded chunk boundary and parks
    the analytic (device carries snapshot to host, lookup runs, resume
    from chunk k warm); then a MeshDeviceLost lands at a later seeded
    boundary and the run must resume IN-RUN from its last checkpoint.
    Oracle-equal rows, exactly one park/unpark, at least one resume,
    and zero re-executed chunk-steps across the whole maneuver."""
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.runtime.coordinator import DistributedQueryRunner

    point = (
        "select n_name, r_name from nation join region "
        "on n_regionkey = r_regionkey where n_nationkey = 3"
    )
    runner = DistributedQueryRunner(
        Session(
            catalog="tpch", schema="tiny",
            mesh_chunk_rows=mesh_chunk_rows,
            mesh_checkpoint_interval_chunks=1,
            mesh_resume_attempts=1,
        ),
        n_workers=2, hash_partitions=2, device=device, mesh_devices=mesh_devices,
    )
    runner.register_catalog("tpch", create_tpch_connector())
    expected = runner.execute(sql).rows  # warm run doubles as oracle
    mesh_clean = runner._last_data_plane == "mesh"
    point_expected = runner.execute(point).rows
    rng = random.Random(seed)
    state = {
        "park_target": None, "fault_target": None,
        "parked": 0, "faulted": 0, "point_rows": None,
    }
    case_thread = threading.current_thread()

    def hook(k: int, K: int) -> None:
        if threading.current_thread() is not case_thread:
            return  # the point lookup's own chunk loop
        if state["park_target"] is None:
            # the park lands at park_target+1; the device loss lands
            # strictly after the resume so both maneuvers compose
            state["park_target"] = rng.randrange(max(K - 2, 1))
            state["fault_target"] = (
                state["park_target"] + 1
                + rng.randrange(max(K - state["park_target"] - 2, 1))
            )
        if k == state["park_target"] and not state["parked"]:
            state["parked"] = 1

            def run_point():
                state["point_rows"] = runner.execute(point).rows

            threadreg.spawn("chaos-point-query", run_point, owner="chaos")
            # hold this boundary until the fast seat is queued, so the
            # NEXT boundary deterministically parks
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                sched = runner._mesh_scheduler
                if sched is not None and sched.waiting_count(fast=True):
                    break
                time.sleep(0.002)
            return
        if (
            k == state["fault_target"]
            and state["parked"]
            and not state["faulted"]
        ):
            state["faulted"] = 1
            raise mesh_chunk.MeshDeviceLost(
                f"chaos[preempt_park_resume]: device loss at chunk "
                f"{k}/{K} after the park/resume cycle"
            )

    mesh_chunk.MESH_FAULT_HOOK = hook
    try:
        rows = runner.execute(sql).rows
    finally:
        mesh_chunk.MESH_FAULT_HOOK = None
    deadline = time.monotonic() + 10.0
    while state["point_rows"] is None and time.monotonic() < deadline:
        time.sleep(0.002)
    info = mesh_chunk.last_run_info()
    report = {
        "mesh_clean_plane": mesh_clean,
        "mesh_fault_plane": runner._last_data_plane,
        "park_chunk": (
            None if state["park_target"] is None
            else state["park_target"] + 1
        ),
        "fault_chunk": state["fault_target"],
        "parked": state["parked"],
        "faulted": state["faulted"],
        "chunks": info.get("chunks"),
        "executed_chunk_steps": info.get("executed_chunk_steps"),
        "parks": info.get("parks"),
        "unparks": info.get("unparks"),
        "resumes": info.get("resumes"),
        "point_ok": state["point_rows"] == point_expected,
        "expected": expected,
    }
    return rows, report


def run_preempt_under_drain_case(
    sql: str, seed: int, mesh_chunk_rows: int = 256,
    device=None, mesh_devices=None,
) -> Tuple[List[list], dict]:
    """A replica drain surfacing while a query sits PARKED: a fast seat
    parks the analytic at a seeded boundary, then the victim replica is
    drained while the query is in the parked wait. The drain must raise
    MeshReplicaDraining OUT of the parked wait, keep the parked
    host-portable snapshot, and resume the query on the sibling
    sub-mesh from exactly the park boundary — oracle-equal, nothing
    re-executed, and the victim quiesces."""
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.recovery import CHECKPOINTS
    from trino_tpu_torch.runtime.coordinator import DistributedQueryRunner
    from trino_tpu_torch.runtime.metrics import METRICS

    runner = DistributedQueryRunner(
        Session(
            catalog="tpch", schema="tiny",
            mesh_replicas=2,
            mesh_chunk_rows=mesh_chunk_rows,
            mesh_checkpoint_interval_chunks=1,
            mesh_resume_attempts=0,
        ),
        n_workers=2, hash_partitions=2, device=device, mesh_devices=mesh_devices,
    )
    runner.register_catalog("tpch", create_tpch_connector())
    # sequential placements alternate replicas: two rounds warm both
    # sub-meshes, so the sibling resume builds no program
    expected = runner.execute(sql).rows
    runner.execute(sql)
    mesh_clean = runner._last_data_plane == "mesh"
    rm = runner._replicas
    rng = random.Random(seed)
    state = {
        "target": None, "victim": None, "fake": None,
        "parked": 0, "drained": 0,
    }

    def drain_when_parked(victim: int) -> None:
        vic = rm.replicas[victim]
        parks0 = vic.scheduler.parks
        state["fake"] = vic.scheduler.submit(
            "chaos-fast-seat", fast=True
        )
        # synthetic waiter: never calls acquire, so mark it ready by
        # hand — only ready waiters exert preemption pressure
        state["fake"].ready = True
        deadline = time.monotonic() + 10.0
        while (
            vic.scheduler.parks <= parks0
            and time.monotonic() < deadline
        ):
            time.sleep(0.002)
        if vic.scheduler.parks > parks0:
            state["parked"] = 1
            state["drained"] = 1
            rm.request_drain(victim)

    def hook(k: int, K: int) -> None:
        rep = mesh_chunk.active_replica()
        if rep is None:
            return
        if state["target"] is None:
            state["target"] = rng.randrange(max(K - 2, 1))
        if k == state["target"] and state["victim"] is None:
            state["victim"] = rep
            threadreg.spawn(
                "chaos-drain-when-parked", drain_when_parked, args=(rep,),
                owner="chaos",
            )
            # hold this boundary until the fast seat is queued: the
            # next boundary parks, and the side thread drains the
            # victim while the query sits parked
            vic = rm.replicas[rep]
            deadline = time.monotonic() + 10.0
            while (
                not vic.scheduler.waiting_count(fast=True)
                and time.monotonic() < deadline
            ):
                time.sleep(0.002)

    failovers0 = rm.failovers
    resumed0 = CHECKPOINTS.resumed
    steps0 = METRICS.snapshot().get("mesh.chunk_steps", 0.0)
    mesh_chunk.MESH_FAULT_HOOK = hook
    try:
        rows = runner.execute(sql).rows
    finally:
        mesh_chunk.MESH_FAULT_HOOK = None
        if state["fake"] is not None and state["victim"] is not None:
            rm.replicas[state["victim"]].scheduler.finish(state["fake"])
    info = mesh_chunk.last_run_info()
    quiesced = bool(
        state["drained"]
        and state["victim"] is not None
        and rm.drain(state["victim"], timeout_s=30.0)
    )
    if quiesced:
        rm.undrain(state["victim"])
    report = {
        "mesh_clean_plane": mesh_clean,
        "mesh_fault_plane": runner._last_data_plane,
        "park_chunk": (
            None if state["target"] is None else state["target"] + 1
        ),
        "parked": state["parked"],
        "drain_requested": state["drained"],
        "replica_drained": quiesced,
        "failovers": rm.failovers - failovers0,
        "checkpoint_resumes": CHECKPOINTS.resumed - resumed0,
        "chunks": info.get("chunks"),
        "resumed_from_chunk": info.get("resumed_from_chunk"),
        "chunk_steps": int(
            METRICS.snapshot().get("mesh.chunk_steps", 0.0) - steps0
        ),
        "expected": expected,
    }
    return rows, report


def _fabric_case_runner(srv_uri: str, mesh_chunk_rows: int,
                        resume_attempts: int = 1, device=None, mesh_devices=None):
    """Replicated runner whose session attaches the checkpoint fabric
    to one peer endpoint (the chaos cases' simulated surviving host)."""
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.runtime.coordinator import DistributedQueryRunner

    runner = DistributedQueryRunner(
        Session(
            catalog="tpch", schema="tiny",
            mesh_chunk_rows=mesh_chunk_rows,
            mesh_checkpoint_interval_chunks=1,
            mesh_replicas=2,
            mesh_resume_attempts=resume_attempts,
            fabric_peers=srv_uri,
        ),
        n_workers=2, hash_partitions=2, device=device, mesh_devices=mesh_devices,
    )
    runner.register_catalog("tpch", create_tpch_connector())
    return runner


def run_host_lost_case(
    sql: str, seed: int, mesh_chunk_rows: int = 256,
    device=None, mesh_devices=None,
) -> Tuple[List[list], dict]:
    """Hard host loss mid-chunk with the fabric attached: at a seeded
    boundary the LOCAL checkpoint store is wiped (the host's memory
    died with it) and the active sub-mesh raises MeshDeviceLost. The
    coordinator's failover must find the local store empty, PULL the
    last pushed snapshot from the fabric peer, and resume the query on
    the sibling from exactly the fault boundary — oracle-equal with
    zero re-executed chunk-steps."""
    import os

    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.recovery.checkpoint import (
        CHECKPOINTS,
        MeshCheckpointStore,
    )
    from trino_tpu_torch.runtime.fabric import (
        HostFabric,
        active_fabric,
        stop_fabric,
    )
    from trino_tpu_torch.runtime.http import FabricServer
    from trino_tpu_torch.runtime.metrics import METRICS

    secret = os.environ.setdefault(
        "TRINO_TPU_INTERNAL_SECRET", "chaos-fabric"
    )
    peer_store = MeshCheckpointStore()
    peer = HostFabric(store=peer_store, host_id="chaos-peer")
    srv = FabricServer(peer, internal_secret=secret)
    stop_fabric()  # fresh attachment: the session below re-binds it
    runner = _fabric_case_runner(srv.uri, mesh_chunk_rows, device=device,
                                 mesh_devices=mesh_devices)
    try:
        expected = runner.execute(sql).rows  # warm run doubles as oracle
        mesh_clean = runner._last_data_plane == "mesh"
        rng = random.Random(seed)
        state = {"target": None, "fired": 0}

        def hook(k: int, K: int) -> None:
            if state["target"] is None:
                state["target"] = 1 + rng.randrange(max(K - 1, 1))
            if k == state["target"] and not state["fired"]:
                state["fired"] = 1
                fab = active_fabric()
                if fab is not None:
                    # the host's last push must be on the wire before
                    # it dies — the smoke's victim does the same flush
                    fab.pusher.flush(10.0)
                CHECKPOINTS.clear()  # the store dies with the host
                raise mesh_chunk.MeshDeviceLost(
                    f"chaos[host_lost_mid_chunk]: host lost at "
                    f"chunk {k}/{K}"
                )

        before = METRICS.snapshot()
        mesh_chunk.MESH_FAULT_HOOK = hook
        try:
            rows = runner.execute(sql).rows
        finally:
            mesh_chunk.MESH_FAULT_HOOK = None
        after = METRICS.snapshot()
        info = mesh_chunk.last_run_info()
        report = {
            "mesh_clean_plane": mesh_clean,
            "mesh_fault_plane": runner._last_data_plane,
            "fault_chunk": state["target"],
            "fired": state["fired"],
            "chunks": info.get("chunks"),
            "executed_chunk_steps": info.get("executed_chunk_steps"),
            "resumes": info.get("resumes"),
            "resumed_from_chunk": info.get("resumed_from_chunk"),
            "pushes": int(
                after.get("fabric.pushes", 0) - before.get("fabric.pushes", 0)
            ),
            "pulls": int(
                after.get("fabric.pulls", 0) - before.get("fabric.pulls", 0)
            ),
            "peer_served": peer.served,
            "expected": expected,
        }
        return rows, report
    finally:
        stop_fabric()
        srv.stop()


def run_membership_flap_case(
    sql: str, seed: int, mesh_chunk_rows: int = 256,
    device=None, mesh_devices=None,
) -> Tuple[List[list], dict]:
    """A membership flap racing a failover: at a seeded boundary the
    SIBLING replica leaves and immediately rejoins (epoch advances
    twice), a second claim on the in-flight query is attempted and must
    be REFUSED (exactly one owner per query, across epochs), then the
    active sub-mesh dies. Failover lands on the freshly rejoined
    sibling — whose join epoch matches the post-flap fault epoch, so
    the resume proceeds from checkpoint — and the query completes
    oracle-equal with the ownership map drained."""
    from trino_tpu_torch.parallel import mesh_chunk

    runner = _fabric_case_runner("", mesh_chunk_rows, resume_attempts=0, device=device,
                                 mesh_devices=mesh_devices)
    rm = runner._replica_manager()
    expected = runner.execute(sql).rows
    mesh_clean = runner._last_data_plane == "mesh"
    rng = random.Random(seed)
    epoch0 = rm.membership_epoch
    state = {
        "target": None, "fired": 0, "flapped": 0, "double_refused": -1,
    }

    def hook(k: int, K: int) -> None:
        if state["target"] is None:
            state["target"] = 1 + rng.randrange(max(K - 1, 1))
        if k == state["target"] and not state["fired"]:
            state["fired"] = 1
            owners = dict(rm._owners)
            if owners:
                qid, (rid, _ep) = next(iter(owners.items()))
                sib = rm.replicas[1 - rid]
                state["double_refused"] = int(not rm.claim(qid, sib))
            sib_id = 1 - (mesh_chunk.active_replica() or 0)
            rm.leave(sib_id)
            rm.join(sib_id)
            state["flapped"] = 1
            raise mesh_chunk.MeshDeviceLost(
                f"chaos[membership_flap]: sub-mesh lost at chunk {k}/{K} "
                f"with replica {sib_id} mid-flap"
            )

    mesh_chunk.MESH_FAULT_HOOK = hook
    try:
        rows = runner.execute(sql).rows
    finally:
        mesh_chunk.MESH_FAULT_HOOK = None
    info = mesh_chunk.last_run_info()
    report = {
        "mesh_clean_plane": mesh_clean,
        "mesh_fault_plane": runner._last_data_plane,
        "fault_chunk": state["target"],
        "fired": state["fired"],
        "flapped": state["flapped"],
        "double_refused": state["double_refused"],
        "epoch_delta": rm.membership_epoch - epoch0,
        "joins": rm.joins,
        "leaves": rm.leaves,
        "epoch_fences": rm.epoch_fences,
        "owners_at_end": len(rm._owners),
        "chunks": info.get("chunks"),
        "executed_chunk_steps": info.get("executed_chunk_steps"),
        "resumes": info.get("resumes"),
        "expected": expected,
    }
    return rows, report


def run_transport_corruption_case(
    sql: str, seed: int, mesh_chunk_rows: int = 256,
    device=None, mesh_devices=None,
) -> Tuple[List[list], dict]:
    """Transport corruption on the failover pull: the peer serves a
    BIT-FLIPPED payload under the original digest (in-flight
    corruption). The digest check must reject it (fabric.digest_rejects
    grows, fabric.pulls does not), try_pull returns False, and the
    failover degrades to a CLEAN restart on the sibling — oracle-equal
    rows, never a resume from corrupt carries. A truncated payload with
    a matching digest is also pushed at the receive side and must come
    back `imported: False` (undecodable bytes never poison a store)."""
    import os

    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.recovery.checkpoint import (
        CHECKPOINTS,
        MeshCheckpointStore,
    )
    from trino_tpu_torch.runtime.fabric import (
        HostFabric,
        active_fabric,
        checkpoint_digest,
        encode_key,
        stop_fabric,
    )
    from trino_tpu_torch.runtime.http import FabricServer
    from trino_tpu_torch.runtime.metrics import METRICS

    class _CorruptingFabric(HostFabric):
        def serve_checkpoint(self, ekey):
            out = HostFabric.serve_checkpoint(self, ekey)
            if out is None:
                return None
            data, digest = out
            bad = bytearray(data)
            bad[len(bad) // 2] ^= 0xFF
            return bytes(bad), digest  # digest of the ORIGINAL bytes

    secret = os.environ.setdefault(
        "TRINO_TPU_INTERNAL_SECRET", "chaos-fabric"
    )
    peer_store = MeshCheckpointStore()
    peer = _CorruptingFabric(store=peer_store, host_id="chaos-corrupt")
    srv = FabricServer(peer, internal_secret=secret)
    stop_fabric()
    runner = _fabric_case_runner(srv.uri, mesh_chunk_rows, device=device,
                                 mesh_devices=mesh_devices)
    try:
        expected = runner.execute(sql).rows
        mesh_clean = runner._last_data_plane == "mesh"
        rng = random.Random(seed)
        state = {"target": None, "fired": 0, "truncated_import": None}

        def hook(k: int, K: int) -> None:
            if state["target"] is None:
                state["target"] = 1 + rng.randrange(max(K - 1, 1))
            if k == state["target"] and not state["fired"]:
                state["fired"] = 1
                fab = active_fabric()
                if fab is not None:
                    fab.pusher.flush(10.0)
                # receive-side truncation probe while the peer holds a
                # live entry: decodes to garbage -> imported False
                for key in list(peer_store._entries):
                    data = peer_store.export_bytes(key)
                    if data is None:
                        continue
                    cut = data[: len(data) // 2]
                    r = peer.receive_checkpoint(
                        encode_key(key), cut, checkpoint_digest(cut)
                    )
                    state["truncated_import"] = r.get("imported")
                    break
                CHECKPOINTS.clear()
                raise mesh_chunk.MeshDeviceLost(
                    f"chaos[transport_corruption]: host lost at "
                    f"chunk {k}/{K}; peer payloads corrupt"
                )

        before = METRICS.snapshot()
        mesh_chunk.MESH_FAULT_HOOK = hook
        try:
            rows = runner.execute(sql).rows
        finally:
            mesh_chunk.MESH_FAULT_HOOK = None
        after = METRICS.snapshot()
        info = mesh_chunk.last_run_info()
        report = {
            "mesh_clean_plane": mesh_clean,
            "mesh_fault_plane": runner._last_data_plane,
            "fault_chunk": state["target"],
            "fired": state["fired"],
            "truncated_import": state["truncated_import"],
            "chunks": info.get("chunks"),
            "executed_chunk_steps": info.get("executed_chunk_steps"),
            "resumes": info.get("resumes"),
            "digest_rejects": int(
                after.get("fabric.digest_rejects", 0)
                - before.get("fabric.digest_rejects", 0)
            ),
            "pulls": int(
                after.get("fabric.pulls", 0) - before.get("fabric.pulls", 0)
            ),
            "expected": expected,
        }
        return rows, report
    finally:
        stop_fabric()
        srv.stop()


class DownableWorker:
    """Proxy handle that can be taken down (every call raises
    ConnectionError) and counts launches — the graylist assertions need
    'zero create_task calls while the breaker is open', and the drain
    assertions need 'zero ACCEPTED launches after the drain landed'
    (accepted_creates is bumped only after the worker took the task, so
    it structurally cannot grow once the worker's state flipped to
    shutting_down — a racing create raises instead)."""

    def __init__(self, inner):
        self._inner = inner
        self.worker_id = inner.worker_id
        self.down = False
        self.create_calls = 0
        self.accepted_creates = 0

    def _check(self) -> None:
        if self.down:
            raise ConnectionError(f"worker {self.worker_id} is down")

    def create_task(self, spec):
        self.create_calls += 1
        self._check()
        out = self._inner.create_task(spec)
        self.accepted_creates += 1
        return out

    def task_state(self, task_id) -> dict:
        self._check()
        return self._inner.task_state(task_id)

    def get_results(self, task_id, partition, token,
                    max_pages=16, wait=0.0):
        self._check()
        return self._inner.get_results(
            task_id, partition, token, max_pages, wait
        )

    def remove_task(self, task_id) -> None:
        self._check()
        self._inner.remove_task(task_id)

    def results_location(self, task_id):
        return self._inner.results_location(task_id)

    def status(self) -> dict:
        self._check()
        return self._inner.status()

    def fail_query(self, query_id, message) -> None:
        self._check()
        self._inner.fail_query(query_id, message)

    def shutdown_gracefully(self) -> None:
        # drain must go through even on a flaky node — request_drain
        # treats delivery as best-effort anyway
        self._inner.shutdown_gracefully()

    # -- stuck-task watchdog passthrough --
    def watchdog_once(self, now=None):
        return self._inner.watchdog_once(now)

    def start_watchdog(self, poll_s: float = 0.01) -> None:
        self._inner.start_watchdog(poll_s)

    def stop_watchdog(self) -> None:
        self._inner.stop_watchdog()

    @property
    def watchdog_interrupts(self):
        return self._inner.watchdog_interrupts

    @property
    def state(self):
        return getattr(self._inner, "state", "active")

    @property
    def memory_pool(self):
        return getattr(self._inner, "memory_pool", None)


def _norm_rows(rows: List[list]) -> List[tuple]:
    """Comparable row form: floats rounded so recomputation noise (a
    retried attempt re-reduces in a different order) doesn't read as
    corruption."""
    out = []
    for r in rows:
        out.append(tuple(
            round(v, 6) if isinstance(v, float) else v for v in r
        ))
    return out


def rows_equal(a: List[list], b: List[list], ordered: bool = False) -> bool:
    na, nb = _norm_rows(a), _norm_rows(b)
    if ordered:
        return na == nb
    key = repr
    return sorted(na, key=key) == sorted(nb, key=key)


class ChaosHarness:
    """One FTE cluster with a shared FailureInjector: run queries under
    generated fault schedules and compare against a clean run.

    The harness owns N in-process workers behind the coordinator's
    worker_handles path (the FTE topology tests use), a NodeManager with
    circuit breakers, and the spooling exchange. `run_case` returns
    (rows, stats) where stats carries the FTE retry counters for
    bounded-attempt assertions.
    """

    def __init__(
        self,
        n_workers: int = 2,
        session=None,
        catalogs: Optional[Dict[str, object]] = None,
        hash_partitions: int = 2,
        memory_pool_bytes: Optional[int] = None,
        stuck_task_interrupt_s: Optional[float] = None,
        stuck_task_interrupt_warm_s: Optional[float] = None,
        in_process: bool = False,
        device=None,
        mesh_devices=None,
    ):
        from trino_tpu_torch.engine import Session
        from trino_tpu_torch.runtime.coordinator import DistributedQueryRunner
        from trino_tpu_torch.runtime.failure import FailureInjector
        from trino_tpu_torch.runtime.worker import Worker

        self.injector = FailureInjector()
        self.session = session or Session(
            catalog="tpch", schema="tiny", retry_policy="task"
        )
        from trino_tpu_torch.connectors.spi import CatalogManager

        self._catalogs = CatalogManager()
        self.in_process = in_process
        if in_process:
            # the mesh plane only engages on COLOCATED (engine-owned)
            # workers, so the recovery drain case builds the runner on
            # the n_workers path and exposes its Workers for the drain
            # bookkeeping. Injector schedules do not land here — mesh
            # faults arrive through MESH_FAULT_HOOK instead.
            self.stuck_task_interrupt_s = stuck_task_interrupt_s
            self.runner = DistributedQueryRunner(
                self.session,
                n_workers=n_workers,
                hash_partitions=hash_partitions,
                device=device,
                mesh_devices=mesh_devices,
            )
            self.workers = list(self.runner.workers)
            for name, conn in (catalogs or {}).items():
                self.register_catalog(name, conn)
            return
        # every worker sits behind a DownableWorker proxy so lifecycle
        # cases can count ACCEPTED launches (drain assertions) and take
        # nodes dark (graylist assertions) without touching the engine
        self.workers = [
            DownableWorker(Worker(
                f"chaos-w{i}", self._catalogs,
                failure_injector=self.injector,
                memory_pool_bytes=memory_pool_bytes,
                stuck_task_interrupt_s=stuck_task_interrupt_s,
                stuck_task_interrupt_warm_s=stuck_task_interrupt_warm_s,
                device=device,
            ))
            for i in range(n_workers)
        ]
        # NOTE: workers carry the watchdog threshold but it is NOT
        # armed here — run_hung_operator_case arms it around its own
        # execution, after a warm run has built every kernel and program
        # the plan needs. Armed from birth, the watchdog would kill
        # healthy COLD tasks (first-use kernel builds and connector data
        # generation happen inside one batch and dwarf any test-speed
        # threshold), and each retry would re-block on the same warm-up.
        self.stuck_task_interrupt_s = stuck_task_interrupt_s
        self.runner = DistributedQueryRunner(
            self.session,
            worker_handles=self.workers,
            hash_partitions=hash_partitions,
            device=device,
        )
        for name, conn in (catalogs or {}).items():
            self.register_catalog(name, conn)

    def register_catalog(self, name: str, connector) -> None:
        # planner-side AND worker-side (worker_handles topologies load
        # catalogs per node, as the reference does)
        self.runner.register_catalog(name, connector)
        self._catalogs.register(name, connector)

    def run_clean(self, sql: str) -> List[list]:
        self.injector.clear()
        return self.runner.execute(sql).rows

    def run_case(
        self, sql: str, fault_class: str, seed: int,
        n_partitions: int = 2,
    ) -> Tuple[List[list], dict]:
        """Run one query under one generated fault schedule."""
        rules = generate_schedule(seed, fault_class, n_partitions)
        self.injector.clear()
        for r in rules:
            self.injector.inject(**r)
        try:
            rows = self.runner.execute(sql).rows
        finally:
            self.injector.clear()
        stats = dict(self.runner.last_fte_stats or {})
        stats["max_injected_failures"] = schedule_max_failures(rules)
        stats["breakers"] = self.runner.node_manager.breaker_states()
        return rows, stats

    # -- cluster-lifecycle scenarios (graceful drain + speculation) --

    def run_lifecycle_case(
        self, sql: str, scenario: str, seed: int = 0,
    ) -> Tuple[List[list], dict]:
        """Drains are one-way (a drained node never rejoins), so run
        each lifecycle case on a FRESH harness."""
        if scenario == "drain_mid_query":
            return self.run_drain_case(sql, seed)
        if scenario == "drain_all_but_one":
            return self.run_drain_case(sql, seed, drain_all_but_one=True)
        if scenario == "straggler_speculation":
            return self.run_speculation_case(sql, seed)
        raise ValueError(f"unknown lifecycle scenario: {scenario}")

    def run_drain_case(
        self, sql: str, seed: int = 0, drain_all_but_one: bool = False,
        stall_s: float = 0.8, drain_timeout_s: float = 60.0,
    ) -> Tuple[List[list], dict]:
        """Gracefully drain worker(s) while `sql` is mid-flight.

        Every first attempt is stretched by `stall_s` so the drain is
        guaranteed to land on a node with running tasks. Returns (rows,
        report); report carries per-victim drain verdicts plus the
        accepted-launch counter at drain time vs end of query — equal
        counters prove the drained node took ZERO post-drain launches.
        """
        rng = random.Random(seed)
        self.injector.clear()
        self.injector.inject(
            where="start", attempts=(0,), stall_s=stall_s,
            max_hits=4 * len(self.workers),
        )
        result: dict = {}

        def run():
            try:
                result["rows"] = self.runner.execute(sql).rows
            except Exception as e:
                result["error"] = e

        t = threadreg.spawn("chaos-query-driver", run, owner="chaos")
        # drain a node that ACTUALLY hosts work: wait for launches
        deadline = time.monotonic() + 10.0
        busy: List[DownableWorker] = []
        while time.monotonic() < deadline and t.is_alive():
            busy = [w for w in self.workers if w.accepted_creates > 0]
            if busy:
                break
            time.sleep(0.002)
        if drain_all_but_one:
            victims = self.workers[:-1]
        else:
            victims = [busy[rng.randrange(len(busy))] if busy
                       else self.workers[0]]
        drained: Dict[str, bool] = {}
        at_drain: Dict[str, int] = {}
        for v in victims:
            drained[v.worker_id] = self.runner.drain(
                v.worker_id, timeout_s=drain_timeout_s
            )
            at_drain[v.worker_id] = v.accepted_creates
        t.join(120.0)
        self.injector.clear()
        if "error" in result:
            raise result["error"]
        report = dict(self.runner.last_fte_stats or {})
        report.update(
            drained=drained,
            launches_at_drain=at_drain,
            launches_at_end={
                v.worker_id: v.accepted_creates for v in victims
            },
            node_states=self.runner.node_manager.all_states(),
        )
        return result.get("rows"), report

    def run_speculation_case(
        self, sql: str, seed: int = 0, stall_s: float = 6.0,
    ) -> Tuple[List[list], dict]:
        """One partition's first attempt stalls hard; the speculative
        duplicate on a spare worker must commit first (stats carry
        speculation_wins/losses and attempts_per_partition).

        stall_s must comfortably exceed the query's REAL per-task wall
        time: the trigger is `age > speculation_quantile * median`, and
        a stalled attempt's age only reaches `stall + wall`, so a stall
        close to the task wall never crosses 2x median and the scenario
        silently degrades to a plain wait. The duplicate wins and
        cancels the stalled loser cooperatively, so a healthy run never
        waits out the full stall."""
        rng = random.Random(seed)
        self.injector.clear()
        # pin the stall to fragment 0 (the leaf stage, one task per
        # worker): speculation needs sibling attempts to commit first so
        # a median exists — a stall on a single-task fragment can never
        # speculate and the scenario would silently degrade to a wait
        self.injector.inject(
            where="start", fragment_id=0, partition=rng.randrange(2),
            attempts=(0,), stall_s=stall_s, max_hits=1,
        )
        try:
            rows = self.runner.execute(sql).rows
        finally:
            self.injector.clear()
        return rows, dict(self.runner.last_fte_stats or {})

    # -- time-bounding scenarios (watchdog + client-abandonment reaper) --

    def run_hung_operator_case(
        self, sql: str, seed: int = 0, stall_s: float = 8.0,
    ) -> Tuple[List[list], dict]:
        """One leaf task WEDGES mid-batch (a hung operator, not a slow
        one: its heartbeat goes stale, where a straggler's keeps
        ticking). The worker watchdog must interrupt it with a
        diagnostic naming the stuck operator; the failure is retryable,
        so FTE re-runs the partition (attempt 1 matches no rule) and the
        query completes correctly — in far less wall time than the
        stall, which is the no-query-may-hang-the-cluster property.

        The conservative threshold must comfortably exceed a cold
        task's honest silence: a fresh shape can build a kernel or a
        program INSIDE one operator call, and retries
        perturb batch capacities (dynamic-filter pruning differs per
        surviving attempt) so no warm run covers every shape. But
        operator-internal heartbeats (InstrumentedOperator._beat fires
        at entry AND exit of every add_input/get_output/finish, always
        on since exec/stats.py instrumentation became unconditional)
        mean a WARM task's longest honest silence is one operator call,
        not one batch — so stuck_task_interrupt_warm_s can run at a few
        hundred ms where the old batch-granular beats needed ~1s+."""
        rng = random.Random(seed)
        # warm run first: builds every kernel and program this plan
        # touches, so
        # once the watchdog arms, the only task that can miss a
        # heartbeat for stuck_task_interrupt_s is the genuinely wedged
        # one (a cold build inside one batch looks identical to a
        # hang at batch granularity). Its duration is the honest-work
        # baseline: the un-wedged proof is elapsed - warm < stall (the
        # injected stall abort-polls, so a killed task wakes early and
        # only a BROKEN watchdog ever waits out the full stall)
        t_warm = time.monotonic()
        self.run_clean(sql)
        warm_clean_s = time.monotonic() - t_warm
        self.injector.inject(
            where="batch", fragment_id=0, partition=rng.randrange(2),
            attempts=(0,), stall_s=stall_s, max_hits=1,
        )
        # speculation would race the watchdog to the rescue (a duplicate
        # attempt commits and cancels the wedged loser) — turn it off so
        # THIS case proves the watchdog path alone unhangs the query
        was_spec = getattr(self.session, "speculation_enabled", True)
        self.session.speculation_enabled = False
        for w in self.workers:
            w.start_watchdog()
        t0 = time.monotonic()
        try:
            rows = self.runner.execute(sql).rows
        finally:
            for w in self.workers:
                w.stop_watchdog()
            self.session.speculation_enabled = was_spec
            self.injector.clear()
        report = dict(self.runner.last_fte_stats or {})
        report["elapsed_s"] = time.monotonic() - t0
        report["warm_clean_s"] = warm_clean_s
        report["stall_s"] = stall_s
        report["watchdog_interrupts"] = [
            d for w in self.workers for _, d in w.watchdog_interrupts
        ]
        return rows, report

    def run_abandoned_client_case(
        self, sql: str, seed: int = 0, stall_s: float = 4.0,
        client_timeout_s: float = 0.2,
    ) -> Tuple[Optional[List[list]], dict]:
        """Submit through the HTTP server's job path, then VANISH —
        never poll the results page. The reaper must notice within
        client_timeout_s, cancel the query (the runner's `cancel` hook
        unwinds every running task), release the resource-group slot,
        and drain the query's memory reservations back to zero. The
        injected batch stall keeps the query mid-flight (with pages in
        memory) when abandonment lands; it abort-polls, so teardown
        never waits out the full stall."""
        from trino_tpu_torch.runtime.resource_groups import (
            ResourceGroupManager,
            ResourceGroupSpec,
        )
        from trino_tpu_torch.runtime.server import CoordinatorServer

        rg = ResourceGroupManager(
            ResourceGroupSpec("global", max_concurrency=4)
        )
        self.injector.clear()
        self.injector.inject(
            where="batch", attempts=(0,), stall_s=stall_s,
            max_hits=1_000,
        )
        server = CoordinatorServer(
            self.runner,
            resource_groups=rg,
            client_timeout_s=client_timeout_s,
            reap_interval_s=0.05,
        )

        def ledgers() -> Dict[str, Dict[str, int]]:
            return {
                w.worker_id: dict(w.memory_pool.query_reservations())
                for w in self.workers
                if w.memory_pool is not None
            }

        try:
            job = server._submit(sql)
            peak_reserved = 0
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                peak_reserved = max(
                    peak_reserved,
                    sum(sum(l.values()) for l in ledgers().values()),
                )
                if (
                    job.finished_at is not None
                    and rg.total_running() == 0
                    and all(not l for l in ledgers().values())
                ):
                    break
                time.sleep(0.01)
            report = {
                "reaped": job.state == "failed"
                and "abandoned" in (job.error or "").lower(),
                "error": job.error,
                "rg_running": rg.total_running(),
                "ledgers": ledgers(),
                "peak_reserved_bytes": peak_reserved,
            }
            return None, report
        finally:
            self.injector.clear()
            server.stop()

    def run_loaded_cluster_case(
        self, queries: Dict[str, str], seed: int = 0,
        n_clients: int = 6, duration_s: float = 3.0,
        join_timeout_s: float = 45.0,
    ) -> Tuple[None, dict]:
        """Faults under LIVE concurrent load, through the HTTP serving
        path end to end (admission lanes, plan cache, statement
        protocol). N client threads drive the query mix closed-loop
        while the fault schedule lands mid-traffic; every completion is
        checked against the clean-run oracle. Acceptable per-query
        outcomes: oracle-equal rows, an overload shed (HTTP 429), or a
        TYPED failure (a bracketed error code the client can act on).
        An untyped error or a client thread that never returns is a
        violation — under concurrency, a silent hang is the failure
        mode this case exists to catch."""
        import re
        import urllib.error

        from trino_tpu_torch.client import Client, QueryError
        from trino_tpu_torch.runtime.server import CoordinatorServer

        rng = random.Random(seed)
        self.injector.clear()
        oracle = {n: self.run_clean(sql) for n, sql in queries.items()}
        ordered = {
            n: "order by" in sql.lower() for n, sql in queries.items()
        }
        server = CoordinatorServer(self.runner, max_concurrent=n_clients)
        lock = named_lock("ChaosHarness.stats_lock")
        stats = {
            "completed": 0, "ok": 0, "mismatches": 0, "sheds": 0,
            "typed_failures": 0, "untyped_errors": [], "hung_threads": 0,
        }
        typed = re.compile(r"\[[A-Z][A-Z_]+\]")
        stop_at = time.monotonic() + duration_s

        def client_loop(i: int):
            r = random.Random(seed * 997 + i)
            c = Client(server.uri, timeout=30.0, poll_interval=0.005)
            names = list(queries)
            while time.monotonic() < stop_at:
                name = r.choice(names)
                try:
                    rows = c.execute(queries[name]).rows
                    with lock:
                        stats["completed"] += 1
                        if rows_equal(rows, oracle[name],
                                      ordered=ordered[name]):
                            stats["ok"] += 1
                        else:
                            stats["mismatches"] += 1
                except urllib.error.HTTPError as e:
                    with lock:
                        stats["completed"] += 1
                        if e.code == 429:
                            stats["sheds"] += 1
                        else:
                            stats["untyped_errors"].append(
                                f"{name}: HTTP {e.code}"
                            )
                except QueryError as e:
                    with lock:
                        stats["completed"] += 1
                        if typed.search(str(e)):
                            stats["typed_failures"] += 1
                        else:
                            stats["untyped_errors"].append(
                                f"{name}: {e}"
                            )
                except Exception as e:
                    with lock:
                        stats["completed"] += 1
                        stats["untyped_errors"].append(
                            f"{name}: {type(e).__name__}: {e}"
                        )

        threads = [
            threadreg.spawn(f"chaos-client-{i}", client_loop, args=(i,),
                            owner="chaos", start=False)
            for i in range(n_clients)
        ]
        try:
            for t in threads:
                t.start()
            # let traffic establish, then land a burst of every injector
            # fault class MID-FLIGHT; clear before the phase ends so the
            # tail of the run proves the cluster comes back clean
            time.sleep(min(0.4, duration_s / 4))
            for fc in ("task_crash_start", "task_crash_mid",
                       "fetch_loss", "oom"):
                for rule in generate_schedule(rng.randrange(1 << 20), fc):
                    self.injector.inject(**rule)
            # and a lifecycle maneuver on top: gracefully drain one
            # worker out from under the live population (one-way, so
            # the remaining nodes carry the tail of the run)
            drain_ok = self.runner.drain(
                self.workers[rng.randrange(len(self.workers))].worker_id,
                timeout_s=30.0,
            )
            time.sleep(min(1.0, duration_s / 2))
            self.injector.clear()
            deadline = time.monotonic() + duration_s + join_timeout_s
            for t in threads:
                t.join(max(0.1, deadline - time.monotonic()))
            stats["hung_threads"] = sum(t.is_alive() for t in threads)
        finally:
            self.injector.clear()
            server.stop()
        stats["drained"] = bool(drain_ok)
        stats["untyped_error_count"] = len(stats["untyped_errors"])
        stats["untyped_errors"] = stats["untyped_errors"][:5]
        return None, stats

    def run_adaptive_drain_case(
        self, queries: Dict[str, str], seed: int = 0, **kw,
    ) -> Tuple[None, dict]:
        """loaded-cluster faults + mid-traffic drain against an
        ADAPTIVE session (construct the harness with adaptive_execution
        on and a permissive re-plan threshold). Delegates the population
        mechanics to run_loaded_cluster_case and adds the adaptive
        counters observed during the phase, so the caller can assert
        the drain actually landed on a cluster that was re-planning."""
        from trino_tpu_torch.runtime.metrics import METRICS

        before = METRICS.snapshot()
        _, report = self.run_loaded_cluster_case(queries, seed, **kw)
        after = METRICS.snapshot()
        for counter in ("adaptive.replans", "adaptive.divergences",
                        "adaptive.spool_hits"):
            report[counter] = int(
                after.get(counter, 0) - before.get(counter, 0)
            )
        return None, report

    def run_recovery_drain_case(
        self, queries: Dict[str, str], seed: int = 0,
        n_faults: int = 3, **kw,
    ) -> Tuple[None, dict]:
        """The drain_mid_query /
        drain_all_but_one maneuvers now land on the loaded_cluster
        POPULATION instead of one isolated query — construct the
        harness with in_process=True and mesh checkpointing on, and
        mesh faults raise mid-chunk (MESH_FAULT_HOOK at the middle
        boundary, first n_faults hits) while run_loaded_cluster_case
        drains a worker out from under the live traffic. Faulted
        queries must RESUME from checkpoint on the surviving capacity
        (report carries checkpoint_resumes from the store's counters),
        and every completion still checks against the clean oracle."""
        from trino_tpu_torch.parallel import mesh_chunk
        from trino_tpu_torch.recovery import CHECKPOINTS

        if not self.in_process:
            raise ValueError(
                "run_recovery_drain_case needs in_process=True (the "
                "mesh plane only engages on colocated workers)"
            )
        lock = named_lock("ChaosHarness.stats_lock")
        state = {"fired": 0}

        def hook(k: int, K: int) -> None:
            # deterministic allowance, not a coin flip: the first
            # n_faults arrivals at a mid-run boundary fault; everything
            # after runs clean so the tail proves the cluster recovered
            with lock:
                if K >= 2 and k == max(1, K // 2) \
                        and state["fired"] < n_faults:
                    state["fired"] += 1
                    raise mesh_chunk.MeshDeviceLost(
                        f"chaos[recovery_drain]: injected device loss "
                        f"at chunk {k}/{K}"
                    )

        resumed0 = CHECKPOINTS.resumed
        mesh_chunk.MESH_FAULT_HOOK = hook
        try:
            _, report = self.run_loaded_cluster_case(queries, seed, **kw)
        finally:
            mesh_chunk.MESH_FAULT_HOOK = None
        report["mesh_faults_fired"] = state["fired"]
        report["checkpoint_resumes"] = CHECKPOINTS.resumed - resumed0
        return None, report

    def run_replica_down_case(
        self, queries: Dict[str, str], seed: int = 0, **kw,
    ) -> Tuple[None, dict]:
        """hard-kill one replica's sub-mesh mid-chunk under live
        serving load. Construct the harness with in_process=True and a
        session with mesh_replicas >= 2 + chunking + checkpointing. A
        PERSISTENT fault hook kills every chunk loop that reaches a
        mid-run boundary on replica 0 — the coordinator must fail each
        one over to the sibling sub-mesh (resuming from the last
        host-portable checkpoint), replica 0's breaker trips after the
        configured consecutive failures, and placement routes the tail
        of the population around the dead sub-mesh. Zero queries may be
        lost: the delegated loaded-cluster case oracle-checks every
        completion. The hook ignores the case thread so the oracle
        pre-pass runs clean; only server-side executions fault."""
        from trino_tpu_torch.parallel import mesh_chunk
        from trino_tpu_torch.recovery import CHECKPOINTS
        from trino_tpu_torch.runtime.metrics import METRICS

        if not self.in_process:
            raise ValueError(
                "run_replica_down_case needs in_process=True (the mesh "
                "plane only engages on colocated workers)"
            )
        lock = named_lock("ChaosHarness.stats_lock")
        state = {"fired": 0}
        case_thread = threading.current_thread()

        def hook(k: int, K: int) -> None:
            if threading.current_thread() is case_thread:
                return  # oracle pre-pass: the clean runs stay clean
            if mesh_chunk.active_replica() == 0 and K >= 2 \
                    and k >= max(1, K // 2):
                with lock:
                    state["fired"] += 1
                raise mesh_chunk.MeshDeviceLost(
                    f"chaos[replica_down]: replica 0 sub-mesh "
                    f"hard-killed at chunk {k}/{K}"
                )

        before = METRICS.snapshot()
        resumed0 = CHECKPOINTS.resumed
        mesh_chunk.MESH_FAULT_HOOK = hook
        try:
            _, report = self.run_loaded_cluster_case(queries, seed, **kw)
        finally:
            mesh_chunk.MESH_FAULT_HOOK = None
        after = METRICS.snapshot()
        report["mesh_faults_fired"] = state["fired"]
        report["checkpoint_resumes"] = CHECKPOINTS.resumed - resumed0
        for name in ("replica.failovers", "replica.breaker_opens"):
            report[name] = int(after.get(name, 0) - before.get(name, 0))
        return None, report

    def run_replica_drain_case(
        self, queries: Dict[str, str], seed: int = 0, **kw,
    ) -> Tuple[None, dict]:
        """gracefully drain one replica with a chunked query in
        flight on it, under live serving load. The fault hook does not
        raise — the FIRST server-side chunk loop to reach a mid-run
        boundary on replica 0 triggers request_drain(0) synchronously,
        so that same run's next boundary hits the drain check, raises
        MeshReplicaDraining, and fails over to the sibling with a query
        deterministically in flight (no timer races). The drained
        replica takes no further placements; after the population
        finishes, drain() must confirm it quiesced to zero inflight."""
        from trino_tpu_torch.parallel import mesh_chunk
        from trino_tpu_torch.recovery import CHECKPOINTS
        from trino_tpu_torch.runtime.metrics import METRICS

        if not self.in_process:
            raise ValueError(
                "run_replica_drain_case needs in_process=True (the mesh "
                "plane only engages on colocated workers)"
            )
        lock = named_lock("ChaosHarness.stats_lock")
        state = {"drain_requested": 0}
        case_thread = threading.current_thread()

        def hook(k: int, K: int) -> None:
            if threading.current_thread() is case_thread:
                return  # oracle pre-pass: don't drain before load starts
            if mesh_chunk.active_replica() == 0 and K >= 2 \
                    and k >= max(1, K // 2):
                rm = getattr(self.runner, "_replicas", None)
                if rm is None:
                    return
                with lock:
                    if state["drain_requested"]:
                        return
                    state["drain_requested"] = 1
                rm.request_drain(0)

        before = METRICS.snapshot()
        resumed0 = CHECKPOINTS.resumed
        mesh_chunk.MESH_FAULT_HOOK = hook
        try:
            _, report = self.run_loaded_cluster_case(queries, seed, **kw)
        finally:
            mesh_chunk.MESH_FAULT_HOOK = None
        rm = getattr(self.runner, "_replicas", None)
        report["drain_requested"] = bool(state["drain_requested"])
        report["replica_drained"] = bool(
            rm is not None and state["drain_requested"]
            and rm.drain(0, timeout_s=30.0)
        )
        after = METRICS.snapshot()
        report["checkpoint_resumes"] = CHECKPOINTS.resumed - resumed0
        for name in ("replica.failovers", "replica.drains"):
            report[name] = int(after.get(name, 0) - before.get(name, 0))
        return None, report


def chaos_smoke(
    seed: int,
    queries: Dict[str, str],
    fault_classes=FAULT_CLASSES,
    verbose: bool = True,
    device=None,
    mesh_devices=None,
) -> List[str]:
    """The whole chaos matrix (the reference's bench.py --chaos-smoke):
    every (query, fault class) pair must be oracle-equal to the clean
    run and stay within its injected failure bound, then the lifecycle,
    time-bounding, serving, adaptive, recovery, replica, preempt and
    fabric scenarios. The replica, preempt and fabric ones need
    `mesh_devices` to hold at least two shards (4 gives 2 replicas of
    2). Returns the list of violation descriptions (empty = pass)."""
    from trino_tpu_torch.connectors.tpch import create_tpch_connector

    harness = ChaosHarness(n_workers=2, device=device)
    harness.register_catalog("tpch", create_tpch_connector())
    failures: List[str] = []
    for name, sql in queries.items():
        expected = harness.run_clean(sql)
        ordered = "order by" in sql.lower()
        for fc in fault_classes:
            try:
                rows, stats = harness.run_case(sql, fc, seed)
            except Exception as e:
                failures.append(f"{name}/{fc}: raised {type(e).__name__}: {e}")
                continue
            if not rows_equal(rows, expected, ordered=ordered):
                failures.append(
                    f"{name}/{fc}: rows diverged from clean run "
                    f"({len(rows)} vs {len(expected)})"
                )
            bound = stats.get("max_injected_failures", 0)
            if stats.get("retries", 0) > bound:
                failures.append(
                    f"{name}/{fc}: {stats['retries']} retries exceeds "
                    f"injected-failure bound {bound}"
                )
            if verbose:
                app = stats.get("attempts_per_partition") or {}
                print(
                    f"  chaos {name}/{fc}: ok rows={len(rows)} "
                    f"retries={stats.get('retries')} "
                    f"spec={stats.get('speculative_hits')} "
                    f"wins={stats.get('speculation_wins')} "
                    f"losses={stats.get('speculation_losses')} "
                    f"max_attempts={max(app.values(), default=0)}"
                )
    # lifecycle scenarios: drains are one-way, so each runs on a fresh
    # 3-worker harness (one spare survives drain_all_but_one)
    lifecycle_sql = next(iter(queries.values()))
    for scenario in LIFECYCLE_CLASSES:
        h = ChaosHarness(n_workers=3, device=device)
        h.register_catalog("tpch", create_tpch_connector())
        expected = h.run_clean(lifecycle_sql)
        try:
            rows, report = h.run_lifecycle_case(
                lifecycle_sql, scenario, seed
            )
        except Exception as e:
            failures.append(
                f"lifecycle/{scenario}: raised {type(e).__name__}: {e}"
            )
            continue
        ordered = "order by" in lifecycle_sql.lower()
        if not rows_equal(rows, expected, ordered=ordered):
            failures.append(
                f"lifecycle/{scenario}: rows diverged from clean run "
                f"({len(rows)} vs {len(expected)})"
            )
        if scenario.startswith("drain"):
            if not all(report["drained"].values()):
                failures.append(
                    f"lifecycle/{scenario}: drain timed out "
                    f"({report['drained']})"
                )
            if report["launches_at_end"] != report["launches_at_drain"]:
                failures.append(
                    f"lifecycle/{scenario}: drained worker accepted "
                    f"post-drain launches "
                    f"({report['launches_at_drain']} -> "
                    f"{report['launches_at_end']})"
                )
        if (
            scenario == "straggler_speculation"
            and not report.get("speculation_wins")
        ):
            failures.append(
                f"lifecycle/{scenario}: no speculative win recorded "
                f"({report})"
            )
        if verbose:
            app = report.get("attempts_per_partition") or {}
            print(
                f"  chaos lifecycle/{scenario}: ok rows={len(rows)} "
                f"retries={report.get('retries')} "
                f"wins={report.get('speculation_wins')} "
                f"losses={report.get('speculation_losses')} "
                f"max_attempts={max(app.values(), default=0)}"
            )
    # time-bounding scenarios: watchdog + abandonment reaper;
    # fresh harnesses again (the abandoned case leaves a dead query in
    # its server, the hung case arms a watchdog). The agg shape is the
    # right query here: its batch capacities do not depend on which
    # attempt survives, so one warm run covers every shape a retry
    # can touch. The join's dynamic-filter pruning makes retry batch
    # capacities attempt-dependent — each retry can meet a fresh
    # build inside one batch, indistinguishable from a hang at any
    # test-speed threshold
    timebound_sql = lifecycle_sql
    for scenario in TIMEBOUND_CLASSES:
        h = ChaosHarness(
            n_workers=3, device=device,
            stuck_task_interrupt_s=1.0,
            memory_pool_bytes=256 << 20,
        )
        h.register_catalog("tpch", create_tpch_connector())
        if scenario == "hung_operator":
            expected = h.run_clean(timebound_sql)
            try:
                rows, report = h.run_hung_operator_case(
                    timebound_sql, seed
                )
            except Exception as e:
                failures.append(
                    f"timebound/{scenario}: raised "
                    f"{type(e).__name__}: {e}"
                )
                continue
            ordered = "order by" in timebound_sql.lower()
            if not rows_equal(rows, expected, ordered=ordered):
                failures.append(
                    f"timebound/{scenario}: rows diverged from clean "
                    f"run ({len(rows)} vs {len(expected)})"
                )
            interrupts = report.get("watchdog_interrupts") or []
            if not interrupts:
                failures.append(
                    f"timebound/{scenario}: watchdog never fired"
                )
            elif not any("in operator" in d for d in interrupts):
                failures.append(
                    f"timebound/{scenario}: diagnostic does not name "
                    f"the stuck operator ({interrupts[0]!r})"
                )
            overhead = report["elapsed_s"] - report["warm_clean_s"]
            if overhead >= report["stall_s"]:
                failures.append(
                    f"timebound/{scenario}: query waited out the full "
                    f"stall (recovery overhead {overhead:.2f}s >= "
                    f"{report['stall_s']}s) — the watchdog did not "
                    f"unwedge it"
                )
            if verbose:
                print(
                    f"  chaos timebound/{scenario}: ok rows={len(rows)} "
                    f"elapsed={report['elapsed_s']:.2f}s "
                    f"(warm clean {report['warm_clean_s']:.2f}s) "
                    f"interrupts={len(interrupts)}"
                )
        else:  # abandoned_client
            try:
                _, report = h.run_abandoned_client_case(
                    timebound_sql, seed
                )
            except Exception as e:
                failures.append(
                    f"timebound/{scenario}: raised "
                    f"{type(e).__name__}: {e}"
                )
                continue
            if not report["reaped"]:
                failures.append(
                    f"timebound/{scenario}: query was not reaped "
                    f"(error={report['error']!r})"
                )
            if report["rg_running"] != 0:
                failures.append(
                    f"timebound/{scenario}: resource-group slot leaked "
                    f"({report['rg_running']} still running)"
                )
            if any(report["ledgers"].values()):
                failures.append(
                    f"timebound/{scenario}: memory ledger not drained "
                    f"({report['ledgers']})"
                )
            if verbose:
                print(
                    f"  chaos timebound/{scenario}: ok "
                    f"peak_reserved={report['peak_reserved_bytes']} "
                    f"ledgers_drained=True rg_running=0"
                )
    # serving scenario: the same fault classes, but landing on a
    # cluster that is actively serving a concurrent client population
    # through the HTTP path — fresh harness (faults + server leftovers)
    for scenario in SERVING_CLASSES:
        h = ChaosHarness(n_workers=3, device=device)
        h.register_catalog("tpch", create_tpch_connector())
        try:
            _, report = h.run_loaded_cluster_case(queries, seed)
        except Exception as e:
            failures.append(
                f"serving/{scenario}: raised {type(e).__name__}: {e}"
            )
            continue
        if report["completed"] == 0:
            failures.append(
                f"serving/{scenario}: no query completed under load"
            )
        if report["ok"] == 0:
            failures.append(
                f"serving/{scenario}: zero oracle-equal results "
                f"({report})"
            )
        if report["mismatches"]:
            failures.append(
                f"serving/{scenario}: {report['mismatches']} results "
                f"diverged from clean run under faults"
            )
        if report["untyped_error_count"]:
            failures.append(
                f"serving/{scenario}: {report['untyped_error_count']} "
                f"untyped errors (first: {report['untyped_errors'][:1]})"
            )
        if report["hung_threads"]:
            failures.append(
                f"serving/{scenario}: {report['hung_threads']} client "
                f"threads never returned"
            )
        if not report["drained"]:
            failures.append(
                f"serving/{scenario}: mid-traffic drain timed out"
            )
        if verbose:
            print(
                f"  chaos serving/{scenario}: ok "
                f"completed={report['completed']} ok={report['ok']} "
                f"sheds={report['sheds']} "
                f"typed_failures={report['typed_failures']} "
                f"drained={report['drained']} hung=0"
            )
    # adaptive scenario: the same loaded-cluster burst + drain,
    # on a session that re-plans mid-query. The query mix adds a join
    # whose build-side filter the stats heuristics misestimate, so with
    # the permissive threshold every execution crosses the re-plan gate
    # — the drain and fault burst land while re-planned programs are in
    # flight, and each completion is still checked against the clean run
    from trino_tpu_torch.engine import Session

    adaptive_queries = dict(queries)
    adaptive_queries["replan"] = (
        "select count(*) from supplier s "
        "join nation n on s_nationkey = n_nationkey "
        "where n_nationkey % 2 = 0"
    )
    for scenario in ADAPTIVE_CLASSES:
        h = ChaosHarness(
            n_workers=3, device=device,
            session=Session(
                catalog="tpch", schema="tiny", retry_policy="task",
                adaptive_execution=True,
                shared_subtree_materialization=True,
                adaptive_replan_threshold=1.3,
            ),
        )
        h.register_catalog("tpch", create_tpch_connector())
        try:
            _, report = h.run_adaptive_drain_case(adaptive_queries, seed)
        except Exception as e:
            failures.append(
                f"adaptive/{scenario}: raised {type(e).__name__}: {e}"
            )
            continue
        if report["ok"] == 0:
            failures.append(
                f"adaptive/{scenario}: zero oracle-equal results "
                f"({report})"
            )
        if report["mismatches"]:
            failures.append(
                f"adaptive/{scenario}: {report['mismatches']} re-planned "
                f"results diverged from clean run under faults"
            )
        if report["untyped_error_count"]:
            failures.append(
                f"adaptive/{scenario}: {report['untyped_error_count']} "
                f"untyped errors (first: {report['untyped_errors'][:1]})"
            )
        if report["hung_threads"]:
            failures.append(
                f"adaptive/{scenario}: {report['hung_threads']} client "
                f"threads never returned"
            )
        if not report["drained"]:
            failures.append(
                f"adaptive/{scenario}: mid-traffic drain timed out"
            )
        if report["adaptive.replans"] < 1:
            failures.append(
                f"adaptive/{scenario}: no re-plan happened during the "
                f"run — the drain never raced a re-planning query"
            )
        if verbose:
            print(
                f"  chaos adaptive/{scenario}: ok "
                f"completed={report['completed']} ok={report['ok']} "
                f"replans={report['adaptive.replans']} "
                f"spool_hits={report['adaptive.spool_hits']} "
                f"drained={report['drained']} hung=0"
            )
    # recovery scenarios: seeded faults INSIDE the mesh chunk
    # loop must resume from the last checkpoint — oracle-equal rows and
    # strictly fewer re-executed chunks than restarting from chunk 0
    recovery_sql = (
        "select o_orderpriority, count(*) c from orders join customer "
        "on o_custkey = c_custkey group by o_orderpriority "
        "order by o_orderpriority"
    )
    for fc in RECOVERY_CLASSES:
        try:
            rows, rep = run_mesh_recovery_case(recovery_sql, fc, seed, device=device,
                                              mesh_devices=mesh_devices)
        except Exception as e:
            failures.append(
                f"recovery/{fc}: raised {type(e).__name__}: {e}"
            )
            continue
        if not rep["mesh_clean_plane"]:
            failures.append(
                f"recovery/{fc}: clean run did not take the mesh plane"
            )
            continue
        K = rep["chunks"] or 0
        steps = rep["executed_chunk_steps"] or 0
        fault_k = rep["fault_chunk"] or 0
        re_executed = steps - K
        if not rows_equal(rows, rep["expected"], ordered=True):
            failures.append(
                f"recovery/{fc}: rows diverged from clean run "
                f"({len(rows)} vs {len(rep['expected'])})"
            )
        if not rep["fired"]:
            failures.append(f"recovery/{fc}: fault never fired ({rep})")
        elif rep["mesh_fault_plane"] != "mesh":
            failures.append(
                f"recovery/{fc}: faulted run left the mesh plane "
                f"({rep['mesh_fault_plane']})"
            )
        elif not rep["resumes"]:
            failures.append(
                f"recovery/{fc}: no checkpoint resume recorded ({rep})"
            )
        elif re_executed >= max(fault_k, 1) or re_executed >= K:
            failures.append(
                f"recovery/{fc}: re-executed {re_executed} of {K} "
                f"chunks — a restart-from-zero re-executes {fault_k}; "
                f"the checkpoint saved nothing"
            )
        if verbose:
            print(
                f"  chaos recovery/{fc}: ok rows={len(rows)} "
                f"fault_chunk={fault_k}/{K} "
                f"resumed_from={rep['resumed_from_chunk']} "
                f"re_executed={re_executed}"
            )
    # carry-forward: the drain maneuvers aimed at the
    # loaded_cluster population, with mesh checkpointing on — device
    # losses land mid-chunk while a worker drains out from under the
    # live traffic, and the faulted queries must resume from checkpoint
    # on what survives
    h = ChaosHarness(
        n_workers=3, in_process=True, device=device, mesh_devices=mesh_devices,
        session=Session(
            catalog="tpch", schema="tiny",
            mesh_chunk_rows=256,
            mesh_checkpoint_interval_chunks=1,
        ),
    )
    h.register_catalog("tpch", create_tpch_connector())
    scenario = "recovery_loaded_drain"
    try:
        _, report = h.run_recovery_drain_case(queries, seed)
    except Exception as e:
        failures.append(
            f"recovery/{scenario}: raised {type(e).__name__}: {e}"
        )
        report = None
    if report is not None:
        if report["ok"] == 0:
            failures.append(
                f"recovery/{scenario}: zero oracle-equal results "
                f"({report})"
            )
        if report["mismatches"]:
            failures.append(
                f"recovery/{scenario}: {report['mismatches']} results "
                f"diverged from clean run under mesh faults"
            )
        if report["untyped_error_count"]:
            failures.append(
                f"recovery/{scenario}: {report['untyped_error_count']} "
                f"untyped errors (first: {report['untyped_errors'][:1]})"
            )
        if report["hung_threads"]:
            failures.append(
                f"recovery/{scenario}: {report['hung_threads']} client "
                f"threads never returned"
            )
        if not report["drained"]:
            failures.append(
                f"recovery/{scenario}: mid-traffic drain timed out"
            )
        if not report["mesh_faults_fired"]:
            failures.append(
                f"recovery/{scenario}: no mesh fault landed — the "
                f"drain never raced a resuming query"
            )
        elif not report["checkpoint_resumes"]:
            failures.append(
                f"recovery/{scenario}: faults fired but nothing "
                f"resumed from checkpoint ({report})"
            )
        if verbose:
            print(
                f"  chaos recovery/{scenario}: ok "
                f"completed={report['completed']} ok={report['ok']} "
                f"faults={report['mesh_faults_fired']} "
                f"resumes={report['checkpoint_resumes']} "
                f"drained={report['drained']} hung=0"
            )
    # replica scenarios: the same live population against a
    # REPLICATED serving plane (two sub-meshes carved from the device
    # set) — one replica hard-killed mid-chunk, then (fresh harness)
    # gracefully drained with a query in flight; preempt scenarios:
    # park/resume composed with a device loss and with a drain; fabric
    # scenarios: checkpoint transport and membership under adversity
    for scenario in MESH_SCENARIOS:
        group = MESH_SCENARIOS[scenario]
        try:
            rows, rep = run_mesh_case(scenario, seed, queries, recovery_sql,
                                      device=device, mesh_devices=mesh_devices)
        except Exception as e:
            failures.append(f"{group}/{scenario}: raised {type(e).__name__}: {e}")
            continue
        bad = mesh_case_failures(scenario, rows, rep)
        failures += bad
        if verbose and not bad:
            print(f"  chaos {group}/{scenario}: ok " + ", ".join(
                f"{k}={v}" for k, v in rep.items() if isinstance(v, (bool, int, float))))
    return failures


# the replica, preempt and fabric scenarios, each with its group
MESH_SCENARIOS = {**dict.fromkeys(REPLICA_CLASSES, "replica"),
                  **dict.fromkeys(PREEMPT_CLASSES, "preempt"),
                  **dict.fromkeys(FABRIC_CLASSES, "fabric")}


def run_mesh_case(
    scenario: str, seed: int, queries: Dict[str, str], sql: str,
    device=None, mesh_devices=None, mesh_chunk_rows: int = 256, **population,
) -> Tuple[Optional[List[list]], dict]:
    """One scenario of MESH_SCENARIOS as chaos_smoke runs it. A replica
    scenario drives `queries` from a client population on a fresh
    two-replica harness (`population`: run_loaded_cluster_case's
    n_clients and duration_s) and gives no rows; the others run `sql`.
    `mesh_devices` must hold at least two shards (4 gives 2 replicas
    of 2)."""
    if scenario in REPLICA_CLASSES:
        from trino_tpu_torch.connectors.tpch import create_tpch_connector
        from trino_tpu_torch.engine import Session

        h = ChaosHarness(
            n_workers=2, in_process=True, device=device, mesh_devices=mesh_devices,
            session=Session(catalog="tpch", schema="tiny", mesh_replicas=2,
                            mesh_chunk_rows=mesh_chunk_rows,
                            mesh_checkpoint_interval_chunks=1, mesh_resume_attempts=0),
        )
        h.register_catalog("tpch", create_tpch_connector())
        case = (h.run_replica_down_case if scenario == "replica_down_mid_serve"
                else h.run_replica_drain_case)
        return case(queries, seed, **population)
    case = {
        "preempt_park_resume": run_preempt_park_resume_case,
        "preempt_under_drain": run_preempt_under_drain_case,
        "host_lost_mid_chunk": run_host_lost_case,
        "membership_flap": run_membership_flap_case,
        "transport_corruption": run_transport_corruption_case,
    }[scenario]
    if scenario != "preempt_park_resume":
        return case(sql, seed, mesh_chunk_rows=mesh_chunk_rows, device=device,
                    mesh_devices=mesh_devices)
    # park_resume doubles as the lock-witness gate: the scheduler's
    # condition wait, the checkpoint store and the fast-lane seat all
    # interleave here, so it runs with order checking live and reports
    # the violations recorded meanwhile (mesh_case_failures wants 0)
    was_enabled = witness.witness_enabled()
    before = witness.violation_count()
    witness.enable_witness(True)
    try:
        rows, rep = case(sql, seed, mesh_chunk_rows=mesh_chunk_rows, device=device,
                         mesh_devices=mesh_devices)
    finally:
        witness.enable_witness(was_enabled)
    rep["witness_violations"] = witness.violation_count() - before
    return rows, rep


def mesh_case_failures(scenario: str, rows: Optional[List[list]], rep: dict) -> List[str]:
    """The gates of one scenario of MESH_SCENARIOS on its run_mesh_case
    result (the reference's chaos_smoke gates): the violations, empty
    for a pass."""
    tag = f"{MESH_SCENARIOS[scenario]}/{scenario}"
    if scenario in REPLICA_CLASSES:
        return _replica_failures(tag, scenario, rep)
    if not rep["mesh_clean_plane"]:
        return [f"{tag}: clean run did not take the mesh plane"]
    out = []
    if not rows_equal(rows, rep["expected"], ordered=True):
        out.append(f"{tag}: rows diverged from clean run "
                   f"({len(rows)} vs {len(rep['expected'])})")
    if scenario in PREEMPT_CLASSES:
        return out + _preempt_failures(tag, scenario, rep)
    if not rep["fired"]:
        return out + [f"{tag}: fault never fired ({rep})"]
    return out + _fabric_failures(tag, scenario, rep)


def _replica_failures(tag: str, scenario: str, report: dict) -> List[str]:
    out = []
    if report["ok"] == 0:
        out.append(f"{tag}: zero oracle-equal results ({report})")
    if report["mismatches"]:
        out.append(f"{tag}: {report['mismatches']} results diverged from clean run "
                   f"with a replica down")
    if report["untyped_error_count"]:
        out.append(f"{tag}: {report['untyped_error_count']} untyped errors "
                   f"(first: {report['untyped_errors'][:1]})")
    if report["hung_threads"]:
        out.append(f"{tag}: {report['hung_threads']} client threads never returned "
                   f"— a query was lost")
    if scenario == "replica_down_mid_serve":
        if not report["mesh_faults_fired"]:
            out.append(f"{tag}: the kill never landed on a mid-chunk boundary ({report})")
        elif not report["replica.failovers"]:
            out.append(f"{tag}: replica 0 died but nothing failed over to the sibling "
                       f"({report})")
    elif not report["drain_requested"]:
        out.append(f"{tag}: the drain never raced an in-flight chunked query ({report})")
    elif not report["replica_drained"]:
        out.append(f"{tag}: replica 0 never quiesced to zero inflight ({report})")
    elif not report["replica.failovers"]:
        out.append(f"{tag}: drained with a query in flight but nothing failed over "
                   f"({report})")
    return out


def _preempt_failures(tag: str, scenario: str, rep: dict) -> List[str]:
    out = []
    if not rep["parked"]:
        out.append(f"{tag}: the fast-lane seat never parked the analytic ({rep})")
    if scenario == "preempt_park_resume":
        if rep["witness_violations"]:
            out.append(f"{tag}: {rep['witness_violations']} lock-witness violation(s) "
                       f"recorded during the park/resume run")
        if not rep["faulted"]:
            out.append(f"{tag}: the post-resume device loss never fired ({rep})")
        elif rep["mesh_fault_plane"] != "mesh":
            out.append(f"{tag}: faulted run left the mesh plane ({rep['mesh_fault_plane']})")
        elif rep["parks"] != 1 or rep["unparks"] != 1:
            out.append(f"{tag}: expected exactly one park/unpark cycle ({rep})")
        elif not rep["resumes"]:
            out.append(f"{tag}: no in-run checkpoint resume after the device loss ({rep})")
        elif rep["executed_chunk_steps"] != rep["chunks"]:
            out.append(f"{tag}: park+fault re-executed "
                       f"{rep['executed_chunk_steps'] - rep['chunks']} of "
                       f"{rep['chunks']} chunks")
        if not rep["point_ok"]:
            out.append(f"{tag}: the preempting point lookup answered wrong ({rep})")
        return out
    if not rep["drain_requested"]:
        out.append(f"{tag}: the drain never landed while the query sat parked ({rep})")
    elif not rep["failovers"]:
        out.append(f"{tag}: drained while parked but nothing failed over to the sibling "
                   f"({rep})")
    elif not rep["checkpoint_resumes"]:
        out.append(f"{tag}: sibling did not resume from the parked snapshot ({rep})")
    elif rep["resumed_from_chunk"] != rep["park_chunk"]:
        out.append(f"{tag}: sibling resumed from chunk {rep['resumed_from_chunk']}, "
                   f"expected the park boundary {rep['park_chunk']}")
    elif rep["chunk_steps"] != rep["chunks"]:
        out.append(f"{tag}: drain-while-parked re-executed "
                   f"{rep['chunk_steps'] - rep['chunks']} of {rep['chunks']} chunks")
    if not rep["replica_drained"]:
        out.append(f"{tag}: the victim replica never quiesced to zero inflight ({rep})")
    return out


def _fabric_failures(tag: str, scenario: str, rep: dict) -> List[str]:
    K = rep["chunks"] or 0
    steps = rep["executed_chunk_steps"] or 0
    if scenario == "host_lost_mid_chunk":
        left = K - (rep["fault_chunk"] or 0)
        if not rep["pushes"]:
            return [f"{tag}: nothing was ever pushed to the peer ({rep})"]
        if not rep["pulls"]:
            return [f"{tag}: local store wiped but failover never pulled from the peer "
                    f"({rep})"]
        if not rep["resumes"]:
            return [f"{tag}: pulled a checkpoint but never resumed from it ({rep})"]
        if steps != left:
            # the failover re-place runs a fresh attempt whose step
            # counter starts at the resume point: exactly the
            # not-yet-executed chunks remain
            return [f"{tag}: re-executed {steps - left} chunk-steps after the fabric pull "
                    f"({steps} steps for {left} remaining chunks)"]
        return []
    if scenario == "membership_flap":
        if not rep["flapped"]:
            return [f"{tag}: the flap never happened ({rep})"]
        if rep["double_refused"] != 1:
            return [f"{tag}: a second claim on an owned query was NOT refused — double "
                    f"placement across epochs ({rep})"]
        if rep["epoch_delta"] < 2:
            return [f"{tag}: membership epoch did not advance across the flap ({rep})"]
        if rep["owners_at_end"] != 0:
            return [f"{tag}: {rep['owners_at_end']} ownership claims leaked past query "
                    f"completion"]
        if not rep["resumes"] and not rep["epoch_fences"]:
            return [f"{tag}: neither a resume nor a typed epoch-fence restart happened "
                    f"after the flap ({rep})"]
        return []
    if not rep["digest_rejects"]:
        return [f"{tag}: corrupted payload was never digest-rejected ({rep})"]
    if rep["pulls"]:
        return [f"{tag}: a corrupted payload was IMPORTED ({rep['pulls']} pulls landed)"]
    if rep["truncated_import"] is not False:
        return [f"{tag}: truncated payload import was not refused "
                f"({rep['truncated_import']!r})"]
    if rep["resumes"]:
        return [f"{tag}: resumed after a rejected transfer — restart expected ({rep})"]
    return []
