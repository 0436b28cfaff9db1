"""Config + session-property system.

Counterpart of trino_tpu/config.py: every property of its registry,
with the same name, type, default, description and allowed values.
Analogue of airlift @Config binding (etc/config.properties -> typed
config objects; 353 @Config annotations in trino-main) and the typed
session-property registry (main/SystemSessionProperties.java, ~200
properties — SURVEY.md §5.6). Properties are declared once with type +
default + description; SET SESSION goes through `validate`, and config
files bind by the same registry."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class PropertyMetadata:
    name: str
    type: type  # bool | int | float | str
    default: Any
    description: str
    allowed: Optional[tuple] = None  # enum-valued string properties

    def parse(self, text: str) -> Any:
        if self.type is bool:
            if text.lower() in ("true", "1", "on"):
                return True
            if text.lower() in ("false", "0", "off"):
                return False
            raise ValueError(f"{self.name}: expected boolean, got {text!r}")
        return self.type(text)


class PropertyRegistry:
    def __init__(self):
        self._props: Dict[str, PropertyMetadata] = {}

    def register(
        self, name: str, type_: type, default, description: str,
        allowed: Optional[tuple] = None,
    ) -> None:
        self._props[name] = PropertyMetadata(
            name, type_, default, description, allowed
        )

    def validate(self, name: str, value: Any) -> Any:
        meta = self._props.get(name)
        if meta is None:
            raise ValueError(f"unknown session property {name!r}")
        if isinstance(value, str) and meta.type is not str:
            value = meta.parse(value)
        elif meta.type is float and isinstance(value, int):
            value = float(value)
        elif not isinstance(value, meta.type):
            raise ValueError(
                f"{name}: expected {meta.type.__name__}, got {type(value).__name__}"
            )
        if meta.allowed is not None and value not in meta.allowed:
            raise ValueError(
                f"{name}: must be one of {meta.allowed}, got {value!r}"
            )
        return value

    def default(self, name: str) -> Any:
        return self._props[name].default

    def all(self) -> List[PropertyMetadata]:
        return sorted(self._props.values(), key=lambda m: m.name)


# The engine's system session properties (SystemSessionProperties
# analogue — the switchboard the executor consults per query).
SYSTEM_PROPERTIES = PropertyRegistry()
for _name, _type, _default, _desc, _allowed in [
    ("batch_rows", int, 1 << 20, "max rows per device batch", None),
    ("target_splits", int, 1, "target connector split count per scan", None),
    ("hash_partition_count", int, 4, "tasks per hash-distributed stage", None),
    ("retry_policy", str, "none", "none | query | task",
     ("none", "query", "task")),
    ("query_retry_count", int, 2,
     "whole-query retry attempts (retry_policy=query)", None),
    ("task_retries", int, 3, "per-task retry attempts (FTE)", None),
    ("memory_pool_bytes", int, 0, "per-query memory budget (0 = unlimited)", None),
    ("enable_dynamic_filtering", bool, True, "probe-side join pruning", None),
    ("broadcast_join_threshold", int, 1_000_000,
     "max estimated build rows for a broadcast join", None),
    ("mesh_execution", bool, True,
     "run colocated fragments over the device-mesh collective exchange", None),
    ("mesh_chunk_rows", int, 0,
     "per-shard rows per mesh chunk-step: the driver scan splits into "
     "ceil(rows/chunk) jit steps with host preemption checks (deadline/"
     "abandonment/watchdog) at every chunk boundary; 0 compiles the "
     "plan as one program (preemption checks only bracket it)", None),
    ("enable_optimizer", bool, True,
     "run the iterative plan-optimizer pipeline", None),
    ("enable_pushdown", bool, True,
     "push supported filter conjuncts and projections into connector "
     "scans (apply_filter/apply_projection SPI)", None),
    ("join_reordering_strategy", str, "automatic",
     "cost-based join reordering: automatic | none",
     ("automatic", "none")),
    ("speculation_enabled", bool, True,
     "FTE: duplicate straggler tasks, first finisher wins", None),
    ("speculation_quantile", float, 2.0,
     "FTE: speculate once a task runs this multiple of the stage's "
     "median committed-attempt wall time", None),
    ("task_concurrency", int, 2,
     "intra-task pipeline parallelism via the local exchange (1 = off)",
     None),
    # -- cluster resiliency (runtime/error_tracker, discovery, memory) --
    ("request_max_error_duration_s", float, 30.0,
     "per-destination transient-error budget before a remote request "
     "is declared failed (RequestErrorTracker deadline)", None),
    ("node_breaker_threshold", int, 3,
     "consecutive failed probes/requests before a worker's circuit "
     "breaker opens (graylist)", None),
    ("node_breaker_cooldown_s", float, 1.0,
     "seconds a graylisted worker sits out before a half-open probe",
     None),
    ("low_memory_killer_enabled", bool, True,
     "under cluster pool exhaustion (after revocation/spill), kill the "
     "single largest query instead of stalling everyone", None),
    # -- deadline hierarchy (runtime/query_tracker.py); 0 = unlimited --
    ("query_max_planning_time_s", float, 0.0,
     "kill a query still PLANNING after this long "
     "(EXCEEDED_TIME_LIMIT, non-retryable)", None),
    ("query_max_execution_time_s", float, 0.0,
     "kill a query EXECUTING (post-planning) after this long "
     "(EXCEEDED_TIME_LIMIT, non-retryable)", None),
    ("query_max_run_time_s", float, 0.0,
     "end-to-end wall bound: queued + planning + execution "
     "(EXCEEDED_TIME_LIMIT, non-retryable)", None),
    ("query_max_cpu_time_s", float, 0.0,
     "kill a query whose tasks' aggregated CPU ledgers exceed this "
     "(EXCEEDED_CPU_LIMIT, non-retryable)", None),
    ("client_timeout_s", float, 300.0,
     "reap a query whose client stopped polling nextUri for this long: "
     "tasks cancelled, resource-group slot and memory released", None),
    ("stuck_task_interrupt_s", float, 0.0,
     "worker watchdog: interrupt a task making no batch progress for "
     "this long (failure is RETRYABLE — a hung split may succeed "
     "elsewhere); 0 disables", None),
    ("speculation_percentile", float, 0.75,
     "FTE speculation bases its per-fragment duration estimate on this "
     "quantile of committed attempt wall times (p75 default)", None),
    # -- plan validation (sql/validate.py, PlanSanityChecker analogue) --
    ("plan_validation", str, "passes",
     "run plan sanity checkers: off | passes (after each optimizer "
     "pass + fragmentation) | rules (additionally after every rule "
     "application, plus plan-determinism double-planning — debug mode)",
     ("off", "passes", "rules")),
    ("compile_churn_warn_threshold", int, 32,
     "EXPLAIN (ANALYZE) warns when the shape census predicts more "
     "distinct (operator, capacity, dtype) XLA lowerings than this",
     None),
    # -- compile regime (compile/: shapes, warmup, cache) --
    ("shape_stabilization", bool, True,
     "pad scan chunks to the capacity class of their pre-pruning span "
     "so pushdown/dynamic-filter pruning and FTE retries re-land on "
     "census-predicted XLA lowerings", None),
    ("capacity_ladder_base", int, 2,
     "geometric ratio between capacity-ladder rungs (power of two; "
     "2 = the native bucket_capacity grid, larger = fewer, coarser "
     "capacity classes)", None),
    ("warmup_mode", str, "off",
     "census-driven AOT warmup of predicted lowerings: off | "
     "background (compile while the query runs) | block (wait for "
     "warmup before execution)", ("off", "background", "block")),
    ("stuck_task_interrupt_warm_s", float, 0.0,
     "aggressive stuck-task watchdog threshold applied once a task's "
     "predicted shape classes are all warm (warmup/cache hits or a "
     "prior completed run); 0 falls back to stuck_task_interrupt_s",
     None),
    # -- serving tier (trino_tpu/serving/) --
    ("plan_cache_entries", int, 256,
     "LRU bound of the prepared-statement plan cache (canonical text + "
     "plan-shaping properties + parameter dtype vector keyed)", None),
    ("micro_batch_window_ms", float, 0.0,
     "inter-query micro-batching: coalesce same-shape point lookups "
     "arriving within this window onto one shared device step; 0 "
     "disables batching", None),
    ("micro_batch_max", int, 16,
     "max point lookups coalesced into one shared device step", None),
    ("admission_fast_depth", int, 64,
     "max in-flight submissions in the fast admission lane "
     "(cached-plan point queries); arrivals beyond it are shed with "
     "429 + Retry-After", None),
    ("admission_general_depth", int, 256,
     "max in-flight submissions in the general admission lane; "
     "arrivals beyond it are shed with 429 + Retry-After", None),
    ("admission_retry_after_s", float, 1.0,
     "Retry-After hint returned with shed (429) submissions", None),
    # -- resident state tier (trino_tpu/resident/) --
    ("resident_tables", str, "",
     "comma-separated tables (table, schema.table or "
     "catalog.schema.table) whose point lookups the serving fast lane "
     "serves from pinned device-resident hash tables; empty disables "
     "the fast lane", None),
    ("resident_pin_budget_mb", int, 64,
     "device-memory budget for resident pins (fast-lane hash tables "
     "and mesh prelude contexts), LRU-evicted and revocable under "
     "memory pressure; 0 disables pinning entirely", None),
    ("resident_delta_max_rows", int, 4096,
     "capacity of a pinned table's append-only delta side; background "
     "compaction folds the delta into the base once it crosses half "
     "this, and an insert that cannot fit evicts the pin instead", None),
    # -- adaptive execution tier (trino_tpu/adaptive/) --
    ("adaptive_execution", bool, False,
     "mid-query re-planning: materialize pipeline barriers (completed "
     "join build sides), diff observed rows/NDV against sql/stats.py "
     "estimates, and re-optimize the remaining plan when divergence "
     "crosses adaptive_replan_threshold; completed work is substituted "
     "back as literal sources and never redone", None),
    ("adaptive_replan_threshold", float, 4.0,
     "divergence ratio max(est,obs)/min(est,obs) at or above which an "
     "observation triggers re-planning of the remaining plan (and is "
     "counted in adaptive.divergences regardless of whether "
     "adaptive_execution is on)", None),
    ("skewed_join_salting", bool, False,
     "skew-aware join plane: when a build-side barrier's modal key "
     "crosses skew_hot_key_threshold, annotate the join so the mesh "
     "plane replicates hot build rows to every shard and salts hot "
     "probe rows across the all_to_all (requires adaptive_execution)",
     None),
    ("skew_hot_key_threshold", float, 0.2,
     "fraction of observed build rows a single key value must reach "
     "to be classified a heavy hitter", None),
    ("skew_spill_min_rows", int, 1 << 18,
     "minimum observed build rows before a divergent build-side "
     "barrier re-plans the join into hybrid-hash spill mode "
     "(pre-opened grace partitions)", None),
    ("mxu_join_enabled", bool, False,
     "plan high-fanout equi-join + aggregation as the MXU matmul "
     "join-project kernel (ops/mxu_join.py) when profitable", None),
    ("mxu_join_min_work", float, 16.0,
     "estimated fanout x build-NDV product at or above which the MXU "
     "join-project kernel is selected over the padded-gather path",
     None),
    ("shared_subtree_materialization", bool, False,
     "materialize identical subtrees (NOT IN rewrites plan the "
     "subquery twice; CTEs referenced twice) once into the "
     "generation-guarded spool and feed every consumer — and the "
     "re-planner — from the same rows", None),
    # -- recovery tier (trino_tpu/recovery/) --
    ("mesh_checkpoint_interval_chunks", int, 0,
     "snapshot the mesh step loop's device carries to the host-side "
     "generation-guarded checkpoint store every N chunk boundaries so "
     "MeshStuck/device-loss faults resume from the last checkpoint "
     "instead of chunk 0; 0 disables checkpointing", None),
    ("mesh_resume_attempts", int, 2,
     "max in-run resume attempts from a mesh checkpoint before the "
     "fault escalates to the page-plane fallback / QUERY retry", None),
    ("recovery_spool_stages", bool, False,
     "tee completed non-root fragment outputs into the subtree spool "
     "so QUERY-level retry substitutes finished stages as literal "
     "sources instead of recomputing them (FTE settles lift committed "
     "stage spool files into the same store)", None),
    # -- replicated serving meshes (trino_tpu/runtime/replicas.py) --
    ("mesh_replicas", int, 1,
     "carve the device set into this many identical sub-meshes "
     "(replica x partition named-axis grid); the coordinator "
     "load-balances mesh queries across healthy replicas and each "
     "replica runs the same prelude/step/flush programs unchanged; "
     "1 (or too few devices) keeps the single full-width mesh", None),
    ("replica_failover_enabled", bool, True,
     "when a replica dies or drains mid-query, re-place its in-flight "
     "chunked query onto a healthy sibling sub-mesh — the sibling "
     "restores the host-portable mesh checkpoint and continues from "
     "chunk k instead of falling back to the page plane", None),
    ("replica_breaker_threshold", int, 3,
     "consecutive mesh-run failures before a replica's circuit breaker "
     "opens (the replica leaves the placement pool until a later "
     "success closes it)", None),
    ("replica_breaker_cooldown_s", float, 1.0,
     "seconds an open replica breaker sits out before a half-open "
     "placement probe may try the replica again", None),
    # -- preemptive multi-tenancy (runtime/scheduler.py) --
    ("mesh_scheduler", bool, True,
     "run mesh queries through the chunk-granular weighted-fair "
     "scheduler (per-mesh run queue with fast-lane point lookups and "
     "virtual-time accounting per resource group) instead of a bare "
     "exec lock; False restores PR 17 serialization", None),
    ("preemption_enabled", bool, True,
     "allow a fast-lane arrival to park the running analytic at the "
     "next chunk boundary (device carries snapshot to the host "
     "checkpoint store, device memory released, resume from chunk k "
     "on the same warm rungs); False degrades preemption to in-place "
     "yields between whole runs", None),
    ("park_max_bytes", int, 256 << 20,
     "host-memory budget for parked query snapshots in the mesh "
     "checkpoint store; a park that would exceed it is refused and "
     "the query runs to completion instead (never query failure)",
     None),
    ("mesh_scheduler_weights", str, "",
     "per-resource-group scheduling weights for the mesh scheduler, "
     "'group=weight,...' (scheduling_weight analogue); unlisted "
     "groups weigh 1", None),
    ("mesh_scheduler_min_slice_chunks", int, 1,
     "minimum chunk-steps a query runs between preemptions "
     "(bounded-slice guarantee: a continuous fast-lane stream cannot "
     "live-lock the analytic)", None),
    ("mesh_scheduler_group", str, "",
     "resource group this session's mesh queries are accounted to in "
     "the weighted-fair scheduler; empty uses 'default'", None),
    ("mesh_steal_enabled", bool, True,
     "on drain failover of a chunked all-append query, split the "
     "unstarted chunk range across two sibling replicas (primary "
     "resumes [k, mid), helper computes [mid, K) and the primary "
     "merges the helper's packed live rows) instead of resuming "
     "wholesale on one", None),
    ("mesh_park_max_bytes", int, 0,
     "aggregate host-memory pool for parked snapshots apportioned "
     "across resource groups by scheduler weight (a group over its "
     "share gets an in-place yield instead of a park); 0 keeps the "
     "single undivided park_max_bytes budget", None),
    # -- multi-host replica fabric (runtime/fabric.py) --
    ("fabric_peers", str, "",
     "comma-separated base URIs of peer coordinator fabric endpoints "
     "(http://host:port); non-empty attaches the checkpoint push/pull "
     "fabric: checkpoints stream asynchronously to every peer and "
     "failover pulls the last pushed snapshot on demand", None),
    ("fabric_queue_depth", int, 8,
     "bounded depth of the asynchronous checkpoint push queue; a full "
     "queue sheds the push (fabric.push_sheds) instead of blocking "
     "the chunk loop", None),
    ("fabric_max_error_duration_s", float, 5.0,
     "per-peer transient-error budget for fabric pushes and pulls "
     "(RequestErrorTracker deadline); exhaustion degrades to a local "
     "restart, never query failure", None),
    # -- observability (runtime/tracing.py) --
    ("query_trace", str, "off",
     "record a full span tree per query (phases, stages, task attempts, "
     "operators; worker spans grafted into the coordinator's tree) "
     "exportable as JSON/Chrome trace-event via GET /v1/query/{id}/trace",
     ("off", "on")),
]:
    SYSTEM_PROPERTIES.register(_name, _type, _default, _desc, _allowed)


def load_properties_file(path: str) -> Dict[str, str]:
    """key=value config file (etc/config.properties format: # comments,
    blank lines ignored)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(f"malformed config line: {line!r}")
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


# Properties whose only reader on the reference's LocalQueryRunner or
# CoordinatorServer path lies in a tier the port does not have yet
# (ROADMAP §1): away from its default, such a property would change
# nothing, so it raises instead.
# The distributed, retry, mesh, replica, scheduler, fabric and tracing
# properties are read only by runtimes that LocalQueryRunner does not use
# (query_trace included: the local runner traces every query), and are
# stored as the reference stores them.
UNPORTED_READERS = {
    "compile_churn_warn_threshold": "item 13 (EXPLAIN ANALYZE's shape census)",
    "shape_stabilization": "item 13 (compile/shapes.py)",
    "capacity_ladder_base": "item 13 (compile/shapes.py)",
    "warmup_mode": "item 13 (compile/warmup.py)",
    "adaptive_execution": "item 13 (adaptive/)",
    "adaptive_replan_threshold": "item 13 (adaptive/)",
    "shared_subtree_materialization": "item 13 (adaptive/)",
    "resident_tables": "item 13 (resident/)",
    "micro_batch_window_ms": "item 13 (serving/batcher.py)",
    "micro_batch_max": "item 13 (serving/batcher.py)",
}


def check_ported(name: str, value: Any) -> None:
    """Raise when `value` of property `name` would need a reader the
    port does not have yet."""
    item = UNPORTED_READERS.get(name)
    if item is not None and value != SYSTEM_PROPERTIES.default(name):
        raise NotImplementedError(
            f"session property {name} = {value!r}: its reader is not in "
            f"trino_tpu_torch yet (ROADMAP §1 {item})"
        )


def check_session(session) -> None:
    """check_ported over every field of `session` with an unported
    reader (a field can be set directly as well as by SET SESSION)."""
    for name in UNPORTED_READERS:
        check_ported(name, getattr(session, name, None))


def bind_session(session, overrides: Dict[str, Any]) -> None:
    """Apply validated property values onto a Session (the
    SessionPropertyManager.validate path)."""
    for name, value in overrides.items():
        value = SYSTEM_PROPERTIES.validate(name, value)
        check_ported(name, value)
        if name == "memory_pool_bytes":
            value = value or None  # 0 means unlimited
        setattr(session, name, value)
