"""Node selection + memory-aware task placement.

Analogues of the reference's scheduling policies (SURVEY.md §2.3):

- `UniformNodeSelector` — least-loaded placement with a per-node task
  cap and optional locality preference
  (main/execution/scheduler/NodeScheduler.java:54,
  UniformNodeSelector.java:67 — maxSplitsPerNode / preferred-host
  selection, with tasks as this engine's scheduling unit).
- `PartitionMemoryEstimator` — per-fragment task-memory estimates that
  GROW after memory failures, so retries re-place onto roomier nodes
  (ExponentialGrowthPartitionMemoryEstimator).
- `BinPackingNodeAllocator` — fits estimated task memory into per-node
  budgets, choosing the node with the most free room
  (BinPackingNodeAllocatorService.java:82). When nothing fits it falls
  back to the emptiest node rather than queueing — this engine's
  workers spill under pressure, so over-admission degrades instead of
  OOM-killing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from trino_tpu_torch.analysis.witness import named_lock


def _drop_graylisted(active: Sequence, node_manager) -> List:
    """Filter out workers whose circuit breaker is open (graylist,
    runtime/discovery.py). All-gray degrades to the full set — placing
    on a suspect node beats starving the query."""
    if node_manager is None:
        return list(active)
    try:
        ok = {id(h) for h in node_manager.schedulable_workers()}
    except Exception:
        return list(active)
    filtered = [h for h in active if id(h) in ok]
    return filtered or list(active)


class UniformNodeSelector:
    """Pick the active node with the fewest running tasks; nodes at the
    cap are skipped (all-at-cap falls back to global least-loaded, the
    reference's best-effort under full cluster). With a `node_manager`,
    graylisted (open-breaker) nodes are excluded from every tier."""

    def __init__(self, max_tasks_per_node: Optional[int] = None,
                 node_manager=None):
        self.max_tasks_per_node = max_tasks_per_node
        self.node_manager = node_manager
        # local assignment ledger: placements increment locally; each
        # handle's remote status() is probed ONCE (its pre-existing
        # load), not per placement — a slow worker must not serialize
        # every launch behind an HTTP round trip
        self._assigned: Dict[int, int] = {}
        self._baseline: Dict[int, int] = {}
        self._lock = named_lock("UniformNodeSelector._lock")

    def _load(self, handle) -> int:
        key = id(handle)
        if key not in self._baseline:
            try:
                self._baseline[key] = int(handle.status().get("tasks", 0))
            except Exception:
                self._baseline[key] = 0
        return self._baseline[key] + self._assigned.get(key, 0)

    def _pick_below_cap_locked(self, pool: Sequence):
        """Least-loaded node of `pool` under the cap, or None (caller
        holds the lock)."""
        loads = [(self._load(h), i, h) for i, h in enumerate(pool)]
        loads.sort(key=lambda t: (t[0], t[1]))
        for load, _, h in loads:
            if (
                self.max_tasks_per_node is None
                or load < self.max_tasks_per_node
            ):
                self._assigned[id(h)] = self._assigned.get(id(h), 0) + 1
                return h
        return None

    def select(self, active: Sequence, preferred: Sequence = ()) -> object:
        if not active:
            raise RuntimeError("no active workers")
        active = _drop_graylisted(active, self.node_manager)
        preferred = [h for h in preferred if h in active]
        with self._lock:
            for pool in (list(preferred), list(active)):
                if not pool:
                    continue
                pick = self._pick_below_cap_locked(pool)
                if pick is not None:
                    return pick
            # every node at cap: least-loaded overall
            _, _, h = min(
                ((self._load(h), i, h) for i, h in enumerate(active)),
                key=lambda t: (t[0], t[1]),
            )
            self._assigned[id(h)] = self._assigned.get(id(h), 0) + 1
            return h

    def release(self, handle) -> None:
        with self._lock:
            n = self._assigned.get(id(handle), 0)
            if n > 1:
                self._assigned[id(handle)] = n - 1
            else:
                self._assigned.pop(id(handle), None)


class TopologyAwareNodeSelector(UniformNodeSelector):
    """Locality-tiered placement (TopologyAwareNodeSelector.java /
    FlatNetworkTopology): a split carrying a preferred LOCATION fills
    nodes tier by tier — same host, then same rack (co-scheduling a
    fragment's tasks inside one rack keeps its exchanges off the
    cross-rack network), then anywhere.
    Node locations are "host" or "rack/host" strings; each tier re-uses
    the least-loaded policy of the parent class."""

    def __init__(self, locations: Dict[int, str],
                 max_tasks_per_node: Optional[int] = None,
                 node_manager=None):
        super().__init__(max_tasks_per_node, node_manager=node_manager)
        # id(handle) -> "rack/host" (or bare "host")
        self._locations = dict(locations)

    @staticmethod
    def _rack(loc: str) -> str:
        return loc.rsplit("/", 1)[0] if "/" in loc else loc

    def select(self, active: Sequence, preferred: Sequence = (),
               location: Optional[str] = None) -> object:
        if location is None:
            return super().select(active, preferred)
        active = _drop_graylisted(active, self.node_manager)
        same_host = [
            h for h in active
            if self._locations.get(id(h)) == location
        ]
        want_rack = self._rack(location)
        same_rack = [
            h for h in active
            if self._rack(self._locations.get(id(h), "")) == want_rack
        ]
        # STRICT tiers: a below-cap same-host node beats ANY same-rack
        # node regardless of load; each tier is least-loaded internally
        with self._lock:
            for pool in (same_host, same_rack, list(preferred)):
                if not pool:
                    continue
                pick = self._pick_below_cap_locked(pool)
                if pick is not None:
                    return pick
        return super().select(active)


class PartitionMemoryEstimator:
    """Per-fragment estimated task memory; doubles after each
    memory-classed failure (the reference's exponential growth)."""

    GROWTH = 2.0

    def __init__(self, default_bytes: int = 64 << 20):
        self.default_bytes = default_bytes
        self._est: Dict[int, float] = {}

    def estimate(self, fragment_id: int) -> int:
        return int(self._est.get(fragment_id, self.default_bytes))

    def register_failure(self, fragment_id: int, failure: Optional[str]) -> None:
        text = (failure or "").lower()
        if "memory" in text or "oom" in text:
            cur = self._est.get(fragment_id, self.default_bytes)
            self._est[fragment_id] = cur * self.GROWTH


class BinPackingNodeAllocator:
    """Track estimated bytes outstanding per node; place each task on
    the node with the most free budget that fits."""

    DEFAULT_NODE_BYTES = 1 << 30

    def __init__(self, capacity_fn=None, node_manager=None):
        """capacity_fn(handle) -> node budget in bytes (defaults to the
        handle's memory pool size, else DEFAULT_NODE_BYTES). With a
        `node_manager`, graylisted nodes are excluded from packing."""
        self._capacity_fn = capacity_fn or self._default_capacity
        self.node_manager = node_manager
        self._used: Dict[int, float] = {}
        self._lock = named_lock("BinPackingNodeAllocator._lock")

    @staticmethod
    def _default_capacity(handle) -> int:
        pool = getattr(handle, "memory_pool", None)
        total = getattr(pool, "total_bytes", None)
        return int(total) if total else BinPackingNodeAllocator.DEFAULT_NODE_BYTES

    def free_bytes(self, handle) -> float:
        return self._capacity_fn(handle) - self._used.get(id(handle), 0.0)

    def acquire(
        self, active: Sequence, estimated_bytes: int,
        avoid: Optional[object] = None,
    ) -> object:
        active = _drop_graylisted(active, self.node_manager)
        candidates = [h for h in active if h is not avoid] or list(active)
        if not candidates:
            raise RuntimeError("no active workers")
        with self._lock:
            fitting = [
                h for h in candidates
                if self.free_bytes(h) >= estimated_bytes
            ]
            pool = fitting or candidates  # over-admit rather than starve
            best = max(
                range(len(pool)), key=lambda i: self.free_bytes(pool[i])
            )
            h = pool[best]
            self._used[id(h)] = self._used.get(id(h), 0.0) + estimated_bytes
            return h

    def release(self, handle, estimated_bytes: int) -> None:
        with self._lock:
            left = self._used.get(id(handle), 0.0) - estimated_bytes
            if left > 0:
                self._used[id(handle)] = left
            else:
                self._used.pop(id(handle), None)
