"""Prepared-statement plan cache.

A hit skips the whole parse→analyze→optimize→plan pipeline: the
runner re-uses the cached (logical output, physical plan) pair and goes
straight to execution. The key has three parts:

1. the formatter's CANONICAL sql text — the formatter's fixpoint
   (format(parse(format(x))) == format(x)) is what makes a text key
   safe: two spellings of one statement canonicalize to one
   entry. EXECUTE keys canonicalize the BOUND statement (parameters
   substituted), so distinct bindings plan separately — values are
   folded into pushdown constraints at analysis time, and a
   value-blind key would serve wrong splits;
2. the plan-affecting session properties (a property flipped via SET
   SESSION must miss, not serve a stale shape);
3. the bound-parameter dtype vector (an EXECUTE binding 1 and one
   binding 1.5 compile different kernels even for equal canonical
   prefixes).

Counterpart of trino_tpu/serving/plan_cache.py. The key also carries
`mxu_join_enabled` and `mxu_join_min_work`, which the reference's
PLAN_AFFECTING_PROPERTIES leaves out although its planner reads both:
after SET SESSION mxu_join_enabled the reference serves the plan made
under the old setting (ROADMAP §3).

Entries are LRU-bounded and never store volatile plans (now(), uuid()
fold at analysis time). Invalidation is table-granular when the write
can name its target (`invalidate_tables` — DML drops only plans that
read the written table) and wholesale
otherwise (`invalidate` — COMMIT, catalog registration; cached
physical plans capture split listings, i.e. data snapshots). The
counters are the cache's hits/misses/evictions/invalidations
attributes, also counted in runtime/metrics.py's METRICS as
plan_cache.{hits,misses,evictions,invalidations} (`metrics_prefix`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple

from trino_tpu_torch.runtime.metrics import METRICS
from trino_tpu_torch.analysis.witness import named_lock

# Session properties that shape the plan (resolution, optimizer
# decisions, physical layout). Anything listed here that
# changes between two executions of the same text yields a different
# key — SET SESSION never needs to invalidate.
PLAN_AFFECTING_PROPERTIES = (
    "catalog",
    "schema",
    "timezone",
    "batch_rows",
    "target_splits",
    "enable_dynamic_filtering",
    "enable_pushdown",
    "enable_optimizer",
    "join_reordering_strategy",
    "broadcast_join_threshold",
    "shape_stabilization",
    "capacity_ladder_base",
    "plan_validation",
    "adaptive_execution",
    "adaptive_replan_threshold",
    "shared_subtree_materialization",
    # the planner's join-project route; missing from the reference's key
    "mxu_join_enabled",
    "mxu_join_min_work",
)


def plan_properties(session) -> Tuple:
    """The plan-shaping slice of a Session, as a hashable tuple."""
    return tuple(
        getattr(session, name, None) for name in PLAN_AFFECTING_PROPERTIES
    )


def plan_tables(root) -> frozenset:
    """Lowercased (catalog, schema, table) triples of every ScanNode
    under a plan root — the `tables=` tag for `store`."""
    out = set()
    stack = [root]
    while stack:
        node = stack.pop()
        handle = getattr(node, "handle", None)
        if handle is not None and hasattr(handle, "table"):
            catalog = getattr(node, "catalog", None) or getattr(
                handle, "catalog", ""
            )
            out.add((
                str(catalog).lower(),
                str(handle.schema).lower(),
                str(handle.table).lower(),
            ))
        stack.extend(getattr(node, "children", lambda: ())())
    return frozenset(out)


class PlanCache:
    """Thread-safe bounded-LRU plan cache with counters.

    Values are opaque to the cache: the runner stores
    (OutputNode, PhysicalPlan)."""

    def __init__(self, max_entries: int = 256, metrics_prefix: str = "plan_cache"):
        self.max_entries = max(1, int(max_entries))
        self._prefix = metrics_prefix
        self._lock = named_lock("PlanCache._lock")
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._tables: dict = {}  # key -> frozenset of source tables
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        # bumped on every invalidate: a long-running planner that began
        # before a DDL must not store its now-stale plan after it
        self.generation = 0

    # -- keying --
    def key(self, canonical_sql: str, session, param_dtypes=()) -> Tuple:
        return (
            canonical_sql,
            plan_properties(session),
            tuple(str(d) for d in param_dtypes),
        )

    # -- cache ops --
    def lookup(self, key: Tuple) -> Optional[Any]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                METRICS.increment(f"{self._prefix}.misses")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            METRICS.increment(f"{self._prefix}.hits")
            return entry

    def contains(self, key: Tuple) -> bool:
        """Presence probe that touches neither LRU order nor counters."""
        with self._lock:
            return key in self._entries

    def store(self, key: Tuple, value: Any, generation: Optional[int] = None,
              tables=()) -> None:
        """`tables` is the plan's source-table set (lowercased
        (catalog, schema, table) triples); entries tagged with it are
        droppable table by table through `invalidate_tables`. Untagged
        entries only fall to wholesale `invalidate`."""
        with self._lock:
            if generation is not None and generation != self.generation:
                return  # invalidated while planning: the plan is stale
            self._entries[key] = value
            self._entries.move_to_end(key)
            self._tables[key] = frozenset(tables)
            while len(self._entries) > self.max_entries:
                old, _ = self._entries.popitem(last=False)
                self._tables.pop(old, None)
                self.evictions += 1
                METRICS.increment(f"{self._prefix}.evictions")

    def invalidate(self) -> None:
        """Catalog/schema changed (DDL, DML, commit): every cached plan
        captured split listings that may no longer describe the data."""
        with self._lock:
            self._entries.clear()
            self._tables.clear()
            self.generation += 1
            self.invalidations += 1
            METRICS.increment(f"{self._prefix}.invalidations")

    def invalidate_tables(self, tables) -> int:
        """Table-granular invalidation: drop plans that read any of
        `tables`, plus untagged plans (their source set is unknown, so
        they must be assumed dirty). Plans over other tables survive.
        The generation still bumps: a concurrent planner racing the write
        may be planning against the written table, and a refused store
        on an unaffected plan only costs one replan."""
        tset = {tuple(str(p).lower() for p in t) for t in tables}
        with self._lock:
            victims = [
                k
                for k in self._entries
                if not self._tables.get(k) or self._tables[k] & tset
            ]
            for k in victims:
                del self._entries[k]
                self._tables.pop(k, None)
            self.generation += 1
            self.invalidations += 1
            METRICS.increment(f"{self._prefix}.invalidations")
            return len(victims)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }
