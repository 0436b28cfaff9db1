"""Shared-subtree materialization: SpooledValuesNode + the spool.

Counterpart of trino_tpu/adaptive/spool.py. A materialized subtree
re-enters the plan as a SpooledValuesNode — a ValuesNode subclass, so
every existing isinstance check (the planner's ValuesOperator path,
EvaluateEmptyJoin, the fragmenter's SINGLE leaf rule, the validators'
row-width check) applies unchanged. The node carries the EXACT observed
PlanStats of the rows it holds, which is what seeds re-optimization with
truth instead of estimates (StatsCalculator short-circuits on the
`plan_stats` attribute). The rows are host Python values: the local
planner re-uploads them to the query's device as one batch padded to its
capacity rung.

The SubtreeSpool is the process-wide cache of materialized subtrees,
keyed by (structural fingerprint, table-generation vector). Generation
guarding reuses the resident tier's per-table write counters
(resident.GENERATIONS): any write to a table a spooled subtree read
bumps that table's generation, which changes the key, so a stale entry
is unreachable — the same invalidation protocol the resident pins and
the plan cache use."""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.sql import plan as P
from trino_tpu_torch.analysis.witness import named_lock

# materialization guard rails: a barrier bigger than this stays in the
# plan (materializing it would trade one misestimated join for an
# equally unbounded host transfer)
MAX_SPOOL_ROWS = 1 << 18

# node types a materializable subtree may contain — deterministic
# relational core only (no remote sources / exchanges: those belong to
# the fragmenter, and materializing them would hide a data plane)
_MATERIALIZABLE_NODES = (
    P.ScanNode,
    P.ValuesNode,
    P.FilterNode,
    P.ProjectNode,
    P.AggregateNode,
    P.JoinNode,
    P.SortNode,
    P.TopNNode,
    P.LimitNode,
    P.EnforceSingleRowNode,
    P.UnionAllNode,
)


@dataclasses.dataclass(frozen=True)
class SpooledValuesNode(P.ValuesNode):
    """A materialized subtree as a literal source. `plan_stats` is the
    exact observed statistics of `rows` (excluded from eq/hash — two
    spools of the same rows are the same plan); `spool_key` names the
    SubtreeSpool entry so EXPLAIN and the physical planner can reach
    the device-resident batches without a python round trip;
    `source_desc` is the one-line provenance EXPLAIN renders."""

    spool_key: str = ""
    source_desc: str = ""
    plan_stats: Optional[object] = dataclasses.field(
        default=None, compare=False, hash=False
    )


def plan_fingerprint(node: P.PlanNode) -> str:
    """Structural identity of a subtree. Frozen-dataclass reprs are
    recursive and value-complete (handles include pushed constraints,
    expressions print their IR), so the repr IS the structure; hash it
    to keep spool keys short."""
    return hashlib.sha256(repr(node).encode()).hexdigest()[:24]


def subtree_tables(node: P.PlanNode) -> Tuple[Tuple[str, str, str], ...]:
    """Sorted (catalog, schema, table) triples the subtree reads — the
    generation-guard domain."""
    out = set()

    def walk(n):
        if isinstance(n, P.ScanNode):
            h = n.handle
            out.add((n.catalog.lower(), h.schema.lower(), h.table.lower()))
        for c in n.children():
            walk(c)

    walk(node)
    return tuple(sorted(out))


def _field_materializable(t: T.DataType) -> bool:
    """Types whose python values round-trip exactly through
    CollectorSink.rows() -> ValuesNode -> RelBatch.from_pydict:
    integer-like (incl. DATE/TIMESTAMP epoch values), floats, booleans
    and dictionary strings. Decimals re-quantize through float and
    TIMESTAMP_TZ decodes to display text, so both stay in the plan."""
    if t.is_nested or t.lanes != 1:
        return False
    if t.is_decimal or t.kind == T.TypeKind.TIMESTAMP_TZ:
        return False
    return True


def materializable(node: P.PlanNode) -> bool:
    """Whether a subtree may be replaced by its materialized rows:
    deterministic relational core only, all output types
    round-trippable."""
    if isinstance(node, P.ValuesNode):
        return False  # already literal — nothing to gain
    ok = True

    def walk(n):
        nonlocal ok
        if not isinstance(n, _MATERIALIZABLE_NODES):
            ok = False
            return
        for c in n.children():
            walk(c)

    walk(node)
    return ok and all(_field_materializable(f.type) for f in node.fields)


@dataclasses.dataclass
class SpoolEntry:
    rows: Tuple[Tuple[object, ...], ...]
    fields: Tuple[P.Field, ...]
    stats: object  # sql.stats.PlanStats
    tables: Tuple[Tuple[str, str, str], ...]
    generations: Tuple[int, ...]
    # the full ObservedStats snapshot (None for entries stored by paths
    # that never observed one, e.g. recovery stage teeing). Persisting
    # it matters for skew: a WARM spool hit must re-classify the same
    # heavy hitters the cold run saw, or the warm plan diverges from
    # the cold one and mints new lowerings.
    obs: Optional[object] = None


class SubtreeSpool:
    """Generation-guarded LRU of materialized subtrees. One entry
    serves every consumer of an identical subtree within a query (the
    NOT IN rewrite plans its subquery twice) and repeat executions of
    the same query until a table it read is written."""

    def __init__(self, max_entries: int = 64):
        self._lock = named_lock("SubtreeSpool._lock")
        self._entries: "OrderedDict[str, SpoolEntry]" = OrderedDict()
        self._max = max_entries
        self.stores = 0
        self.hits = 0
        self.invalidations = 0

    def _generations(self, tables) -> Tuple[int, ...]:
        from trino_tpu_torch.resident import GENERATIONS

        return GENERATIONS.snapshot(tables)

    def key(self, node: P.PlanNode) -> str:
        return plan_fingerprint(node)

    def get(self, key: str, tables) -> Optional[SpoolEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if self._generations(e.tables) != e.generations:
                # a write landed on a table this entry read: the entry
                # is stale by construction — drop it
                del self._entries[key]
                self.invalidations += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            from trino_tpu_torch.runtime.metrics import METRICS

            METRICS.increment("adaptive.spool_hits")
            return e

    def put(self, key: str, rows, fields, stats, tables,
            obs=None) -> SpoolEntry:
        e = SpoolEntry(
            rows=tuple(tuple(r) for r in rows),
            fields=tuple(fields),
            stats=stats,
            tables=tuple(tables),
            generations=self._generations(tables),
            obs=obs,
        )
        with self._lock:
            self._entries[key] = e
            self._entries.move_to_end(key)
            self.stores += 1
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)
        return e

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats_line(self) -> str:
        with self._lock:
            return (
                f"spool: entries={len(self._entries)} stores={self.stores} "
                f"hits={self.hits} invalidations={self.invalidations}"
            )


SPOOL = SubtreeSpool()


def spooled_node(
    entry: SpoolEntry, key: str, source_desc: str
) -> SpooledValuesNode:
    return SpooledValuesNode(
        fields=entry.fields,
        rows=entry.rows,
        spool_key=key,
        source_desc=source_desc,
        plan_stats=entry.stats,
    )


def substitute(
    root: P.PlanNode, replacements: Dict[int, P.PlanNode]
) -> P.PlanNode:
    """Rebuild `root` with every node whose id() appears in
    `replacements` swapped for its replacement (identity-keyed: the
    same subtree object appearing twice is replaced at both seats)."""

    def walk(n: P.PlanNode) -> P.PlanNode:
        r = replacements.get(id(n))
        if r is not None:
            return r
        kids = n.children()
        if not kids:
            return n
        new_kids = [walk(c) for c in kids]
        if all(a is b for a, b in zip(new_kids, kids)):
            return n
        if isinstance(n, P.UnionAllNode):
            return dataclasses.replace(n, inputs=tuple(new_kids))
        if isinstance(n, P.JoinNode):
            return dataclasses.replace(
                n, left=new_kids[0], right=new_kids[1]
            )
        return dataclasses.replace(n, child=new_kids[0])

    return walk(root)


def duplicate_subtrees(
    root: P.PlanNode, min_nodes: int = 1
) -> List[List[P.PlanNode]]:
    """Identical-subtree groups (>= 2 occurrences), outermost first.
    A subtree must contain a ScanNode to count (repeated literal
    Values are already free). Bare scans qualify: the NOT IN rewrite
    plans its subquery twice, and after predicate pushdown that
    subquery IS one constrained scan. Nested duplicates are
    suppressed: once a subtree is grouped, its descendants are not."""
    by_fp: Dict[str, List[P.PlanNode]] = {}
    sizes: Dict[int, int] = {}

    def measure(n) -> int:
        s = 1 + sum(measure(c) for c in n.children())
        sizes[id(n)] = s
        return s

    measure(root)

    def has_scan(n) -> bool:
        if isinstance(n, P.ScanNode):
            return True
        return any(has_scan(c) for c in n.children())

    def collect(n):
        if n is not root:
            by_fp.setdefault(plan_fingerprint(n), []).append(n)
        for c in n.children():
            collect(c)

    collect(root)
    groups = [
        nodes
        for nodes in by_fp.values()
        if len(nodes) >= 2
        and sizes[id(nodes[0])] >= min_nodes
        and materializable(nodes[0])
        and has_scan(nodes[0])
    ]
    # outermost (largest) first, and drop groups nested inside one we
    # already took — the outer materialization subsumes them
    groups.sort(key=lambda ns: -sizes[id(ns[0])])
    taken_ids: set = set()

    def ids_of(n, acc):
        acc.add(id(n))
        for c in n.children():
            ids_of(c, acc)

    out: List[List[P.PlanNode]] = []
    for nodes in groups:
        if any(id(n) in taken_ids for n in nodes):
            continue
        out.append(nodes)
        for n in nodes:
            ids_of(n, taken_ids)
    return out
