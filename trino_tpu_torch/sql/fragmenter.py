"""Distributed planning: AddExchanges + PlanFragmenter.

Analogue of main/sql/planner/optimizations/AddExchanges.java:140 (insert
REMOTE partitioned/broadcast/gathering exchanges by partitioning
properties, :266–276) and main/sql/planner/PlanFragmenter.java (cut the
plan at remote exchanges into a SubPlan tree of PlanFragments with
SystemPartitioningHandle-style handles — SURVEY.md §2.2, §2.7).

Two passes:
1. `add_exchanges(root)` — a properties-driven visitor that tracks each
   subtree's distribution (`single` / `source` / `hash(channels)` /
   `any`) and inserts ExchangeNodes where an operator needs a different
   one: partial->FINAL aggregation around a hash repartition, partitioned
   or broadcast joins, local-sort + merging gather, partial limits.
2. `fragment(root)` — cuts at every ExchangeNode, producing PlanFragments
   whose leaves are ScanNodes or RemoteSourceNodes.

Counterpart of trino_tpu/sql/fragmenter.py: host code over the port's
plan nodes, stats and aggregation state layout, so the fragments (and
EXPLAIN's rendering of them) are the reference's. The fragments run as
tasks over the page exchange (runtime/), or over the shard mesh, where
the same repartition is a collective (parallel/mesh_plan.py). Given the
catalogs, `explain_distributed` annotates each fragment with its shape
census summary, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.exec.operators import agg_state_meta
from trino_tpu_torch.sql import plan as P


def _metrics():
    # deferred: trino_tpu_torch.runtime's package __init__ imports the task
    # module, which imports this module (PlanFragment)
    from trino_tpu_torch.runtime.metrics import METRICS

    return METRICS

# -- distribution properties ------------------------------------------------

SINGLE = ("single",)
SOURCE = ("source",)
ANY = ("any",)  # distributed, partitioning unknown (post-project remap loss)


def hash_dist(channels: Tuple[int, ...]):
    return ("hash", tuple(channels))


def is_distributed(dist) -> bool:
    return dist != SINGLE


# -- fragments ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanFragment:
    """One schedulable stage (PlanFragment analogue). `partitioning` is
    how this fragment's tasks are laid out: "single" | "hash" | "source";
    `output_kind` + `output_channels` describe the PartitionedOutput at
    its root ("single" | "hash" | "broadcast" | "arbitrary").
    `suggested_partitions` is the stats-driven task count for hash
    fragments (DeterminePartitionCount.java:90)."""

    id: int
    root: P.PlanNode
    partitioning: str
    output_kind: str
    output_channels: Tuple[int, ...] = ()
    output_merge_keys: Tuple = ()
    suggested_partitions: Optional[int] = None


@dataclasses.dataclass
class SubPlan:
    fragment: PlanFragment
    children: List["SubPlan"]

    def all_fragments(self) -> List[PlanFragment]:
        out = [self.fragment]
        for c in self.children:
            out.extend(c.all_fragments())
        return out


# -- pass 1: AddExchanges ----------------------------------------------------


class _AddExchanges:
    def __init__(self, estimate_rows, broadcast_threshold: int,
                 scan_partitioning=None):
        self._estimate = estimate_rows
        self._broadcast_threshold = broadcast_threshold
        # ScanNode -> Optional[hash_dist(...)] from declared connector
        # bucketing (AddExchanges' use of actual table partitioning via
        # NodePartitioningManager.java:96)
        self._scan_partitioning = scan_partitioning

    def visit(self, node: P.PlanNode):
        m = getattr(self, f"_{type(node).__name__}", None)
        if m is None:
            raise NotImplementedError(f"AddExchanges: {type(node).__name__}")
        return m(node)

    # leaves
    def _ScanNode(self, node):
        if self._scan_partitioning is not None:
            dist = self._scan_partitioning(node)
            if dist is not None:
                # the connector's splits ARE hash buckets on these
                # channels: downstream joins/aggs on the same keys skip
                # their repartition exchange (co-bucketed execution)
                return node, dist
        return node, SOURCE

    def _ValuesNode(self, node):
        return node, SINGLE

    # a spooled (adaptively materialized) subtree is a literal leaf
    _SpooledValuesNode = _ValuesNode

    # pass-through (channels unchanged)
    def _FilterNode(self, node):
        child, dist = self.visit(node.child)
        return dataclasses.replace(node, child=child), dist

    def _LimitNode(self, node):
        child, dist = self.visit(node.child)
        if not is_distributed(dist):
            return dataclasses.replace(node, child=child), dist
        # partial limit per task, gather, final limit (LimitNode partial)
        pre = None
        if node.count is not None:
            pre = P.LimitNode(child, node.count + node.offset, 0, node.fields)
        gathered = _gather(pre if pre is not None else child)
        return (
            P.LimitNode(gathered, node.count, node.offset, node.fields),
            SINGLE,
        )

    def _ProjectNode(self, node):
        child, dist = self.visit(node.child)
        out = dataclasses.replace(node, child=child)
        if dist[0] != "hash":
            return out, dist
        # remap hash channels through identity projections; a lost key
        # degrades the property to "any" (still distributed)
        mapping: Dict[int, int] = {}
        from trino_tpu_torch.expr.ir import InputRef

        for i, e in enumerate(node.exprs):
            if isinstance(e, InputRef) and e.index not in mapping:
                mapping[e.index] = i
        new_channels = []
        for c in dist[1]:
            if c not in mapping:
                return out, ANY
            new_channels.append(mapping[c])
        return out, hash_dist(tuple(new_channels))

    def _EnforceSingleRowNode(self, node):
        child, dist = self.visit(node.child)
        if is_distributed(dist):
            child = _gather(child)
        return dataclasses.replace(node, child=child), SINGLE

    def _SortNode(self, node):
        child, dist = self.visit(node.child)
        if not is_distributed(dist):
            return dataclasses.replace(node, child=child), dist
        # local sort per task + merging gather (distributed sort,
        # MergeOperator.java:46 / dist-sort.rst)
        local = P.SortNode(child, node.keys, node.fields)
        ex = P.ExchangeNode(
            local, "gather", (), node.fields, merge_keys=tuple(node.keys)
        )
        return ex, SINGLE

    def _TopNNode(self, node):
        child, dist = self.visit(node.child)
        if not is_distributed(dist):
            return dataclasses.replace(node, child=child), dist
        partial = P.TopNNode(child, node.keys, node.count, node.fields)
        gathered = _gather(partial)
        return P.TopNNode(gathered, node.keys, node.count, node.fields), SINGLE

    def _UnionAllNode(self, node):
        new_inputs = []
        for child in node.inputs:
            c, dist = self.visit(child)
            if is_distributed(dist):
                c = _gather(c)
            new_inputs.append(c)
        return dataclasses.replace(node, inputs=tuple(new_inputs)), SINGLE

    def _OutputNode(self, node):
        child, dist = self.visit(node.child)
        if is_distributed(dist):
            child = _gather(child)
        return dataclasses.replace(node, child=child), SINGLE

    # aggregation: naive single-step placement over a repartition or
    # gather; push_partial_aggregation_through_exchange later splits it
    # into partial -> exchange -> final (the Trino split between
    # AddExchanges and PushPartialAggregationThroughExchange)
    def _AggregateNode(self, node):
        child, dist = self.visit(node.child)
        from trino_tpu_torch.exec.operators import HOLISTIC_KINDS

        holistic = any(a.kind in HOLISTIC_KINDS for a in node.aggs)
        if not is_distributed(dist) or holistic or any(
            a.distinct for a in node.aggs
        ):
            # distinct and holistic aggregation run single-step after a
            # gather (the MarkDistinct distributed form and mergeable
            # holistic sketches are future work)
            if is_distributed(dist):
                child = _gather(child)
            return dataclasses.replace(node, child=child), SINGLE
        groups = tuple(node.group_channels)
        if groups and dist == hash_dist(groups):
            # child already partitioned on the exact grouping keys: the
            # repartition exchange is provably redundant (co-bucketed
            # scans, or an upstream join/agg on the same keys)
            _metrics().increment("exchanges_elided")
            out = dataclasses.replace(node, child=child)
            return out, hash_dist(tuple(range(len(groups))))
        if not groups:
            return dataclasses.replace(node, child=_gather(child)), SINGLE
        ex = P.ExchangeNode(
            child, "repartition", groups, tuple(child.fields)
        )
        out = dataclasses.replace(node, child=ex)
        return out, hash_dist(tuple(range(len(groups))))

    def _WindowNode(self, node):
        child, dist = self.visit(node.child)
        if not is_distributed(dist):
            return dataclasses.replace(node, child=child), dist
        keys = tuple(node.partition_channels)
        if not keys:
            # no PARTITION BY: the whole input is one window partition
            child = _gather(child)
            return dataclasses.replace(node, child=child), SINGLE
        if dist != hash_dist(keys):
            child = P.ExchangeNode(
                child, "repartition", keys, tuple(node.child.fields)
            )
        else:
            _metrics().increment("exchanges_elided")
        out = dataclasses.replace(node, child=child)
        # window appends columns; partition channel positions survive
        return out, hash_dist(keys)

    # joins: partitioned or broadcast
    def _JoinNode(self, node):
        left, ldist = self.visit(node.left)
        right, rdist = self.visit(node.right)
        if not is_distributed(ldist) and not is_distributed(rdist):
            return dataclasses.replace(node, left=left, right=right), SINGLE

        build_rows = self._estimate(node.right)
        # FULL outer can never broadcast: a replicated build would emit
        # its unmatched rows once PER TASK (AddExchanges enforces the
        # same partitioned-only rule for full joins)
        broadcast = node.kind != "full" and (
            node.kind == "cross"
            or not node.right_keys
            or build_rows <= self._broadcast_threshold
        )
        if broadcast:
            # Replicate the build side whenever EITHER side is
            # distributed. A single-distribution build must still cross a
            # fragment boundary when the probe is multi-task: its internal
            # gather exchanges deliver to one consumer partition only, so
            # leaving it inline would starve every probe task but one.
            if is_distributed(rdist) or is_distributed(ldist):
                right = P.ExchangeNode(
                    right, "broadcast", (), _fields_of(node.right)
                )
            out_dist = ldist if is_distributed(ldist) else SINGLE
            return (
                dataclasses.replace(node, left=left, right=right),
                out_dist,
            )
        # partitioned join: both sides hash-distributed on the join keys
        lkeys, rkeys = tuple(node.left_keys), tuple(node.right_keys)
        if ldist != hash_dist(lkeys):
            left = P.ExchangeNode(left, "repartition", lkeys, _fields_of(node.left))
        else:
            _metrics().increment("exchanges_elided")
        if rdist != hash_dist(rkeys):
            right = P.ExchangeNode(right, "repartition", rkeys, _fields_of(node.right))
        else:
            _metrics().increment("exchanges_elided")
        out = dataclasses.replace(node, left=left, right=right)
        # semi/anti keep only left columns; inner/left keep left prefix —
        # either way the left keys' positions survive unchanged
        return out, hash_dist(lkeys)


def _fields_of(node: P.PlanNode) -> Tuple[P.Field, ...]:
    return tuple(node.fields)


def _gather(node: P.PlanNode) -> P.ExchangeNode:
    return P.ExchangeNode(node, "gather", (), tuple(node.fields))


def _partial_fields(node: P.AggregateNode, child: P.PlanNode) -> List[P.Field]:
    """Fields of the partial step's output (partial_output_schema shape)."""
    child_types = [(f.type, None) for f in child.fields]
    fields = [child.fields[c] for c in node.group_channels]
    for a in node.aggs:
        spec = _spec_of(a)
        (vt, _), _ = agg_state_meta(spec, child_types)
        name = a.kind if a.arg_channel is None else f"{a.kind}_{a.arg_channel}"
        fields.append(P.Field(f"{name}_val", vt))
        fields.append(P.Field(f"{name}_cnt", T.BIGINT))
    return fields


def _spec_of(a: P.AggCall):
    from trino_tpu_torch.exec.operators import AggSpec

    return AggSpec(a.kind, a.arg_channel, a.out_type, a.distinct,
                   a.arg2_channel, a.percentile, a.separator,
                   a.arg3_channel, a.param, a.post)


# -- exchange-tree rewrite passes --------------------------------------------


def eliminate_redundant_exchanges(root: P.PlanNode) -> P.PlanNode:
    """Drop a repartition feeding another repartition on the same keys:
    the inner shuffle lays rows out exactly as the outer one will again,
    so it only costs wire time. Arises when property tracking degrades
    to ANY (e.g. through a projection that drops a key) and a
    conservative repartition gets stacked on an existing one. Counted
    in the `exchanges_elided` metric alongside the property-driven
    skips in _AddExchanges."""

    def walk(n: P.PlanNode) -> P.PlanNode:
        kids = [walk(c) for c in n.children()]
        if kids:
            n = _replace_children(n, kids)
        if (
            isinstance(n, P.ExchangeNode)
            and n.kind == "repartition"
            and isinstance(n.child, P.ExchangeNode)
            and n.child.kind == "repartition"
            and n.child.hash_channels == n.hash_channels
            and not n.child.merge_keys
        ):
            _metrics().increment("exchanges_elided")
            n = dataclasses.replace(n, child=n.child.child)
        return n

    return walk(root)


# skip the partial/final split when the estimated aggregation output is
# at least this fraction of its input: the partial step would shrink
# nothing, so it only adds a device pass + a wider wire schema
PARTIAL_AGG_MIN_REDUCTION = 0.9


def push_partial_aggregation_through_exchange(
    root: P.PlanNode, stats=None
) -> P.PlanNode:
    """Split a mergeable single-step aggregation sitting on a
    repartition (or gather) exchange into partial -> exchange -> final,
    so each producer task pre-aggregates before rows cross the wire
    (PushPartialAggregationThroughExchange.java as an explicit pass
    over the naive plan _AddExchanges now emits).

    With a StatsCalculator the split is cost-based: when NDV(group
    keys) ~= input rows (estimated output >= PARTIAL_AGG_MIN_REDUCTION
    of input) the partial step cannot reduce wire volume and is
    skipped — Trino's preferPartialAggregation cost gate. Without
    stats (legacy one-arg callers) the split stays structural."""
    from trino_tpu_torch.exec.operators import HOLISTIC_KINDS

    def walk(n: P.PlanNode) -> P.PlanNode:
        kids = [walk(c) for c in n.children()]
        if kids:
            n = _replace_children(n, kids)
        if not isinstance(n, P.AggregateNode) or n.step != "single":
            return n
        if any(a.kind in HOLISTIC_KINDS or a.distinct for a in n.aggs):
            return n
        ex = n.child
        if not isinstance(ex, P.ExchangeNode) or ex.merge_keys:
            return n
        groups = tuple(n.group_channels)
        if ex.kind == "repartition":
            if not groups or set(ex.hash_channels) != set(groups):
                return n
        elif ex.kind != "gather" or groups:
            return n
        if stats is not None and groups:
            # skip the split ONLY on confident stats: every group key
            # needs a known NDV. Unknown NDV defaults to sqrt(rows) in
            # StatsCalculator, so with >=2 keys the product saturates
            # at row_count and the gate would silently disable partial
            # aggregation everywhere (TPC-DS q72 regressed ~20% wall
            # from exactly that) — unknown stats keep the structural
            # split, which is also runtime-adaptive on the wire.
            try:
                child_stats = stats.stats(ex.child)
                in_rows = child_stats.row_count
                ndvs = [child_stats.col(c).ndv for c in groups]
            except Exception:
                in_rows, ndvs = None, [None]
            if in_rows and all(v is not None for v in ndvs):
                out_rows = 1.0
                for v in ndvs:
                    out_rows *= v
                out_rows = min(out_rows, in_rows)
                if out_rows >= PARTIAL_AGG_MIN_REDUCTION * in_rows:
                    return n
        k = len(groups)
        partial_fields = tuple(_partial_fields(n, ex.child))
        partial = dataclasses.replace(
            n, child=ex.child, step="partial", fields=partial_fields
        )
        final_aggs = tuple(
            dataclasses.replace(a, arg_channel=k + 2 * i)
            for i, a in enumerate(n.aggs)
        )
        if ex.kind == "gather":
            new_ex = P.ExchangeNode(partial, "gather", (), partial_fields)
        else:
            # partial output puts the group keys first
            new_ex = P.ExchangeNode(
                partial, "repartition", tuple(range(k)), partial_fields
            )
        return P.AggregateNode(
            new_ex, tuple(range(k)), final_aggs, n.fields, step="final"
        )

    return walk(root)


# -- row estimation: the cost-based StatsCalculator (sql/stats.py) -----------


def make_row_estimator(catalogs):
    """Cardinality estimates for the broadcast-vs-partitioned decision,
    backed by the stats-propagation framework (main/cost/ analogue)."""
    from trino_tpu_torch.sql.stats import StatsCalculator

    calc = StatsCalculator(catalogs)
    return lambda node: calc.stats(node).row_count


# -- pass 2: fragment cutting ------------------------------------------------


class _Fragmenter:
    def __init__(self):
        self.fragments: Dict[int, PlanFragment] = {}
        self.children: Dict[int, List[int]] = {}
        self._next_id = 0

    def cut(self, root: P.PlanNode) -> SubPlan:
        """Cut the exchange-annotated plan; the root fragment is always
        single-partitioned (the coordinator-consumed stage)."""
        new_root, child_ids = self._rewrite(root)
        fid = self._new_fragment(new_root, "single", (), ())
        self.children[fid] = child_ids
        return self._subplan(fid)

    def _subplan(self, fid: int) -> SubPlan:
        return SubPlan(
            self.fragments[fid],
            [self._subplan(c) for c in self.children.get(fid, [])],
        )

    def _new_fragment(self, root, output_kind, output_channels, merge_keys) -> int:
        fid = self._next_id
        self._next_id += 1
        self.fragments[fid] = PlanFragment(
            id=fid,
            root=root,
            partitioning=_fragment_partitioning(root),
            output_kind=output_kind,
            output_channels=tuple(output_channels),
            output_merge_keys=tuple(merge_keys),
        )
        return fid

    def _rewrite(self, node: P.PlanNode) -> Tuple[P.PlanNode, List[int]]:
        """Replace each ExchangeNode subtree with a RemoteSourceNode and
        register the producer fragment. Returns (node', child fragment
        ids referenced anywhere below node)."""
        if isinstance(node, P.ExchangeNode):
            child, grandchildren = self._rewrite(node.child)
            if node.kind == "gather":
                out_kind, out_channels = "single", ()
            elif node.kind == "repartition":
                out_kind, out_channels = "hash", node.hash_channels
            else:
                out_kind, out_channels = "broadcast", ()
            fid = self._new_fragment(child, out_kind, out_channels, node.merge_keys)
            self.children[fid] = grandchildren
            rs = P.RemoteSourceNode(
                (fid,), tuple(node.fields), tuple(node.merge_keys)
            )
            return rs, [fid]
        kids = list(node.children())
        if not kids:
            return node, []
        new_kids, ids = [], []
        for c in kids:
            nc, cids = self._rewrite(c)
            new_kids.append(nc)
            ids.extend(cids)
        return _replace_children(node, new_kids), ids


def _replace_children(node: P.PlanNode, kids: List[P.PlanNode]) -> P.PlanNode:
    if isinstance(node, P.JoinNode):
        return dataclasses.replace(node, left=kids[0], right=kids[1])
    if isinstance(node, P.UnionAllNode):
        return dataclasses.replace(node, inputs=tuple(kids))
    return dataclasses.replace(node, child=kids[0])


def _make_scan_partitioning(catalogs, target_splits: int):
    """ScanNode -> Optional[hash_dist] from the connector's declared
    bucketing (spi.ConnectorMetadata.table_partitioning). The derived
    property relies on both schedulers' split assignment rule — task p
    of tc scans splits[p::tc] of get_splits(max(target_splits, tc)) — so
    bucket i lands on task i only when the connector returns EXACTLY tc
    splits; with a session target_splits > 1 the request can exceed tc
    and fold several buckets onto one task, where a runtime-repartitioned
    third side would no longer align. Bucketing is therefore only
    claimed at the default split target."""
    if target_splits > 1:
        return None

    def resolve(node):
        try:
            conn = catalogs.get(node.catalog)
            cols = conn.metadata.table_partitioning(node.handle)
        except Exception:
            return None
        if not cols:
            return None
        try:
            chans = tuple(node.columns.index(c) for c in cols)
        except ValueError:
            # a pruned-away bucket column: splits are still buckets, but
            # the property is unverifiable downstream — stay SOURCE
            return None
        return hash_dist(chans)

    return resolve


def _fragment_partitioning(root: P.PlanNode) -> str:
    """Task layout of a fragment, derived from its leaves: connector
    splits ("source"), hash-partitioned remote input ("hash"), else a
    single task. Broadcast-only remote inputs pair with whatever the
    other leaves say (a broadcast build feeding a source-distributed
    probe keeps "source")."""
    def any_node(n, pred) -> bool:
        return pred(n) or any(any_node(c, pred) for c in n.children())

    if any_node(root, lambda n: isinstance(n, P.ScanNode)):
        return "source"
    # consumer of a hash repartition is hash-partitioned; a gather/
    # broadcast-only consumer runs single — plan_distributed refines
    # this once producers are known (consumes_hash_input).
    if any_node(root, lambda n: isinstance(n, P.RemoteSourceNode)):
        return "hash"
    return "single"


def consumes_hash_input(fragment: PlanFragment, producers: Dict[int, PlanFragment]) -> bool:
    """True when any remote source feeding this fragment is
    hash-partitioned output (fixed task count > 1 is meaningful)."""
    found = [False]

    def walk(n):
        if isinstance(n, P.RemoteSourceNode):
            for fid in n.fragment_ids:
                if producers[fid].output_kind == "hash":
                    found[0] = True
        for c in n.children():
            walk(c)

    walk(fragment.root)
    return found[0]


# -- public entry ------------------------------------------------------------


def plan_distributed(
    root: P.OutputNode,
    catalogs,
    broadcast_threshold: int = 1_000_000,
    target_splits: int = 1,
    validation: str = "passes",
) -> SubPlan:
    """Logical plan -> SubPlan tree of PlanFragments (the
    LogicalPlanner->AddExchanges->PlanFragmenter.createSubPlans path).
    `validation` != "off" runs the fragment-level sanity checkers
    (sql/validate.py) over the result before it ships to schedulers."""
    from trino_tpu_torch.sql.stats import StatsCalculator

    calc = StatsCalculator(catalogs)
    estimate = lambda node: calc.stats(node).row_count
    adder = _AddExchanges(
        estimate, broadcast_threshold,
        scan_partitioning=_make_scan_partitioning(catalogs, target_splits),
    )
    annotated, _ = adder.visit(root)
    annotated = eliminate_redundant_exchanges(annotated)
    annotated = push_partial_aggregation_through_exchange(annotated, calc)
    subplan = _Fragmenter().cut(annotated)
    # refine "hash" vs "single" partitioning now that producers are known,
    # and derive stats-driven partition counts per hash stage
    frags = {f.id: f for f in subplan.all_fragments()}
    from trino_tpu_torch.sql.stats import determine_partition_count

    def hash_input_rows(fragment: PlanFragment) -> float:
        total = [0.0]

        def walk(n):
            if isinstance(n, P.RemoteSourceNode):
                for fid in n.fragment_ids:
                    prod = frags[fid]
                    if prod.output_kind == "hash":
                        total[0] += estimate(prod.root)
            for c in n.children():
                walk(c)

        walk(fragment.root)
        return total[0]

    def refine(sp: SubPlan):
        f = sp.fragment
        if f.partitioning == "hash":
            if not consumes_hash_input(f, frags):
                sp.fragment = dataclasses.replace(f, partitioning="single")
            else:
                rows = hash_input_rows(f)
                sp.fragment = dataclasses.replace(
                    f,
                    suggested_partitions=determine_partition_count(rows, 1 << 10),
                )
        for c in sp.children:
            refine(c)

    refine(subplan)
    if validation != "off":
        from trino_tpu_torch.sql.validate import validate_subplan

        validate_subplan(subplan)
    return subplan


def explain_distributed(subplan: SubPlan, catalogs=None, batch_rows: int = 1 << 20,
                        dynamic_filtering: bool = True, warn_threshold: int = 0) -> str:
    """EXPLAIN (TYPE DISTRIBUTED) rendering: one section per fragment.
    With `catalogs` each fragment also carries its shape census summary
    (sql/validate.py)."""
    lines = []
    for f in sorted(subplan.all_fragments(), key=lambda f: f.id):
        out = f.output_kind
        if f.output_channels:
            out += f" on={list(f.output_channels)}"
        header = f"Fragment {f.id} [{f.partitioning}] output={out}"
        if catalogs is not None:
            from trino_tpu_torch.sql.validate import census_line, shape_census

            classes = shape_census(f.root, catalogs, batch_rows=batch_rows,
                                   dynamic_filtering=dynamic_filtering)
            header += " " + census_line(classes, warn_threshold)
        lines.append(header)
        lines.append(P.explain_text(f.root, indent=1))
    return "\n".join(lines)
