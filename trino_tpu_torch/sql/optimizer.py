"""Plan optimizer: memo, iterative rule engine, cost-based join reorder.

Analogue of the reference's optimizer stack (SURVEY.md §2.2):

- `Memo` — group-per-subtree plan store whose nodes point at child
  *groups* (main/sql/planner/iterative/Memo.java:37). Rules replace a
  group's representative without rebuilding the whole tree.
- `IterativeOptimizer` — applies a rule set to every group to fixpoint
  (main/sql/planner/iterative/IterativeOptimizer.java:63). Rules get a
  `Context` with a GroupRef resolver and a StatsCalculator, mirroring
  Rule.Context's Lookup + StatsProvider.
- `ReorderJoins` — cost-based join-order search over maximal inner-join
  regions: DPsub over connected sub-graphs with probe/build orientation
  chosen by cost, replacing the analyzer's greedy smaller-side order
  (main/sql/planner/iterative/rule/ReorderJoins.java:84 + main/cost/
  JoinStatsRule / CostCalculatorUsingExchanges). Output schema is
  restored with a permutation Project so enclosing plans are untouched.

The pass pipeline (`optimize`) mirrors PlanOptimizers.java's staged
list: simplification to fixpoint, then join reordering, then a cleanup
fixpoint for the projections reordering introduces.

The rule inventory is deliberately smaller than the reference's ~220:
the analyzer already plans subqueries/pushdowns during translation, so
the rules here are the ones with post-translation leverage. Each rule
cites its reference analogue.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.expr import ir
from trino_tpu_torch.sql import plan as P
from trino_tpu_torch.sql.cost import CostCalculator
from trino_tpu_torch.sql.stats import StatsCalculator

MAX_DP_LEAVES = 10       # beyond this, keep the analyzer's greedy order
MAX_FIXPOINT_PASSES = 16


# ---------------------------------------------------------------------------
# expression utilities
# ---------------------------------------------------------------------------


def expr_refs(e: ir.Expr) -> set:
    """Channels an expression reads."""
    out: set = set()

    def walk(x: ir.Expr):
        if isinstance(x, ir.InputRef):
            out.add(x.index)
        for c in x.children():
            walk(c)

    walk(e)
    return out


def substitute(e: ir.Expr, mapping: Dict[int, ir.Expr]) -> ir.Expr:
    """Replace InputRefs by expressions (projection inlining)."""
    if isinstance(e, ir.InputRef):
        return mapping[e.index]
    if isinstance(e, ir.Call):
        return ir.Call(e.name, tuple(substitute(a, mapping) for a in e.args), e.type)
    if isinstance(e, ir.Cast):
        return ir.Cast(substitute(e.arg, mapping), e.type)
    if isinstance(e, ir.Case):
        return ir.Case(
            tuple(substitute(c, mapping) for c in e.conds),
            tuple(substitute(r, mapping) for r in e.results),
            substitute(e.default, mapping) if e.default is not None else None,
            e.type,
        )
    if isinstance(e, ir.InList):
        return ir.InList(substitute(e.value, mapping), e.options, e.type)
    return e  # Literal


def shift_refs(e: ir.Expr, delta: int) -> ir.Expr:
    if isinstance(e, ir.InputRef):
        return ir.InputRef(e.index + delta, e.type)
    if isinstance(e, ir.Call):
        return ir.Call(e.name, tuple(shift_refs(a, delta) for a in e.args), e.type)
    if isinstance(e, ir.Cast):
        return ir.Cast(shift_refs(e.arg, delta), e.type)
    if isinstance(e, ir.Case):
        return ir.Case(
            tuple(shift_refs(c, delta) for c in e.conds),
            tuple(shift_refs(r, delta) for r in e.results),
            shift_refs(e.default, delta) if e.default is not None else None,
            e.type,
        )
    if isinstance(e, ir.InList):
        return ir.InList(shift_refs(e.value, delta), e.options, e.type)
    return e


def split_conjuncts(e: ir.Expr) -> List[ir.Expr]:
    if isinstance(e, ir.Call) and e.name == "and":
        out: List[ir.Expr] = []
        for a in e.args:
            out.extend(split_conjuncts(a))
        return out
    return [e]


# ---------------------------------------------------------------------------
# child plumbing for frozen plan nodes
# ---------------------------------------------------------------------------


def with_children(node: P.PlanNode, new_children: Sequence[P.PlanNode]) -> P.PlanNode:
    kids = tuple(node.children())
    if len(kids) != len(new_children):
        raise ValueError("child arity mismatch")
    if all(a is b for a, b in zip(kids, new_children)):
        return node
    if isinstance(node, P.JoinNode):
        left, right = new_children
        return dataclasses.replace(node, left=left, right=right)
    if isinstance(node, P.UnionAllNode):
        return dataclasses.replace(node, inputs=tuple(new_children))
    return dataclasses.replace(node, child=new_children[0])


def _fresh_tree(node: P.PlanNode) -> P.PlanNode:
    """Rebuild every interior node of a subtree as a new object.

    Rewrites that replicate a subtree into several plan positions (the
    multi-sketch UNION ALL expansion) must not alias the same node
    object from two parents: node identity doubles as the plan-node id,
    and id()-keyed consumers (StatsCalculator's memo, the structure
    validator) assume tree shape. Leaves stay shared — they have no
    children for a traversal to double-visit.
    """
    kids = tuple(node.children())
    if not kids:
        return node
    new_kids = [_fresh_tree(k) for k in kids]
    if isinstance(node, P.JoinNode):
        return dataclasses.replace(node, left=new_kids[0], right=new_kids[1])
    if isinstance(node, P.UnionAllNode):
        return dataclasses.replace(node, inputs=tuple(new_kids))
    return dataclasses.replace(node, child=new_kids[0])


# ---------------------------------------------------------------------------
# Memo
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupRef(P.PlanNode):
    """Placeholder child pointing at a memo group
    (iterative/GroupReference.java)."""

    group: int
    fields: Tuple[P.Field, ...]

    def children(self):
        return ()


class Memo:
    """Plan store: every subtree lives in a group; nodes reference child
    groups through GroupRef (Memo.java:37 — without multi-expression
    exploration groups; one representative per group, like the
    reference's, which also keeps exactly one node per group and relies
    on rules returning full replacements)."""

    def __init__(self, root: P.PlanNode):
        self._nodes: Dict[int, P.PlanNode] = {}
        self._next = 0
        self.root = self._insert(root)

    def _insert(self, node: P.PlanNode) -> int:
        if isinstance(node, GroupRef):
            return node.group
        kids = [
            GroupRef(self._insert(c), c.fields)
            if not isinstance(c, GroupRef) else c
            for c in node.children()
        ]
        gid = self._next
        self._next += 1
        self._nodes[gid] = with_children(node, kids) if kids else node
        return gid

    def node(self, gid: int) -> P.PlanNode:
        return self._nodes[gid]

    def resolve(self, node: P.PlanNode) -> P.PlanNode:
        """GroupRef -> its group's current representative."""
        if isinstance(node, GroupRef):
            return self._nodes[node.group]
        return node

    def replace(self, gid: int, new_subtree: P.PlanNode) -> None:
        """Install a replacement for a group; fresh (non-GroupRef)
        children get groups of their own."""
        kids = [
            c if isinstance(c, GroupRef)
            else GroupRef(self._insert(c), c.fields)
            for c in new_subtree.children()
        ]
        self._nodes[gid] = (
            with_children(new_subtree, kids) if kids else new_subtree
        )

    def extract(self, gid: Optional[int] = None) -> P.PlanNode:
        gid = self.root if gid is None else gid
        node = self._nodes[gid]
        kids = [
            self.extract(c.group) if isinstance(c, GroupRef) else c
            for c in node.children()
        ]
        return with_children(node, kids) if kids else node

    def groups(self) -> List[int]:
        return list(self._nodes)


@dataclasses.dataclass
class Context:
    """Rule.Context analogue: lookup + stats. `last_rule` records the
    most recently applied rule so a PlanValidationError can name the
    rewrite that broke the invariant."""

    memo: Memo
    stats: Optional[StatsCalculator] = None
    last_rule: Optional[str] = None

    def resolve(self, node: P.PlanNode) -> P.PlanNode:
        return self.memo.resolve(node)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


class Rule:
    """apply() returns a replacement subtree (children may be the
    matched node's GroupRef children) or None for no match."""

    name = "rule"

    def apply(self, node: P.PlanNode, ctx: Context) -> Optional[P.PlanNode]:
        raise NotImplementedError


class MergeFilters(Rule):
    """Filter(Filter(x)) -> Filter(x, p1 AND p2)
    (rule/MergeFilters.java)."""

    name = "merge_filters"

    def apply(self, node, ctx):
        if not isinstance(node, P.FilterNode):
            return None
        child = ctx.resolve(node.child)
        if not isinstance(child, P.FilterNode):
            return None
        return P.FilterNode(
            child.child,
            ir.and_(child.predicate, node.predicate),
            node.fields,
        )


class RemoveIdentityProject(Rule):
    """Project that reproduces its child verbatim disappears
    (rule/RemoveRedundantIdentityProjections.java)."""

    name = "remove_identity_project"

    def apply(self, node, ctx):
        if not isinstance(node, P.ProjectNode):
            return None
        child = ctx.resolve(node.child)
        if len(node.exprs) != len(child.fields):
            return None
        if node.fields != child.fields:
            return None
        for i, e in enumerate(node.exprs):
            if not (isinstance(e, ir.InputRef) and e.index == i):
                return None
        # splice the child's group in place of this one
        return child if not isinstance(node.child, GroupRef) else ctx.memo.node(
            node.child.group
        )


class InlineProjections(Rule):
    """Project(Project(x)) -> Project(x) when safe: every inner
    expression is trivial or referenced at most once
    (rule/InlineProjections.java's duplication guard)."""

    name = "inline_projections"

    def apply(self, node, ctx):
        if not isinstance(node, P.ProjectNode):
            return None
        child = ctx.resolve(node.child)
        if not isinstance(child, P.ProjectNode):
            return None
        counts: Dict[int, int] = {}
        for e in node.exprs:
            for r in expr_refs(e):
                counts[r] = counts.get(r, 0) + 1
        for idx, inner in enumerate(child.exprs):
            trivial = isinstance(inner, (ir.InputRef, ir.Literal))
            if not trivial and counts.get(idx, 0) > 1:
                return None
        mapping = dict(enumerate(child.exprs))
        return P.ProjectNode(
            child.child,
            tuple(substitute(e, mapping) for e in node.exprs),
            node.fields,
        )


class PushFilterThroughProject(Rule):
    """Filter(Project(x)) -> Project(Filter(x)) by substituting the
    projection into the predicate (rule/PushdownFilterIntoProject
    family); filters run earlier and joins below become visible to
    reordering."""

    name = "push_filter_through_project"

    def apply(self, node, ctx):
        if not isinstance(node, P.FilterNode):
            return None
        child = ctx.resolve(node.child)
        if not isinstance(child, P.ProjectNode):
            return None
        # duplication guard (the reference's isInliningCandidate): only
        # push when every projection the predicate touches is trivial —
        # otherwise the expensive expression runs in the filter AND in
        # the retained Project
        for r in expr_refs(node.predicate):
            if r < len(child.exprs) and not isinstance(
                child.exprs[r], (ir.InputRef, ir.Literal)
            ):
                return None
        mapping = dict(enumerate(child.exprs))
        pred = substitute(node.predicate, mapping)
        grandchild = child.child
        return P.ProjectNode(
            P.FilterNode(
                grandchild,
                pred,
                ctx.resolve(grandchild).fields
                if isinstance(grandchild, GroupRef)
                else grandchild.fields,
            ),
            child.exprs,
            child.fields,
        )


class InferTransitivePredicates(Rule):
    """EqualityInference over a post-join filter (sql/equality.py —
    main/sql/planner/EqualityInference.java:57): equivalence classes
    from inner-join equi-keys and conjunct equalities; every
    single-channel deterministic conjunct is replicated onto each
    equivalent channel, so a filter on one join key reaches the other
    side's scan once PushFilterIntoJoin distributes the conjuncts.
    Fires at most once per filter (derive() returns only conjuncts not
    already present), ordered BEFORE PushFilterIntoJoin so the derived
    copies are still above the join when they appear."""

    name = "infer_transitive_predicates"

    def apply(self, node, ctx):
        from trino_tpu_torch.sql.equality import EqualityInference

        if not isinstance(node, P.FilterNode):
            return None
        join = ctx.resolve(node.child)
        if not isinstance(join, P.JoinNode) or join.kind not in ("inner", "cross"):
            return None
        left = ctx.resolve(join.left)
        width_l = len(left.fields)
        conjuncts = split_conjuncts(node.predicate)
        inf = EqualityInference()
        for lk, rk in zip(join.left_keys, join.right_keys):
            inf.add_equality(lk, width_l + rk)
        inf.add_conjunct_equalities(conjuncts)
        derived = inf.derive(conjuncts, join.fields, _is_deterministic)
        if not derived:
            return None
        return P.FilterNode(
            node.child, ir.and_(*(conjuncts + derived)), node.fields
        )


class PushFilterIntoJoin(Rule):
    """Split a post-join filter's conjuncts to the join sides they
    reference (rule/PushPredicateIntoTableScan's ancestor pass,
    PredicatePushDown.java): inner joins only — under outer joins a
    pushed predicate changes NULL-extension semantics."""

    name = "push_filter_into_join"

    def apply(self, node, ctx):
        if not isinstance(node, P.FilterNode):
            return None
        join = ctx.resolve(node.child)
        if not isinstance(join, P.JoinNode) or join.kind not in ("inner", "cross"):
            return None
        left = ctx.resolve(join.left)
        width_l = len(left.fields)
        width = len(join.fields)
        left_parts: List[ir.Expr] = []
        right_parts: List[ir.Expr] = []
        keep: List[ir.Expr] = []
        for c in split_conjuncts(node.predicate):
            refs = expr_refs(c)
            if refs and max(refs) < width_l:
                left_parts.append(c)
            elif refs and min(refs) >= width_l and max(refs) < width:
                right_parts.append(c)
            else:
                keep.append(c)
        if not left_parts and not right_parts:
            return None
        new_left = join.left
        if left_parts:
            new_left = P.FilterNode(
                join.left, ir.and_(*left_parts), left.fields
            )
        new_right = join.right
        if right_parts:
            rfields = ctx.resolve(join.right).fields
            new_right = P.FilterNode(
                join.right,
                ir.and_(*[shift_refs(c, -width_l) for c in right_parts]),
                rfields,
            )
        out: P.PlanNode = dataclasses.replace(
            join, left=new_left, right=new_right
        )
        if keep:
            out = P.FilterNode(out, ir.and_(*keep), node.fields)
        return out


class PushPredicateIntoTableScan(Rule):
    """Filter(Scan) -> Scan' [+ residual Filter] through the connector's
    apply_filter SPI hook (rule/PushPredicateIntoTableScan.java:141 +
    ConnectorMetadata.applyFilter). Only conjuncts expressible as
    per-column ``ColumnConstraint``s are offered; whatever the
    connector declines — plus everything unclassifiable — stays in a
    FilterNode above the scan (residual-predicate semantics)."""

    name = "push_predicate_into_table_scan"

    def __init__(self, catalogs):
        self._catalogs = catalogs

    def apply(self, node, ctx):
        from trino_tpu_torch.connectors.pushdown import (
            classify_conjunct,
            merge_handle_constraints,
        )

        if not isinstance(node, P.FilterNode):
            return None
        scan = ctx.resolve(node.child)
        if not isinstance(scan, P.ScanNode):
            return None
        handle = scan.handle
        conjuncts = split_conjuncts(node.predicate)
        offered: Dict[int, object] = {}
        for i, c in enumerate(conjuncts):
            if not _is_deterministic(c):
                continue
            cc = classify_conjunct(c, scan.columns, scan.fields)
            if cc is not None and cc not in handle.constraints:
                offered[i] = cc
        if not offered:
            return None
        try:
            conn = self._catalogs.get(scan.catalog)
        except KeyError:
            return None
        result = conn.metadata.apply_filter(handle, tuple(offered.values()))
        if result is None:
            return None
        new_handle, residual = result
        accepted = [cc for cc in offered.values() if cc not in residual]
        if not accepted:
            return None
        if new_handle is handle or new_handle == handle:
            # connector claimed acceptance but returned the same handle;
            # fold the constraints in engine-side so the plan records them
            new_handle = merge_handle_constraints(handle, accepted)
        keep = [
            c
            for i, c in enumerate(conjuncts)
            if i not in offered or offered[i] not in accepted
        ]
        new_scan = dataclasses.replace(scan, handle=new_handle)
        if not keep:
            return new_scan
        return P.FilterNode(new_scan, ir.and_(*keep), node.fields)


class PushProjectionIntoTableScan(Rule):
    """Project(Scan) -> Project(Scan') with the scan narrowed to the
    channels the projection actually reads, when the connector accepts
    via apply_projection (rule/PushProjectionIntoTableScan.java). The
    page source then materializes only surviving columns (the tpch
    generator literally skips generating the rest)."""

    name = "push_projection_into_table_scan"

    def __init__(self, catalogs):
        self._catalogs = catalogs

    def apply(self, node, ctx):
        if not isinstance(node, P.ProjectNode):
            return None
        scan = ctx.resolve(node.child)
        if not isinstance(scan, P.ScanNode):
            return None
        used = sorted(set().union(*map(expr_refs, node.exprs)) if node.exprs else ())
        if not used:
            # count(*)-style: only the row count matters — scan the
            # cheapest single column (fixed-width over dictionary)
            used = [
                min(
                    range(len(scan.fields)),
                    key=lambda i: (scan.fields[i].type.is_string, i),
                )
            ]
        if len(used) >= len(scan.columns):
            return None
        try:
            conn = self._catalogs.get(scan.catalog)
        except KeyError:
            return None
        new_cols = tuple(scan.columns[i] for i in used)
        new_handle = conn.metadata.apply_projection(scan.handle, new_cols)
        if new_handle is None:
            return None
        remap = {
            old: ir.InputRef(new, scan.fields[old].type)
            for new, old in enumerate(used)
        }
        new_scan = P.ScanNode(
            scan.catalog,
            new_handle,
            new_cols,
            tuple(scan.fields[i] for i in used),
        )
        return P.ProjectNode(
            new_scan,
            tuple(substitute(e, remap) for e in node.exprs),
            node.fields,
        )


class LimitOverSortToTopN(Rule):
    """Limit(Sort(x)) -> TopN (rule/MergeLimitWithSort.java)."""

    name = "limit_over_sort_to_topn"

    def apply(self, node, ctx):
        if not isinstance(node, P.LimitNode) or node.count is None:
            return None
        if node.offset:
            return None
        child = ctx.resolve(node.child)
        if not isinstance(child, P.SortNode):
            return None
        return P.TopNNode(child.child, child.keys, node.count, node.fields)


class EvaluateEmptyJoin(Rule):
    """Inner join with a zero-row Values side is empty
    (rule/EvaluateEmptyIntersect / RemoveEmpty* family)."""

    name = "evaluate_empty_join"

    def apply(self, node, ctx):
        if not isinstance(node, P.JoinNode) or node.kind not in ("inner", "cross"):
            return None
        for side in (node.left, node.right):
            s = ctx.resolve(side)
            if isinstance(s, P.ValuesNode) and not s.rows:
                return P.ValuesNode(node.fields, ())
        return None


class MergeLimits(Rule):
    """Limit(Limit(x)) -> one Limit with the tighter count and summed
    offsets (rule/MergeLimits.java)."""

    name = "merge_limits"

    def apply(self, node, ctx):
        if not isinstance(node, P.LimitNode):
            return None
        child = ctx.resolve(node.child)
        if not isinstance(child, P.LimitNode):
            return None
        # outer sees child's post-offset stream: child rows
        # [child.offset, child.offset+child.count); outer then skips
        # node.offset more and takes node.count
        counts = []
        if child.count is not None:
            counts.append(max(child.count - node.offset, 0))
        if node.count is not None:
            counts.append(node.count)
        return P.LimitNode(
            child.child,
            min(counts) if counts else None,
            child.offset + node.offset,
            node.fields,
        )


class PushLimitThroughProject(Rule):
    """Limit(Project(x)) -> Project(Limit(x)) — projections are
    row-wise, so limiting first shrinks the projected batch
    (rule/PushLimitThroughProject.java). Only fires when the projection
    is not itself sitting on another Limit (avoid ping-ponging with
    MergeLimits)."""

    name = "push_limit_through_project"

    def apply(self, node, ctx):
        if not isinstance(node, P.LimitNode):
            return None
        child = ctx.resolve(node.child)
        if not isinstance(child, P.ProjectNode):
            return None
        inner = ctx.resolve(child.child)
        if isinstance(inner, (P.LimitNode, P.TopNNode)):
            return None
        limited = P.LimitNode(
            child.child, node.count, node.offset, tuple(inner.fields)
            if hasattr(inner, "fields") else tuple(child.child.fields),
        )
        return P.ProjectNode(limited, child.exprs, node.fields)


class PushTopNThroughProject(Rule):
    """TopN(Project(x)) -> Project(TopN(x)) when every sort key maps to
    a direct input column of the projection
    (rule/PushTopNThroughProject.java)."""

    name = "push_topn_through_project"

    def apply(self, node, ctx):
        if not isinstance(node, P.TopNNode):
            return None
        child = ctx.resolve(node.child)
        if not isinstance(child, P.ProjectNode):
            return None
        inner = ctx.resolve(child.child)
        if isinstance(inner, (P.TopNNode, P.SortNode, P.LimitNode)):
            return None
        remapped = []
        for k in node.keys:
            ex = child.exprs[k.channel]
            if not isinstance(ex, ir.InputRef):
                return None
            remapped.append(dataclasses.replace(k, channel=ex.index))
        topn = P.TopNNode(
            child.child, tuple(remapped), node.count,
            tuple(child.child.fields)
            if hasattr(child.child, "fields") else tuple(inner.fields),
        )
        return P.ProjectNode(topn, child.exprs, node.fields)


class RemoveTrivialFilters(Rule):
    """Filter(TRUE) disappears; Filter(FALSE/NULL) becomes an empty
    Values (rule/RemoveTrivialFilters.java)."""

    name = "remove_trivial_filters"

    def apply(self, node, ctx):
        if not isinstance(node, P.FilterNode):
            return None
        p = node.predicate
        if not isinstance(p, ir.Literal):
            return None
        if p.value is True:
            child = ctx.resolve(node.child)
            return child
        return P.ValuesNode(node.fields, ())


class PushLimitThroughUnion(Rule):
    """Limit(n, Union(a, b)) -> Limit(n, Union(Limit(n+off, a), ...)):
    each branch needs at most the outer window
    (rule/PushLimitThroughUnion.java). Fires once per union (inner
    limits mark it)."""

    name = "push_limit_through_union"

    def apply(self, node, ctx):
        if not isinstance(node, P.LimitNode) or node.count is None:
            return None
        child = ctx.resolve(node.child)
        if not isinstance(child, P.UnionAllNode):
            return None
        want = node.count + node.offset
        new_inputs = []
        changed = False
        for inp in child.inputs:
            r = ctx.resolve(inp)
            if isinstance(r, P.LimitNode) and r.count is not None \
                    and r.count <= want:
                new_inputs.append(inp)
                continue
            new_inputs.append(P.LimitNode(
                inp, want, 0,
                tuple(r.fields) if hasattr(r, "fields") else node.fields,
            ))
            changed = True
        if not changed:
            return None
        return P.LimitNode(
            dataclasses.replace(child, inputs=tuple(new_inputs)),
            node.count, node.offset, node.fields,
        )


_NONDETERMINISTIC_FNS = {"rand", "random", "uuid", "shuffle", "now"}


def _is_deterministic(e) -> bool:
    """False when the expression calls a volatile function — pushing it
    below an aggregation/window re-evaluates it against a different row
    set (PredicatePushDown pushes deterministic conjuncts only)."""
    if isinstance(e, ir.Call):
        if e.name in _NONDETERMINISTIC_FNS:
            return False
        return all(_is_deterministic(a) for a in e.args)
    for f in dataclasses.fields(e) if dataclasses.is_dataclass(e) else ():
        v = getattr(e, f.name)
        if isinstance(v, ir.Expr) and not _is_deterministic(v):
            return False
        if isinstance(v, tuple) and any(
            isinstance(i, ir.Expr) and not _is_deterministic(i) for i in v
        ):
            return False
    return True


class PushFilterThroughAggregation(Rule):
    """Filter conjuncts touching only GROUP KEY outputs move below the
    aggregation (PredicatePushDown.visitAggregation): the filter then
    shrinks the aggregation's input instead of its output."""

    name = "push_filter_through_aggregation"

    def apply(self, node, ctx):
        if not isinstance(node, P.FilterNode):
            return None
        agg = ctx.resolve(node.child)
        if not isinstance(agg, P.AggregateNode) or agg.step != "single":
            return None
        k = len(agg.group_channels)
        if k == 0:
            return None
        child_fields = ctx.resolve(agg.child).fields
        mapping = {
            i: ir.InputRef(
                agg.group_channels[i],
                child_fields[agg.group_channels[i]].type,
            )
            for i in range(k)
        }
        push, keep = [], []
        for c in split_conjuncts(node.predicate):
            refs = expr_refs(c)
            if refs and max(refs) < k and _is_deterministic(c):
                push.append(substitute(c, mapping))
            else:
                keep.append(c)
        if not push:
            return None
        new_child = P.FilterNode(agg.child, ir.and_(*push), child_fields)
        out: P.PlanNode = dataclasses.replace(agg, child=new_child)
        if keep:
            out = P.FilterNode(out, ir.and_(*keep), node.fields)
        return out


class PushFilterThroughWindow(Rule):
    """Filter conjuncts over PARTITION BY columns move below the window
    (rule/PushdownFilterIntoWindow's safe case): dropping whole
    partitions cannot change any surviving row's window result."""

    name = "push_filter_through_window"

    def apply(self, node, ctx):
        if not isinstance(node, P.FilterNode):
            return None
        win = ctx.resolve(node.child)
        if not isinstance(win, P.WindowNode):
            return None
        part = set(win.partition_channels)
        if not part:
            return None
        child_fields = ctx.resolve(win.child).fields
        push, keep = [], []
        for c in split_conjuncts(node.predicate):
            refs = expr_refs(c)
            if refs and all(r in part for r in refs) \
                    and _is_deterministic(c):
                push.append(c)  # window passes child channels through
            else:
                keep.append(c)
        if not push:
            return None
        new_child = P.FilterNode(win.child, ir.and_(*push), child_fields)
        out: P.PlanNode = dataclasses.replace(win, child=new_child)
        if keep:
            out = P.FilterNode(out, ir.and_(*keep), node.fields)
        return out


class FlattenUnion(Rule):
    """UnionAll(UnionAll(a, b), c) -> UnionAll(a, b, c)
    (rule/MergeUnion.java)."""

    name = "flatten_union"

    def apply(self, node, ctx):
        if not isinstance(node, P.UnionAllNode):
            return None
        flat, changed = [], False
        for inp in node.inputs:
            r = ctx.resolve(inp)
            if isinstance(r, P.UnionAllNode):
                flat.extend(r.inputs)
                changed = True
            else:
                flat.append(inp)
        if not changed:
            return None
        return P.UnionAllNode(tuple(flat), node.fields)


class PushFilterThroughUnion(Rule):
    """Filter(UnionAll(inputs)) -> UnionAll(Filter(input)...) — branch
    channels align 1:1, so the predicate applies verbatim per branch
    (PredicatePushDown.visitUnion)."""

    name = "push_filter_through_union"

    def apply(self, node, ctx):
        if not isinstance(node, P.FilterNode):
            return None
        u = ctx.resolve(node.child)
        if not isinstance(u, P.UnionAllNode):
            return None
        new_inputs = tuple(
            P.FilterNode(inp, node.predicate, ctx.resolve(inp).fields)
            for inp in u.inputs
        )
        return P.UnionAllNode(new_inputs, u.fields)


class RemoveRedundantDistinct(Rule):
    """DISTINCT over an aggregation output keyed on every column is a
    no-op: group keys are already unique
    (rule/RemoveRedundantDistinctLimit's core observation)."""

    name = "remove_redundant_distinct"

    def apply(self, node, ctx):
        if not isinstance(node, P.AggregateNode) or node.aggs:
            return None
        if tuple(node.group_channels) != tuple(range(len(node.fields))):
            return None
        child = ctx.resolve(node.child)
        if not isinstance(child, P.AggregateNode):
            return None
        # the child's whole output is its group-key set (a distinct or
        # a grouped aggregation selecting only its keys)
        if len(child.fields) == len(child.group_channels) + len(child.aggs) \
                and len(node.fields) == len(child.fields) \
                and not child.aggs:
            return child
        return None


class PushAggregationThroughOuterJoin(Rule):
    """Aggregation grouping on ALL left-join probe columns, aggregating
    only build columns, pushes below the join when the probe side is
    provably distinct (rule/PushAggregationThroughOuterJoin.java —
    the correlated-scalar / Q17 shape). count() over NULL-extended
    rows restores its 0 via a coalesce projection."""

    name = "push_aggregation_through_outer_join"

    _PUSHABLE = {"sum", "min", "max", "avg", "any", "count"}

    def apply(self, node, ctx):
        if not isinstance(node, P.AggregateNode) or node.step != "single":
            return None
        join = ctx.resolve(node.child)
        if not isinstance(join, P.JoinNode) or join.kind != "left" \
                or join.residual is not None:
            return None
        left = ctx.resolve(join.left)
        wl = len(left.fields)
        # grouping must cover exactly the probe columns (any order)
        if sorted(node.group_channels) != list(range(wl)):
            return None
        # probe side provably distinct: its own full-width distinct
        if not (
            isinstance(left, P.AggregateNode)
            and not left.aggs
            and tuple(left.group_channels) == tuple(range(len(left.fields)))
        ):
            return None
        right = ctx.resolve(join.right)
        for a in node.aggs:
            if a.kind not in self._PUSHABLE or a.distinct:
                return None
            if a.arg_channel is None or a.arg_channel < wl:
                return None
            if a.arg2_channel is not None or a.arg3_channel is not None:
                return None
        rk = tuple(join.right_keys)
        shifted = tuple(
            dataclasses.replace(a, arg_channel=a.arg_channel - wl)
            for a in node.aggs
        )
        r_fields = tuple(right.fields[c] for c in rk) + tuple(
            P.Field(None, a.out_type) for a in node.aggs
        )
        right_agg = P.AggregateNode(join.right, rk, shifted, r_fields)
        nj_fields = left.fields + r_fields
        new_join = P.JoinNode(
            "left", join.left, right_agg,
            tuple(join.left_keys), tuple(range(len(rk))), None, nj_fields,
        )
        # restore the original output layout [group keys..., aggs...];
        # count over a null-extended row reads 0, not NULL
        exprs: List[ir.Expr] = []
        for g in node.group_channels:
            exprs.append(ir.InputRef(g, left.fields[g].type))
        for i, a in enumerate(node.aggs):
            ref: ir.Expr = ir.InputRef(wl + len(rk) + i, a.out_type)
            if a.kind == "count":
                ref = ir.Call(
                    "coalesce", (ref, ir.Literal(0, a.out_type)),
                    a.out_type,
                )
            exprs.append(ref)
        return P.ProjectNode(new_join, tuple(exprs), node.fields)


SIMPLIFICATION_RULES: Tuple[Rule, ...] = (
    MergeFilters(),
    InlineProjections(),
    RemoveIdentityProject(),
    PushFilterThroughProject(),
    InferTransitivePredicates(),
    PushFilterIntoJoin(),
    LimitOverSortToTopN(),
    EvaluateEmptyJoin(),
    MergeLimits(),
    PushLimitThroughProject(),
    PushTopNThroughProject(),
    RemoveTrivialFilters(),
    PushLimitThroughUnion(),
    PushFilterThroughAggregation(),
    PushFilterThroughWindow(),
    FlattenUnion(),
    PushFilterThroughUnion(),
    RemoveRedundantDistinct(),
    PushAggregationThroughOuterJoin(),
)


class IterativeOptimizer:
    """Fixpoint driver (IterativeOptimizer.java:63): visit every memo
    group, offer each rule the group's representative, install
    replacements, repeat until a full pass fires nothing."""

    def __init__(self, rules: Sequence[Rule] = SIMPLIFICATION_RULES):
        self._rules = tuple(rules)

    def optimize(
        self,
        root: P.PlanNode,
        stats: Optional[StatsCalculator] = None,
        validator=None,
    ) -> P.PlanNode:
        """`validator(plan, rule_name)` — when given (plan_validation=
        rules), the extracted plan is re-validated after EVERY rule
        application, so a violation names the exact rewrite that
        introduced it."""
        memo = Memo(root)
        ctx = Context(memo, stats)
        for _ in range(MAX_FIXPOINT_PASSES):
            fired = False
            for gid in memo.groups():
                if gid not in memo._nodes:
                    continue
                progress = True
                while progress:
                    progress = False
                    node = memo.node(gid)
                    for rule in self._rules:
                        result = rule.apply(node, ctx)
                        if result is not None and result is not node:
                            memo.replace(gid, result)
                            ctx.last_rule = rule.name
                            if validator is not None:
                                validator(memo.extract(), rule.name)
                            progress = True
                            fired = True
                            break
            if not fired:
                break
        return memo.extract()


# ---------------------------------------------------------------------------
# cost-based join reordering
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Region:
    """A maximal tree of clean inner joins. leaves are the non-region
    subtrees in original concat order; edges are equi-join pairs
    ((leaf_i, off_i), (leaf_j, off_j))."""

    leaves: List[P.PlanNode]
    edges: List[Tuple[Tuple[int, int], Tuple[int, int]]]


def _is_region_join(node: P.PlanNode) -> bool:
    return (
        isinstance(node, P.JoinNode)
        and node.kind == "inner"
        and node.residual is None
    )


def _extract_region(root: P.JoinNode) -> _Region:
    leaves: List[P.PlanNode] = []
    edges: List[Tuple[Tuple[int, int], Tuple[int, int]]] = []

    def locate(layout: List[int], ch: int) -> Tuple[int, int]:
        off = ch
        for leaf_idx in layout:
            w = len(leaves[leaf_idx].fields)
            if off < w:
                return (leaf_idx, off)
            off -= w
        raise AssertionError("key channel outside layout")

    def walk(node: P.PlanNode) -> List[int]:
        if _is_region_join(node):
            left_layout = walk(node.left)
            right_layout = walk(node.right)
            for lk, rk in zip(node.left_keys, node.right_keys):
                edges.append((locate(left_layout, lk), locate(right_layout, rk)))
            return left_layout + right_layout
        leaves.append(node)
        return [len(leaves) - 1]

    walk(root)
    return _Region(leaves, edges)


# -- shared "other aggregates" re-aggregation plumbing for the approx
# rewrites: both expand an AggregateNode into two levels, so plain
# aggregates must split into per-level calls (sum->sum/sum,
# count->count/sum, avg->sum+count/sum+sum then a final division).
_REAGG_KINDS = {"sum", "count", "count_star", "min", "max", "any"}
_REAGG_MAP = {"sum": "sum", "count": "sum", "count_star": "sum",
              "min": "min", "max": "max", "any": "any"}


def _reagg_ok(o: P.AggCall) -> bool:
    """Can this plain aggregate re-aggregate through two levels?"""
    if o.distinct:
        return False
    # avg re-aggregates as (sum, count): float avgs in double, decimal
    # avgs EXACTLY via a decimal(38,s) sum + HALF_UP division (the
    # DecimalAverageAggregation contract) — VERDICT r3 item #3
    return o.kind in _REAGG_KINDS or o.kind == "avg"


def _reagg_a1_calls(o: P.AggCall, pos: int, arg_ch, a1_aggs, a1_fields):
    """Append o's LEVEL-1 state aggregates; returns their slot indexes."""
    slots = []
    if o.kind == "avg":
        sum_t = (
            T.decimal(T.MAX_DECIMAL_PRECISION, o.out_type.scale or 0)
            if o.out_type.is_decimal
            else T.DOUBLE
        )
        slots.append(len(a1_aggs))
        a1_aggs.append(P.AggCall("sum", arg_ch, sum_t))
        a1_fields.append(P.Field(f"$s{pos}", sum_t))
        slots.append(len(a1_aggs))
        a1_aggs.append(P.AggCall("count", arg_ch, T.BIGINT))
        a1_fields.append(P.Field(f"$c{pos}", T.BIGINT))
    else:
        slots.append(len(a1_aggs))
        a1_aggs.append(P.AggCall(o.kind, arg_ch, o.out_type))
        a1_fields.append(P.Field(f"$s{pos}", o.out_type))
    return slots


def _reagg_a2_call(o: P.AggCall, si: int):
    """(kind, out_type) of the LEVEL-2 re-aggregate for state slot si."""
    if o.kind == "avg":
        sum_t = (
            T.decimal(T.MAX_DECIMAL_PRECISION, o.out_type.scale or 0)
            if o.out_type.is_decimal
            else T.DOUBLE
        )
        return "sum", (sum_t if si == 0 else T.BIGINT)
    return _REAGG_MAP[o.kind], o.out_type


def _reagg_final_expr(o: P.AggCall, chs, ref):
    """Final output expression from the A2 channels `chs`."""
    if o.kind == "avg":
        return ir.Call("div", (ref(chs[0]), ref(chs[1])), o.out_type)
    return ref(chs[0])


class RewriteMultiSketch:
    """SEVERAL approx sketch aggregates in one node -> tagged UNION ALL
    expansion (VERDICT r3 item #3 — the single-sketch rewrites below
    were gated to exactly one approx aggregate per node; this removes
    the holistic raw-row fallback for every approx_distinct /
    approx_percentile combination).

    Each sketch's register/bucket file becomes a grouping dimension as
    in the single rewrites, but the dimensions cannot share one GROUP
    BY (a (k, b1, b2) grouping would be the register-file PRODUCT). So
    the child replicates once per sketch through UNION ALL with a $tag
    column, every branch computing ONLY its sketch's bucket/payload
    (NULL elsewhere), and plain re-aggregable siblings riding branch 0
    alone (their inputs are NULL on other branches, which every
    mergeable aggregate ignores; count(*) becomes count($one) with
    $one NULL off branch 0). One A1 over (k, tag, bucket), one A2 over
    k with per-tag CASE masks, then the original output layout.

    Trade-off: the child subtree evaluates once per sketch — still
    mergeable end to end (partial/final wire, spill, mesh collectives),
    unlike the holistic path's full raw-row gather to one node.
    approx_percentile payloads travel as DOUBLE here (its bucket
    interpolation is double-precision already)."""

    _SKETCH_KINDS = ("approx_distinct", "approx_percentile")

    def rewrite(self, node: P.PlanNode) -> P.PlanNode:
        kids = [self.rewrite(c) for c in node.children()]
        node = with_children(node, kids)
        if not isinstance(node, P.AggregateNode) or node.step != "single":
            return node
        sketches = [
            (i, a) for i, a in enumerate(node.aggs)
            if a.kind in self._SKETCH_KINDS and not a.distinct
        ]
        if len(sketches) < 2:
            return node  # single sketches keep their leaner rewrites
        sk_pos = {i for i, _ in sketches}
        others = [
            (i, a) for i, a in enumerate(node.aggs) if i not in sk_pos
        ]
        if not all(_reagg_ok(o) for _, o in others):
            return node
        return self._expand(node, sketches, others)

    def _expand(self, node: P.AggregateNode, sketches, others):
        child = node.child
        K = len(node.group_channels)
        ref = lambda ch, nd: ir.InputRef(ch, nd.fields[ch].type)
        null = lambda t: ir.Literal(None, t)

        # -- branches: one projection of the child per sketch ----------
        branches: List[P.PlanNode] = []
        branch_fields: Optional[Tuple[P.Field, ...]] = None
        for t, (pos, a) in enumerate(sketches):
            # each branch gets its own copy of the child subtree —
            # aliasing one object under two UnionAll inputs turns the
            # tree into a DAG (see _fresh_tree)
            src = child if t == 0 else _fresh_tree(child)
            exprs: List[ir.Expr] = [
                ref(c, child) for c in node.group_channels
            ]
            fields: List[P.Field] = [
                child.fields[c] for c in node.group_channels
            ]
            exprs.append(ir.Literal(t, T.BIGINT))
            fields.append(P.Field("$tag", T.BIGINT))
            x = ref(a.arg_channel, child)
            if a.kind == "approx_distinct":
                exprs += [
                    ir.Call("hll_bucket", (x,), T.BIGINT),
                    ir.Call("hll_rho", (x,), T.BIGINT),
                    null(T.DOUBLE),
                ]
            else:
                exprs += [
                    ir.Call("pctl_bucket", (x,), T.BIGINT),
                    null(T.BIGINT),
                    ir.Cast(x, T.DOUBLE),
                ]
            fields += [
                P.Field("$b", T.BIGINT),
                P.Field("$rho", T.BIGINT),
                P.Field("$x", T.DOUBLE),
            ]
            for pos2, o in others:
                if o.arg_channel is None:
                    # count(*) marker: 1 on branch 0, NULL elsewhere
                    exprs.append(
                        ir.Literal(1, T.BIGINT) if t == 0 else null(T.BIGINT)
                    )
                    fields.append(P.Field(f"$one{pos2}", T.BIGINT))
                else:
                    ft = child.fields[o.arg_channel]
                    exprs.append(
                        ref(o.arg_channel, child) if t == 0 else null(ft.type)
                    )
                    fields.append(ft)
            branches.append(P.ProjectNode(src, tuple(exprs), tuple(fields)))
            branch_fields = branches[-1].fields
        u = P.UnionAllNode(tuple(branches), branch_fields)

        # -- A1: group by (k, tag, b) ---------------------------------
        # union layout: [k... | $tag=K | $b=K+1 | $rho=K+2 | $x=K+3 |
        # other args from K+4]
        rho_u, x_u = K + 2, K + 3
        a1_aggs: List[P.AggCall] = [
            P.AggCall("max", rho_u, T.BIGINT),   # $maxrho
            P.AggCall("count", x_u, T.BIGINT),   # $c  (pctl)
            P.AggCall("min", x_u, T.DOUBLE),     # $mn (pctl)
            P.AggCall("max", x_u, T.DOUBLE),     # $mx (pctl)
        ]
        a1_fields = list(u.fields[: K + 2]) + [
            P.Field("$maxrho", T.BIGINT), P.Field("$c", T.BIGINT),
            P.Field("$mn", T.DOUBLE), P.Field("$mx", T.DOUBLE),
        ]
        state_slots: Dict[int, List[int]] = {}
        for j, (pos2, o) in enumerate(others):
            arg = K + 4 + j  # the per-other column in the union layout
            # count(*) must count ONLY branch-0 rows: it aggregates the
            # $one marker (NULL off branch 0) as a plain count
            o_eff = (
                o if o.arg_channel is not None
                else P.AggCall("count", arg, o.out_type)
            )
            state_slots[pos2] = _reagg_a1_calls(
                o_eff, pos2, arg, a1_aggs, a1_fields,
            )
        a1 = P.AggregateNode(
            u, tuple(range(K + 2)), tuple(a1_aggs), tuple(a1_fields),
            "single",
        )
        # A1 layout: [k..., $tag, $b, $maxrho, $c, $mn, $mx, states...]

        # -- L2: weights + per-tag masks ------------------------------
        tag_ch, b_ch = K, K + 1
        mr, c_ch, mn_ch, mx_ch = K + 2, K + 3, K + 4, K + 5
        exprs2: List[ir.Expr] = [ref(c, a1) for c in range(K)]
        fields2: List[P.Field] = list(a1.fields[:K])

        def mask(t, e, out_t):
            return ir.Case(
                (ir.Call(
                    "eq", (ref(tag_ch, a1), ir.Literal(t, T.BIGINT)),
                    T.BOOLEAN,
                ),),
                (e,),
                None,
                out_t,
            )

        sk_ch: Dict[int, List[int]] = {}
        for t, (pos, a) in enumerate(sketches):
            chs = []
            if a.kind == "approx_distinct":
                w = ir.Call(
                    "hll_weight_rho", (ref(mr, a1), ref(b_ch, a1)), T.DOUBLE
                )
                chs.append(len(exprs2))
                exprs2.append(mask(t, w, T.DOUBLE))
                fields2.append(P.Field(f"$w{t}", T.DOUBLE))
                chs.append(len(exprs2))
                exprs2.append(mask(t, ref(b_ch, a1), T.BIGINT))
                fields2.append(P.Field(f"$mb{t}", T.BIGINT))
            else:
                for src, ot in ((mn_ch, T.DOUBLE), (c_ch, T.BIGINT),
                                (mx_ch, T.DOUBLE)):
                    chs.append(len(exprs2))
                    exprs2.append(mask(t, ref(src, a1), ot))
                    fields2.append(P.Field(f"$p{t}_{src}", ot))
            sk_ch[pos] = chs
        state_ch2: Dict[int, List[int]] = {}
        for pos2, o in others:
            state_ch2[pos2] = []
            for slot in state_slots[pos2]:
                state_ch2[pos2].append(len(exprs2))
                exprs2.append(ref(K + 2 + slot, a1))
                fields2.append(a1.fields[K + 2 + slot])
        l2 = P.ProjectNode(a1, tuple(exprs2), tuple(fields2))

        # -- A2: group by k -------------------------------------------
        a2_aggs: List[P.AggCall] = []
        a2_fields = list(l2.fields[:K])
        out_ch: Dict[int, List[int]] = {}
        for t, (pos, a) in enumerate(sketches):
            chs = sk_ch[pos]
            if a.kind == "approx_distinct":
                out_ch[pos] = [K + len(a2_aggs), K + len(a2_aggs) + 1]
                a2_aggs.append(P.AggCall("sum", chs[0], T.DOUBLE))
                a2_fields.append(P.Field(f"$sw{t}", T.DOUBLE))
                a2_aggs.append(P.AggCall("count", chs[1], T.BIGINT))
                a2_fields.append(P.Field(f"$cnt{t}", T.BIGINT))
            else:
                out_ch[pos] = [K + len(a2_aggs)]
                a2_aggs.append(P.AggCall(
                    "pctl_merge", chs[0], a.out_type,
                    arg2_channel=chs[1], arg3_channel=chs[2],
                    percentile=a.percentile,
                ))
                a2_fields.append(P.Field(f"$p{t}", a.out_type))
        final_ch: Dict[int, List[int]] = {}
        for pos2, o in others:
            final_ch[pos2] = []
            for si, ch2 in enumerate(state_ch2[pos2]):
                re_kind, out_t = _reagg_a2_call(o, si)
                final_ch[pos2].append(K + len(a2_aggs))
                a2_aggs.append(P.AggCall(re_kind, ch2, out_t))
                a2_fields.append(P.Field(f"$f{pos2}_{si}", out_t))
        a2 = P.AggregateNode(
            l2, tuple(range(K)), tuple(a2_aggs), tuple(a2_fields), "single"
        )

        # -- restore the original output layout -----------------------
        exprs4: List[ir.Expr] = [ref(c, a2) for c in range(K)]
        smap = dict(sketches)
        for i, a in enumerate(node.aggs):
            if i in smap:
                if a.kind == "approx_distinct":
                    exprs4.append(ir.Call(
                        "hll_estimate",
                        (ref(out_ch[i][0], a2), ref(out_ch[i][1], a2)),
                        T.BIGINT,
                    ))
                else:
                    exprs4.append(ref(out_ch[i][0], a2))
            else:
                exprs4.append(_reagg_final_expr(
                    a, final_ch[i], lambda c: ref(c, a2)
                ))
        return P.ProjectNode(a2, tuple(exprs4), tuple(node.fields))


class RewriteApproxDistinct:
    """approx_distinct -> a two-level MERGEABLE aggregation (plan
    rewrite), replacing the holistic raw-row gather (VERDICT r2
    missing #1; reference:
    operator/aggregation/ApproximateCountDistinctAggregations.java).

    approx_distinct(x) GROUP BY k becomes

        Project  k..., hll_estimate($sw, $cnt), other finals...
          Aggregate k:    sum($w) as $sw, count($b) as $cnt, re-aggs...
            Project k..., $w = hll_weight_rho($maxrho, $b), $b, states...
              Aggregate (k..., $b): max($r) as $maxrho, partial others...
                Project k..., $b = hll_bucket(x), $r = hll_rho(x), args...

    i.e. the HLL register file IS a grouping dimension: register
    updates are a grouped max, register merges across partials are the
    SAME grouped max, and every level is a plain mergeable aggregation
    that rides the existing partial/final wire, spill, and mesh
    collective paths unchanged — nothing gathers raw rows. NULL x rows
    land in the NULL-bucket group (SQL GROUP BY keeps them), carry
    weight 0, and keep all-NULL key groups alive, so no join or
    null-key normalization is needed. m=2048 registers (standard error
    1.04/sqrt(m) = 2.3%, the reference's default).

    Mixed aggregates re-aggregate through both levels (sum->sum,
    count->sum, min->min, ...). Queries mixing approx_distinct with
    non-re-aggregable kinds (avg over decimals, holistic kinds,
    DISTINCT-qualified aggs) or with several approx_distincts keep the
    single-step holistic path."""

    def rewrite(self, node: P.PlanNode) -> P.PlanNode:
        kids = [self.rewrite(c) for c in node.children()]
        node = with_children(node, kids)
        if not isinstance(node, P.AggregateNode) or node.step != "single":
            return node
        hlls = [
            (i, a) for i, a in enumerate(node.aggs)
            if a.kind == "approx_distinct"
        ]
        if len(hlls) != 1:
            return node
        others = [
            (i, a) for i, a in enumerate(node.aggs)
            if a.kind != "approx_distinct"
        ]
        if not all(_reagg_ok(o) for _, o in others):
            return node
        return self._expand(node, hlls[0], others)

    def _expand(self, node: P.AggregateNode, hll, others) -> P.PlanNode:
        child = node.child
        K = len(node.group_channels)
        hll_pos, hll_agg = hll
        ref = lambda ch, nd: ir.InputRef(ch, nd.fields[ch].type)

        # -- L0: project keys + bucket/rho + other args --
        exprs: List[ir.Expr] = [
            ref(c, child) for c in node.group_channels
        ]
        fields: List[P.Field] = [
            child.fields[c] for c in node.group_channels
        ]
        x = ref(hll_agg.arg_channel, child)
        exprs += [
            ir.Call("hll_bucket", (x,), T.BIGINT),
            ir.Call("hll_rho", (x,), T.BIGINT),
        ]
        fields += [P.Field("$hll_b", T.BIGINT), P.Field("$hll_r", T.BIGINT)]
        arg_ch: Dict[int, Optional[int]] = {}
        for pos, o in others:
            if o.arg_channel is None:
                arg_ch[pos] = None
                continue
            arg_ch[pos] = len(exprs)
            exprs.append(ref(o.arg_channel, child))
            fields.append(child.fields[o.arg_channel])
        l0 = P.ProjectNode(child, tuple(exprs), tuple(fields))

        # -- A1: group by (k..., bucket); max(rho) + partial others --
        a1_aggs: List[P.AggCall] = [
            P.AggCall("max", K + 1, T.BIGINT)
        ]
        a1_fields = list(l0.fields[: K + 1]) + [P.Field("$maxrho", T.BIGINT)]
        # per other agg: list of A1 state slots (avg splits in two)
        state_slots: Dict[int, List[int]] = {}
        for pos, o in others:
            state_slots[pos] = _reagg_a1_calls(
                o, pos, arg_ch[pos], a1_aggs, a1_fields
            )
        a1 = P.AggregateNode(
            l0, tuple(range(K + 1)), tuple(a1_aggs), tuple(a1_fields),
            "single",
        )
        # A1 output layout: [k..., $b, $maxrho, states...]

        # -- L2: keys + weight + bucket + states --
        exprs2: List[ir.Expr] = [ref(c, a1) for c in range(K)]
        fields2: List[P.Field] = list(a1.fields[:K])
        exprs2.append(
            ir.Call(
                "hll_weight_rho",
                (ref(K + 1, a1), ref(K, a1)),
                T.DOUBLE,
            )
        )
        fields2.append(P.Field("$w", T.DOUBLE))
        exprs2.append(ref(K, a1))
        fields2.append(P.Field("$hll_b", T.BIGINT))
        state_ch2: Dict[int, List[int]] = {}
        for pos, o in others:
            state_ch2[pos] = []
            for slot in state_slots[pos]:
                state_ch2[pos].append(len(exprs2))
                exprs2.append(ref(K + 2 + slot - 1, a1))
                fields2.append(a1.fields[K + 2 + slot - 1])
        l2 = P.ProjectNode(a1, tuple(exprs2), tuple(fields2))

        # -- A2: group by k; sum(w), count(b), re-agg others --
        a2_aggs: List[P.AggCall] = [
            P.AggCall("sum", K, T.DOUBLE),
            P.AggCall("count", K + 1, T.BIGINT),
        ]
        a2_fields = list(l2.fields[:K]) + [
            P.Field("$sw", T.DOUBLE), P.Field("$cnt", T.BIGINT),
        ]
        final_ch: Dict[int, List[int]] = {}
        for pos, o in others:
            final_ch[pos] = []
            for si, ch2 in enumerate(state_ch2[pos]):
                re_kind, out_t = _reagg_a2_call(o, si)
                final_ch[pos].append(K + len(a2_aggs))
                a2_aggs.append(P.AggCall(re_kind, ch2, out_t))
                a2_fields.append(P.Field(f"$f{pos}_{si}", out_t))
        a2 = P.AggregateNode(
            l2, tuple(range(K)), tuple(a2_aggs), tuple(a2_fields),
            "single",
        )

        # -- L4: restore the original output layout --
        exprs4: List[ir.Expr] = [ref(c, a2) for c in range(K)]
        for i, a in enumerate(node.aggs):
            if i == hll_pos:
                exprs4.append(
                    ir.Call(
                        "hll_estimate",
                        (ref(K, a2), ref(K + 1, a2)),
                        T.BIGINT,
                    )
                )
            else:
                exprs4.append(_reagg_final_expr(
                    node.aggs[i], final_ch[i], lambda c: ref(c, a2)
                ))
        return P.ProjectNode(a2, tuple(exprs4), tuple(node.fields))


class RewriteDistinctAggs:
    """DISTINCT aggregates -> dedup-then-aggregate (two plain
    aggregation levels), the reference's
    SingleDistinctAggregationToGroupBy rule. count(DISTINCT x) GROUP BY
    k becomes

        Aggregate k: count(x), ...
          Aggregate (k..., x): [dedup]

    Both levels are ordinary mergeable aggregations, so DISTINCT aggs
    ride the partial/final wire AND the mesh collective data plane
    (mesh_plan rejects AggCall.distinct — this rewrite removes it).
    Applies when every aggregate is DISTINCT over the SAME argument
    (the common count(DISTINCT x) shape); mixed distinct/plain keeps
    the local MarkDistinct-style path."""

    _KINDS = {"count", "sum", "avg", "min", "max"}

    def rewrite(self, node: P.PlanNode) -> P.PlanNode:
        kids = [self.rewrite(c) for c in node.children()]
        node = with_children(node, kids)
        if not isinstance(node, P.AggregateNode) or node.step != "single":
            return node
        if not node.aggs or not all(a.distinct for a in node.aggs):
            return node
        if any(a.arg_channel is None for a in node.aggs):
            return node
        if not all(a.kind in self._KINDS for a in node.aggs):
            return node
        child = node.child
        # "same argument" up to projection duplication: the analyzer
        # gives each aggregate its own projected channel, so compare the
        # underlying expressions when the child is a Project
        def basis(ch):
            if isinstance(child, P.ProjectNode):
                return child.exprs[ch]
            return ch

        bases = {basis(a.arg_channel) for a in node.aggs}
        if len(bases) != 1:
            return node
        K = len(node.group_channels)
        arg = node.aggs[0].arg_channel
        dedup_fields = tuple(
            [child.fields[c] for c in node.group_channels]
            + [child.fields[arg]]
        )
        dedup = P.AggregateNode(
            child,
            tuple(node.group_channels) + (arg,),
            (),
            dedup_fields,
            "single",
        )
        aggs = tuple(
            P.AggCall(a.kind, K, a.out_type, percentile=a.percentile)
            for a in node.aggs
        )
        return P.AggregateNode(
            dedup, tuple(range(K)), aggs, node.fields, "single"
        )


class RewriteApproxPercentile:
    """approx_percentile -> mergeable bucket summaries + a bounded merge
    (VERDICT r2 missing #1; reference: qdigest-state
    ApproximateDoublePercentileAggregations.java).

    approx_percentile(x, f) GROUP BY k becomes

        Aggregate k: pctl_merge($mn, $c, $mx, f), re-agg others...
          Aggregate (k..., $qb): count(x) $c, min(x) $mn, max(x) $mx
            Project k..., $qb = pctl_bucket(x), x, args...

    The inner level is a plain mergeable aggregation (rides partial/
    final, spill, mesh); pctl_merge buffers only per-bucket summaries —
    bounded by distinct quantile buckets, never raw rows — and
    interpolates within the chosen bucket (error <= the bucket's 1.6%
    relative width; exact for single-valued buckets). Skipped when a
    second approx aggregate or a non-re-aggregable kind shares the
    node (those keep the single-step holistic path)."""

    def rewrite(self, node: P.PlanNode) -> P.PlanNode:
        kids = [self.rewrite(c) for c in node.children()]
        node = with_children(node, kids)
        if not isinstance(node, P.AggregateNode) or node.step != "single":
            return node
        pcts = [
            (i, a) for i, a in enumerate(node.aggs)
            if a.kind == "approx_percentile"
        ]
        if len(pcts) != 1:
            return node
        others = [
            (i, a) for i, a in enumerate(node.aggs)
            if a.kind != "approx_percentile"
        ]
        if not all(_reagg_ok(o) for _, o in others):
            return node
        if pcts[0][1].distinct:
            return node
        return self._expand(node, pcts[0], others)

    def _expand(self, node: P.AggregateNode, pct, others) -> P.PlanNode:
        child = node.child
        K = len(node.group_channels)
        pct_pos, pct_agg = pct
        x_t = child.fields[pct_agg.arg_channel].type
        ref = lambda ch, nd: ir.InputRef(ch, nd.fields[ch].type)

        # -- L0: keys + bucket + x + other args --
        exprs: List[ir.Expr] = [ref(c, child) for c in node.group_channels]
        fields: List[P.Field] = [child.fields[c] for c in node.group_channels]
        x = ref(pct_agg.arg_channel, child)
        exprs.append(ir.Call("pctl_bucket", (x,), T.BIGINT))
        fields.append(P.Field("$qb", T.BIGINT))
        x_ch0 = len(exprs)
        exprs.append(x)
        fields.append(child.fields[pct_agg.arg_channel])
        arg_ch: Dict[int, Optional[int]] = {}
        for pos, o in others:
            if o.arg_channel is None:
                arg_ch[pos] = None
                continue
            arg_ch[pos] = len(exprs)
            exprs.append(ref(o.arg_channel, child))
            fields.append(child.fields[o.arg_channel])
        l0 = P.ProjectNode(child, tuple(exprs), tuple(fields))

        # -- A1: group by (k..., qb): count/min/max of x + partials --
        a1_aggs = [
            P.AggCall("count", x_ch0, T.BIGINT),
            P.AggCall("min", x_ch0, x_t),
            P.AggCall("max", x_ch0, x_t),
        ]
        a1_fields = list(l0.fields[: K + 1]) + [
            P.Field("$c", T.BIGINT), P.Field("$mn", x_t), P.Field("$mx", x_t),
        ]
        state_slots: Dict[int, List[int]] = {}
        for pos, o in others:
            state_slots[pos] = _reagg_a1_calls(
                o, pos, arg_ch[pos], a1_aggs, a1_fields
            )
        a1 = P.AggregateNode(
            l0, tuple(range(K + 1)), tuple(a1_aggs), tuple(a1_fields),
            "single",
        )
        # layout: [k..., $qb, $c, $mn, $mx, states...]

        # -- A2: group by k: pctl_merge + re-aggs --
        a2_aggs = [
            P.AggCall(
                "pctl_merge", K + 2, pct_agg.out_type,
                arg2_channel=K + 1, arg3_channel=K + 3,
                percentile=pct_agg.percentile,
            )
        ]
        a2_fields = list(a1.fields[:K]) + [
            P.Field(f"$p{pct_pos}", pct_agg.out_type)
        ]
        final_ch: Dict[int, List[int]] = {}
        for pos, o in others:
            final_ch[pos] = []
            for si, slot in enumerate(state_slots[pos]):
                re_kind, out_t = _reagg_a2_call(o, si)
                final_ch[pos].append(K + len(a2_aggs))
                a2_aggs.append(P.AggCall(re_kind, K + 1 + slot, out_t))
                a2_fields.append(P.Field(f"$f{pos}_{si}", out_t))
        a2 = P.AggregateNode(
            a1, tuple(range(K)), tuple(a2_aggs), tuple(a2_fields), "single"
        )

        # -- restore original layout --
        exprs4: List[ir.Expr] = [ref(c, a2) for c in range(K)]
        for i, a in enumerate(node.aggs):
            if i == pct_pos:
                exprs4.append(ref(K, a2))
            else:
                exprs4.append(_reagg_final_expr(
                    a, final_ch[i], lambda c: ref(c, a2)
                ))
        return P.ProjectNode(a2, tuple(exprs4), tuple(node.fields))


class ReorderJoins:
    """DPsub join-order search over a region (ReorderJoins.java:84 — the
    reference enumerates partitions per multi-join node with a cost
    comparator and a result limit; this explores all connected subsets,
    feasible at the region sizes analytic queries produce). Cross joins
    are admitted only to connect otherwise-disconnected components and
    only one leaf at a time, mirroring EliminateCrossJoins' bias."""

    def __init__(self, stats: StatsCalculator, cost: CostCalculator):
        self._stats = stats
        self._cost = cost

    def rewrite(self, node: P.PlanNode) -> P.PlanNode:
        if _is_region_join(node):
            return self._reorder(node)
        kids = [self.rewrite(c) for c in node.children()]
        return with_children(node, kids)

    # -- region machinery --
    def _reorder(self, root: P.JoinNode) -> P.PlanNode:
        region = _extract_region(root)
        # recurse into leaves first (nested regions under aggregates etc.)
        region.leaves = [self.rewrite(l) for l in region.leaves]
        n = len(region.leaves)  # a join region always has >= 2 leaves
        if n > MAX_DP_LEAVES:
            # oversized region: keep the analyzer's greedy order
            return self._rebuild_original(root, region)
        plan, layout = self._dp(region)
        if plan is None:
            return self._rebuild_original(root, region)
        if layout == tuple(range(n)):
            return plan
        # permutation project restoring the original output order
        widths = [len(l.fields) for l in region.leaves]
        new_offsets: Dict[int, int] = {}
        pos = 0
        for leaf_idx in layout:
            new_offsets[leaf_idx] = pos
            pos += widths[leaf_idx]
        exprs: List[ir.Expr] = []
        fields: List[P.Field] = []
        for leaf_idx in range(n):
            base = new_offsets[leaf_idx]
            for off, f in enumerate(region.leaves[leaf_idx].fields):
                exprs.append(ir.InputRef(base + off, f.type))
                fields.append(f)
        return P.ProjectNode(plan, tuple(exprs), tuple(fields))

    def _rebuild_original(self, node: P.PlanNode, region: _Region,
                          counter: Optional[List[int]] = None) -> P.PlanNode:
        """Original structure with (recursively-rewritten) leaves."""
        if counter is None:
            counter = [0]
        if _is_region_join(node):
            left = self._rebuild_original(node.left, region, counter)
            right = self._rebuild_original(node.right, region, counter)
            return dataclasses.replace(node, left=left, right=right)
        leaf = region.leaves[counter[0]]
        counter[0] += 1
        return leaf

    def _dp(self, region: _Region):
        n = len(region.leaves)
        full = (1 << n) - 1
        # best[mask] = (total_cost, plan, layout)
        best: Dict[int, Tuple[float, P.PlanNode, Tuple[int, ...]]] = {}
        for i, leaf in enumerate(region.leaves):
            best[1 << i] = (self._cost.cost(leaf).total, leaf, (i,))

        def crossing(s1: int, s2: int):
            out = []
            for (a, b) in region.edges:
                (la, _), (lb, _) = a, b
                if (s1 >> la) & 1 and (s2 >> lb) & 1:
                    out.append((a, b))
                elif (s2 >> la) & 1 and (s1 >> lb) & 1:
                    out.append((b, a))
            return out

        def offsets(layout: Tuple[int, ...]) -> Dict[int, int]:
            out: Dict[int, int] = {}
            pos = 0
            for li in layout:
                out[li] = pos
                pos += len(region.leaves[li].fields)
            return out

        def make_join(probe, build, keys):
            (_, pplan, playout) = probe
            (_, bplan, blayout) = build
            poff = offsets(playout)
            boff = offsets(blayout)
            lkeys = tuple(poff[l] + o for ((l, o), _) in keys)
            rkeys = tuple(boff[l] + o for (_, (l, o)) in keys)
            kind = "inner" if keys else "cross"
            node = P.JoinNode(
                kind, pplan, bplan, lkeys, rkeys, None,
                pplan.fields + bplan.fields,
            )
            return (self._cost.cost(node).total, node, playout + blayout)

        for mask in range(1, full + 1):
            if mask in best or bin(mask).count("1") < 2:
                continue
            lowest = mask & -mask
            entry = None
            s1 = (mask - 1) & mask
            while s1:
                s2 = mask ^ s1
                if (s1 & lowest) and s1 in best and s2 in best:
                    keys = crossing(s1, s2)
                    candidates = []
                    if keys:
                        # orientation: either side may probe
                        candidates.append(make_join(
                            best[s1], best[s2],
                            [(a, b) for (a, b) in keys],
                        ))
                        candidates.append(make_join(
                            best[s2], best[s1],
                            [(b, a) for (a, b) in keys],
                        ))
                    elif bin(s2).count("1") == 1 or bin(s1).count("1") == 1:
                        # cross join admitted one leaf at a time
                        candidates.append(make_join(best[s1], best[s2], []))
                    for cand in candidates:
                        if entry is None or cand[0] < entry[0]:
                            entry = cand
                s1 = (s1 - 1) & mask
            if entry is not None:
                best[mask] = entry
        hit = best.get(full)
        if hit is None:
            return None, None
        return hit[1], hit[2]


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def optimize(
    root: P.PlanNode,
    catalogs,
    session=None,
) -> P.PlanNode:
    """The PlanOptimizers pipeline: iterative simplification, cost-based
    join reordering, cleanup. `session.enable_optimizer` gates the whole
    pass; `session.join_reordering_strategy` gates the CBO step
    ("automatic" | "none" — SystemSessionProperties
    JOIN_REORDERING_STRATEGY)."""
    if session is not None and not getattr(session, "enable_optimizer", True):
        return root
    strategy = getattr(session, "join_reordering_strategy", "automatic")
    validation = getattr(session, "plan_validation", "passes")
    if validation != "off":
        from trino_tpu_torch.sql.validate import validate_logical
    else:
        validate_logical = None
    per_rule = None
    if validation == "rules":
        per_rule = lambda plan, rule: validate_logical(
            plan, stage="optimizer", rule=rule
        )

    def checkpoint(plan: P.PlanNode, stage: str) -> None:
        # PlanSanityChecker.validateIntermediatePlan: every pass must
        # hand the next one a well-formed plan
        if validate_logical is not None:
            validate_logical(plan, stage=stage)

    stats = StatsCalculator(catalogs)
    rules: Tuple[Rule, ...] = SIMPLIFICATION_RULES
    if getattr(session, "enable_pushdown", True) and catalogs is not None:
        rules = rules + (
            PushPredicateIntoTableScan(catalogs),
            PushProjectionIntoTableScan(catalogs),
        )
    it = IterativeOptimizer(rules)
    checkpoint(root, "analyzer")
    root = it.optimize(root, stats, validator=per_rule)
    checkpoint(root, "iterative")
    root = RewriteMultiSketch().rewrite(root)
    root = RewriteApproxDistinct().rewrite(root)
    root = RewriteApproxPercentile().rewrite(root)
    checkpoint(root, "approx_rewrites")
    root = RewriteDistinctAggs().rewrite(root)
    checkpoint(root, "distinct_aggs")
    if strategy == "automatic":
        cost = CostCalculator(stats)
        root = ReorderJoins(stats, cost).rewrite(root)
        root = it.optimize(root, stats, validator=per_rule)
        checkpoint(root, "join_reordering")
    return root


# -- timestamptz key canonicalization (correctness, not optimization) --------


def _is_tstz(t: T.DataType) -> bool:
    return t.kind == T.TypeKind.TIMESTAMP_TZ


def _masked_tstz(c: int, t: T.DataType) -> ir.Expr:
    # at_timezone_id(x, 0) clears the packed zone bits while keeping the
    # instant and validity — the canonical grouping/join key
    return ir.Call(
        "at_timezone_id",
        (ir.InputRef(c, t), ir.Literal(0, T.INTEGER)),
        t,
    )


def _tstz_side_project(child: P.PlanNode, need: List[int]):
    """Project appending one zone-masked copy per channel in `need`;
    returns (project, {orig channel: masked channel})."""
    cf = child.fields
    base = len(cf)
    pos = {c: base + x for x, c in enumerate(need)}
    exprs = tuple(ir.InputRef(i, f.type) for i, f in enumerate(cf)) + tuple(
        _masked_tstz(c, cf[c].type) for c in need
    )
    flds = cf + tuple(
        P.Field((cf[c].name or "tstz") + "$utc", cf[c].type)
        for c in need
    )
    return P.ProjectNode(child, exprs, flds), pos


def _canonicalize_agg(n: P.AggregateNode) -> P.PlanNode:
    cf = n.child.fields
    k = len(n.group_channels)
    tg = [
        j for j, c in enumerate(n.group_channels) if _is_tstz(cf[c].type)
    ]
    is_td = lambda a: (
        a.distinct
        and a.arg_channel is not None
        and _is_tstz(cf[a.arg_channel].type)
    )
    if not tg and not any(is_td(a) for a in n.aggs):
        return n
    need: List[int] = []
    for c in n.group_channels:
        if _is_tstz(cf[c].type) and c not in need:
            need.append(c)
    for a in n.aggs:
        if is_td(a) and a.arg_channel not in need:
            need.append(a.arg_channel)
    below, pos = _tstz_side_project(n.child, need)
    groups = tuple(pos.get(c, c) for c in n.group_channels)
    aggs = tuple(
        dataclasses.replace(a, arg_channel=pos[a.arg_channel])
        if is_td(a)
        else a
        for a in n.aggs
    )
    if not tg:
        # only a DISTINCT arg was tstz: schema is unchanged
        return dataclasses.replace(n, child=below, aggs=aggs)
    # an any() per tstz key carries one ORIGINAL packed value (with its
    # zone) out of each group, so rendering keeps the source zone
    reps = tuple(
        P.AggCall("any", n.group_channels[j], cf[n.group_channels[j]].type)
        for j in tg
    )
    agg_fields = n.fields + tuple(
        P.Field((n.fields[j].name or "tstz") + "$any", n.fields[j].type)
        for j in tg
    )
    agg = P.AggregateNode(below, groups, aggs + reps, agg_fields, n.step)
    rep_at = {j: k + len(aggs) + x for x, j in enumerate(tg)}
    exprs = tuple(
        ir.InputRef(rep_at.get(i, i), n.fields[i].type)
        for i in range(len(n.fields))
    )
    return P.ProjectNode(agg, exprs, n.fields)


def _canonicalize_join(n: P.JoinNode) -> P.PlanNode:
    if not n.left_keys:
        return n

    def side(child, keys):
        cf = child.fields
        need = []
        for c in keys:
            if _is_tstz(cf[c].type) and c not in need:
                need.append(c)
        if not need:
            return child, tuple(keys), 0
        proj, pos = _tstz_side_project(child, need)
        return proj, tuple(pos.get(c, c) for c in keys), len(need)

    nleft, lk, el = side(n.left, n.left_keys)
    nright, rk, er = side(n.right, n.right_keys)
    if not el and not er:
        return n
    lf, rf = n.left.fields, n.right.fields
    nl, nr = len(lf), len(rf)
    residual = n.residual
    if residual is not None and el:
        # residual is typed over left++right: right-side refs shift past
        # the appended left-side masked copies
        mapping = {
            i: ir.InputRef(
                i if i < nl else i + el,
                lf[i].type if i < nl else rf[i - nl].type,
            )
            for i in range(nl + nr)
        }
        residual = substitute(residual, mapping)
    semi = n.kind in ("semi", "anti")
    jfields = nleft.fields if semi else nleft.fields + nright.fields
    j = dataclasses.replace(
        n,
        left=nleft,
        right=nright,
        left_keys=lk,
        right_keys=rk,
        residual=residual,
        fields=jfields,
    )
    sel = (
        tuple(range(nl))
        if semi
        else tuple(range(nl)) + tuple(nl + el + i for i in range(nr))
    )
    if len(sel) == len(jfields):
        return j
    exprs = tuple(ir.InputRef(i, jfields[i].type) for i in sel)
    return P.ProjectNode(j, exprs, n.fields)


def _canonicalize_window(n: P.WindowNode) -> P.PlanNode:
    cf = n.child.fields
    need: List[int] = []
    for c in n.partition_channels:
        if _is_tstz(cf[c].type) and c not in need:
            need.append(c)
    if not need:
        return n
    # partition on the zone-masked copies appended below; function args
    # and order keys keep their original (unshifted) channels
    below, pos = _tstz_side_project(n.child, need)
    parts = tuple(pos.get(c, c) for c in n.partition_channels)
    n_funcs = len(n.fields) - len(cf)
    wfields = below.fields + n.fields[len(cf):]
    w = dataclasses.replace(
        n, child=below, partition_channels=parts, fields=wfields
    )
    # project above drops the masked copies, restoring the schema
    base = len(below.fields)
    sel = tuple(range(len(cf))) + tuple(base + i for i in range(n_funcs))
    exprs = tuple(ir.InputRef(i, wfields[i].type) for i in sel)
    return P.ProjectNode(w, exprs, n.fields)


def canonicalize_tstz_keys(root: P.PlanNode) -> P.PlanNode:
    """Correctness pass, applied to every plan even when the optimizer
    is off: timestamptz packs millis<<12 | zoneKey, but SQL equality is
    instant-only, so GROUP BY / JOIN / DISTINCT must key on the instant
    and never the zone bits (the reference keys on
    LongTimestampWithTimeZone.getEpochMillis()). Rewrites tstz-keyed
    aggregations, joins, and window PARTITION BY to key on a zone-masked
    copy appended by a Project below; for group keys an any() aggregate
    preserves one original packed value per group as the rendered
    representative, and a Project above restores the original schema."""
    kids = [canonicalize_tstz_keys(c) for c in root.children()]
    if any(a is not b for a, b in zip(kids, root.children())):
        if isinstance(root, P.JoinNode):
            root = dataclasses.replace(root, left=kids[0], right=kids[1])
        elif isinstance(root, P.UnionAllNode):
            root = dataclasses.replace(root, inputs=tuple(kids))
        else:
            root = dataclasses.replace(root, child=kids[0])
    if isinstance(root, P.AggregateNode) and root.step == "single":
        return _canonicalize_agg(root)
    if isinstance(root, P.JoinNode):
        return _canonicalize_join(root)
    if isinstance(root, P.WindowNode):
        return _canonicalize_window(root)
    return root
