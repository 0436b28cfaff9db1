"""Plan sanity checking.

Counterpart of trino_tpu/sql/validate.py's logical part: the four
checkers of LOGICAL_CHECKERS, validate_logical, the fragment-level
checks over sql/fragmenter.py's SubPlan (validate_subplan) and the
determinism checks, and the shape census (`shape_census`, Lowering):
the (operator, capacity, dtype-sig) classes a plan will run, which
EXPLAIN ANALYZE prints beside the classes its operators produced, the
planner's warmup predicts, and a task checks against the warm
registry.

Analogue of Trino's sanity/PlanSanityChecker (ValidateDependenciesChecker,
TypeValidator, NoDuplicatePlanNodeIdsChecker, the AddExchanges
partitioning checks) and sanity/PlanDeterminismChecker, run over the
logical plan after optimizer passes. A rule that mis-shifts an InputRef, drops a tstz
canonicalization, or desynchronizes exchange hash keys fails HERE with
the checker, node path, and last-applied rule named — instead of
surfacing as a wrong answer or a shape error deep in exec/.

Checker vocabulary:
  refs           InputRef indices in bounds; node arity/schema widths
  types          expression dtypes recomputed bottom-up match Field dtypes
  structure      no duplicate node objects, acyclic, no leaked GroupRef /
                 ExchangeNode post-fragmentation, RemoteSourceNodes
                 reference existing fragments with schema agreement
  exchange_keys  repartition keys hash identically on both sides (count,
                 dtype, tstz keys zone-mask-canonicalized `$utc`)
  determinism    planning the same AST twice yields byte-identical
                 explain_text (check_plan_determinism)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.expr import ir
from trino_tpu_torch.sql import plan as P


class PlanValidationError(RuntimeError):
    """Typed validation failure: which checker, where in the tree, and —
    when threaded through optimizer.Context — the last-applied rule."""

    def __init__(
        self,
        checker: str,
        node_path: str,
        message: str,
        rule: Optional[str] = None,
        stage: Optional[str] = None,
    ):
        self.checker = checker
        self.node_path = node_path
        self.rule = rule
        self.stage = stage
        where = f"[{checker}] at {node_path}"
        if stage:
            where += f" (stage={stage})"
        if rule:
            where += f" (last rule={rule})"
        super().__init__(f"{where}: {message}")


@dataclasses.dataclass(frozen=True)
class Violation:
    checker: str
    node_path: str
    message: str


# -- walking ------------------------------------------------------------------


def _child_tag(node: P.PlanNode, i: int) -> str:
    if isinstance(node, P.JoinNode):
        return ("left", "right")[i]
    if isinstance(node, P.UnionAllNode):
        return str(i)
    return ""


def _walk(node: P.PlanNode, path: str = ""):
    """Yield (path, node) pre-order; paths look like
    Output/Join[left]/Scan."""
    name = type(node).__name__.replace("Node", "")
    here = f"{path}/{name}" if path else name
    yield here, node
    for i, c in enumerate(node.children()):
        tag = _child_tag(node, i)
        yield from _walk(c, here + (f"[{tag}]" if tag else ""))


def _expr_walk(e: ir.Expr):
    yield e
    for c in e.children():
        yield from _expr_walk(c)


def _node_exprs(node: P.PlanNode) -> List[Tuple[str, ir.Expr, Tuple[P.Field, ...]]]:
    """(label, expr, input schema) triples for every expression a node
    carries. The input schema is what the expr's InputRefs index."""
    out: List[Tuple[str, ir.Expr, Tuple[P.Field, ...]]] = []
    if isinstance(node, P.FilterNode):
        out.append(("predicate", node.predicate, node.child.fields))
    elif isinstance(node, P.ProjectNode):
        for i, e in enumerate(node.exprs):
            out.append((f"exprs[{i}]", e, node.child.fields))
    elif isinstance(node, P.JoinNode) and node.residual is not None:
        out.append(
            ("residual", node.residual, node.left.fields + node.right.fields)
        )
    elif isinstance(node, P.MatchRecognizeNode):
        ext = node.child.fields + tuple(
            node.child.fields[ch] for ch, _ in node.shifts
        )
        for var, pred in node.defines:
            out.append((f"define[{var}]", pred, ext))
    return out


def _expected_width(node: P.PlanNode) -> Optional[int]:
    """Output width implied by the node's own shape, or None when the
    fields tuple is the only source of truth."""
    if isinstance(node, P.ScanNode):
        return len(node.columns)
    if isinstance(node, P.ProjectNode):
        return len(node.exprs)
    if isinstance(node, P.AggregateNode):
        k = len(node.group_channels)
        if node.step == "partial":
            return k + 2 * len(node.aggs)
        return k + len(node.aggs)
    if isinstance(node, P.JoinNode):
        nl = len(node.left.fields)
        if node.kind in ("semi", "anti"):
            return nl
        if node.kind in ("mark", "mark_exists"):
            return nl + 1
        return nl + len(node.right.fields)
    if isinstance(node, P.WindowNode):
        return len(node.child.fields) + len(node.functions)
    if isinstance(node, P.UnnestNode):
        return (
            len(node.child.fields)
            + len(node.array_channels)
            + (1 if node.ordinality else 0)
        )
    if isinstance(node, P.MatchRecognizeNode):
        return len(node.partition_channels) + len(node.measures)
    if isinstance(
        node,
        (P.FilterNode, P.SortNode, P.TopNNode, P.LimitNode,
         P.EnforceSingleRowNode, P.OutputNode, P.ExchangeNode),
    ):
        return len(node.children()[0].fields)
    return None


def _channel_lists(node: P.PlanNode) -> List[Tuple[str, Sequence[int], int]]:
    """(label, channels, input width) for every plain channel list a
    node carries."""
    out: List[Tuple[str, Sequence[int], int]] = []
    if isinstance(node, P.AggregateNode):
        w = len(node.child.fields)
        out.append(("group_channels", node.group_channels, w))
        for i, a in enumerate(node.aggs):
            chans = [
                c for c in (a.arg_channel, a.arg2_channel, a.arg3_channel)
                if c is not None
            ]
            out.append((f"aggs[{i}]", chans, w))
    elif isinstance(node, P.JoinNode):
        out.append(("left_keys", node.left_keys, len(node.left.fields)))
        out.append(("right_keys", node.right_keys, len(node.right.fields)))
    elif isinstance(node, P.WindowNode):
        w = len(node.child.fields)
        out.append(("partition_channels", node.partition_channels, w))
        out.append(("order_keys", [k.channel for k in node.order_keys], w))
        for i, f in enumerate(node.functions):
            if f.arg_channel is not None:
                out.append((f"functions[{i}]", [f.arg_channel], w))
    elif isinstance(node, P.UnnestNode):
        out.append(
            ("array_channels", node.array_channels, len(node.child.fields))
        )
    elif isinstance(node, (P.SortNode, P.TopNNode)):
        out.append(
            ("keys", [k.channel for k in node.keys], len(node.child.fields))
        )
    elif isinstance(node, P.ExchangeNode):
        out.append(
            ("hash_channels", node.hash_channels, len(node.child.fields))
        )
    elif isinstance(node, P.MatchRecognizeNode):
        w = len(node.child.fields)
        out.append(("partition_channels", node.partition_channels, w))
        out.append(("order_keys", [k.channel for k in node.order_keys], w))
        out.append(("shifts", [c for c, _ in node.shifts], w))
    return out


# -- checker 1: references / arity -------------------------------------------


def _check_refs(root: P.PlanNode) -> List[Violation]:
    out: List[Violation] = []
    for path, node in _walk(root):
        exp = _expected_width(node)
        if exp is not None and len(node.fields) != exp:
            out.append(Violation(
                "refs", path,
                f"output width {len(node.fields)} != expected {exp}",
            ))
        if isinstance(node, P.ValuesNode):
            for i, row in enumerate(node.rows):
                if len(row) != len(node.fields):
                    out.append(Violation(
                        "refs", path,
                        f"rows[{i}] width {len(row)} != {len(node.fields)}",
                    ))
        if isinstance(node, P.OutputNode) and len(node.names) != len(node.fields):
            out.append(Violation(
                "refs", path,
                f"{len(node.names)} names for {len(node.fields)} fields",
            ))
        if isinstance(node, P.UnionAllNode):
            for i, inp in enumerate(node.inputs):
                if len(inp.fields) != len(node.fields):
                    out.append(Violation(
                        "refs", path,
                        f"inputs[{i}] width {len(inp.fields)} != "
                        f"{len(node.fields)}",
                    ))
        if isinstance(node, P.JoinNode) and (
            len(node.left_keys) != len(node.right_keys)
        ):
            out.append(Violation(
                "refs", path,
                f"{len(node.left_keys)} left keys vs "
                f"{len(node.right_keys)} right keys",
            ))
        for label, chans, width in _channel_lists(node):
            for c in chans:
                if not (0 <= c < width):
                    out.append(Violation(
                        "refs", path,
                        f"{label} channel {c} outside input width {width}",
                    ))
        for label, expr, schema in _node_exprs(node):
            for e in _expr_walk(expr):
                if isinstance(e, ir.InputRef) and not (
                    0 <= e.index < len(schema)
                ):
                    out.append(Violation(
                        "refs", path,
                        f"{label}: {e!r} outside input width {len(schema)}",
                    ))
    return out


# -- checker 2: types ---------------------------------------------------------

# scalar names whose result is definitionally BOOLEAN; "and"/"or"/"not"
# additionally require BOOLEAN arguments
_BOOLEAN_RESULT = frozenset(
    ("and", "or", "not", "eq", "ne", "lt", "le", "gt", "ge", "is_null")
)
_BOOLEAN_ARGS = frozenset(("and", "or", "not"))


def _is_unknown(t: T.DataType) -> bool:
    return t.kind == T.TypeKind.UNKNOWN


def _check_expr_types(
    label: str, expr: ir.Expr, schema: Tuple[P.Field, ...], path: str,
    out: List[Violation],
) -> None:
    for e in _expr_walk(expr):
        if isinstance(e, ir.InputRef):
            if 0 <= e.index < len(schema) and e.type != schema[e.index].type:
                out.append(Violation(
                    "types", path,
                    f"{label}: {e!r} but input channel {e.index} is "
                    f"{schema[e.index].type}",
                ))
        elif isinstance(e, ir.Call):
            if e.name in _BOOLEAN_RESULT and e.type != T.BOOLEAN:
                out.append(Violation(
                    "types", path,
                    f"{label}: {e.name}(...) typed {e.type}, not boolean",
                ))
            if e.name in _BOOLEAN_ARGS:
                for a in e.args:
                    if a.type != T.BOOLEAN and not _is_unknown(a.type):
                        out.append(Violation(
                            "types", path,
                            f"{label}: {e.name} argument typed {a.type}",
                        ))
        elif isinstance(e, ir.Case):
            for r in e.results:
                if r.type != e.type and not (
                    _is_unknown(r.type) or _is_unknown(e.type)
                ):
                    out.append(Violation(
                        "types", path,
                        f"{label}: CASE result typed {r.type}, "
                        f"node typed {e.type}",
                    ))


def _agg_partial_fields(node: P.AggregateNode) -> Optional[List[P.Field]]:
    """Expected partial-step output fields (partial_output_schema shape);
    None when the state layout can't be derived (unknown kind)."""
    from trino_tpu_torch.sql.fragmenter import _partial_fields

    try:
        return _partial_fields(node, node.child)
    except Exception:
        return None


def _check_types(root: P.PlanNode) -> List[Violation]:
    out: List[Violation] = []
    for path, node in _walk(root):
        for label, expr, schema in _node_exprs(node):
            _check_expr_types(label, expr, schema, path, out)

        def expect(i: int, t: T.DataType, what: str) -> None:
            if i < len(node.fields) and node.fields[i].type != t:
                out.append(Violation(
                    "types", path,
                    f"fields[{i}] is {node.fields[i].type}, {what} is {t}",
                ))

        if isinstance(node, P.FilterNode):
            if node.predicate.type != T.BOOLEAN:
                out.append(Violation(
                    "types", path,
                    f"predicate typed {node.predicate.type}, not boolean",
                ))
            for i, f in enumerate(node.child.fields):
                expect(i, f.type, f"child fields[{i}]")
        elif isinstance(node, P.ProjectNode):
            for i, e in enumerate(node.exprs):
                expect(i, e.type, f"exprs[{i}]")
        elif isinstance(node, P.AggregateNode):
            cf = node.child.fields
            k = len(node.group_channels)
            if node.step == "partial":
                pf = _agg_partial_fields(node)
                if pf is not None:
                    for i, f in enumerate(pf):
                        expect(i, f.type, f"partial state fields[{i}]")
            else:
                for i, c in enumerate(node.group_channels):
                    if node.step == "final":
                        # final consumes the partial wire layout: keys
                        # arrive first, at positions 0..k-1
                        if c < len(cf):
                            expect(i, cf[c].type, f"group key channel {c}")
                    elif c < len(cf):
                        expect(i, cf[c].type, f"group key channel {c}")
                for i, a in enumerate(node.aggs):
                    expect(k + i, a.out_type, f"aggs[{i}].out_type")
        elif isinstance(node, P.JoinNode):
            lf, rf = node.left.fields, node.right.fields
            for lk, rk in zip(node.left_keys, node.right_keys):
                if lk < len(lf) and rk < len(rf) and (
                    lf[lk].type != rf[rk].type
                ):
                    out.append(Violation(
                        "types", path,
                        f"join key L{lk} {lf[lk].type} != "
                        f"R{rk} {rf[rk].type}",
                    ))
            if node.kind in ("semi", "anti"):
                expected = lf
            elif node.kind in ("mark", "mark_exists"):
                expected = lf + (P.Field("mark", T.BOOLEAN),)
            else:
                expected = lf + rf
            for i, f in enumerate(expected):
                expect(i, f.type, f"join input fields[{i}]")
        elif isinstance(node, P.WindowNode):
            base = len(node.child.fields)
            for i, f in enumerate(node.child.fields):
                expect(i, f.type, f"child fields[{i}]")
            for i, fn in enumerate(node.functions):
                expect(base + i, fn.out_type, f"functions[{i}].out_type")
        elif isinstance(
            node,
            (P.SortNode, P.TopNNode, P.LimitNode, P.EnforceSingleRowNode,
             P.OutputNode, P.ExchangeNode),
        ):
            for i, f in enumerate(node.children()[0].fields):
                expect(i, f.type, f"child fields[{i}]")
        elif isinstance(node, P.UnionAllNode):
            for j, inp in enumerate(node.inputs):
                for i, f in enumerate(inp.fields):
                    if i < len(node.fields) and node.fields[i].type != f.type:
                        out.append(Violation(
                            "types", path,
                            f"inputs[{j}].fields[{i}] is {f.type}, "
                            f"output is {node.fields[i].type}",
                        ))
    return out


# -- checker 3: structure -----------------------------------------------------


def _check_structure(
    root: P.PlanNode, fragmented: bool = False
) -> List[Violation]:
    out: List[Violation] = []
    seen: Dict[int, str] = {}
    on_path: Set[int] = set()

    def visit(node: P.PlanNode, path: str) -> None:
        name = type(node).__name__.replace("Node", "")
        here = f"{path}/{name}" if path else name
        key = id(node)
        if key in on_path:
            out.append(Violation("structure", here, "cycle in plan tree"))
            return
        if type(node).__name__ == "GroupRef":
            out.append(Violation(
                "structure", here,
                "GroupRef leaked out of the optimizer memo",
            ))
            return
        if node.children() and key in seen:
            # interior-node sharing: two parents point at the SAME
            # object (the NoDuplicatePlanNodeIds analogue — node
            # identity doubles as the node id here, and id()-keyed
            # consumers like StatsCalculator's memo assume tree shape)
            out.append(Violation(
                "structure", here,
                f"duplicate node object (also at {seen[key]})",
            ))
            return
        seen[key] = here
        if fragmented and isinstance(node, P.ExchangeNode):
            out.append(Violation(
                "structure", here,
                "ExchangeNode survived fragmentation",
            ))
        on_path.add(key)
        for i, c in enumerate(node.children()):
            tag = _child_tag(node, i)
            visit(c, here + (f"[{tag}]" if tag else ""))
        on_path.discard(key)

    visit(root, "")
    return out


# -- checker 4: exchange keys -------------------------------------------------


def _is_tstz(t: T.DataType) -> bool:
    return t.kind == T.TypeKind.TIMESTAMP_TZ


def _masked_name(f: P.Field) -> bool:
    # canonicalize_tstz_keys names its zone-masked projections "<x>$utc"
    return bool(f.name) and f.name.endswith("$utc")


def _check_exchange_keys(root: P.PlanNode) -> List[Violation]:
    out: List[Violation] = []
    for path, node in _walk(root):
        if isinstance(node, P.ExchangeNode) and node.kind == "repartition":
            cf = node.child.fields
            for c in node.hash_channels:
                if 0 <= c < len(cf) and _is_tstz(cf[c].type) and not (
                    _masked_name(cf[c])
                ):
                    out.append(Violation(
                        "exchange_keys", path,
                        f"repartition hash channel {c} "
                        f"({cf[c].name}: {cf[c].type}) is not "
                        "zone-mask-canonicalized (expected a `$utc` "
                        "projection from canonicalize_tstz_keys)",
                    ))
        if isinstance(node, P.JoinNode):
            sides = []
            for side in (node.left, node.right):
                if isinstance(side, P.ExchangeNode) and (
                    side.kind == "repartition"
                ):
                    cf = side.child.fields
                    sides.append([
                        cf[c].type for c in side.hash_channels
                        if 0 <= c < len(cf)
                    ])
                else:
                    sides.append(None)
            lt, rt = sides
            if lt is not None and rt is not None:
                if len(lt) != len(rt):
                    out.append(Violation(
                        "exchange_keys", path,
                        f"{len(lt)} left vs {len(rt)} right partition keys",
                    ))
                else:
                    for i, (a, b) in enumerate(zip(lt, rt)):
                        if a != b:
                            out.append(Violation(
                                "exchange_keys", path,
                                f"partition key {i}: left hashes {a}, "
                                f"right hashes {b} — rows land on "
                                "different tasks",
                            ))
    return out


# -- logical pipeline ---------------------------------------------------------

LOGICAL_CHECKERS: Tuple[Tuple[str, Callable], ...] = (
    ("refs", _check_refs),
    ("types", _check_types),
    ("structure", _check_structure),
    ("exchange_keys", _check_exchange_keys),
)


def collect_violations(root: P.PlanNode) -> List[Violation]:
    """All logical-plan violations, for reporting paths (bench
    --validate-corpus); validate_logical raises on the first instead."""
    out: List[Violation] = []
    for _, check in LOGICAL_CHECKERS:
        out.extend(check(root))
    return out


def validate_logical(
    root: P.PlanNode,
    stage: Optional[str] = None,
    rule: Optional[str] = None,
) -> None:
    """Run every logical checker; raise PlanValidationError on the first
    violation (PlanSanityChecker.validateIntermediatePlan analogue)."""
    for v in collect_violations(root):
        raise PlanValidationError(v.checker, v.node_path, v.message,
                                  rule=rule, stage=stage)


# -- checker 5: determinism ---------------------------------------------------


# -- fragment-level validation ------------------------------------------------


def _fragment_violations(subplan) -> List[Violation]:
    frags = {f.id: f for f in subplan.all_fragments()}
    out: List[Violation] = []
    ids = [f.id for f in subplan.all_fragments()]
    if len(ids) != len(set(ids)):
        out.append(Violation(
            "structure", "SubPlan", f"duplicate fragment ids: {sorted(ids)}"
        ))
    for f in frags.values():
        fpath = f"Fragment {f.id}"
        for _, check in LOGICAL_CHECKERS:
            for v in check(f.root):
                out.append(dataclasses.replace(
                    v, node_path=f"{fpath}/{v.node_path}"
                ))
        for v in _check_structure(f.root, fragmented=True):
            if "ExchangeNode" in v.message:
                out.append(dataclasses.replace(
                    v, node_path=f"{fpath}/{v.node_path}"
                ))
        # consumer-side remote source checks
        for path, node in _walk(f.root):
            if not isinstance(node, P.RemoteSourceNode):
                continue
            here = f"{fpath}/{path}"
            for fid in node.fragment_ids:
                prod = frags.get(fid)
                if prod is None:
                    out.append(Violation(
                        "structure", here,
                        f"dangling reference to fragment {fid} "
                        f"(existing: {sorted(frags)})",
                    ))
                    continue
                pf = prod.root.fields
                if len(pf) != len(node.fields):
                    out.append(Violation(
                        "structure", here,
                        f"width {len(node.fields)} != producer fragment "
                        f"{fid} width {len(pf)}",
                    ))
                else:
                    for i, (a, b) in enumerate(zip(node.fields, pf)):
                        if a.type != b.type:
                            out.append(Violation(
                                "structure", here,
                                f"fields[{i}] {a.type} != producer "
                                f"fragment {fid} fields[{i}] {b.type}",
                            ))
                if tuple(node.merge_keys) != tuple(prod.output_merge_keys):
                    out.append(Violation(
                        "structure", here,
                        f"merge keys {node.merge_keys} != producer "
                        f"fragment {fid} {prod.output_merge_keys}",
                    ))
        # every hash producer feeding one consumer fragment must agree
        # on the partition-key dtype vector: the schedulers route
        # partition p of EVERY input to consumer task p, so two inputs
        # hashing different key types desynchronize silently
        hash_producers: List[Tuple[int, List[T.DataType]]] = []

        def gather(n):
            if isinstance(n, P.RemoteSourceNode):
                for fid in n.fragment_ids:
                    prod = frags.get(fid)
                    if prod is not None and prod.output_kind == "hash":
                        pf = prod.root.fields
                        hash_producers.append((fid, [
                            pf[c].type for c in prod.output_channels
                            if 0 <= c < len(pf)
                        ]))
            for c in n.children():
                gather(c)

        gather(f.root)
        for fid, ktypes in hash_producers[1:]:
            fid0, k0 = hash_producers[0]
            if ktypes != k0:
                out.append(Violation(
                    "exchange_keys", fpath,
                    f"hash inputs disagree: fragment {fid0} partitions on "
                    f"{[str(t) for t in k0]}, fragment {fid} on "
                    f"{[str(t) for t in ktypes]}",
                ))
    # producer-side: tstz output partition keys must be canonicalized
    for f in frags.values():
        if f.output_kind != "hash":
            continue
        pf = f.root.fields
        for c in f.output_channels:
            if 0 <= c < len(pf) and _is_tstz(pf[c].type) and not (
                _masked_name(pf[c])
            ):
                out.append(Violation(
                    "exchange_keys", f"Fragment {f.id}",
                    f"hash output channel {c} ({pf[c].name}: "
                    f"{pf[c].type}) is not zone-mask-canonicalized",
                ))
    return out


def collect_subplan_violations(subplan) -> List[Violation]:
    return _fragment_violations(subplan)


def validate_subplan(subplan, rule: Optional[str] = None) -> None:
    """Fragmented-plan validation (run after sql/fragmenter.py)."""
    for v in _fragment_violations(subplan):
        raise PlanValidationError(
            v.checker, v.node_path, v.message, rule=rule, stage="fragmenter"
        )


# -- checker 5: determinism ---------------------------------------------------


def check_plan_determinism(
    plan_once: Callable[[], P.PlanNode], what: str = "plan"
) -> None:
    """PlanDeterminismChecker analogue: run the full planning pipeline
    twice over the same AST; the EXPLAIN renderings must be
    byte-identical (a nondeterministic rule poisons the plan cache and
    makes EXPLAIN lie about what executed)."""
    a = P.explain_text(plan_once())
    b = P.explain_text(plan_once())
    if a == b:
        return
    for la, lb in zip(a.splitlines(), b.splitlines()):
        if la != lb:
            raise PlanValidationError(
                "determinism", "Output",
                f"{what}: two plannings diverge: {la.strip()!r} vs "
                f"{lb.strip()!r}",
            )
    raise PlanValidationError(
        "determinism", "Output",
        f"{what}: two plannings differ in length "
        f"({len(a.splitlines())} vs {len(b.splitlines())} lines)",
    )


def check_sql_stability(sql: str, what: str = "statement") -> None:
    """Formatter leg of the determinism checker: formatting must be a
    fixpoint (format(parse(format(parse(sql)))) == format(parse(sql))).
    Prepared-statement plan-cache keys are formatted text (engine.py),
    so an unstable formatter silently splits the cache per rendering."""
    from trino_tpu_torch.sql.formatter import format_statement
    from trino_tpu_torch.sql.parser import parse

    once = format_statement(parse(sql))
    twice = format_statement(parse(once))
    if once != twice:
        raise PlanValidationError(
            "determinism", "SQL",
            f"{what}: formatter is not idempotent: {once!r} reformats "
            f"to {twice!r}",
        )


# -- compile-churn static analyzer -------------------------------------------


@dataclasses.dataclass(frozen=True)
class Lowering:
    """One expected shape class: (operator, padded capacity class, dtype
    signature), the key the reference compiles one XLA program under and
    the port launches one set of kernel shapes for. `retry_variant`
    marks classes that appear only when dynamic-filter pruning
    re-buckets capacities across retry attempts."""

    operator: str
    capacity: int
    dtypes: Tuple[str, ...]
    retry_variant: bool = False
    # any column in the class is array/map/row-typed: no scalar device
    # layout exists, so the class is ineligible for zero-batch warmup
    # AND for resident pinning (resident/fastlane skips it) — the census
    # names these classes instead of letting them vanish silently
    nested: bool = False


def nested_column_types(types) -> List[str]:
    """The nested-kind entries in a column-type set — the shared
    eligibility predicate for warmup and resident pinning. Non-empty
    means 'skip, and say so' (resident.skips_nested / census [nested]
    marker), never a silent drop."""
    return [str(t) for t in types if getattr(t, "is_nested", False)]


def _sig(fields: Sequence[P.Field]) -> Tuple[str, ...]:
    return tuple(str(f.type) for f in fields)


def _cap(rows: float, batch_rows: int, ladder=None) -> int:
    from trino_tpu_torch.block import bucket_capacity

    n = int(min(max(rows, 1.0), float(batch_rows)))
    if ladder is not None:
        # snap through the session's capacity ladder so the census
        # predicts the same classes a stabilized scan will produce
        return ladder.rung(n)
    return bucket_capacity(n)


def _tail_rows(rows: float, batch_rows: int) -> float:
    """Rows in the final (smaller) chunk of a table larger than
    batch_rows — 0 when the table fits one chunk or divides evenly."""
    r = int(rows)
    if r > batch_rows and r % batch_rows:
        return float(r % batch_rows)
    return 0.0


_FUSE_CONSUMERS = (P.AggregateNode, P.SortNode, P.TopNNode)


def shape_census(
    root: P.PlanNode,
    catalogs,
    batch_rows: int = 1 << 20,
    dynamic_filtering: bool = True,
    stats=None,
    ladder=None,
) -> List[Lowering]:
    """Enumerate the distinct lowerings this (fragment) plan will
    request, mirroring LocalPlanner's operator selection and fusion:
    consecutive Filter/Project stages share one FilterProjectOperator
    program, and one feeding directly into an Aggregate/Sort/TopN runs
    inside the consumer's kernel (pre_fn) and compiles no program of its
    own. Capacities come from the stats framework, so the census is as
    exact as the connector's row counts. Tables larger than batch_rows
    scan in batch_rows chunks plus one smaller tail chunk, so scans
    (and filter/project chains directly over them) contribute a tail
    capacity class too. `ladder` (compile.shapes.CapacityLadder) snaps
    predicted capacities onto the session's stabilization ladder."""
    if stats is None:
        from trino_tpu_torch.sql.stats import StatsCalculator

        stats = StatsCalculator(catalogs)
    classes: List[Lowering] = []

    def rows(node: P.PlanNode) -> float:
        try:
            return stats.stats(node).row_count
        except Exception:
            return float(batch_rows)

    def add(op: str, rc: float, fields, retry_variant: bool = False):
        classes.append(
            Lowering(
                op, _cap(rc, batch_rows, ladder), _sig(fields), retry_variant,
                nested=bool(
                    nested_column_types([f.type for f in fields])
                ),
            )
        )

    def visit(node: P.PlanNode, fused_into_consumer: bool = False) -> None:
        if isinstance(node, (P.OutputNode, P.ExchangeNode)):
            visit(node.child, fused_into_consumer)
            return
        if isinstance(node, (P.FilterNode, P.ProjectNode)):
            # walk to the bottom of the maximal Filter/Project chain
            bottom = node
            while isinstance(bottom.child, (P.FilterNode, P.ProjectNode)):
                bottom = bottom.child
            if not fused_into_consumer:
                # filters keep capacity (live-mask discipline): the
                # chain's class is the INPUT capacity at the chain's
                # output signature
                src = rows(bottom.child)
                add("FilterProjectOperator", src, node.fields)
                if isinstance(bottom.child, P.ScanNode):
                    tail = _tail_rows(src, batch_rows)
                    if tail:
                        add("FilterProjectOperator", tail, node.fields)
            visit(bottom.child)
            return
        if isinstance(node, P.ScanNode):
            rc = rows(node)
            add("TableScanOperator", rc, node.fields)
            tail = _tail_rows(rc, batch_rows)
            if tail:
                add("TableScanOperator", tail, node.fields)
            return
        if isinstance(node, P.ValuesNode):
            add("ValuesOperator", float(len(node.rows)), node.fields)
            return
        if isinstance(node, P.RemoteSourceNode):
            add("RemoteSourceOperator", rows(node), node.fields)
            return
        if isinstance(node, P.AggregateNode):
            if any(a.distinct for a in node.aggs):
                add("HashAggregationOperator", rows(node.child), node.fields)
            add("HashAggregationOperator", rows(node), node.fields)
            visit(node.child, fused_into_consumer=True)
            return
        if isinstance(node, (P.SortNode, P.TopNNode)):
            op = ("TopNOperator" if isinstance(node, P.TopNNode)
                  else "SortOperator")
            add(op, rows(node), node.fields)
            visit(node.child, fused_into_consumer=True)
            return
        if isinstance(node, P.JoinNode):
            probe_rows = rows(node.left)
            if node.kind == "cross":
                add("CrossJoinOperator", rows(node), node.fields)
            else:
                if node.kind in ("inner", "semi") and dynamic_filtering:
                    # the filter compacts probe batches to a DATA-
                    # DEPENDENT capacity; which capacity depends on which
                    # retry attempt's build side survives, so every
                    # pruned class is a fresh lowering no warm run covers
                    add("DynamicFilterOperator", probe_rows,
                        node.left.fields, retry_variant=True)
                # an equi-join's output rides at the bucketed MATCH
                # capacity, which is data-dependent: selective keys land
                # near the output-row estimate, FK-ish multiplicity
                # lands near the probe's own class. Report both ends of
                # that band (they coincide and dedup when the estimator
                # is confident) so the census bounds join churn from
                # above instead of trusting a collapsed estimate.
                add("LookupJoinOperator", rows(node), node.fields)
                add("LookupJoinOperator", probe_rows, node.fields)
            visit(node.left)
            visit(node.right)
            return
        if isinstance(node, P.WindowNode):
            add("WindowOperator", rows(node), node.fields)
        elif isinstance(node, P.UnnestNode):
            add("UnnestOperator", rows(node), node.fields)
        elif isinstance(node, P.MatchRecognizeNode):
            add("MatchRecognizeOperator", rows(node), node.fields)
        elif isinstance(node, P.LimitNode):
            add("LimitOperator", rows(node), node.fields)
        elif isinstance(node, P.EnforceSingleRowNode):
            add("EnforceSingleRowOperator", rows(node), node.fields)
        elif isinstance(node, P.UnionAllNode):
            for inp in node.inputs:
                add("BufferSource", rows(inp), inp.fields)
        for c in node.children():
            visit(c)

    visit(root)
    # distinct classes only: a repeated (op, cap, sig) hits the jit cache
    seen: Set[Lowering] = set()
    out: List[Lowering] = []
    for c in classes:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def census_line(classes: List[Lowering], warn_threshold: int = 0) -> str:
    """One summary line for EXPLAIN (ANALYZE) output."""
    n = len(classes)
    variants = sum(1 for c in classes if c.retry_variant)
    nested = sum(1 for c in classes if c.nested)
    line = f"expected_xla_lowerings={n}"
    if variants:
        line += f" ({variants} retry-variant)"
    if nested:
        line += f" ({nested} nested: warmup/resident-ineligible)"
    if warn_threshold and n > warn_threshold:
        line += (
            f"  WARNING: exceeds compile_churn_warn_threshold="
            f"{warn_threshold}; expect XLA recompilation stalls "
            "(see ROADMAP shape stabilization)"
        )
    return line


def census_text(
    classes: List[Lowering],
    warn_threshold: int = 0,
    observed: Optional[int] = None,
) -> str:
    """Multi-line census block: summary + one line per class."""
    lines = ["Compile-churn census: " + census_line(classes, warn_threshold)]
    if observed is not None:
        lines[0] += f" observed_shape_classes={observed}"
    for c in sorted(classes, key=lambda c: (c.operator, c.capacity)):
        mark = " [retry-variant]" if c.retry_variant else ""
        if c.nested:
            mark += " [nested]"
        lines.append(
            f"  {c.operator} cap={c.capacity} "
            f"[{', '.join(c.dtypes)}]{mark}"
        )
    return "\n".join(lines)
