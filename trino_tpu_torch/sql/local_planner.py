"""Physical planner: logical plan -> reusable operator-factory pipelines.

Counterpart of trino_tpu/sql/local_planner.py (LocalExecutionPlanner +
DriverFactory). Expression binding happens once at plan time; each
execution instantiates fresh operator state from the factories. Adjacent
filter/project stages fold into one stage, and a blocking consumer
(aggregation, sort, top-n) absorbs the stage below it, as in the
reference.

A factory is `ctx -> Operator`; `ctx` is the per-execution context that
holds the join bridges, so two executions never share mutable state. A
join's build side becomes a pipeline of its own, which the engine runs
to completion before the pipelines that probe it.

Ported node kinds: Output, Scan, Values, Filter, Project, Aggregate
(single, partial and final steps, DISTINCT aggregates in the
single-distinct shape, and the join-project route over an inner
equi-join when the session enables it), Join (hash joins of every kind,
with dynamic filtering, and cross joins), Window, UnionAll,
EnforceSingleRow, Sort, TopN, Limit, Unnest, MatchRecognize and
RemoteSource (a distributed task's exchange input: the execution context
supplies "make_remote_source"). A task plans its fragment with
`remote_schemas` (producer fragment id -> schema) and `scan_slice`
((task index, task count): the task's share of the splits).

The compile regime, as in the reference: a `stabilizer`
(compile/shapes.py) pads scan chunks onto the session's capacity ladder,
each fused filter/project closure comes from the process-wide
PROGRAM_CACHE (keyed by structure, input schema and device, so a
replanned stage reuses its bound closure), and every fused stage,
aggregation and hash join over a scan whose capacity classes the census
predicts records a WarmupEntry (`PhysicalPlan.warmup_entries`) that the
engine's WarmupService drives on all-dead batches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import Dictionary, RelBatch, RuntimeDictionary
from trino_tpu_torch.connectors.spi import CatalogManager
from trino_tpu_torch.exec.match_recognize import MatchRecognizeOperator, classifier_dictionary
from trino_tpu_torch.exec.unnest import UnnestOperator
from trino_tpu_torch.exec import (
    AggSpec,
    BufferSink,
    BufferSource,
    CrossJoinBuildSink,
    CrossJoinOperator,
    DynamicFilterOperator,
    EnforceSingleRowOperator,
    FilterProjectOperator,
    HashAggregationOperator,
    HashBuildSink,
    JoinBridge,
    LimitOperator,
    LookupJoinOperator,
    MxuJoinAggOperator,
    Operator,
    SortOperator,
    TableScanOperator,
    TopNOperator,
    ValuesOperator,
    WindowOperator,
)
from trino_tpu_torch.exec.operators import (
    WINDOW_VALUE_KINDS,
    compose_batch_fns,
    dynamic_filter_constraints,
    make_filter_project_fn,
    make_residual_fn,
)
from trino_tpu_torch.expr.compile import Bound, ExprBinder
from trino_tpu_torch.expr.ir import Expr, InputRef
from trino_tpu_torch.sql import plan as P

Schema = List[Tuple[T.DataType, Optional[Dictionary]]]
Factory = Callable[[dict], Operator]

# plans that took the join-project route (ops/mxu_join.py); tests and
# chip_smoke.py read it
mxu_join_selected = 0


def _mem_ctx(ctx: dict):
    """Per-operator MemoryContext when the execution context carries a
    pool (OperatorContext.newLocalUserMemoryContext). Contexts register
    in ctx["memory_contexts"] so the engine closes them when the query
    ends, and spill into ctx["spill_dir"]."""
    pool = ctx.get("memory_pool")
    if pool is None:
        return None
    from trino_tpu_torch.runtime.memory import MemoryContext

    mc = MemoryContext(pool, query_id=ctx.get("query_id"), spill_dir=ctx.get("spill_dir"))
    ctx.setdefault("memory_contexts", []).append(mc)
    return mc


class PhysicalPlan:
    """Executable form of one query: the build pipelines, in the order
    they must run, and the main chain; instantiate() stamps fresh
    operators for both. `warmup_entries` are the compile.warmup
    WarmupEntrys of the stages this plan runs, with their predicted
    capacity classes."""

    def __init__(self, pipelines: List[List[Factory]], chain: List[Factory],
                 schema: Schema, warmup_entries: Sequence = ()):
        self.pipeline_factories = pipelines
        self.chain_factories = chain
        self.schema = schema
        self.warmup_entries = list(warmup_entries)

    def instantiate(self, ctx: dict) -> Tuple[List[List[Operator]], List[Operator]]:
        pipelines = [[f(ctx) for f in fs] for fs in self.pipeline_factories]
        return pipelines, [f(ctx) for f in self.chain_factories]


class _AggWarmer:
    """WarmupEntry.fn for an aggregation: a throwaway operator driven
    over the dead batch reaches the group-reduce kernels the query's
    operator will launch (grouped_sum over rows that are all dead)."""

    def __init__(self, groups, specs, schema, step, device):
        self.groups = list(groups)
        self.specs = list(specs)
        self.schema = list(schema)
        self.step = step
        self.device = device

    def __call__(self, batch):
        op = HashAggregationOperator(self.groups, self.specs, self.schema, self.device,
                                     deferred_checks=[], step=self.step)
        op.add_input(batch)
        op.finish()
        for _ in range(8):
            if op.get_output() is None:
                break


class _JoinWarmer:
    """WarmupEntry.fn for a hash join: build from an all-dead batch at
    the build side's predicted capacity, then probe it with the entry's
    dead batch (the probe's bounds search the dead build's hashes,
    run_owner and take_flat expand its empty runs)."""

    def __init__(self, lkeys, rkeys, kind, probe_schema, build_schema, build_cap, device):
        self.lkeys, self.rkeys, self.kind = list(lkeys), list(rkeys), kind
        self.probe_schema = list(probe_schema)
        self.build_schema = list(build_schema)
        self.build_cap = int(build_cap)
        self.device = device

    def __call__(self, batch):
        from trino_tpu_torch.compile.warmup import zeros_batch

        bridge = JoinBridge()
        sink = HashBuildSink(bridge, self.rkeys, self.build_schema, self.device)
        sink.add_input(zeros_batch(self.build_schema, self.build_cap, self.device))
        sink.finish()
        op = LookupJoinOperator(bridge, self.lkeys, self.kind, self.probe_schema)
        op.add_input(batch)
        op.finish()
        for _ in range(8):
            if op.get_output() is None:
                break


class LocalPlanner:
    def __init__(self, catalogs: CatalogManager, device,
                 batch_rows: int = 1 << 20, target_splits: int = 1,
                 dynamic_filtering: bool = True,
                 mxu_join: bool = False, mxu_join_min_work: float = 16.0,
                 remote_schemas=None, scan_slice=None, stabilizer=None):
        """`stabilizer` (compile.shapes.ShapeStabilizer) pads scan chunks
        onto the session's capacity ladder and enables warmup-entry
        collection."""
        self.catalogs = catalogs
        self.stabilizer = stabilizer
        self._warmup_entries: List = []
        self.remote_schemas = remote_schemas or {}
        self.scan_slice = scan_slice
        self.device = torch.device(device)
        self.batch_rows = batch_rows
        self.target_splits = target_splits
        # enable_dynamic_filtering: build-side key domains prune the probe
        self.dynamic_filtering = dynamic_filtering
        self.mxu_join = mxu_join
        self.mxu_join_min_work = float(mxu_join_min_work)
        self.pipelines: List[List[Factory]] = []
        self._next_key = 0
        self._stats_calc = None

    def plan(self, root: P.PlanNode) -> PhysicalPlan:
        chain, schema = self._visit(root)
        return PhysicalPlan(self.pipelines, chain, schema,
                            warmup_entries=self._warmup_entries)

    def _key(self) -> int:
        self._next_key += 1
        return self._next_key

    # -- helpers --
    def _bind(self, e: Expr, schema: Schema) -> Bound:
        return ExprBinder([t for t, _ in schema], [d for _, d in schema]).bind(e)

    def _identity(self, schema: Schema) -> List[Bound]:
        return [self._bind(InputRef(i, t), schema) for i, (t, _) in enumerate(schema)]

    def _visit(self, node: P.PlanNode):
        m = getattr(self, f"_visit_{type(node).__name__}", None)
        if m is None:
            raise NotImplementedError(f"no physical plan for {type(node).__name__}")
        return m(node)

    def _visit_OutputNode(self, node: P.OutputNode):
        return self._visit(node.child)

    def _visit_ScanNode(self, node: P.ScanNode):
        conn = self.catalogs.get(node.catalog)
        splits = conn.split_manager.get_splits(node.handle, self.target_splits)
        if self.scan_slice is not None:
            idx, count = self.scan_slice
            splits = splits[idx::count]
        columns = list(node.columns)
        page_source = conn.page_source
        batch_rows, device, stabilizer = self.batch_rows, self.device, self.stabilizer
        schema: Schema = [
            (f.type, conn.metadata.column_dictionary(node.handle, c))
            for c, f in zip(node.columns, node.fields)
        ]

        def factory(ctx):
            return TableScanOperator(page_source, splits, columns, batch_rows, device,
                                     stabilizer=stabilizer)

        # predicted output capacity classes (main + tail): the warmup
        # entries of the stages above read them
        factory.out_caps = self._scan_caps(node)
        return [factory], schema

    def _scan_caps(self, node: P.PlanNode) -> Optional[Tuple[int, ...]]:
        """The census-predicted capacity classes of a scan's batches;
        None when stabilization is off or the row count is unknown."""
        if self.stabilizer is None:
            return None
        if self._stats_calc is None:
            from trino_tpu_torch.sql.stats import StatsCalculator

            self._stats_calc = StatsCalculator(self.catalogs)
        rows = self._stats_calc.stats(node).row_count
        if not rows or rows != rows or rows >= 1e9:  # no usable estimate
            return None
        return self.stabilizer.scan_classes(rows)

    def _visit_ValuesNode(self, node: P.ValuesNode):
        keys = [f.name or f"_c{i}" for i, f in enumerate(node.fields)]
        if len(set(keys)) != len(keys):
            keys = [f"{k}_{i}" for i, k in enumerate(keys)]
        data = {k: [] for k in keys}
        for row in node.rows:
            for k, v in zip(keys, row):
                data[k].append(v)
        schema_t = [(k, f.type) for k, f in zip(keys, node.fields)]
        batch = RelBatch.from_pydict(schema_t, data, device=self.device)
        schema: Schema = [(c.type, c.dictionary) for c in batch.columns]

        def factory(ctx):
            return ValuesOperator([batch])

        if self.stabilizer is not None and batch.columns:
            factory.out_caps = (batch.capacity,)
        return [factory], schema

    # adaptive execution: a materialized subtree IS a values source; its
    # rows upload to the planner's device as one batch padded to
    # bucket_capacity like any other, so re-planned programs land on
    # existing capacity-ladder shape classes
    _visit_SpooledValuesNode = _visit_ValuesNode

    # -- filter/project folding --
    def _cached_fp(self, build, schema: Schema, fingerprint):
        """(fn, out_schema) of a fused filter/project stage: from the
        process-wide PROGRAM_CACHE when the stage is structurally keyed
        (expression reprs, the input schema with its dictionary values,
        the device), else bound afresh. `build()` binds and returns
        (fn, out_schema); a hit skips it."""
        from trino_tpu_torch.compile.cache import (
            PROGRAM_CACHE,
            expr_fingerprint,
            schema_cache_key,
        )

        fp = expr_fingerprint(fingerprint)
        skey = schema_cache_key(schema)
        if fp is None or skey is None:
            fn, out_schema = build()
            return fn, out_schema

        def program():
            fn, out_schema = build()
            fn.out_schema = out_schema
            return fn

        fn = PROGRAM_CACHE.get_or_create(("fp", fp, skey, str(self.device)), program)
        return fn, fn.out_schema

    def _append_fp(self, chain: List[Factory], fn, in_schema: Schema,
                   out_schema: Schema) -> None:
        """Append a filter/project stage, folding it into a directly
        preceding one (the composition cached under its parts' keys),
        and record its warmup entry: the (composed) closure, the schema
        feeding it, and the capacity classes of the chain's source."""
        from trino_tpu_torch.compile.cache import PROGRAM_CACHE

        prev = chain[-1] if chain else None
        pf = getattr(prev, "fused_fn", None)
        caps = getattr(prev, "out_caps", None)
        if pf is not None:
            chain.pop()
            prev_entry = getattr(prev, "warmup_entry", None)
            if prev_entry is not None:
                # the folded stage runs as one: its parts are not warmed
                # apart
                self._warmup_entries.remove(prev_entry)
                in_schema = prev_entry.in_schema
            inner = fn
            k1, k2 = PROGRAM_CACHE.key_of(pf), PROGRAM_CACHE.key_of(inner)
            if k1 is not None and k2 is not None:
                fn = PROGRAM_CACHE.get_or_create(
                    ("compose", k1, k2), lambda: compose_batch_fns(pf, inner))
            else:
                fn = compose_batch_fns(pf, inner)

        def factory(ctx, fn=fn):
            return FilterProjectOperator(fn)

        factory.fused_fn = fn
        # filter/project keeps capacity: the source classes flow through
        factory.out_caps = caps
        if caps:
            from trino_tpu_torch.compile.warmup import WarmupEntry

            entry = WarmupEntry(
                operator="FilterProjectOperator", fn=fn, in_schema=list(in_schema),
                out_dtypes=tuple(str(t) for t, _ in out_schema), capacities=tuple(caps),
                device=self.device,
            )
            factory.warmup_entry = entry
            self._warmup_entries.append(entry)
        chain.append(factory)

    def _record_kernel_warmup(self, operator: str, warmer, in_schema, out_schema,
                              caps) -> None:
        """Warmup entry of a blocking kernel (aggregation, join) whose
        input classes the census predicted; no-op without a
        prediction."""
        if not caps:
            return
        from trino_tpu_torch.compile.warmup import WarmupEntry

        self._warmup_entries.append(WarmupEntry(
            operator=operator, fn=warmer, in_schema=list(in_schema),
            out_dtypes=tuple(str(t) for t, _ in out_schema), capacities=tuple(caps),
            device=self.device,
        ))

    @staticmethod
    def _take_fused(chain: List[Factory]):
        """Pop a trailing filter/project stage so a blocking consumer
        runs it on each input batch itself."""
        prev = chain[-1] if chain else None
        pf = getattr(prev, "fused_fn", None)
        if pf is not None:
            chain.pop()
        return pf

    def _visit_RemoteSourceNode(self, node: P.RemoteSourceNode):
        """The exchange client as a source operator (ExchangeOperator;
        with merge_keys, MergeOperator). The execution context provides
        "make_remote_source": (fragment_ids) -> page source; each page
        lands on this planner's device."""
        from trino_tpu_torch.exec.exchange_ops import RemoteSourceOperator

        schemas = [self.remote_schemas[fid] for fid in node.fragment_ids]
        assert schemas and all(
            [t for t, _ in s] == [t for t, _ in schemas[0]] for s in schemas
        ), "remote source fragments must share one schema"
        schema: Schema = schemas[0]
        fragment_ids = tuple(node.fragment_ids)
        merge_keys = list(node.merge_keys) if node.merge_keys else None
        device = self.device
        ladder = self.stabilizer.ladder if self.stabilizer is not None else None
        return [
            lambda ctx: RemoteSourceOperator(
                ctx["make_remote_source"](fragment_ids), merge_keys, ladder=ladder,
                device=device,
            )
        ], schema

    def _visit_FilterNode(self, node: P.FilterNode):
        chain, schema = self._visit(node.child)

        def build():
            flt = self._bind(node.predicate, schema)
            return make_filter_project_fn(flt, self._identity(schema)), schema

        fn, _ = self._cached_fp(build, schema, ("flt", repr(node.predicate)))
        self._append_fp(chain, fn, schema, schema)
        return chain, schema

    def _visit_ProjectNode(self, node: P.ProjectNode):
        child = node.child
        predicate = None
        if isinstance(child, P.FilterNode):
            chain, schema = self._visit(child.child)
            predicate = child.predicate
        else:
            chain, schema = self._visit(child)

        def build():
            flt = self._bind(predicate, schema) if predicate is not None else None
            bounds = [self._bind(e, schema) for e in node.exprs]
            return make_filter_project_fn(flt, bounds), [(b.type, b.dictionary) for b in bounds]

        fingerprint = ("proj", repr(predicate) if predicate is not None else None,
                       tuple(repr(e) for e in node.exprs))
        fn, out_schema = self._cached_fp(build, schema, fingerprint)
        self._append_fp(chain, fn, schema, out_schema)
        return chain, out_schema

    def _visit_AggregateNode(self, node: P.AggregateNode):
        mxu = self._try_mxu_join_agg(node)
        if mxu is not None:
            return mxu
        chain, schema = self._visit(node.child)
        if any(a.distinct for a in node.aggs):
            return self._distinct_agg(node, chain, schema)
        specs = [
            AggSpec(a.kind, a.arg_channel, a.out_type,
                    arg2_channel=a.arg2_channel, percentile=a.percentile,
                    separator=a.separator, arg3_channel=a.arg3_channel,
                    param=a.param, post=a.post)
            for a in node.aggs
        ]
        groups = list(node.group_channels)
        step = node.step
        # the input classes before the fused stage is absorbed
        # (filter/project keeps capacity, so they flow through)
        src_caps = getattr(chain[-1], "out_caps", None) if chain else None
        pre = self._take_fused(chain)
        device = self.device
        chain.append(
            lambda ctx: HashAggregationOperator(
                groups, specs, schema, device,
                deferred_checks=ctx.setdefault("deferred_checks", []),
                pre_fn=pre, memory_context=_mem_ctx(ctx), step=step,
            )
        )
        warmer = _AggWarmer(groups, specs, schema, step, device)
        if step == "partial":
            from trino_tpu_torch.exec.operators import partial_output_schema

            out_schema = partial_output_schema(specs, groups, schema)
            self._record_kernel_warmup("HashAggregationOperator", warmer, schema,
                                       out_schema, src_caps)
            return chain, out_schema

        def _out_dict(a):
            # results taken from the argument column keep its dictionary;
            # listagg's strings get theirs at execution time
            if (a.kind in ("min", "max", "any", "min_by", "max_by", "approx_percentile")
                    and a.arg_channel is not None):
                return schema[a.arg_channel][1]
            if a.kind == "listagg":
                return RuntimeDictionary()
            return None

        out_schema: Schema = [schema[c] for c in node.group_channels] + [
            (a.out_type, _out_dict(a)) for a in node.aggs
        ]
        if step == "final":
            # keys and min/max/any results keep the dictionaries that
            # rode through the state wire format
            out_schema = [schema[c] for c in range(len(groups))] + [
                (a.out_type, schema[len(groups) + 2 * i][1])
                for i, a in enumerate(node.aggs)
            ]
        self._record_kernel_warmup("HashAggregationOperator", warmer, schema,
                                   out_schema, src_caps)
        return chain, out_schema

    def _try_mxu_join_agg(self, node: P.AggregateNode):
        """Join-project selection (ops/mxu_join.py): a single-step grouped
        aggregate directly over an inner single-integer-key equi-join,
        every group column build-side, every aggregate argument
        probe-side (or COUNT(*)), kinds sum/count. There the pair sum
        factors through the key and the join never expands. Returns
        (chain, schema) when selected, None for the ordinary plan."""
        global mxu_join_selected
        if not self.mxu_join:
            return None
        # the column pruner leaves identity Projects (bare channel
        # references) between the aggregate and the join: look through
        # them, composing the channel map
        join = node.child
        cmap: Optional[List[int]] = None
        while isinstance(join, P.ProjectNode) and all(
            isinstance(e, InputRef) for e in join.exprs
        ):
            m = [e.index for e in join.exprs]
            cmap = m if cmap is None else [m[c] for c in cmap]
            join = join.child
        if not isinstance(join, P.JoinNode):
            return None

        def tr(ch: int) -> int:
            return cmap[ch] if cmap is not None else ch

        if (
            join.kind != "inner"
            or join.residual is not None
            or len(join.left_keys) != 1
            or len(join.right_keys) != 1
            or getattr(join, "spill_build", False)
        ):
            return None
        if node.step != "single" or not node.group_channels or not node.aggs:
            return None
        probe_width = len(join.left.fields)
        if any(tr(ch) < probe_width for ch in node.group_channels):
            return None
        for side, ch in ((join.left, join.left_keys[0]),
                         (join.right, join.right_keys[0])):
            t = side.fields[ch].type
            if t.is_nested or t.lanes != 1 or not t.is_integerlike:
                return None
        for a in node.aggs:
            if a.kind not in ("sum", "count", "count_star") or a.distinct:
                return None
            if (
                a.arg2_channel is not None or a.arg3_channel is not None
                or a.post is not None or a.out_type != T.BIGINT
            ):
                return None
            if a.kind == "count_star":
                if a.arg_channel is not None:
                    return None
                continue
            if a.arg_channel is None or tr(a.arg_channel) >= probe_width:
                return None
            at = join.left.fields[tr(a.arg_channel)].type
            if at.is_nested or at.lanes != 1 or not at.is_integerlike:
                return None
        # work gate: expected pairs per probe row (fanout) x build key NDV
        # must reach the threshold; below it the expansion is cheap and the
        # ordinary join keeps its dynamic filter
        if self._stats_calc is None:
            from trino_tpu_torch.sql.stats import StatsCalculator

            self._stats_calc = StatsCalculator(self.catalogs)
        bs = self._stats_calc.stats(join.right)
        rows = float(bs.row_count or 0.0)
        ndv = float(bs.col(join.right_keys[0]).ndv or rows)
        fanout = rows / max(ndv, 1.0)
        if fanout * ndv < self.mxu_join_min_work:
            return None

        build_chain, build_schema = self._visit(join.right)
        probe_chain, probe_schema = self._visit(join.left)
        key = self._key()
        device = self.device

        def bridge_of(ctx) -> JoinBridge:
            return ctx.setdefault(key, JoinBridge())

        rkeys = [join.right_keys[0]]
        build_chain.append(
            lambda ctx: HashBuildSink(bridge_of(ctx), rkeys, build_schema, device)
        )
        self.pipelines.append(build_chain)
        lkey = join.left_keys[0]
        aggs = [
            dataclasses.replace(a, arg_channel=tr(a.arg_channel))
            if a.arg_channel is not None else a
            for a in node.aggs
        ]
        groups_b = [tr(ch) - probe_width for ch in node.group_channels]
        probe_chain.append(
            lambda ctx: MxuJoinAggOperator(bridge_of(ctx), lkey, aggs, groups_b)
        )
        # the final grouping over the per-build-row partials: SUM of each
        # partial column (NULL partials drop out, so a SUM over only NULLs
        # stays NULL, and COUNT partials, always valid, add up exactly)
        g = len(groups_b)
        partial_schema: Schema = [build_schema[ch] for ch in groups_b] + [
            (a.out_type, None) for a in aggs
        ]
        specs = [AggSpec("sum", g + i, a.out_type) for i, a in enumerate(aggs)]
        probe_chain.append(
            lambda ctx: HashAggregationOperator(
                list(range(g)), specs, partial_schema, device,
                deferred_checks=ctx.setdefault("deferred_checks", []),
                memory_context=_mem_ctx(ctx),
            )
        )
        mxu_join_selected += 1
        from trino_tpu_torch.runtime.metrics import METRICS

        METRICS.increment("skew.mxu_join_selected")
        return probe_chain, list(partial_schema)

    def _distinct_agg(self, node: P.AggregateNode, chain, schema: Schema):
        """DISTINCT aggregates by dedup-then-aggregate (the MarkDistinct
        analogue, restricted to the single-distinct shape)."""
        if len(node.aggs) != 1:
            raise NotImplementedError("DISTINCT aggregates must be the only aggregate")
        a = node.aggs[0]
        if a.arg_channel is None:
            raise NotImplementedError("count(distinct *) is meaningless")
        dedup_channels = list(node.group_channels) + [a.arg_channel]
        device = self.device
        chain.append(
            lambda ctx: HashAggregationOperator(
                dedup_channels, [], schema, device,
                deferred_checks=ctx.setdefault("deferred_checks", []),
            )
        )
        dedup_schema: Schema = [schema[c] for c in dedup_channels]
        k = len(node.group_channels)
        specs = [AggSpec(a.kind, k, a.out_type)]
        groups = list(range(k))
        chain.append(
            lambda ctx: HashAggregationOperator(
                groups, specs, dedup_schema, device,
                deferred_checks=ctx.setdefault("deferred_checks", []),
            )
        )
        return chain, dedup_schema[:k] + [(a.out_type, None)]

    def _visit_WindowNode(self, node: P.WindowNode):
        chain, schema = self._visit(node.child)
        partition = list(node.partition_channels)
        order = list(node.order_keys)
        fns = list(node.functions)
        frame = node.frame
        device = self.device
        chain.append(
            lambda ctx: WindowOperator(partition, order, fns, frame, schema, device)
        )
        out_schema: Schema = list(schema)
        for f in fns:
            d = None
            if f.arg_channel is not None and f.kind in WINDOW_VALUE_KINDS:
                d = schema[f.arg_channel][1]
            out_schema.append((f.out_type, d))
        return chain, out_schema

    def _visit_UnionAllNode(self, node: P.UnionAllNode):
        """Each input runs as a pipeline of its own into a BufferSink;
        the main chain replays them all. String columns must share one
        dictionary across the inputs (an all-NULL input, with no or an
        empty dictionary, goes with any)."""
        sink_keys = []
        schemas = []
        for child in node.inputs:
            chain, schema = self._visit(child)
            schemas.append(schema)
            key = self._key()
            sink_keys.append(key)
            chain.append(lambda ctx, key=key: ctx.setdefault(key, BufferSink()))
            self.pipelines.append(chain)

        def _dict_rank(d):
            return 0 if d is None or len(d) == 0 else 1

        out_schema = list(schemas[0])
        for s in schemas[1:]:
            for i, ((t0, d0), (t1, d1)) in enumerate(zip(out_schema, s)):
                if not t0.is_string:
                    continue
                if _dict_rank(d0) == 0:
                    out_schema[i] = (t0, d1)
                elif _dict_rank(d1) == 0 or d0 == d1:
                    continue
                else:
                    raise NotImplementedError(
                        "UNION of string columns with differing dictionaries"
                    )
        return [lambda ctx: BufferSource([ctx[k] for k in sink_keys])], out_schema

    def _visit_UnnestNode(self, node: P.UnnestNode):
        chain, schema = self._visit(node.child)
        channels = list(node.array_channels)
        ordinality = node.ordinality
        chain.append(lambda ctx: UnnestOperator(channels, ordinality, schema))
        # an ARRAY column's plan-time dictionary is its elements'
        out_schema: Schema = list(schema)
        out_schema += [(schema[ch][0].element, schema[ch][1]) for ch in channels]
        if ordinality:
            out_schema.append((T.BIGINT, None))
        return chain, out_schema

    def _visit_MatchRecognizeNode(self, node: P.MatchRecognizeNode):
        chain, schema = self._visit(node.child)
        # the DEFINEs bind over the extended schema: the child's channels,
        # then one shifted copy per PREV/NEXT (exec/match_recognize.py)
        ext_schema: Schema = list(schema) + [schema[ch] for ch, _ in node.shifts]
        define_fns = [(var, self._bind(pred, ext_schema).fn) for var, pred in node.defines]
        device = self.device
        chain.append(lambda ctx: MatchRecognizeOperator(node, schema, define_fns, device))
        out_schema: Schema = [schema[ch] for ch in node.partition_channels]
        for m in node.measures:
            if m.kind == "classifier":
                # the pattern's variables are known here, so a string
                # operation above binds against the values it will read
                out_schema.append((m.out_type, classifier_dictionary(node.pattern)))
            elif m.channel is not None:
                out_schema.append((m.out_type, schema[m.channel][1]))
            else:
                out_schema.append((m.out_type, None))
        return chain, out_schema

    def _visit_EnforceSingleRowNode(self, node: P.EnforceSingleRowNode):
        chain, schema = self._visit(node.child)
        device = self.device
        chain.append(lambda ctx: EnforceSingleRowOperator(schema, device))
        return chain, schema

    def _visit_SortNode(self, node: P.SortNode):
        chain, schema = self._visit(node.child)
        keys = list(node.keys)
        pre = self._take_fused(chain)
        device = self.device
        chain.append(lambda ctx: SortOperator(keys, schema, device, pre_fn=pre,
                                              memory_context=_mem_ctx(ctx)))
        return chain, schema

    def _visit_TopNNode(self, node: P.TopNNode):
        chain, schema = self._visit(node.child)
        keys = list(node.keys)
        count = node.count
        pre = self._take_fused(chain)
        device = self.device
        chain.append(
            lambda ctx: TopNOperator(keys, count, schema, device, pre_fn=pre)
        )
        return chain, schema

    def _visit_LimitNode(self, node: P.LimitNode):
        chain, schema = self._visit(node.child)
        count, offset = node.count, node.offset
        chain.append(lambda ctx: LimitOperator(count, offset))
        return chain, schema

    def _visit_JoinNode(self, node: P.JoinNode):
        build_chain, build_schema = self._visit(node.right)
        probe_chain, probe_schema = self._visit(node.left)
        build_caps = getattr(build_chain[-1], "out_caps", None) if build_chain else None
        probe_caps = getattr(probe_chain[-1], "out_caps", None) if probe_chain else None
        key = self._key()
        device = self.device

        def bridge_of(ctx) -> JoinBridge:
            return ctx.setdefault(key, JoinBridge())

        if node.kind == "cross":
            build_chain.append(
                lambda ctx: CrossJoinBuildSink(bridge_of(ctx), build_schema, device)
            )
            self.pipelines.append(build_chain)
            probe_chain.append(lambda ctx: CrossJoinOperator(bridge_of(ctx)))
            return probe_chain, probe_schema + build_schema
        rkeys = list(node.right_keys)
        force_spill = bool(getattr(node, "spill_build", False))
        build_chain.append(
            lambda ctx: HashBuildSink(bridge_of(ctx), rkeys, build_schema, device,
                                      memory_context=_mem_ctx(ctx), force_spill=force_spill)
        )
        self.pipelines.append(build_chain)
        residual_fn = None
        if node.residual is not None:
            residual_fn = make_residual_fn(
                self._bind(node.residual, probe_schema + build_schema)
            )
        lkeys = list(node.left_keys)
        kind = node.kind
        if kind in ("inner", "semi") and self.dynamic_filtering:
            # when the probe side is a bare scan, the build-side key
            # domains also fold into the scan's split handles (read at the
            # first probe batch, after the build pipeline has run); the
            # DynamicFilterOperator below enforces them either way
            if isinstance(node.left, P.ScanNode) and len(probe_chain) == 1:
                scan = node.left
                key_names = [scan.columns[c] for c in lkeys]
                key_types = [scan.fields[c].type for c in lkeys]
                scan_factory = probe_chain[0]

                def df_scan_factory(ctx, _f=scan_factory):
                    op = _f(ctx)
                    op.set_runtime_constraints(
                        lambda: dynamic_filter_constraints(
                            bridge_of(ctx), key_types, key_names
                        )
                    )
                    return op

                df_scan_factory.out_caps = getattr(scan_factory, "out_caps", None)
                probe_chain[0] = df_scan_factory
            probe_chain.append(lambda ctx: DynamicFilterOperator(bridge_of(ctx), lkeys))
        probe_chain.append(
            lambda ctx: LookupJoinOperator(
                bridge_of(ctx), lkeys, kind, probe_schema, residual_fn=residual_fn
            )
        )
        if kind in ("semi", "anti"):
            out_schema = probe_schema
        elif kind in ("mark", "mark_exists"):
            out_schema = probe_schema + [(T.BOOLEAN, None)]
        else:
            out_schema = probe_schema + build_schema
        # a residual join is not warmed: its residual closure belongs to
        # this plan, and the dead-batch warmer does not rebuild it
        if probe_caps and build_caps and residual_fn is None:
            self._record_kernel_warmup(
                "LookupJoinOperator",
                _JoinWarmer(lkeys, rkeys, kind, probe_schema, build_schema, build_caps[0],
                            device),
                probe_schema, out_schema, probe_caps)
        return probe_chain, out_schema
