"""Physical operators.

Counterpart of trino_tpu/exec/operators.py (the Operator layer:
needsInput/addInput/getOutput/finish), pulled batch-at-a-time by the
host Driver. Each add_input/get_output runs eager torch ops on the
batch's device; filters only flip `live` mask bits and dead rows ride
along until an explicit compact, as in the reference.

Ported: TableScan (with runtime dynamic-filter constraints), Values,
FilterProject, Limit, Sort, TopN, Window, HashAggregation in its single,
partial and final steps (global, dense, grouped-sum kernel and sort
routes, with the N-way state merge, and the holistic path for
min_by/max_by, approx_distinct, approx_percentile, pctl_merge and
listagg), EnforceSingleRow, the hash
join (HashBuildSink + LookupJoinOperator for inner, left, full, semi,
anti and mark joins), the join-project MxuJoinAggOperator,
DynamicFilter, the cross join, BufferSink/BufferSource (UNION ALL) and
CollectorSink; nested ARRAY/MAP/ROW columns ride every one of them
whole, and the collect aggregates (array_agg, map_agg, histogram, the
sketch builders, ...) run on the holistic path (UNNEST is
exec/unnest.py, MATCH_RECOGNIZE exec/match_recognize.py).

Under a memory pool (runtime/memory.py) the sort, the grouped
aggregation and the hash build account their buffered state and give it
back when revoked: the sort spills sorted runs and merges them at
finish, the aggregation spills its group state in the partial wire
format (`partial_output_schema`) and merges it back at finish, and the
build side turns into a grace hash join, whose probe side spills to the
same hash partitions and joins partition by partition at finish
(exec/spill.py). Revocation may come from another operator's thread, so
buffered state changes under each operator's lock. The distributed
plane's partial step emits the same partial wire format, and its final
step ingests it through the spill's merge path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import (
    Column,
    Dictionary,
    RelBatch,
    RuntimeDictionary,
    bucket_capacity,
    concat_batches,
    null_column,
    phys_zeros,
)
from trino_tpu_torch.expr import pyfns
from trino_tpu_torch.expr.compile import Bound
from trino_tpu_torch.ops import gather_kernels as GK
from trino_tpu_torch.ops import groupby as G
from trino_tpu_torch.ops import int128 as I128
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops.gather import take_clip
from trino_tpu_torch.ops.sort import SortKey, sort_order
from trino_tpu_torch.analysis.witness import named_lock


class Operator:
    """Pull/push contract (Operator.java)."""

    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, batch: RelBatch) -> None:
        raise NotImplementedError

    def get_output(self) -> Optional[RelBatch]:
        return None

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        raise NotImplementedError

    def is_blocked(self) -> bool:
        """True while the operator waits on another thread (a local
        exchange's producers); the driver then yields instead of
        declaring the pipeline stalled."""
        return False

    _finishing = False


Schema = Sequence[Tuple[T.DataType, Optional[Dictionary]]]


def empty_batch(schema: Schema, device, capacity: int = 16) -> RelBatch:
    cols = [null_column(t, capacity, d, device) if t.is_nested
            else Column(t, phys_zeros(t, capacity, device), None, d) for t, d in schema]
    return RelBatch(cols, torch.zeros(capacity, dtype=torch.bool, device=device))


def _spill_dir(memory_context) -> Optional[str]:
    """Where an operator's spill files go: the query's directory when
    the engine gave one, else the process's temporary directory."""
    return getattr(memory_context, "spill_dir", None)


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


class TableScanOperator(Operator):
    """Pulls batches from a page source over a list of splits, placing
    them on the runner's device. `stabilizer` (compile.shapes
    .ShapeStabilizer) pads each chunk onto the session's capacity
    ladder; None keeps the bucket of the chunk's surviving rows."""

    def __init__(self, page_source, splits, columns: Sequence[str],
                 batch_rows: int, device, stabilizer=None):
        self._page_source = page_source
        self._stabilizer = stabilizer
        self._splits = list(splits)
        self._columns = columns
        self._batch_rows = batch_rows
        self._device = device
        # zero-arg callable -> ColumnConstraints found at run time (the
        # dynamic-filter build domains), folded into every split's handle
        # just before the first batch is pulled
        self._runtime_constraints = None
        self._iters = None
        self._done = False

    def set_runtime_constraints(self, fn) -> None:
        self._runtime_constraints = fn

    def _gen(self):
        splits = self._splits
        if self._runtime_constraints is not None:
            cs = tuple(self._runtime_constraints())
            if cs:
                from trino_tpu_torch.connectors.pushdown import merge_handle_constraints
                from trino_tpu_torch.runtime.metrics import METRICS

                splits = [
                    dataclasses.replace(s, table=merge_handle_constraints(s.table, cs))
                    for s in splits
                ]
                METRICS.increment("dynamic_filter_scan_constraints")
        for split in splits:
            yield from self._page_source.batches(
                split, self._columns, self._batch_rows, device=self._device,
                stabilizer=self._stabilizer,
            )

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[RelBatch]:
        if self._done:
            return None
        if self._iters is None:
            self._iters = self._gen()
        nxt = next(self._iters, None)
        if nxt is None:
            self._done = True
            return None
        from trino_tpu_torch.runtime.metrics import METRICS

        if nxt.live is not None:
            n = int(torch.sum(nxt.live))
        elif nxt.columns:
            n = int(nxt.columns[0].data.shape[0])
        else:
            n = 0
        METRICS.increment("rows_scanned", n)
        return nxt

    def is_finished(self) -> bool:
        return self._done


class ValuesOperator(Operator):
    """Emits a fixed list of batches."""

    def __init__(self, batches: Sequence[RelBatch]):
        self._batches = list(batches)

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[RelBatch]:
        if self._batches:
            return self._batches.pop(0)
        return None

    def is_finished(self) -> bool:
        return not self._batches


# ---------------------------------------------------------------------------
# Filter + project
# ---------------------------------------------------------------------------


def batch_inputs(batch: RelBatch) -> list:
    """An expression's per-column inputs: the data tensor of a flat
    column, the whole Column of a nested one (its starts, flat children
    or fields would be lost in a bare tensor)."""
    return [c if c.type.is_nested else c.data for c in batch.columns]


def make_filter_project_fn(filter_bound: Optional[Bound],
                           projections: Sequence[Bound]):
    """The fused per-batch filter+project function, bound once and
    shared by every operator instance the factory creates."""
    projections = list(projections)

    def fn(batch: RelBatch) -> RelBatch:
        cols = batch_inputs(batch)
        valids = [c.valid for c in batch.columns]
        live = batch.live
        if filter_bound is not None:
            d, v = filter_bound.fn(cols, valids)
            keep = d if v is None else (d & v)  # NULL predicate = drop
            live = keep if live is None else (live & keep)
        if not projections and live is None:
            # a batch without columns (count(*) over a projection of
            # nothing) keeps its row count in its mask
            live = batch.live_mask()
        out_cols = []
        for b in projections:
            data, valid = b.fn(cols, valids)
            if isinstance(data, Column):
                # a whole-Column result (nested, or a string field with
                # its batch dictionary): merge the validity into it
                if valid is not None:
                    data = data.with_data(
                        data.data, valid if data.valid is None else (data.valid & valid))
                out_cols.append(data)
                continue
            d = b.dictionary
            if (
                (d is None or isinstance(d, RuntimeDictionary))
                and b.type.is_string
                and b.input_ref is not None
            ):
                # a column reference keeps the batch's own dictionary
                # (listagg output gets its values at execution time)
                d = batch.columns[b.input_ref].dictionary
            out_cols.append(Column(b.type, data, valid, d))
        return RelBatch(out_cols, live)

    return fn


def compose_batch_fns(f1, f2):
    """Fold two per-batch functions into one stage."""
    def composed(b):
        return f2(f1(b))
    return composed


class FilterProjectOperator(Operator):
    """Applies a per-batch filter/project function (make_filter_project_fn,
    possibly several folded by compose_batch_fns)."""

    def __init__(self, fn):
        self._out: Optional[RelBatch] = None
        self._fn = fn

    def needs_input(self) -> bool:
        return self._out is None and not self._finishing

    def add_input(self, batch: RelBatch) -> None:
        self._out = self._fn(batch)

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._out is None


# ---------------------------------------------------------------------------
# Limit
# ---------------------------------------------------------------------------


class LimitOperator(Operator):
    """LIMIT n OFFSET k: masks rows outside the remaining window. The
    counters stay on the device (no per-batch host sync)."""

    def __init__(self, n: Optional[int], offset: int = 0):
        self._init = (n if n is not None else (1 << 60), offset)
        self._skip = None
        self._remaining = None
        self._out: Optional[RelBatch] = None

    def needs_input(self) -> bool:
        return self._out is None and not self._finishing

    def add_input(self, batch: RelBatch) -> None:
        live = batch.live_mask()
        if self._remaining is None:
            n, offset = self._init
            self._remaining = torch.tensor(n, dtype=torch.int64, device=live.device)
            self._skip = torch.tensor(offset, dtype=torch.int64, device=live.device)
        rank = torch.cumsum(live.to(torch.int64), 0)  # 1-based among live
        keep = live & (rank > self._skip) & (rank <= self._skip + self._remaining)
        n_live = rank[-1] if live.shape[0] else torch.zeros_like(self._skip)
        skipped = torch.minimum(n_live, self._skip)
        taken = torch.minimum(n_live - skipped, self._remaining)
        self._skip = self._skip - skipped
        self._remaining = self._remaining - taken
        self._out = RelBatch(batch.columns, keep)

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    def is_finished(self) -> bool:
        return self._out is None and self._finishing


# ---------------------------------------------------------------------------
# Sort / TopN
# ---------------------------------------------------------------------------


def _apply_sort(batch: RelBatch, keys: Sequence[SortKey]) -> torch.Tensor:
    return sort_order(
        [batch.columns[k.channel].data for k in keys],
        [batch.columns[k.channel].valid for k in keys],
        [k.descending for k in keys],
        [k.nulls_first for k in keys],
        batch.live,
    )


def _concat_sort(parts: Sequence[RelBatch], keys: Sequence[SortKey]) -> RelBatch:
    """Consolidate + sort + front-pack."""
    merged = concat_batches(list(parts))
    order = _apply_sort(merged, keys)
    n_live = torch.sum(merged.live_mask())
    live = torch.arange(order.shape[0], device=order.device) < n_live
    return merged.gather(order, live)


def _topn_merge(parts: Sequence[RelBatch], keys: Sequence[SortKey], n: int,
                cap: int) -> RelBatch:
    merged = concat_batches(list(parts))
    order = _apply_sort(merged, keys)
    cap = min(cap, int(order.shape[0]))
    top = order[:cap]
    n_live = torch.clamp(torch.sum(merged.live_mask()), max=n)
    live = torch.arange(cap, device=order.device) < n_live
    return merged.gather(top, live)


class SortOperator(Operator):
    """Full ORDER BY: consolidate + one sort at finish. Under a memory
    pool the buffered input is revocable: a revoke sorts it into a run
    on disk, and finish sorts the runs read back with the remaining
    input (one consolidating sort, as in the reference). The runs come
    first, in spill order, so rows that tie keep their input order, as
    without a spill (the reference puts the remaining input first)."""

    def __init__(self, keys: Sequence[SortKey], input_schema: Schema, device,
                 pre_fn=None, memory_context=None):
        self._keys = list(keys)
        self._schema = list(input_schema)
        self._device = device
        self._pre = pre_fn
        self._inputs: List[RelBatch] = []
        self._out: Optional[RelBatch] = None
        self._memory = memory_context
        self._spiller = None
        self._in_finish = False
        self._state_lock = named_lock("SortOperator._state_lock")
        if self._memory is not None:
            self._memory.set_revoker(self._revoke_memory)

    def add_input(self, batch: RelBatch) -> None:
        if self._pre is not None:
            batch = self._pre(batch)
        with self._state_lock:
            self._inputs.append(batch)
        self._track_memory()

    def _track_memory(self) -> None:
        """Accounts the buffered input; the final sort's output is not
        operator state and goes unaccounted, as in the reference."""
        if self._memory is None:
            return
        from trino_tpu_torch.runtime.memory import ExceededMemoryLimitError, batch_bytes

        with self._state_lock:
            total = sum(batch_bytes(b) for b in self._inputs)
        try:
            self._memory.set_bytes(total)
        except ExceededMemoryLimitError:
            if total == 0:
                raise
            self._revoke_memory()
            return
        self._memory.set_revocable_bytes(total)

    def _revoke_memory(self) -> None:
        with self._state_lock:
            if not self._inputs or self._in_finish:
                return
            if self._spiller is None:
                from trino_tpu_torch.exec.spill import FileSpiller

                self._spiller = FileSpiller(_spill_dir(self._memory))
            self._spiller.spill(_concat_sort(self._inputs, self._keys))
            self._inputs = []
        self._track_memory()

    def finish(self) -> None:
        if self._finishing:
            return
        self._finishing = True
        with self._state_lock:
            self._in_finish = True
            parts, self._inputs = self._inputs, []
            spiller, self._spiller = self._spiller, None
        if spiller is not None:
            try:
                parts = list(spiller.unspill()) + parts
            finally:
                spiller.close()
        self._out = _concat_sort(parts or [empty_batch(self._schema, self._device)],
                                 self._keys)
        if self._memory is not None:
            self._memory.set_bytes(0)
            self._memory.set_revocable_bytes(0)

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._out is None


class TopNOperator(Operator):
    """ORDER BY + LIMIT n with a bounded reservoir."""

    def __init__(self, keys: Sequence[SortKey], n: int, input_schema: Schema,
                 device, pre_fn=None):
        self._keys = list(keys)
        self._n = n
        self._schema = list(input_schema)
        self._device = device
        self._pre = pre_fn
        self._reservoir: Optional[RelBatch] = None
        self._out: Optional[RelBatch] = None

    def add_input(self, batch: RelBatch) -> None:
        if self._pre is not None:
            batch = self._pre(batch)
        parts = (batch,) if self._reservoir is None else (self._reservoir, batch)
        cap = bucket_capacity(min(self._n, sum(p.capacity for p in parts)))
        self._reservoir = _topn_merge(parts, self._keys, self._n, cap)

    def finish(self) -> None:
        if self._finishing:
            return
        self._finishing = True
        self._out = (
            self._reservoir if self._reservoir is not None
            else empty_batch(self._schema, self._device)
        )

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._out is None


# ---------------------------------------------------------------------------
# Window functions
# ---------------------------------------------------------------------------


def _window_compute(batch: RelBatch, partition_channels: Sequence[int],
                    order_keys: Sequence[SortKey], functions: tuple, frame: str):
    """Every window column over the batch sorted by (partition, order):
    the WindowOperator's inner loop as segmented scans (ops/window.py).
    Returns (sorted columns, sorted live mask, [(data, valid)] per
    function)."""
    from trino_tpu_torch.ops import window as W

    live = batch.live_mask()
    n = batch.capacity
    part_cols = [batch.columns[c] for c in partition_channels]
    order_cols = [batch.columns[k.channel] for k in order_keys]
    key_cols = part_cols + order_cols
    if key_cols:
        order = sort_order(
            [c.data for c in key_cols], [c.valid for c in key_cols],
            [False] * len(part_cols) + [k.descending for k in order_keys],
            [False] * len(part_cols) + [k.nulls_first for k in order_keys],
            live,
        )
    else:
        order = torch.argsort((~live).to(torch.int8), stable=True)
    s_live = take_clip(live, order)
    s_cols = [c.gather(order) for c in batch.columns]

    def sorted_keys(cols):
        return ([take_clip(c.data, order) for c in cols],
                [None if c.valid is None else take_clip(c.valid, order) for c in cols])

    # partition boundaries; the dead tail is a segment of its own
    pd, pv = sorted_keys(part_cols)
    part_start = W.segment_starts(pd + [s_live], pv + [None], n)
    peer_start = part_start
    if order_cols:
        od, ov = sorted_keys(order_cols)
        peer_start = part_start | W.segment_starts(od, ov, n)

    out_cols = []
    for kind, arg_ch, out_dt, offset, arg_sf, out_float, out_sf, out_lanes in functions:
        if kind == "row_number":
            out_cols.append((W.row_number(part_start).to(out_dt), None))
        elif kind in ("rank", "dense_rank", "percent_rank", "cume_dist"):
            fn = getattr(W, kind)
            out_cols.append((fn(part_start, peer_start).to(out_dt), None))
        elif kind == "ntile":
            out_cols.append((W.ntile(offset, part_start).to(out_dt), None))
        elif kind in ("lead", "lag"):
            col = s_cols[arg_ch]
            off = offset if kind == "lag" else -offset
            data, valid = W.shift_in_partition(col.data, col.valid, part_start, off)
            out_cols.append((data, valid & s_live))
        elif kind == "first_value":
            col = s_cols[arg_ch]
            out_cols.append(W.first_value(col.data, col.valid, part_start))
        elif kind == "last_value":
            col = s_cols[arg_ch]
            out_cols.append(W.last_value(col.data, col.valid, part_start, peer_start,
                                         frame))
        elif kind == "nth_value":
            col = s_cols[arg_ch]
            data, valid = W.nth_value(col.data, col.valid, part_start, peer_start,
                                      frame, offset)
            out_cols.append((data, valid & s_live if valid is not None else None))
        elif kind in ("count", "count_star"):
            vals = valid = None
            if arg_ch is not None:
                vals, valid = s_cols[arg_ch].data, s_cols[arg_ch].valid
            v, _ = W.windowed_agg("count", vals, valid, s_live, part_start, peer_start,
                                  frame, 0)
            out_cols.append((v.to(out_dt), None))
        elif kind in ("sum", "avg", "min", "max"):
            col = s_cols[arg_ch]
            if col.data.dim() == 2:
                raise NotImplementedError("window aggregates over decimal(>18) arguments")
            if kind in ("min", "max"):
                vals = col.data
                neutral = G.minmax_neutral(vals.dtype, kind)
            else:
                vals = col.data.to(G._acc_dtype(col.data.dtype))
                neutral = 0
            v, cnt = W.windowed_agg(kind, vals, col.valid, s_live, part_start,
                                    peer_start, frame, neutral)
            has = cnt > 0
            if kind == "avg":
                q = v.to(torch.float64) / torch.clamp(cnt, min=1) / arg_sf
                if out_sf is not None:
                    # decimal avg: back into the output's scaled-int64
                    # domain, rounding half away from zero (as _agg_output)
                    q = q * out_sf
                    q = torch.sign(q) * torch.floor(torch.abs(q) + 0.5)
                out_cols.append((q.to(out_dt), has))
            elif kind == "sum" and out_float:
                out_cols.append(((v / arg_sf).to(out_dt), has))
            else:
                safe = torch.where(has, v, torch.zeros_like(v))
                if out_lanes == 2:
                    # sum(short decimal) -> decimal(38, s): widen the int64
                    # accumulator into limb pairs
                    h, lo = I128.from_i64(safe.to(torch.int64))
                    out_cols.append((torch.stack([h, lo], dim=-1), has))
                else:
                    out_cols.append((safe.to(out_dt), has))
        else:
            raise NotImplementedError(f"window function {kind}")
    return s_cols, s_live, out_cols


def window_fn_tuples(specs, schema: Schema) -> tuple:
    """Per-function static layout for _window_compute: (kind, arg
    channel, output dtype, offset, argument scale divisor, float output,
    decimal output scale factor, output lanes). Decimal arguments stay
    scaled int64; only an output that leaves the scaled domain (avg to
    DOUBLE, float sums) divides by the argument's scale."""
    fns = []
    for s in specs:
        arg_sf = 1
        out_float = s.out_type.is_floating
        out_sf = T.decimal_scale_factor(s.out_type) if s.out_type.is_decimal else None
        if s.arg_channel is not None:
            arg_t = schema[s.arg_channel][0]
            if arg_t.is_decimal and (s.kind == "avg" or out_float):
                arg_sf = T.decimal_scale_factor(arg_t)
        fns.append((s.kind, s.arg_channel, s.out_type.dtype, s.offset, arg_sf,
                    out_float, out_sf, s.out_type.lanes))
    return tuple(fns)


# window functions whose result is a value of their argument column, so
# the argument's dictionary rides along
WINDOW_VALUE_KINDS = ("lead", "lag", "first_value", "last_value", "nth_value",
                      "min", "max")


class WindowOperator(Operator):
    """Blocking window evaluation (WindowOperator.java): consume all
    input, sort once by (partition, order), emit the child's columns and
    the window results in sorted order."""

    def __init__(self, partition_channels: Sequence[int], order_keys: Sequence[SortKey],
                 functions: Sequence, frame: str, input_schema: Schema, device):
        self._partition = tuple(partition_channels)
        self._order = tuple(order_keys)
        self._specs = list(functions)
        self._frame = frame
        self._schema = list(input_schema)
        self._device = device
        self._inputs: List[RelBatch] = []
        self._out: Optional[RelBatch] = None
        self._fns = window_fn_tuples(self._specs, self._schema)

    def add_input(self, batch: RelBatch) -> None:
        self._inputs.append(batch)

    def finish(self) -> None:
        if self._finishing:
            return
        self._finishing = True
        parts = self._inputs or [empty_batch(self._schema, self._device)]
        self._inputs = []
        s_cols, s_live, out_cols = _window_compute(
            concat_batches(parts), self._partition, self._order, self._fns,
            self._frame)
        cols = list(s_cols)
        for spec, (data, valid) in zip(self._specs, out_cols):
            d = None
            if spec.arg_channel is not None and spec.kind in WINDOW_VALUE_KINDS:
                d = s_cols[spec.arg_channel].dictionary
            cols.append(Column(spec.out_type, data, valid, d))
        self._out = RelBatch(cols, s_live)

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._out is None


# ---------------------------------------------------------------------------
# Hash aggregation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate: kind, input channel (None for count_star) and SQL
    result type. The planner fields beyond arg_channel are carried so
    the plan layer matches the reference; the ported operator reads
    kind, arg_channel and out_type."""

    kind: str
    arg_channel: Optional[int]
    out_type: T.DataType
    distinct: bool = False
    arg2_channel: Optional[int] = None
    percentile: Optional[float] = None
    separator: Optional[str] = None
    arg3_channel: Optional[int] = None
    param: Optional[float] = None
    post: Optional[str] = None


_COLLECT_KINDS = (
    "array_agg", "map_agg", "multimap_agg", "histogram",
    "numeric_histogram", "approx_most_frequent", "map_union",
    "bitwise_and_agg", "bitwise_or_agg", "bitwise_xor_agg",
    "approx_set", "tdigest_agg", "sketch_merge",
)

# aggregates needing raw rows rather than mergeable accumulators (the
# analyzer reads this set): the operator buffers its input and reduces
# once at finish. pctl_merge is the merge half of the mergeable
# approx_percentile (sql/optimizer.RewriteApproxPercentile); it reads
# quantile-bucket summaries, never raw rows. The collect kinds build each
# group's container on the host from the device's group-contiguous row
# order (HashAggregationOperator._collect_column).
HOLISTIC_KINDS = (
    "min_by", "max_by", "approx_percentile", "listagg", "approx_distinct",
    "pctl_merge",
) + _COLLECT_KINDS


def _bht_histogram(vals, b: int):
    """Ben-Haim/Tom-Tov streaming histogram, batch form: merge the two
    closest centroids until at most b remain (NumericHistogram).
    {centroid: weight}, or None for no input."""
    if not vals or b <= 0:
        return None
    pts: List[List[float]] = []
    for v in sorted(float(x) for x in vals):
        if pts and pts[-1][0] == v:
            pts[-1][1] += 1.0
        else:
            pts.append([v, 1.0])
    while len(pts) > b:
        bi, bgap = 0, float("inf")
        for i in range(len(pts) - 1):
            gap = pts[i + 1][0] - pts[i][0]
            if gap < bgap:
                bi, bgap = i, gap
        (v1, c1), (v2, c2) = pts[bi], pts[bi + 1]
        pts[bi] = [(v1 * c1 + v2 * c2) / (c1 + c2), c1 + c2]
        del pts[bi + 1]
    return {v: c for v, c in pts}


def _counts(vals) -> dict:
    h: dict = {}
    for v in vals:
        if v is not None:
            h[v] = h.get(v, 0) + 1
    return h


def _collect_value(a: AggSpec, vals: list):
    """One group's container (None for an empty one) from its values in
    group order (pairs for map_agg and multimap_agg)."""
    kind = a.kind
    nn = [v for v in vals if v is not None]
    if kind == "array_agg":
        return vals or None  # NULL elements are kept
    if kind == "map_agg":
        return {k: v for k, v in vals if k is not None} or None
    if kind == "multimap_agg":
        mm: dict = {}
        for k, v in vals:
            if k is not None:
                mm.setdefault(k, []).append(v)
        return mm or None
    if kind == "histogram":
        return _counts(vals) or None
    if kind == "approx_most_frequent":
        top = sorted(_counts(vals).items(), key=lambda kv: (-kv[1], str(kv[0])))
        return dict(top[:int(a.param or 3)]) or None
    if kind == "numeric_histogram":
        return _bht_histogram(nn, int(a.param or 10))
    if kind == "map_union":
        merged: dict = {}
        for m in vals:
            if m:
                merged.update(m)
        return merged or None
    if not nn:
        return None
    if kind == "approx_set":
        return pyfns.hll_from_values(nn)
    if kind == "tdigest_agg":
        return pyfns.tdigest_from_values(nn)
    return pyfns.sketch_merge(nn)  # sketch_merge


_BATCH_REDUCER = {"sum": "sum", "avg": "sum", "count": "count",
                  "count_star": "count", "min": "min", "max": "max",
                  "any": "first"}
# merging two states: counts add, mins min, firsts keep-first
_MERGE_REDUCER = {"sum": "sum", "avg": "sum", "count": "sum",
                  "count_star": "sum", "min": "min", "max": "max",
                  "any": "first"}


def _agg_output(spec: AggSpec, state, arg_type: Optional[T.DataType],
                arg_dict: Optional[Dictionary]) -> Column:
    """Finalize a state into the SQL result column. Decimal
    accumulators hold scaled values at the ARG's scale."""
    out_t = spec.out_type
    if spec.kind in ("count", "count_star"):
        (cnt,) = state
        return Column(out_t, cnt.to(torch.int64), None, None)
    if len(state) == 3:
        # Int128 state (sum/avg over a long-decimal arg)
        h, lo, cnt = state
        has = cnt > 0
        if spec.kind in ("min", "max", "any"):
            return Column(out_t, torch.stack([h, lo], dim=-1), has, arg_dict)
        if spec.kind == "avg":
            h, lo = I128.div_round_i64(h, lo, torch.clamp(cnt, min=1).to(torch.int64))
        arg_s = arg_type.scale or 0
        out_s = out_t.scale or 0
        if out_s > arg_s:
            h, lo = I128.rescale_up(h, lo, out_s - arg_s)
        elif arg_s > out_s:
            h, lo = I128.rescale_down_round(h, lo, arg_s - out_s)
        if out_t.is_long_decimal:
            return Column(out_t, torch.stack([h, lo], dim=-1), has, None)
        x, _ = I128.to_i64(h, lo)
        return Column(out_t, x.to(out_t.dtype), has, None)
    acc, cnt = state
    has = cnt > 0
    arg_sf = (
        T.decimal_scale_factor(arg_type)
        if arg_type is not None and arg_type.is_decimal else 1
    )
    out_sf = T.decimal_scale_factor(out_t) if out_t.is_decimal else None
    if spec.kind == "sum":
        if out_t.is_floating:
            return Column(out_t, acc.to(out_t.dtype) / arg_sf, has, None)
        if out_sf is not None and out_sf != arg_sf:
            acc = (acc * (out_sf // arg_sf) if out_sf > arg_sf
                   else torch.div(acc, arg_sf // out_sf, rounding_mode="floor"))
        if out_t.is_long_decimal:
            h, lo = I128.from_i64(acc.to(torch.int64))
            return Column(out_t, torch.stack([h, lo], dim=-1), has, None)
        return Column(out_t, acc.to(out_t.dtype), has, None)
    if spec.kind == "avg":
        q = acc.to(torch.float64) / torch.clamp(cnt, min=1)
        if out_t.is_floating:
            return Column(out_t, (q / arg_sf).to(out_t.dtype), has, None)
        q = q * (out_sf / arg_sf)
        data = (torch.sign(q) * torch.floor(torch.abs(q) + 0.5)).to(out_t.dtype)
        return Column(out_t, data, has, None)
    if spec.kind in ("min", "max", "any"):
        safe = torch.where(has, acc, torch.zeros((), dtype=acc.dtype, device=acc.device))
        if out_t.is_floating and arg_sf != 1:
            return Column(out_t, safe.to(out_t.dtype) / arg_sf, has, None)
        return Column(out_t, safe.to(out_t.dtype), has, arg_dict)
    raise NotImplementedError(spec.kind)


# -- Int128 sum accumulation: a long-decimal (n, 2) argument splits into
# FOUR 32-bit limb columns whose int64 sums are exact for < 2^31 rows,
# recombined into (hi, lo) at finalize:
#   value = l0 + l1*2^32 + h0*2^64 + h1*2^96   (h1 signed, rest unsigned)

_LIMB_MASK = 0xFFFFFFFF


def _limb_split(d: torch.Tensor) -> List[torch.Tensor]:
    h, lo = d[:, 0], d[:, 1]
    return [lo & _LIMB_MASK, (lo >> 32) & _LIMB_MASK, h & _LIMB_MASK, h >> 32]


def _limb_join(sums: Sequence[torch.Tensor]):
    """Four limb-sum tensors -> (hi, lo) Int128."""
    h, lo = I128.from_i64(sums[3].to(torch.int64))
    for s in (sums[2], sums[1], sums[0]):
        h, lo = I128.mul_128_64(h, lo, 1 << 32)
        ah, al = I128.from_i64(s.to(torch.int64))
        h, lo = I128.add(h, lo, ah, al)
    return h, lo


def _lex128_reduce(h, lo, w, kind: str):
    """Masked whole-array Int128 min/max over (hi, lo) rows."""
    big = (1 << 63) - 1
    sgn = -(1 << 63)
    lo_u = lo ^ sgn
    if kind == "min":
        m1 = torch.min(torch.where(w, h, big))
        m2 = torch.min(torch.where(w & (h == m1), lo_u, big)) ^ sgn
    else:
        m1 = torch.max(torch.where(w, h, -big - 1))
        m2 = torch.max(torch.where(w & (h == m1), lo_u, -big - 1)) ^ sgn
    return m1, m2


def _append_long_decimal_slots(a, col, live, values, vvalids, reds) -> None:
    """Value slots for an aggregate over a decimal(>18) column: count
    reads validity; sum/avg split into four exact limb slots; min/max
    ride the coupled (hi, lo) reducers; any picks both limbs."""
    if a.kind == "count":
        values.append(live.to(torch.int64))
        vvalids.append(col.valid)
        reds.append("count")
        return
    if a.kind in ("min", "max"):
        values.extend([col.data[:, 0], col.data[:, 1]])
        vvalids.extend([col.valid, col.valid])
        reds.extend([f"{a.kind}128h", f"{a.kind}128l"])
        return
    if a.kind == "any":
        values.extend([col.data[:, 0], col.data[:, 1]])
        vvalids.extend([col.valid, col.valid])
        reds.extend(["first", "first"])
        return
    if a.kind not in ("sum", "avg"):
        raise NotImplementedError(f"{a.kind}() over decimal(>18) arguments")
    for piece in _limb_split(col.data):
        values.append(piece)
        vvalids.append(col.valid)
        reds.append("sum")


def _agg_slot_count(spec: AggSpec, arg_type: Optional[T.DataType]) -> int:
    """State (value, count) slot pairs one aggregate occupies."""
    if arg_type is None or not arg_type.is_long_decimal:
        return 1
    if spec.kind in ("sum", "avg"):
        return 4
    if spec.kind in ("min", "max", "any"):
        return 2
    return 1


def _slots_to_state(spec: AggSpec, arg_type: Optional[T.DataType], vals, cnts,
                    si: int):
    """One aggregate's finalize-ready state from its slots at `si`."""
    kslots = _agg_slot_count(spec, arg_type)
    if kslots == 4:
        h, lo = _limb_join(vals[si: si + 4])
        state = (h, lo, cnts[si])
    elif kslots == 2:
        state = (vals[si], vals[si + 1], cnts[si])
    elif spec.kind in ("count", "count_star"):
        state = (vals[si],)
    else:
        state = (vals[si], cnts[si])
    return state, si + kslots


def _slot_merge_reducers(spec: AggSpec, arg_type: Optional[T.DataType]):
    """Per-slot reducers for merging two group states of one aggregate."""
    if arg_type is not None and arg_type.is_long_decimal:
        if spec.kind in ("sum", "avg"):
            return ["sum"] * 4
        if spec.kind in ("min", "max"):
            return [f"{spec.kind}128h", f"{spec.kind}128l"]
        if spec.kind == "any":
            return ["first", "first"]
    return [_MERGE_REDUCER[spec.kind]]


def agg_state_meta(spec: AggSpec, input_schema: Schema) -> List[tuple]:
    """Wire schema of one aggregate's partial state: its (value, count)
    columns (the accumulator serialization between the partial and final
    steps, and the spill format)."""
    if spec.kind in ("count", "count_star"):
        return [(T.BIGINT, None), (T.BIGINT, None)]
    arg_t, arg_d = input_schema[spec.arg_channel]
    if spec.kind in ("sum", "avg"):
        if arg_t.is_long_decimal:
            # one (hi, lo) Int128 column at the argument's scale: the limb
            # sums join before the wire and split again after it
            return [(T.DataType(T.TypeKind.DECIMAL, 38, arg_t.scale), None),
                    (T.BIGINT, None)]
        if arg_t.is_floating:
            val_t = T.DOUBLE
        elif arg_t.is_decimal:
            val_t = T.DataType(T.TypeKind.DECIMAL, 18, arg_t.scale)
        else:
            val_t = T.BIGINT
        return [(val_t, None), (T.BIGINT, None)]
    # min/max/any carry the argument representation through the wire
    return [(arg_t, arg_d), (T.BIGINT, None)]


def partial_output_schema(aggs: Sequence[AggSpec], group_channels: Sequence[int],
                          input_schema: Schema) -> List[tuple]:
    """Schema of a partial aggregation's state batch: [group keys...,
    (value, count) per aggregate...]."""
    out = [input_schema[c] for c in group_channels]
    for a in aggs:
        out.extend(agg_state_meta(a, input_schema))
    return out


def _slots_to_wire_column(spec: AggSpec, arg_type: Optional[T.DataType], vt, vd,
                          vals, si: int):
    """One aggregate's wire-format value column from its slots at `si`
    (the serialization half of `_slots_to_state`). Returns (column,
    next si)."""
    kslots = _agg_slot_count(spec, arg_type)
    if kslots == 4:
        h, lo = _limb_join(vals[si: si + 4])
        col = Column(vt, torch.stack([h, lo], dim=-1), None, vd)
    elif kslots == 2:
        col = Column(vt, torch.stack([vals[si], vals[si + 1]], dim=-1), None, vd)
    else:
        col = Column(vt, vals[si].to(vt.dtype), None, vd)
    return col, si + kslots


def _merge_group_states(states, reducers: tuple, out_capacity: int):
    """Concat N (keys, valids, used, vals, cnts) group-state sets and
    re-group-reduce them in one pass."""
    n_keys = len(states[0][0])
    keys = [torch.cat([s[0][i] for s in states]) for i in range(n_keys)]
    valids = [torch.cat([s[1][i] for s in states]) for i in range(n_keys)]
    mask = torch.cat([s[2] for s in states])
    values, vvalids, reds = [], [], []
    for i, mred in enumerate(reducers):
        v = torch.cat([s[3][i] for s in states])
        c = torch.cat([s[4][i] for s in states])
        values.append(v)
        vvalids.append((c > 0) if mred == "first" else None)
        reds.append(mred)
        values.append(c)
        vvalids.append(None)
        reds.append("sum")
    gk, gv, used, vals, _, ngroups, ovf = G.sort_group_reduce(
        keys, valids, mask, values, tuple(vvalids), tuple(reds), out_capacity
    )
    return (
        (tuple(gk), tuple(gv), used, tuple(vals[0::2]), tuple(vals[1::2])),
        ngroups,
        ovf,
    )


def _batch_values(batch: RelBatch, aggs: Sequence[AggSpec]):
    """(live, value slots, value validities, batch reducers)."""
    live = batch.live_mask()
    values, vvalids, reds = [], [], []
    for a in aggs:
        if a.arg_channel is None:
            values.append(live.to(torch.int64))
            vvalids.append(None)
        elif batch.columns[a.arg_channel].data.dim() == 2:
            _append_long_decimal_slots(
                a, batch.columns[a.arg_channel], live, values, vvalids, reds
            )
            continue
        else:
            col = batch.columns[a.arg_channel]
            values.append(col.data)
            vvalids.append(col.valid)
        reds.append(_BATCH_REDUCER[a.kind])
    return live, values, vvalids, tuple(reds)


def _agg_ingest(batch: RelBatch, groups: Sequence[int], aggs: Sequence[AggSpec],
                cap: int, pre_fn, dense_dims=None, mxu_dims=None):
    """Upstream filter/project + per-batch group-reduce."""
    if pre_fn is not None:
        batch = pre_fn(batch)
    keys, valids = [], []
    for c in groups:
        col = batch.columns[c]
        v = col.valid_mask()
        if col.data.dim() == 2:
            keys.extend([col.data[:, 0], col.data[:, 1]])
            valids.extend([v, v])
        else:
            keys.append(col.data)
            valids.append(v)
    live, values, vvalids, reds = _batch_values(batch, aggs)
    if dense_dims is not None:
        return G.dense_group_reduce(
            keys, valids, live, values, tuple(vvalids), reds, dense_dims, cap
        )
    if mxu_dims is not None:
        return G.mxu_group_reduce(
            keys, valids, live, values, tuple(vvalids), reds, mxu_dims, cap
        )
    return G.sort_group_reduce(
        keys, valids, live, values, tuple(vvalids), reds, cap
    )


def _global_update(aggs: Sequence[AggSpec], long_flags: Sequence[bool],
                   states, batch: RelBatch):
    """Whole-batch reduction for GROUP-BY-less aggregation."""
    live = batch.live_mask()
    out = []
    for a, is_long, (val, cnt) in zip(aggs, long_flags, states):
        if a.arg_channel is None:
            data, valid = live.to(torch.int64), None
        else:
            col = batch.columns[a.arg_channel]
            data, valid = col.data, col.valid
        w = live if valid is None else (live & valid)
        n = torch.sum(w.to(torch.int64))
        if a.kind in ("count", "count_star"):
            out.append((val + n, cnt + n))
        elif is_long and a.kind in ("sum", "avg"):
            zero = torch.zeros((), dtype=torch.int64, device=live.device)
            limb_sums = [
                torch.sum(torch.where(w, piece, zero))
                for piece in _limb_split(data)
            ]
            bh, bl = _limb_join(limb_sums)
            h, lo = I128.add(val[0], val[1], bh, bl)
            out.append((torch.stack([h, lo]), cnt + n))
        elif a.kind in ("sum", "avg"):
            contrib = torch.where(
                w, data.to(val.dtype), torch.zeros((), dtype=val.dtype, device=live.device)
            )
            out.append((val + torch.sum(contrib), cnt + n))
        elif is_long and a.kind in ("min", "max"):
            m1, m2 = _lex128_reduce(data[:, 0], data[:, 1], w, a.kind)
            better = (I128.lt(m1, m2, val[0], val[1]) if a.kind == "min"
                      else I128.lt(val[0], val[1], m1, m2))
            take = (better | (cnt == 0)) & (n > 0)
            nh = torch.where(take, m1, val[0])
            nl = torch.where(take, m2, val[1])
            out.append((torch.stack([nh, nl]), cnt + n))
        elif a.kind in ("min", "max"):
            neutral = torch.tensor(
                G.minmax_neutral(data.dtype, a.kind), dtype=data.dtype, device=live.device
            )
            masked = torch.where(w, data, neutral)
            red = torch.min(masked) if a.kind == "min" else torch.max(masked)
            op = torch.minimum if a.kind == "min" else torch.maximum
            out.append((op(val, red.to(val.dtype)), cnt + n))
        elif a.kind == "any":
            first = data[torch.argmax(w.to(torch.int8))]
            new_val = torch.where(
                cnt > 0, val, torch.where(torch.any(w), first, val)
            )
            out.append((new_val, cnt + n))
        else:
            raise NotImplementedError(a.kind)
    return out


_SHRINK_MIN_CAPACITY = 1 << 17


def _shrink_prefix(batch: RelBatch, live_count: int) -> RelBatch:
    """Slice a prefix-dense batch down to a bucketed capacity."""
    new_cap = max(bucket_capacity(live_count), 16)
    if new_cap >= batch.capacity:
        return batch
    cols = [
        Column(c.type, c.data[:new_cap],
               None if c.valid is None else c.valid[:new_cap], c.dictionary)
        for c in batch.columns
    ]
    live = None if batch.live is None else batch.live[:new_cap]
    return RelBatch(cols, live)


def kernel_band_enabled(device) -> bool:
    """The grouped-sum kernel band runs on the card, and on the CPU only
    when TRINO_TPU_FORCE_MXU=1 (the reference's test switch)."""
    return (
        torch.device(device).type == "cuda"
        or os.environ.get("TRINO_TPU_FORCE_MXU") == "1"
    )


class HashAggregationOperator(Operator):
    """GROUP BY + aggregates. Per-batch group states collect and merge
    in one N-way pass; output schema = [group keys..., aggregate
    results...]. Route selection is the reference's: dense slots for
    bounded domains up to 64 slots, the grouped-sum kernel for bounded
    sum/count domains up to 2048 slots, the sort path otherwise.

    `step` is the reference's AggregationNode.Step: "single" (raw rows
    in, results out), "partial" (raw rows in, the accumulator state out
    in `partial_output_schema`'s layout) or "final" (that state in,
    results out). A final step's input value columns carry each
    aggregate's argument representation (decimal scale, dictionary), so
    finalization reads it from the input schema. A partial step picks
    its route as a single step does.

    Under a memory pool the group state of a grouped aggregation is
    revocable (SpillableHashAggregationBuilder): a revoke merges it,
    spills it in the partial wire format and resets; finish reads the
    spilled states back through `_add_state_input`, the final step's
    ingestion, and merges them. The holistic route accounts its buffered
    rows and never spills; the global route holds one row."""

    def __init__(
        self,
        group_channels: Sequence[int],
        aggregates: Sequence[AggSpec],
        input_schema: Schema,
        device,
        initial_capacity: int = 1024,
        deferred_checks: Optional[List] = None,
        pre_fn=None,
        memory_context=None,
        step: str = "single",
    ):
        assert step in ("single", "partial", "final"), step
        self._step = step
        self._device = torch.device(device)
        self._pre = pre_fn
        self._group_channels = list(group_channels)
        self._aggs = list(aggregates)
        self._schema = list(input_schema)
        self._global = not self._group_channels
        self._cap = initial_capacity
        for a in self._aggs:
            if a.distinct:
                raise NotImplementedError(
                    f"{a.kind}(DISTINCT): the planner deduplicates first "
                    f"(sql/local_planner._distinct_agg)"
                )
        # holistic aggregates need the raw rows: batches collect and
        # reduce once at finish
        self._holistic = any(a.kind in HOLISTIC_KINDS for a in self._aggs)
        if self._holistic:
            assert step == "single", "holistic aggregates run single-step"
        self._collected: List[RelBatch] = []
        self._acc = None
        self._pending: List[tuple] = []
        # a state ingested off the wire may carry duplicate group keys
        # within one batch (pages of several producers), so it passes
        # through a group-reduce even when it is the only pending state
        self._unreduced_state = False
        self._gstate = None
        self._out: Optional[RelBatch] = None
        self._arg_meta = [
            input_schema[a.arg_channel] if a.arg_channel is not None else (None, None)
            for a in self._aggs
        ]
        self._n_slots = sum(
            _agg_slot_count(a, m[0]) for a, m in zip(self._aggs, self._arg_meta)
        )
        # dictionary-coded and boolean keys bound the group count at
        # plan time
        bound = 1
        dims = []
        for c in self._group_channels:
            t, d = self._schema[c]
            if t.is_string and d is not None and len(d) > 0:
                dims.append(len(d))
                bound *= len(d) + 1  # +1: the NULL group
            elif t.kind == T.TypeKind.BOOLEAN:
                dims.append(2)
                bound *= 3
            else:
                bound = 0
                break
        self._static_bound = bound if 0 < bound <= (1 << 16) else None
        self._dense_dims = (
            tuple(dims)
            if self._static_bound is not None
            and bound <= 64
            and self._group_channels
            and all(
                _BATCH_REDUCER.get(a.kind) in ("sum", "count", "min", "max")
                and not (
                    a.kind in ("min", "max")
                    and a.arg_channel is not None
                    and self._schema[a.arg_channel][0].is_long_decimal
                )
                for a in self._aggs
            )
            else None
        )

        def _int_kind(a: AggSpec) -> bool:
            if a.arg_channel is None:
                return True
            return not self._schema[a.arg_channel][0].is_floating

        self._mxu_dims = (
            tuple(dims)
            if self._dense_dims is None
            and self._static_bound is not None
            and bound <= 2048
            and self._group_channels
            and all(
                _BATCH_REDUCER.get(a.kind) in ("sum", "count") and _int_kind(a)
                for a in self._aggs
            )
            and kernel_band_enabled(self._device)
            else None
        )
        self._deferred_ovf: List = []
        self._checks = deferred_checks
        if self._static_bound is not None:
            self._cap = max(bucket_capacity(self._static_bound), 16)
        self._long_flags = tuple(
            a.arg_channel is not None and input_schema[a.arg_channel][0].is_long_decimal
            for a in self._aggs
        )
        self._memory = memory_context
        self._spiller = None
        self._in_finish = False
        # revocation runs on the reserving thread (MemoryPool.reserve
        # calls the victim's callback), so state changes and the revoke
        # serialize on this lock; accounting calls stay outside it
        self._state_lock = named_lock("HashAggregationOperator._state_lock")
        if self._memory is not None and not self._global and not self._holistic:
            self._memory.set_revoker(self._revoke_memory)

    @property
    def route(self) -> str:
        if self._global:
            return "global"
        if self._dense_dims is not None:
            return "dense"
        if self._mxu_dims is not None:
            return "grouped_sum"
        return "sort"

    def add_input(self, batch: RelBatch) -> None:
        if self._holistic:
            if self._pre is not None:
                batch = self._pre(batch)
            self._collected.append(batch)
            if self._memory is not None:
                # buffered raw rows: accounted so the pool sees them, not
                # revocable (an oversized holistic input fails loudly)
                from trino_tpu_torch.runtime.memory import batch_bytes

                self._memory.set_bytes(sum(batch_bytes(b) for b in self._collected))
            return
        if self._step == "final":
            if self._pre is not None:
                batch = self._pre(batch)
            self._add_state_input(batch)
            self._track_memory()
            return
        if self._global:
            if self._pre is not None:
                batch = self._pre(batch)
            if self._gstate is None:
                self._gstate = self._global_init()
            self._gstate = _global_update(
                self._aggs, self._long_flags, self._gstate, batch
            )
            return
        # the dense/kernel routes address slots by mixed-radix position,
        # so their table holds the full domain; the sort path caps the
        # per-batch table at the batch capacity
        if self._dense_dims is not None or self._mxu_dims is not None:
            cap = self._cap
        else:
            cap = min(self._cap, bucket_capacity(batch.capacity))
        while True:
            gk, gv, used, vals, cnts, ngroups, ovf = _agg_ingest(
                batch, self._group_channels, self._aggs, cap, self._pre,
                self._dense_dims, self._mxu_dims,
            )
            if self._static_bound is not None:
                # overflow impossible by the plan-time bound: verify once
                # at finish
                self._deferred_ovf.append(ovf)
                break
            if not bool(ovf):
                break
            cap = max(cap * 2, bucket_capacity(int(ngroups)))
            self._cap = max(self._cap, cap)
        with self._state_lock:
            self._pending.append((tuple(gk), tuple(gv), used, tuple(vals), tuple(cnts)))
        self._track_memory()

    # -- spill (revocable memory) --
    def _revoke_memory(self) -> None:
        """Merge the group state, spill it in the partial wire format
        and reset. May run on another operator's thread."""
        with self._state_lock:
            if self._in_finish:
                return  # finish owns the state
            self._merge_pending()
            if self._acc is None:
                return
            if self._spiller is None:
                from trino_tpu_torch.exec.spill import FileSpiller

                self._spiller = FileSpiller(_spill_dir(self._memory))
            self._spiller.spill(self._partial_state_batch())
            self._acc = None
        self._track_memory()

    def _track_memory(self) -> None:
        """Accounts the accumulation state (merged and pending group
        states). The finish-phase merge produces output, not state, and
        goes unaccounted, as in the reference; so does a global
        aggregation's single state row (it registers no revoker, as in
        the reference, whose final step accounts nothing)."""
        if self._memory is None or self._in_finish or self._global:
            return
        from trino_tpu_torch.runtime.memory import ExceededMemoryLimitError

        with self._state_lock:
            states = ([self._acc] if self._acc is not None else []) + list(self._pending)
        total = 0
        for gk, gv, used, vals, cnts in states:
            total += sum(t.nbytes for t in (*gk, *gv, used, *vals, *cnts))
        try:
            self._memory.set_bytes(total)
        except ExceededMemoryLimitError:
            # the pool is full even after revoking others: spill our own
            if not states:
                raise
            self._revoke_memory()
            return
        self._memory.set_revocable_bytes(total)

    def _partial_state_batch(self) -> RelBatch:
        """The merged group state as a partial-wire-format batch
        (`partial_output_schema`'s layout), shared by the exchange and
        the spiller."""
        if self._acc is None:
            self._acc = self._empty_acc()
        cols: List[Column] = []
        gk, gv, used, vals, cnts = self._acc
        ki = 0
        for ch in self._group_channels:
            t, d = self._schema[ch]
            if t.lanes == 2:  # reassemble split long-decimal key limbs
                cols.append(Column(t, torch.stack([gk[ki], gk[ki + 1]], dim=-1), gv[ki], d))
                ki += 2
            else:
                cols.append(Column(t, gk[ki], gv[ki], d))
                ki += 1
        si = 0
        for a, (arg_t, _) in zip(self._aggs, self._arg_meta):
            vt, vd = agg_state_meta(a, self._schema)[0]
            cnt = cnts[si]
            col, si = _slots_to_wire_column(a, arg_t, vt, vd, vals, si)
            cols.append(col)
            cols.append(Column(T.BIGINT, cnt.to(torch.int64), None, None))
        return RelBatch(cols, used)

    def _add_state_input(self, batch: RelBatch) -> None:
        """Ingest a partial-wire-format batch as a group-state set: k key
        columns, then one (value, count) pair per aggregate; long
        decimals split back into the slot layout (keys into limb lanes,
        sums into four limb slots, extremes into (hi, lo) slots). A global
        final step folds the single-row states instead."""
        k = len(self._group_channels)
        if self._global:
            self._merge_global_state(batch, batch.live_mask())
            return
        keys, valids = [], []
        for c in range(k):
            col = batch.columns[c]
            v = col.valid_mask()
            if col.data.dim() == 2:
                keys.extend([col.data[:, 0], col.data[:, 1]])
                valids.extend([v, v])
            else:
                keys.append(col.data)
                valids.append(v)
        vals, cnts = [], []
        for i, a in enumerate(self._aggs):
            val_col = batch.columns[k + 2 * i]
            cnt = batch.columns[k + 2 * i + 1].data.to(torch.int64)
            if val_col.data.dim() == 2:
                if a.kind in ("sum", "avg"):
                    pieces = _limb_split(val_col.data)
                else:  # min/max/any: the slots are the (hi, lo) pair
                    pieces = [val_col.data[:, 0], val_col.data[:, 1]]
                vals.extend(pieces)
                cnts.extend([cnt] * len(pieces))
            else:
                vals.append(val_col.data)
                cnts.append(cnt)
        with self._state_lock:
            self._pending.append(
                (tuple(keys), tuple(valids), batch.live_mask(), tuple(vals), tuple(cnts)))
            self._unreduced_state = True

    def _merge_global_state(self, batch: RelBatch, live) -> None:
        """Global (no GROUP BY) final step: fold incoming single-row
        states with the merge reducers."""
        if self._gstate is None:
            self._gstate = self._global_init()
        out = []
        for i, a in enumerate(self._aggs):
            val, cnt = self._gstate[i]
            v_in = batch.columns[2 * i].data
            c_in = batch.columns[2 * i + 1].data.to(torch.int64)
            c_in = torch.where(live, c_in, torch.zeros_like(c_in))
            n = torch.sum(c_in)
            present = live & (c_in > 0)
            any_present = torch.any(present)
            red = _MERGE_REDUCER[a.kind]
            if v_in.dim() == 2:
                # Int128 partial states merge in limb arithmetic
                if red == "sum":
                    zero = torch.zeros((), dtype=torch.int64, device=v_in.device)
                    limb_sums = [torch.sum(torch.where(live, piece, zero))
                                 for piece in _limb_split(v_in)]
                    bh, bl = _limb_join(limb_sums)
                    h, lo = I128.add(val[0], val[1], bh, bl)
                    out.append((torch.stack([h, lo]), cnt + n))
                elif red in ("min", "max"):
                    m1, m2 = _lex128_reduce(v_in[:, 0], v_in[:, 1], present, red)
                    better = (I128.lt(m1, m2, val[0], val[1]) if red == "min"
                              else I128.lt(val[0], val[1], m1, m2))
                    take = (better | (cnt == 0)) & any_present
                    out.append((torch.stack([torch.where(take, m1, val[0]),
                                             torch.where(take, m2, val[1])]), cnt + n))
                else:  # first
                    first = v_in[torch.argmax(present.to(torch.int8))]
                    new_val = torch.where(
                        cnt > 0, val, torch.where(any_present, first, val))
                    out.append((new_val, cnt + n))
                continue
            if red == "sum":
                contrib = torch.where(live, v_in.to(val.dtype),
                                      torch.zeros((), dtype=val.dtype, device=v_in.device))
                out.append((val + torch.sum(contrib), cnt + n))
            elif red in ("min", "max"):
                neutral = torch.tensor(G.minmax_neutral(v_in.dtype, red),
                                       dtype=v_in.dtype, device=v_in.device)
                masked = torch.where(present, v_in, neutral)
                r = torch.min(masked) if red == "min" else torch.max(masked)
                op = torch.minimum if red == "min" else torch.maximum
                out.append((op(val, r.to(val.dtype)), cnt + n))
            else:  # first
                first = v_in[torch.argmax(present.to(torch.int8))]
                new_val = torch.where(cnt > 0, val, torch.where(any_present, first, val))
                out.append((new_val, cnt + n))
        self._gstate = out

    def _emit_partial(self) -> None:
        """The partial step's output: the accumulator state in the
        partial wire format (a global step's single row of states)."""
        if self._global:
            cols: List[Column] = []
            states = self._gstate if self._gstate is not None else self._global_init()
            for a, (val, cnt) in zip(self._aggs, states):
                vt, vd = agg_state_meta(a, self._schema)[0]
                cols.append(Column(vt, val[None].to(vt.dtype), None, vd))
                cols.append(Column(T.BIGINT, cnt[None].to(torch.int64), None, None))
            self._out = RelBatch(
                cols, torch.ones(1, dtype=torch.bool, device=self._device))
            return
        out = self._partial_state_batch()
        if out.capacity >= _SHRINK_MIN_CAPACITY and self._dense_dims is None \
                and self._mxu_dims is None:
            out = _shrink_prefix(out, int(torch.sum(out.live_mask())))
        self._out = out

    def _merge_pending(self) -> None:
        """Fold pending per-batch states (+ current acc) into one."""
        states = ([self._acc] if self._acc is not None else []) + self._pending
        self._pending = []
        if not states:
            return
        if len(states) == 1 and not self._unreduced_state:
            self._acc = states[0]
            return
        reducers = []
        for a, (arg_t, _) in zip(self._aggs, self._arg_meta):
            reducers.extend(_slot_merge_reducers(a, arg_t))
        reducers = tuple(reducers)
        concat_len = sum(int(s[2].shape[0]) for s in states)
        while True:
            cap = min(max(self._cap, 16), bucket_capacity(max(concat_len, 16)))
            merged, ngroups, ovf = _merge_group_states(states, reducers, cap)
            if self._static_bound is not None:
                self._deferred_ovf.append(ovf)
                break
            if not bool(ovf):
                break
            self._cap = max(self._cap * 2, bucket_capacity(int(ngroups)))
        self._acc = merged
        self._unreduced_state = False

    def _global_init(self):
        states = []
        dev = self._device
        for a in self._aggs:
            dt = (
                self._schema[a.arg_channel][0].dtype
                if a.arg_channel is not None else torch.int64
            )
            is_long = (a.arg_channel is not None
                       and self._schema[a.arg_channel][0].is_long_decimal)
            if a.kind in ("count", "count_star"):
                val = torch.zeros((), dtype=torch.int64, device=dev)
            elif is_long:
                val = torch.zeros(2, dtype=torch.int64, device=dev)
            elif a.kind in ("sum", "avg"):
                acc_dt = torch.float64 if dt.is_floating_point else torch.int64
                val = torch.zeros((), dtype=acc_dt, device=dev)
            elif a.kind in ("min", "max"):
                val = torch.tensor(G.minmax_neutral(dt, a.kind), dtype=dt, device=dev)
            else:
                val = torch.zeros((), dtype=dt, device=dev)
            states.append((val, torch.zeros((), dtype=torch.int64, device=dev)))
        return states

    def _empty_acc(self):
        key_dts = []
        for c in self._group_channels:
            t = self._schema[c][0]
            key_dts.extend([t.dtype] * t.lanes)
        dev = self._device
        z = lambda dt: torch.zeros(16, dtype=dt, device=dev)  # noqa: E731
        return (
            [z(dt) for dt in key_dts],
            [z(torch.bool) for _ in key_dts],
            z(torch.bool),
            [z(torch.int64) for _ in range(self._n_slots)],
            [z(torch.int64) for _ in range(self._n_slots)],
        )

    def finish(self) -> None:
        if self._finishing:
            return
        self._finishing = True
        if self._holistic:
            self._out = self._finish_holistic()
            if self._memory is not None:
                self._memory.set_bytes(0)
            return
        with self._state_lock:
            # from here finish owns the state: revocation is off
            self._in_finish = True
            spiller, self._spiller = self._spiller, None
        if spiller is not None:
            # merge on unspill: the spilled states re-enter through the
            # final step's ingestion
            try:
                for b in spiller.unspill():
                    self._add_state_input(b)
            finally:
                spiller.close()
        with self._state_lock:
            self._merge_pending()
        if self._memory is not None and not self._global:
            self._memory.set_bytes(0)
            self._memory.set_revocable_bytes(0)
        if self._deferred_ovf:
            flag = torch.any(torch.stack(self._deferred_ovf))
            msg = (
                "group table overflowed its plan-time bound "
                "(runtime dictionary larger than planned)"
            )
            if self._checks is not None:
                self._checks.append((flag, msg))
            elif bool(flag):
                raise RuntimeError(msg)
            self._deferred_ovf = []
        if self._step == "partial":
            self._emit_partial()
            return
        cols: List[Column] = []
        if self._global:
            states = self._gstate if self._gstate is not None else self._global_init()
            for i, (a, (val, cnt)) in enumerate(zip(self._aggs, states)):
                arg_t, arg_d = self._arg_meta[i]
                if a.kind in ("count", "count_star"):
                    state = (val[None],)
                elif self._long_flags[i]:
                    state = (val[0][None], val[1][None], cnt[None])
                else:
                    state = (val[None], cnt[None])
                cols.append(_agg_output(a, state, arg_t, arg_d))
            self._out = RelBatch(
                cols, torch.ones(1, dtype=torch.bool, device=self._device)
            )
            return
        if self._acc is None:
            self._acc = self._empty_acc()
        gk, gv, used, vals, cnts = self._acc
        ki = 0
        for ch in self._group_channels:
            t, d = self._schema[ch]
            if t.lanes == 2:  # reassemble split long-decimal limbs
                cols.append(Column(t, torch.stack([gk[ki], gk[ki + 1]], dim=-1), gv[ki], d))
                ki += 2
            else:
                cols.append(Column(t, gk[ki], gv[ki], d))
                ki += 1
        si = 0
        for a, (arg_t, arg_d) in zip(self._aggs, self._arg_meta):
            state, si = _slots_to_state(a, arg_t, vals, cnts, si)
            col = _agg_output(a, state, arg_t, None)
            d = arg_d if a.kind in ("min", "max", "any") else None
            cols.append(Column(a.out_type, col.data, col.valid, d))
        out = RelBatch(cols, used)
        if out.capacity >= _SHRINK_MIN_CAPACITY and self._dense_dims is None \
                and self._mxu_dims is None:
            out = _shrink_prefix(out, int(torch.sum(used)))
        self._out = out

    def _finish_holistic(self) -> RelBatch:
        """One pass over all collected rows: the regular aggregates
        through sort_group_reduce, the order statistics through the
        sorted-segment reducers. All sort by the same key chain, so
        their group slots align."""
        dev = self._device
        mega = concat_batches(self._collected) if self._collected else None
        self._collected = []
        if mega is None:
            # no rows: one dead row keeps every shape non-empty so the
            # global path can slice its single slot
            mega = RelBatch(
                [null_column(t, 1, d, dev) for t, d in self._schema],
                torch.zeros(1, dtype=torch.bool, device=dev),
            )
        keys = [mega.columns[c].data for c in self._group_channels]
        valids = [mega.columns[c].valid_mask() for c in self._group_channels]
        live = mega.live_mask()
        regular = [(i, a) for i, a in enumerate(self._aggs)
                   if a.kind not in HOLISTIC_KINDS]
        _, values, vvalids, reds = _batch_values(mega, [a for _, a in regular])
        cap = self._cap
        while True:
            gk, gv, used, vals, cnts, ngroups, ovf = G.sort_group_reduce(
                tuple(keys), tuple(valids), live, tuple(values), tuple(vvalids),
                reds, cap,
            )
            if not self._group_channels or not bool(ovf):
                break
            cap = max(cap * 2, bucket_capacity(int(ngroups)))
        self._cap = cap

        agg_cols = {}
        si = 0
        for i, a in regular:
            arg_t, arg_d = self._arg_meta[i]
            state, si = _slots_to_state(a, arg_t, vals, cnts, si)
            agg_cols[i] = _agg_output(a, state, arg_t, arg_d)
        # one key sort shared by every min_by/max_by (the percentile and
        # distinct reducers pre-order by value and sort on their own)
        shared_order = (
            G.key_order(tuple(keys), tuple(valids), live, cap)
            if any(a.kind in ("min_by", "max_by") for a in self._aggs) else None
        )
        for i, a in enumerate(self._aggs):
            if a.kind not in HOLISTIC_KINDS:
                continue
            xcol = mega.columns[a.arg_channel]
            if a.kind == "listagg":
                agg_cols[i] = self._listagg_column(a, keys, valids, live, xcol, cap)
                continue
            if a.kind in _COLLECT_KINDS:
                agg_cols[i] = self._collect_column(a, keys, valids, live, mega, cap)
                continue
            if a.kind == "approx_distinct":
                cnt = G.grouped_count_distinct(
                    tuple(keys), tuple(valids), live, xcol.data, xcol.valid, cap)
                agg_cols[i] = Column(T.BIGINT, cnt, None, None)
                continue
            if a.kind in ("min_by", "max_by"):
                bycol = mega.columns[a.arg2_channel]
                data, valid = G.grouped_argbest(
                    tuple(keys), tuple(valids), live, bycol.data, bycol.valid,
                    xcol.data, xcol.valid, a.kind, cap, order=shared_order,
                )
            elif a.kind == "pctl_merge":
                data, valid = G.grouped_weighted_percentile(
                    tuple(keys), tuple(valids), live, xcol.data, xcol.valid,
                    mega.columns[a.arg2_channel].data,
                    mega.columns[a.arg3_channel].data, a.percentile, cap,
                )
            else:  # approx_percentile
                data, valid = G.grouped_percentile(
                    tuple(keys), tuple(valids), live, xcol.data, xcol.valid,
                    a.percentile, cap,
                )
            agg_cols[i] = Column(a.out_type, data.to(a.out_type.dtype), valid,
                                 xcol.dictionary)

        out_cols = [Column(self._schema[ch][0], kk, vv, self._schema[ch][1])
                    for ch, kk, vv in zip(self._group_channels, gk, gv)]
        out_cols += [agg_cols[i] for i in range(len(self._aggs))]
        if self._global:
            # a global aggregation yields one row even over no input
            # (counts 0, the rest NULL): slot 0 carries it; a nested
            # result slices through its gather, which keeps its layout
            first = torch.zeros(1, dtype=torch.int64, device=dev)
            return RelBatch(
                [c.gather(first) if c.type.is_nested
                 else Column(c.type, c.data[:1], None if c.valid is None else c.valid[:1],
                             c.dictionary) for c in out_cols],
                torch.ones(1, dtype=torch.bool, device=dev),
            )
        return RelBatch(out_cols, used)

    def _collect_column(self, a: AggSpec, keys, valids, live, mega: RelBatch,
                        cap: int) -> Column:
        """The collect aggregates (array_agg, map_agg, multimap_agg,
        histogram, numeric_histogram, approx_most_frequent, map_union,
        the bitwise_*_agg, approx_set, tdigest_agg, sketch_merge): the
        device puts the rows in group-contiguous, value-ordered order
        (ops/groupby.grouped_rows_order) and the host builds each group's
        container from it, as ArrayAggregationFunction and
        MapAggregationFunction build theirs on the heap. `a.post` fuses a
        sketch reader, so the digest never leaves the host."""
        xcol = mega.columns[a.arg_channel]
        gid, sm, order, n_groups, overflowed = G.grouped_rows_order(
            tuple(keys), tuple(valids), live, xcol.data, xcol.valid, cap)
        if bool(overflowed):
            # the finish loop settles the capacity before this runs
            raise RuntimeError("collect aggregate group overflow")
        gid_h, sm_h, ord_h = (t.cpu().numpy() for t in (gid, sm, order))
        n_h = int(n_groups)

        def pyvals(ch):
            lst = mega.columns[ch].to_pylist()
            return [lst[i] for i in ord_h]

        xs = pyvals(a.arg_channel)
        ys = pyvals(a.arg2_channel) if a.arg2_channel is not None else None
        groups: List[list] = [[] for _ in range(n_h)]
        for j, (g, ok) in enumerate(zip(gid_h, sm_h)):
            if ok and 0 <= g < n_h:
                groups[g].append((xs[j], ys[j]) if ys is not None else xs[j])
        dev = self._device
        kind = a.kind
        if kind in ("bitwise_and_agg", "bitwise_or_agg", "bitwise_xor_agg"):
            op = {"bitwise_and_agg": lambda s_, v: s_ & v,
                  "bitwise_or_agg": lambda s_, v: s_ | v,
                  "bitwise_xor_agg": lambda s_, v: s_ ^ v}[kind]
            data = np.zeros(cap, dtype=np.int64)
            valid = np.zeros(cap, dtype=bool)
            for g, vals in enumerate(groups):
                vals = [v for v in vals if v is not None]
                if not vals:
                    continue
                acc = vals[0]
                for v in vals[1:]:
                    acc = op(acc, v)
                acc &= (1 << 64) - 1  # wrap to signed 64-bit
                data[g] = acc - (1 << 64) if acc >= (1 << 63) else acc
                valid[g] = True
            return Column(T.BIGINT, torch.from_numpy(data).to(dev),
                          torch.from_numpy(valid).to(dev), None)
        out_vals: List[object] = [None] * cap
        for g, vals in enumerate(groups):
            out_vals[g] = _collect_value(a, vals)
        if not a.post:
            return Column.from_pylist(a.out_type, out_vals, capacity=cap, device=dev)
        if a.post == "vaq":
            # values_at_quantiles: one array(double) per group
            arrs: List[object] = [None] * cap
            for g in range(n_h):
                if out_vals[g] is not None:
                    arrs[g] = [pyfns.tdigest_value_at_quantile(out_vals[g], float(q))
                               for q in (a.param or ())]
            return Column.from_pylist(a.out_type, arrs, capacity=cap, device=dev)
        data = np.zeros(cap, dtype=np.int64 if a.post == "card" else np.float64)
        valid = np.zeros(cap, dtype=bool)
        for g in range(n_h):
            d = out_vals[g]
            if d is None:
                continue
            if a.post == "card":
                r = pyfns.hll_cardinality(d)
            elif a.post == "vq":
                r = pyfns.tdigest_value_at_quantile(d, float(a.param))
            else:
                r = pyfns.tdigest_quantile_at_value(d, float(a.param))
            if r is not None:
                data[g] = r
                valid[g] = True
        return Column(a.out_type, torch.from_numpy(data).to(dev),
                      torch.from_numpy(valid).to(dev), None)

    def _listagg_column(self, a: AggSpec, keys, valids, live, xcol: Column,
                        cap: int) -> Column:
        """listagg: the device groups and value-orders the rows, the host
        joins each group's dictionary values into a new string (element
        order = the values' lexical order). The result's dictionary is
        made here, at execution time."""
        gid, w, codes, n_groups, _ = G.grouped_rows_sorted(
            tuple(keys), tuple(valids), live, xcol.data, xcol.valid, cap)
        gid_h, w_h, codes_h = (t.cpu().numpy() for t in (gid, w, codes))
        dict_values = xcol.dictionary.values if xcol.dictionary else ()
        parts: List[List[str]] = [[] for _ in range(int(n_groups))]
        for g, ok, c in zip(gid_h, w_h, codes_h):
            if ok and 0 <= g < len(parts) and 0 <= c < len(dict_values):
                parts[g].append(dict_values[int(c)])
        strings = [(a.separator or "").join(p) for p in parts]
        out_dict = Dictionary(strings)
        data = np.zeros(cap, dtype=np.int32)
        valid = np.zeros(cap, dtype=bool)
        for g, text in enumerate(strings):
            if parts[g]:
                data[g] = out_dict.code(text)
                valid[g] = True
        return Column(T.VARCHAR, torch.from_numpy(data).to(self._device),
                      torch.from_numpy(valid).to(self._device), out_dict)

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._out is None


class EnforceSingleRowOperator(Operator):
    """Scalar-subquery cardinality guard: one input row passes; zero
    rows give one all-NULL row; more than one raises."""

    def __init__(self, input_schema: Schema, device):
        self._schema = list(input_schema)
        self._device = device
        self._inputs: List[RelBatch] = []
        self._out: Optional[RelBatch] = None

    def add_input(self, batch: RelBatch) -> None:
        self._inputs.append(batch)

    def finish(self) -> None:
        if self._finishing:
            return
        self._finishing = True
        total = sum(b.row_count() for b in self._inputs)
        if total > 1:
            raise RuntimeError("Scalar sub-query has returned multiple rows")
        if total == 1:
            self._out = concat_batches(self._inputs).compact()
            self._inputs = []
            return
        dev = self._device
        cols = [null_column(t, 16, d, dev) for t, d in self._schema]
        live = torch.zeros(16, dtype=torch.bool, device=dev)
        live[0] = True
        self._out = RelBatch(cols, live)

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._out is None


# ---------------------------------------------------------------------------
# Hash join
# ---------------------------------------------------------------------------


class JoinBridge:
    """Build->probe handoff (PartitionedLookupSourceFactory). The engine
    runs the build pipeline to completion before the probe pipeline.
    When the build side spilled (grace mode), `grace` carries the
    hash-partitioned build pages instead of a lookup source."""

    def __init__(self):
        self.lookup_source: Optional[J.LookupSource] = None
        self.build_batch: Optional[RelBatch] = None
        # build-side key dictionaries, for probe-side code remapping
        self.key_dicts: Optional[List[Optional[Dictionary]]] = None
        # build-side key channels (pair verify, dynamic-filter domains)
        self.build_key_channels: List[int] = []
        # grace mode: the partitioned build spill and its schema
        self.grace = None  # Optional[spill.GracePartitionSpill]
        self.build_schema: Optional[list] = None
        self.spill_dir: Optional[str] = None


GRACE_PARTITIONS = 8


def _consolidate_build(parts: Sequence[RelBatch], key_channels: Sequence[int]):
    """Consolidate the build batches and build the LookupSource."""
    merged = concat_batches(list(parts))
    keys, valids = [], []
    for c in key_channels:
        col = merged.columns[c]
        v = col.valid_mask()
        if col.data.dim() == 2:  # long-decimal limbs
            keys.extend([col.data[:, 0], col.data[:, 1]])
            valids.extend([v, v])
        else:
            keys.append(col.data)
            valids.append(v)
    return J.build_lookup(keys, valids, merged.live_mask()), merged


def _compact_to(parts: Sequence[RelBatch], n_live: int, capacity: int) -> RelBatch:
    """The live rows of `parts`, in order, front-packed into one batch
    of `capacity` rows (the reference's host page round trip)."""
    merged = concat_batches(list(parts))
    dev = merged.device
    idx = torch.nonzero(merged.live_mask()).reshape(-1)
    pos = torch.zeros(capacity, dtype=torch.int64, device=dev)
    pos[:n_live] = idx
    live = torch.arange(capacity, device=dev) < n_live
    cols = []
    for c in merged.columns:
        g = c.gather(pos)
        valid = None if g.valid is None else (g.valid & live)
        if c.type.is_nested:
            cols.append(g.with_data(g.data, valid))
            continue
        data = torch.where(
            live.reshape((-1,) + (1,) * (g.data.dim() - 1)), g.data,
            torch.zeros((), dtype=g.data.dtype, device=dev))
        cols.append(Column(c.type, data, valid, c.dictionary))
    return RelBatch(cols, None if n_live == capacity else live)


class HashBuildSink(Operator):
    """Consumes the build side, consolidates it and builds the
    LookupSource (HashBuilderOperator: one sort instead of row inserts).

    Out of core: a revoke under memory pressure, or `force_spill`, turns
    the sink into grace mode (HashBuilderOperator's spill states): the
    batches held and every later one hash-partition to disk, and the
    probe joins partition by partition."""

    def __init__(self, bridge: JoinBridge, key_channels: Sequence[int],
                 input_schema: Schema, device, memory_context=None,
                 force_spill: bool = False):
        self._bridge = bridge
        self._keys = list(key_channels)
        self._schema = list(input_schema)
        self._device = device
        self._inputs: List[RelBatch] = []
        self._memory = memory_context
        self._grace = None
        self._state_lock = named_lock("HashBuildSink._state_lock")
        if force_spill:
            # the grace partitions open before the first batch arrives
            self._grace = self._new_grace()
        if self._memory is not None:
            self._memory.set_revoker(self._revoke_memory)

    def _new_grace(self):
        from trino_tpu_torch.exec.spill import GracePartitionSpill

        return GracePartitionSpill(GRACE_PARTITIONS, self._keys,
                                   _spill_dir(self._memory))

    def add_input(self, batch: RelBatch) -> None:
        with self._state_lock:
            if self._grace is not None:
                self._grace.add(batch)
                return
            self._inputs.append(batch)
        self._track_memory()

    def _track_memory(self) -> None:
        if self._memory is None:
            return
        from trino_tpu_torch.runtime.memory import ExceededMemoryLimitError, batch_bytes

        with self._state_lock:
            total = sum(batch_bytes(b) for b in self._inputs)
        try:
            self._memory.set_bytes(total)
        except ExceededMemoryLimitError:
            if total == 0:
                raise
            self._revoke_memory()
            return
        # a revocation from another thread may have spilled the inputs
        # since the snapshot: advertise only what is still revocable
        with self._state_lock:
            still = sum(batch_bytes(b) for b in self._inputs)
        self._memory.set_revocable_bytes(min(total, still))

    def _revoke_memory(self) -> None:
        """Move the held build rows into the partitioned spill and go on
        in grace mode."""
        with self._state_lock:
            if self._finishing or self._grace is not None and not self._inputs:
                return
            if self._grace is None:
                self._grace = self._new_grace()
            for b in self._inputs:
                self._grace.add(b)
            self._inputs = []
        if self._memory is not None:
            self._memory.set_bytes(0)
            self._memory.set_revocable_bytes(0)

    def finish(self) -> None:
        if self._finishing:
            return
        with self._state_lock:
            self._finishing = True
            grace, inputs = self._grace, self._inputs
            self._inputs = []
        if grace is not None:
            for b in inputs:
                grace.add(b)
            if grace.device is None:  # nothing spilled: partitions rebuild here
                grace.device = torch.device(self._device)
            self._bridge.grace = grace
            self._bridge.build_schema = self._schema
            self._bridge.build_key_channels = list(self._keys)
            self._bridge.spill_dir = _spill_dir(self._memory)
            if self._memory is not None:
                self._memory.set_bytes(0)
                self._memory.set_revocable_bytes(0)
            return
        parts = inputs or [empty_batch(self._schema, self._device)]
        total_cap = sum(b.capacity for b in parts)
        if total_cap >= _SHRINK_MIN_CAPACITY:
            # sparse build side (e.g. a HAVING-filtered aggregate): compact
            # so the lookup build and every probe run at the live size
            n_live = int(sum(int(torch.sum(b.live_mask())) for b in parts))
            target = max(bucket_capacity(n_live), 16)
            if target * 4 <= total_cap:
                parts = [_compact_to(parts, n_live, target)]
        ls, merged = _consolidate_build(parts, self._keys)
        self._bridge.lookup_source = ls
        self._bridge.build_batch = merged
        self._bridge.key_dicts = [merged.columns[c].dictionary for c in self._keys]
        self._bridge.build_key_channels = list(self._keys)

    def is_finished(self) -> bool:
        return self._finishing


class MxuJoinAggOperator(Operator):
    """Join-project-aggregate (ops/mxu_join.py): consumes the probe
    batches of an inner single-key equi-join whose aggregate arguments
    are all probe-side and whose group columns are all build-side, and
    sums each batch per build key id (the grouped_sum kernel) instead of
    expanding pairs.

    Emits one partial batch at finish: per build row, the summed probe
    contributions of its key, which the planner feeds into an ordinary
    HashAggregationOperator for the final grouping. The build side
    arrives through the JoinBridge; the engine runs its pipeline first."""

    def __init__(self, bridge: JoinBridge, key_channel: int, aggs,
                 group_channels: Sequence[int]):
        self._bridge = bridge
        self._key = key_channel
        self._kinds = tuple(a.kind for a in aggs)
        self._args = tuple(a.arg_channel for a in aggs)
        self._groups = list(group_channels)
        self._analysis = None
        self._acc: Optional[List[torch.Tensor]] = None
        self._outputs: List[RelBatch] = []

    def _analyze(self):
        from trino_tpu_torch.ops import mxu_join as MJ

        ls = self._bridge.lookup_source
        build = self._bridge.build_batch
        col = build.columns[self._bridge.build_key_channels[0]]
        kid, kid_by_pos, distinct, n_distinct, hash_pure = MJ.build_key_analysis(
            col.data, col.valid_mask(), build.live_mask(), ls.sorted_hash, ls.perm)
        # one host read at the build barrier: whether the build's hash runs
        # are key-pure decides the probe lookup for the whole query
        self._analysis = (kid, kid_by_pos, distinct, n_distinct, bool(hash_pure))

    def add_input(self, probe: RelBatch) -> None:
        from trino_tpu_torch.ops import mxu_join as MJ

        if self._analysis is None:
            self._analyze()
        _kid, kid_by_pos, distinct, n_distinct, hash_pure = self._analysis
        kcol = probe.columns[self._key]
        kv = kcol.valid_mask()
        arg_data, arg_valid = [], []
        for ch in self._args:
            if ch is None:  # count_star placeholder, never read
                arg_data.append(kcol.data)
                arg_valid.append(kv)
            else:
                c = probe.columns[ch]
                arg_data.append(c.data)
                arg_valid.append(c.valid_mask())
        capacity = self._bridge.build_batch.capacity
        sums = MJ.probe_page_sums(
            self._bridge.lookup_source, kid_by_pos, distinct, n_distinct,
            kcol.data, kv, probe.live_mask(), arg_data, arg_valid, self._kinds,
            capacity, MJ.uses_kernel(capacity, probe.capacity), hash_pure)
        self._acc = (list(sums) if self._acc is None
                     else [a + s for a, s in zip(self._acc, sums)])

    def finish(self) -> None:
        from trino_tpu_torch.ops import mxu_join as MJ

        if self._finishing:
            return
        self._finishing = True
        if self._analysis is None:
            self._analyze()
        build = self._bridge.build_batch
        if self._acc is None:
            # no probe batch arrived: zero sums, nothing matches
            n_cols = sum(2 if k == "sum" else (1 if k == "count" else 0)
                         for k in self._kinds)
            z = torch.zeros(build.capacity, dtype=torch.int64, device=build.device)
            self._acc = [z] * (n_cols + 1)
        live, outs = MJ.finalize_partials(self._analysis[0], build.live_mask(),
                                          self._acc, self._kinds)
        cols = [build.columns[ch] for ch in self._groups]
        for data, valid in outs:
            cols.append(Column(T.BIGINT, data, valid, None))
        self._outputs.append(RelBatch(cols, live))

    def get_output(self) -> Optional[RelBatch]:
        return self._outputs.pop(0) if self._outputs else None

    def is_finished(self) -> bool:
        return self._finishing and not self._outputs


def _pair_key_verify(ok, probe_cols, build_cols, pkc, bkc):
    """AND exact key equality (and non-NULL keys) of the pair columns."""
    for pc, bc in zip(pkc, bkc):
        a, b = probe_cols[pc], build_cols[bc]
        eqd = a.data == b.data
        if eqd.dim() == 2:  # long-decimal limb pairs
            eqd = eqd.all(dim=-1)
        ok = ok & eqd
        if a.valid is not None:
            ok = ok & a.valid
        if b.valid is not None:
            ok = ok & b.valid
    return ok


def _expand_pairs(ls, probe: RelBatch, build: RelBatch, keys, valids, lo, counts,
                  out_cap: int, pkc=None, bkc=None):
    """Expansion + pair gather (JoinProbe + LookupJoinPageBuilder). When
    the keys are pass-through columns (pkc/bkc), the hash-collision
    verify runs on the gathered pair columns."""
    on_pairs = pkc is not None
    pi, bi, ok = J.expand_matches(ls, keys, valids, lo, counts, out_cap,
                                  verify=not on_pairs)
    pairs_probe = probe.gather(pi)
    pairs_build = build.gather(bi)
    if on_pairs:
        ok = _pair_key_verify(ok, pairs_probe.columns, pairs_build.columns, pkc, bkc)
    cols = list(pairs_probe.columns) + list(pairs_build.columns)
    return pi, bi, ok, RelBatch(cols, ok)


def _fanout_le_one(counts) -> torch.Tensor:
    """Device flag: no probe row has more than one candidate match."""
    return torch.all(counts <= 1)


def _expand_pairs_fanout1(ls, probe: RelBatch, build: RelBatch, keys, valids, lo,
                          counts, pkc=None, bkc=None):
    """Fanout <= 1 expansion (the PK-side FK join): the pair batch is the
    probe batch with the matched build row appended; probe columns pass
    through untouched. Caller guarantees max(counts) <= 1."""
    spos = torch.clamp(lo, 0, ls.perm.shape[0] - 1)
    bi = GK.take_flat(ls.perm, spos)
    ok = counts > 0
    pairs_build = build.gather(bi)
    if pkc is not None:
        ok = _pair_key_verify(ok, probe.columns, pairs_build.columns, pkc, bkc)
    else:
        for pk, pv, bk, bv in zip(keys, valids, ls.key_cols, ls.key_valids):
            eqd = pk == take_clip(bk, bi)
            if eqd.dim() == 2:
                eqd = eqd.all(dim=-1)
            ok = ok & eqd & pv & take_clip(bv, bi)
    live = probe.live_mask() & ok
    pi = torch.arange(probe.capacity, dtype=torch.int32, device=live.device)
    cols = list(probe.columns) + list(pairs_build.columns)
    return pi, bi, live, RelBatch(cols, live)


def _segment_any(counts, pi, ok, probe_capacity: int) -> torch.Tensor:
    """Per-probe-row 'any verified pair' without a scatter: pi is
    nondecreasing, so each probe row's pairs are the segment
    [off - counts, off); reduce by cumsum + gather."""
    e = ok.shape[0]
    okc = torch.cumsum(ok.to(torch.int32), 0, dtype=torch.int32)
    exc = okc - ok.to(torch.int32)
    off = torch.cumsum(counts, 0, dtype=torch.int32)
    start = off - counts
    seg = take_clip(okc, torch.clamp(off - 1, 0, max(e - 1, 0))) - take_clip(
        exc, torch.clamp(start, 0, max(e - 1, 0)))
    return (counts > 0) & (seg > 0)


def _left_unmatched(probe: RelBatch, build: RelBatch, matched) -> RelBatch:
    """Unmatched probe rows with NULL build columns (LEFT outer arm)."""
    nulls = [null_column(c.type, probe.capacity, c.dictionary, probe.device)
             for c in build.columns]
    return RelBatch(list(probe.columns) + nulls, probe.live_mask() & ~matched)


def _right_unmatched(probe_schema, build: RelBatch, matched_b) -> RelBatch:
    """Unmatched build rows with NULL probe columns (RIGHT/FULL outer
    arm, LookupOuterOperator)."""
    nulls = [null_column(t, build.capacity, d, build.device) for t, d in probe_schema]
    return RelBatch(nulls + list(build.columns), build.live_mask() & ~matched_b)


def make_residual_fn(residual: Bound):
    """Plan-time bound residual evaluator over pair batches."""

    def fn(pairs: RelBatch) -> torch.Tensor:
        d, v = residual.fn(batch_inputs(pairs), [c.valid for c in pairs.columns])
        return d if v is None else (d & v)

    return fn


class LookupJoinOperator(Operator):
    """Probe side (LookupJoinOperator). join_type in {inner, left, full,
    semi, anti, mark, mark_exists}. Output: [probe columns, build
    columns] for inner/left/full, probe columns for semi/anti, probe
    columns + a BOOLEAN match column for mark joins. `residual_fn` runs
    on candidate pairs before the match flags (filtered semi/anti
    joins).

    When the build side spilled (grace mode), probe batches partition to
    disk by the same key hash, and finish joins partition by partition:
    each partition's build rows are read back onto the device, built
    into a lookup source and probed with that partition's probe rows,
    through the same build_lookup / probe_counts / expand_matches path
    as an in-memory join."""

    def __init__(self, bridge: JoinBridge, key_channels: Sequence[int],
                 join_type: str, probe_schema: Schema, residual_fn=None):
        self._bridge = bridge
        self._keys = list(key_channels)
        self._type = join_type
        self._probe_schema = list(probe_schema)
        self._residual_fn = residual_fn
        self._outputs: List[RelBatch] = []
        self._remap_cache: dict = {}
        # grace mode: probe rows hash-partitioned to disk
        self._probe_spill = None
        # FULL outer: build-side matched bitmap across probe batches
        self._build_matched = None
        # depth-1 pipeline: batch i's match total is read only when
        # batch i+1 arrives, so the host read overlaps the next batch's
        # upstream device work and the expansion still gets its exact
        # bucketed capacity
        self._probe_pending: List[dict] = []

    def needs_input(self) -> bool:
        return not self._outputs and not self._finishing

    def add_input(self, probe: RelBatch) -> None:
        bridge = self._bridge
        if bridge.grace is not None:
            if self._probe_spill is None:
                from trino_tpu_torch.exec.spill import GracePartitionSpill

                self._probe_spill = GracePartitionSpill(
                    bridge.grace.n, self._keys, bridge.spill_dir)
            self._probe_spill.add(probe)
            return
        self._probe_one(bridge.lookup_source, bridge.build_batch, bridge.key_dicts, probe)

    def _probe_one(self, ls, build: RelBatch, key_dicts, probe: RelBatch) -> None:
        keys, valids = [], []
        remapped = False
        for i, c in enumerate(self._keys):
            col = probe.columns[c]
            v = col.valid_mask()
            build_dict = key_dicts[i] if key_dicts else None
            if (col.dictionary is not None and build_dict is not None
                    and col.dictionary != build_dict):
                # cross-dictionary string join: remap probe codes onto the
                # build dictionary by value; absent values -> -1
                ck = (col.dictionary.values, build_dict.values)
                remap = self._remap_cache.get(ck)
                if remap is None:
                    remap = torch.tensor(
                        [build_dict.code(x) for x in col.dictionary.values],
                        dtype=torch.int32, device=col.device)
                    self._remap_cache[ck] = remap
                keys.append(take_clip(remap, col.data))
                valids.append(v)
                remapped = True
            elif col.data.dim() == 2:  # long-decimal key: its two limbs
                keys.extend([col.data[:, 0], col.data[:, 1]])
                valids.extend([v, v])
            else:
                keys.append(col.data)
                valids.append(v)
        lo, counts, total = J.probe_counts(ls, keys, valids, probe.live_mask())
        self._probe_pending.append({
            "ls": ls, "build": build, "probe": probe, "keys": keys, "valids": valids, "lo": lo,
            "counts": counts, "total": total, "fan1": _fanout_le_one(counts),
            "remapped": remapped,
        })
        while len(self._probe_pending) > 1:
            self._expand_oldest()

    def _expand_oldest(self) -> None:
        rec = self._probe_pending.pop(0)
        ls, build, probe = rec["ls"], rec["build"], rec["probe"]
        # pair-column verify only when every key is a pass-through column
        pkc = bkc = None
        if not rec["remapped"] and self._bridge.build_key_channels:
            pkc = tuple(self._keys)
            bkc = tuple(self._bridge.build_key_channels)
        total = int(rec["total"])
        dense = total * 4 >= probe.capacity
        if dense and bool(rec["fan1"]):
            # fanout <= 1 and most probe rows match: pairs = probe batch +
            # one matched build row. Sparse joins keep the exact-capacity
            # expansion, so small outputs stay small downstream.
            pi, bi, ok, pairs = _expand_pairs_fanout1(
                ls, probe, build, rec["keys"], rec["valids"], rec["lo"],
                rec["counts"], pkc=pkc, bkc=bkc)
            if self._residual_fn is not None:
                ok = ok & self._residual_fn(pairs)
                pairs = RelBatch(pairs.columns, ok)
            matched = ok
        else:
            out_cap = bucket_capacity(max(total, 1))
            pi, bi, ok, pairs = _expand_pairs(
                ls, probe, build, rec["keys"], rec["valids"], rec["lo"],
                rec["counts"], out_cap, pkc=pkc, bkc=bkc)
            if self._residual_fn is not None:
                ok = ok & self._residual_fn(pairs)
                pairs = RelBatch(pairs.columns, ok)
            matched = None
        if self._type == "inner":
            self._outputs.append(pairs)
            return
        if matched is None:
            matched = _segment_any(rec["counts"], pi, ok, probe.capacity)
        if self._type == "semi":
            self._outputs.append(probe.mask(matched))
        elif self._type == "anti":
            self._outputs.append(probe.mask(~matched))
        elif self._type in ("mark", "mark_exists"):
            self._outputs.append(self._mark(probe, build, matched, rec["valids"]))
        elif self._type == "left":
            self._outputs.append(pairs)
            self._outputs.append(_left_unmatched(probe, build, matched))
        elif self._type == "full":
            self._outputs.append(pairs)
            self._outputs.append(_left_unmatched(probe, build, matched))
            self._build_matched = J.build_matched_flags(
                build.capacity, bi, ok, prior=self._build_matched)
        else:
            raise NotImplementedError(self._type)

    def _mark(self, probe, build, matched, valids) -> RelBatch:
        """Probe rows with an appended BOOLEAN match column. "mark" is
        IN's three-valued result: no match is UNKNOWN when the probe key
        is NULL against a nonempty build, or the build has NULL keys;
        "mark_exists" is two-valued."""
        valid = None
        if self._type == "mark":
            b_live = build.live_mask()
            grace = self._bridge.grace
            if grace is not None:
                # one partition's build holds some of the rows: the IN
                # semantics read the whole build side's
                nonempty = torch.tensor(grace.rows > 0, device=b_live.device)
                has_null = torch.tensor(grace.null_keys, device=b_live.device)
            else:
                nonempty = torch.any(b_live)
                has_null = torch.zeros((), dtype=torch.bool, device=b_live.device)
                for ch in self._bridge.build_key_channels:
                    bc = build.columns[ch]
                    if bc.valid is not None:
                        has_null = has_null | torch.any(b_live & ~bc.valid)
            pv = None
            for vv in valids:
                pv = vv if pv is None else (pv & vv)
            probe_null = ~pv if pv is not None else torch.zeros_like(matched)
            valid = ~((~matched) & ((probe_null & nonempty) | has_null))
        col = Column(T.BOOLEAN, matched, valid, None)
        return RelBatch(list(probe.columns) + [col], probe.live_mask())

    def _drain(self, build: RelBatch) -> None:
        """Expand every pending probe batch; a FULL join then emits the
        build rows no probe row matched."""
        while self._probe_pending:
            self._expand_oldest()
        if self._type == "full":
            mb = (self._build_matched if self._build_matched is not None
                  else torch.zeros(build.capacity, dtype=torch.bool,
                                   device=build.device))
            self._outputs.append(_right_unmatched(self._probe_schema, build, mb))

    def finish(self) -> None:
        if self._finishing:
            return
        self._finishing = True
        grace = self._bridge.grace
        if grace is None:
            self._drain(self._bridge.build_batch)
            return
        try:
            self._grace_join(grace)
        finally:
            if self._probe_spill is not None:
                self._probe_spill.close()
                self._probe_spill = None
            # the probe is the bridge's one consumer: release the build spill
            grace.close()
            self._bridge.grace = None

    def _grace_join(self, grace) -> None:
        """Partition by partition (PartitionedConsumption): both sides
        routed by the same key hash, so each partition joins alone."""
        from trino_tpu_torch.exec import spill

        spilled = self._probe_spill
        device = grace.device
        build_keys = self._bridge.build_key_channels
        for p in range(grace.n):
            probe_pages = spilled.partition_pages(p) if spilled is not None else []
            if not probe_pages and self._type != "full":
                continue  # no probe rows: the build partition stays on disk
            parts = ([pg.to_batch(device=device) for pg in grace.partition_pages(p)]
                     or [empty_batch(self._bridge.build_schema, device)])
            ls, merged = _consolidate_build(parts, build_keys)
            key_dicts = [merged.columns[c].dictionary for c in build_keys]
            # FULL: each build row lives in one partition, so the matched
            # flags are per partition
            self._build_matched = None
            for pg in probe_pages:
                self._probe_one(ls, merged, key_dicts, pg.to_batch(device=device))
            self._drain(merged)
            spill.record("grace_partitions")

    def get_output(self) -> Optional[RelBatch]:
        return self._outputs.pop(0) if self._outputs else None

    def is_finished(self) -> bool:
        return self._finishing and not self._outputs


# ---------------------------------------------------------------------------
# Dynamic filtering
# ---------------------------------------------------------------------------


def _df_domains(build: RelBatch, channels: Sequence[int]):
    """Per key: (min, max, any) over the build side's live, valid rows."""
    live = build.live_mask()
    out = []
    for c in channels:
        col = build.columns[c]
        w = live if col.valid is None else (live & col.valid)
        dt = col.data.dtype
        lo_n = torch.tensor(G.minmax_neutral(dt, "min"), dtype=dt, device=live.device)
        hi_n = torch.tensor(G.minmax_neutral(dt, "max"), dtype=dt, device=live.device)
        lo = torch.min(torch.where(w, col.data, lo_n))
        hi = torch.max(torch.where(w, col.data, hi_n))
        out.append((lo, hi, torch.any(w)))
    return out


def _df_filter(batch: RelBatch, keys, domains) -> RelBatch:
    """Drop probe rows outside [lo, hi] on every key (NULL keys never
    match an inner or semi join, so they drop too)."""
    keep = batch.live_mask()
    for (c_data, c_valid), (lo, hi, any_rows) in zip(keys, domains):
        ok = (c_data >= lo) & (c_data <= hi) & any_rows
        if c_valid is not None:
            ok = ok & c_valid
        keep = keep & ok
    return batch.mask(keep)


class DynamicFilterOperator(Operator):
    """Probe-side pruning from build-side key domains (the local form of
    dynamic filtering): the build pipeline has completed when the probe
    pipeline starts, so the bridge's build batch supplies min/max
    domains. Inner and semi probes only; dictionary-coded keys take part
    only when both sides share the dictionary."""

    def __init__(self, bridge: JoinBridge, key_channels: Sequence[int]):
        self._bridge = bridge
        self._keys = list(key_channels)
        self._domains = None
        self._active: Optional[List[Tuple[int, int]]] = None
        self._out: Optional[RelBatch] = None

    def _prepare(self, probe: RelBatch) -> None:
        if self._bridge.build_batch is None:
            # grace mode: no build batch on the device to read domains from
            self._active = []
            return
        key_dicts = self._bridge.key_dicts or [None] * len(self._keys)
        active = []
        for i, c in enumerate(self._keys):
            col = probe.columns[c]
            if col.data.dim() == 2:
                continue  # long-decimal keys: no scalar min/max domain
            if key_dicts[i] == col.dictionary:  # both None, or equal
                active.append((i, c))
        self._active = active
        if active:
            domains = _df_domains(self._bridge.build_batch,
                                  self._bridge.build_key_channels)
            self._domains = [domains[i] for i, _ in active]

    def needs_input(self) -> bool:
        return self._out is None and not self._finishing

    def add_input(self, batch: RelBatch) -> None:
        if self._active is None:
            self._prepare(batch)
        if not self._active:
            self._out = batch
            return
        keys = [(batch.columns[c].data, batch.columns[c].valid) for _, c in self._active]
        self._out = _df_filter(batch, keys, self._domains)

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._out is None


_DF_MAX_IN_LIST = 64  # distinct build keys pushed as an IN-list


def dynamic_filter_constraints(bridge: JoinBridge, key_types, key_names) -> tuple:
    """Build-side key domains as ColumnConstraints for a probe that is a
    bare scan: an IN-list when the build has few distinct values, else
    the [min, max] range. () until the build completes."""
    from trino_tpu_torch.connectors.pushdown import _pushable_type
    from trino_tpu_torch.connectors.spi import ColumnConstraint

    build = bridge.build_batch
    if build is None:
        return ()
    live = build.live_mask().cpu().numpy()
    out = []
    for i, bc in enumerate(bridge.build_key_channels[:len(key_names)]):
        t = key_types[i]
        if t is None or not _pushable_type(t):
            continue
        col = build.columns[bc]
        if col.data.dim() == 2 or col.dictionary is not None:
            continue  # long-decimal limbs / dictionary codes: no raw domain
        w = live if col.valid is None else (live & col.valid.cpu().numpy())
        vals = col.data.cpu().numpy()[w]
        if vals.size == 0:
            continue  # empty build: the join itself yields nothing
        uniq = np.unique(vals)
        if uniq.size <= _DF_MAX_IN_LIST:
            out.append(ColumnConstraint(key_names[i], "in",
                                        tuple(v.item() for v in uniq)))
        else:
            out.append(ColumnConstraint(key_names[i], "ge", uniq[0].item()))
            out.append(ColumnConstraint(key_names[i], "le", uniq[-1].item()))
    return tuple(out)


# ---------------------------------------------------------------------------
# Cross join (NestedLoopJoinOperator)
# ---------------------------------------------------------------------------


def _cross_row(probe: RelBatch, build: RelBatch, b: int) -> RelBatch:
    """The probe batch with build row `b` appended to every row."""
    n = probe.capacity
    cols = []
    for c in build.columns:
        if c.type.is_nested:
            cols.append(c.gather(torch.full((n,), b, dtype=torch.int64, device=c.device)))
            continue
        data = c.data[b].expand((n,) + tuple(c.data.shape[1:])).clone()
        valid = None if c.valid is None else c.valid[b].expand(n).clone()
        cols.append(Column(c.type, data, valid, c.dictionary))
    return RelBatch(list(probe.columns) + cols, probe.live)


class CrossJoinBuildSink(Operator):
    """Collects the (small) build side of a cross join."""

    def __init__(self, bridge: JoinBridge, input_schema: Schema, device):
        self._bridge = bridge
        self._schema = list(input_schema)
        self._device = device
        self._inputs: List[RelBatch] = []

    def add_input(self, batch: RelBatch) -> None:
        self._inputs.append(batch)

    def finish(self) -> None:
        if self._finishing:
            return
        self._finishing = True
        parts = self._inputs or [empty_batch(self._schema, self._device)]
        self._bridge.build_batch = concat_batches(parts).compact()
        self._inputs = []

    def is_finished(self) -> bool:
        return self._finishing


class CrossJoinOperator(Operator):
    """Probe x build cartesian product; the build side is small
    (scalar-subquery bridges hold one row)."""

    def __init__(self, bridge: JoinBridge):
        self._bridge = bridge
        self._outputs: List[RelBatch] = []

    def needs_input(self) -> bool:
        return not self._outputs and not self._finishing

    def add_input(self, probe: RelBatch) -> None:
        build = self._bridge.build_batch
        for b in range(build.row_count()):
            self._outputs.append(_cross_row(probe, build, b))

    def get_output(self) -> Optional[RelBatch]:
        return self._outputs.pop(0) if self._outputs else None

    def is_finished(self) -> bool:
        return self._finishing and not self._outputs


class ScaledWriterSink:
    """Writer scale-out driven by OBSERVED output volume — the
    SCALED_WRITER_* partitioning + ScaledWriterScheduler analogue
    (main/sql/planner/SystemPartitioningHandle.java:53-54,
    main/execution/scheduler/ScaledWriterScheduler.java): start with
    one connector sink, add another whenever the written volume
    exceeds scale_rows x current writer count (up to max_writers), and
    round-robin batches across the active sinks. Volume is measured in
    batch capacities, so the write path adds no device sync."""

    COUNTERS = {"max_writers": 0, "scale_ups": 0}

    def __init__(self, make_sink, max_writers: int, scale_rows: int = 1 << 21):
        self._make = make_sink
        self._sinks = [make_sink()]
        self._max = max(1, max_writers)
        self._scale_rows = scale_rows
        self._rows = 0
        self._rr = 0

    def append(self, batch) -> None:
        self._rows += batch.capacity
        if (self._rows > self._scale_rows * len(self._sinks)
                and len(self._sinks) < self._max):
            self._sinks.append(self._make())
            ScaledWriterSink.COUNTERS["scale_ups"] += 1
        self._rr += 1
        self._sinks[self._rr % len(self._sinks)].append(batch)

    def finish(self) -> int:
        total = sum(s.finish() for s in self._sinks)
        ScaledWriterSink.COUNTERS["max_writers"] = max(
            ScaledWriterSink.COUNTERS["max_writers"], len(self._sinks))
        return total


class TableWriterOperator(Operator):
    """Terminal sink writing batches into a connector page sink
    (TableWriterOperator + TableFinishOperator collapsed — the commit
    handshake is the sink's finish(), whose row count lands in
    `rows_written`)."""

    def __init__(self, sink):
        self._sink = sink
        self.rows_written = 0

    def add_input(self, batch: RelBatch) -> None:
        self._sink.append(batch)

    def finish(self) -> None:
        if self._finishing:
            return
        self._finishing = True
        self.rows_written = self._sink.finish()

    def is_finished(self) -> bool:
        return self._finishing


class BufferSink(Operator):
    """Collects batches for a later pipeline (the LocalExchange handoff,
    single-buffer form): each input of a UNION ALL ends in one."""

    def __init__(self):
        self.batches: List[RelBatch] = []

    def add_input(self, batch: RelBatch) -> None:
        self.batches.append(batch)

    def is_finished(self) -> bool:
        return self._finishing


class BufferSource(Operator):
    """Replays the batches of one or more BufferSinks, in order. The
    engine runs the producing pipelines first."""

    def __init__(self, sinks: Sequence[BufferSink]):
        self._sinks = list(sinks)
        self._batches: Optional[List[RelBatch]] = None
        self._i = 0

    def needs_input(self) -> bool:
        return False

    def _all(self) -> List[RelBatch]:
        if self._batches is None:
            self._batches = [b for s in self._sinks for b in s.batches]
        return self._batches

    def get_output(self) -> Optional[RelBatch]:
        batches = self._all()
        if self._i < len(batches):
            self._i += 1
            return batches[self._i - 1]
        return None

    def is_finished(self) -> bool:
        return self._i >= len(self._all())


class CollectorSink(Operator):
    """Terminal sink gathering result batches."""

    def __init__(self):
        self.batches: List[RelBatch] = []

    def add_input(self, batch: RelBatch) -> None:
        self.batches.append(batch)

    def is_finished(self) -> bool:
        return self._finishing

    def rows(self) -> List[list]:
        out = []
        for b in self.batches:
            out.extend(b.to_pylists())
        return out
