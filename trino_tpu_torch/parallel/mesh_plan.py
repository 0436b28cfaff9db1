"""Mesh-resident distributed execution: collectives as the SQL data plane.

Counterpart of trino_tpu/parallel/mesh_plan.py. The reference compiles
a SubPlan into ONE SPMD program over a `jax.sharding.Mesh`; the port
runs the same plan over a ShardMesh (parallel/mesh.py), one process
driving a list of shard devices:

- every fragment's operator tree becomes per-shard torch ops over each
  shard's fixed-capacity RelBatch, looped over shard indices (a
  fragment's value is the list of its n per-shard batches);
- a FIXED_HASH exchange between fragments becomes a per-shard hash
  partition plus `all_to_all` over the shards;
- a FIXED_BROADCAST exchange becomes `all_gather`;
- the final gather boundary ships per-shard results to the host, where
  the root (single-partition) fragment runs through the ordinary local
  operator pipeline (merge-sorting RemoteSource included).

The compiler consumes the SAME SubPlan the page scheduler would run
(sql/fragmenter.plan_distributed), so planning decisions are shared
between both data planes; only the transport differs. Mesh execution
is selected when all tasks share the process (in-process workers);
HTTP workers and FTE keep the page exchange.

Static-shape discipline carries over: per-shard capacities are chosen
on the host; group tables and join fan-out use host-chosen capacities
with device overflow flags, read at program boundaries, and a
double-and-retry protocol (the tryRehash analogue). An all_to_all send
block equals the sender's capacity, so exchange overflow is impossible
by construction. Joins launch the port's CUDA kernels (`bounds` in
probe_counts, `run_owner` and `take_flat` in the expansion) once per
shard on a CUDA shard device.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import (
    Column,
    RelBatch,
    bucket_capacity,
    concat_batches,
    phys_zeros,
    unify_column_dicts,
)
from trino_tpu_torch.exec.operators import (
    _BATCH_REDUCER,
    AggSpec,
    _agg_output,
    _append_long_decimal_slots,
    _expand_pairs,
    _left_unmatched,
    _lex128_reduce,
    _limb_join,
    _limb_split,
    _right_unmatched,
    _segment_any,
    _slot_merge_reducers,
    _slots_to_state,
    _slots_to_wire_column,
    agg_state_meta,
    make_filter_project_fn,
    make_residual_fn,
)
from trino_tpu_torch.exec.serde import Page
from trino_tpu_torch.expr.compile import ExprBinder
from trino_tpu_torch.ops import groupby as G
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops.gather import take_clip
from trino_tpu_torch.ops.hashing import (
    canonical_hash_input,
    dictionary_lut,
    hash32,
    partition_of,
)
from trino_tpu_torch.ops.sort import sort_order
from trino_tpu_torch.parallel.mesh import ShardMesh, all_gather, all_to_all, psum
from trino_tpu_torch.sql import plan as P
from trino_tpu_torch.sql.fragmenter import SubPlan
from trino_tpu_torch.analysis.witness import named_lock

Shards = List[RelBatch]

# Counters, monotonically increasing for the process life (capacity-
# overflow restarts count again). The reference bumps them at trace
# time; the port at run time, once per exchange over all shards (a
# chunked run bumps a stream fragment's exchange once a chunk). Tests
# assert on before/after deltas. Bumps come from concurrent query
# threads, so all go through bump_mesh_counter.
_counters_lock = named_lock("mesh_plan._counters_lock")
MESH_COUNTERS = {"queries": 0, "all_to_all": 0, "all_gather": 0, "fallbacks": 0}  # guarded_by: _counters_lock

_METRICS_REGISTERED = False


def bump_mesh_counter(name: str, n: int = 1) -> None:
    with _counters_lock:
        MESH_COUNTERS[name] += n


def mesh_counter(name: str) -> int:
    with _counters_lock:
        return MESH_COUNTERS[name]


def mesh_counters_snapshot() -> dict:
    with _counters_lock:
        return dict(MESH_COUNTERS)


def register_mesh_metrics() -> None:
    """Expose MESH_COUNTERS as mesh_* gauges in the METRICS registry
    (and so in /v1/metrics). Idempotent; gauges read live at snapshot
    time."""
    global _METRICS_REGISTERED
    if _METRICS_REGISTERED:
        return
    from trino_tpu_torch.runtime.metrics import METRICS

    for name in mesh_counters_snapshot():
        METRICS.register_gauge(f"mesh_{name}", lambda n=name: float(mesh_counter(n)))
    _METRICS_REGISTERED = True


class MeshUnsupported(Exception):
    """Plan shape the mesh compiler cannot run; the coordinator falls
    back to the host page-exchange data plane."""


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------


def _check_node(n: P.PlanNode) -> None:
    if isinstance(n, P.OutputNode):
        raise MeshUnsupported(type(n).__name__)
    if isinstance(n, P.WindowNode) and not n.partition_channels:
        # PARTITION BY-less windows are one global partition; the
        # fragmenter gathers them to the root, so a distributed one
        # reaching here is a plan bug: fall back loudly
        raise MeshUnsupported("window without partition keys")
    if isinstance(n, P.AggregateNode):
        for a in n.aggs:
            if a.distinct or a.kind not in _BATCH_REDUCER:
                raise MeshUnsupported(f"agg {a.kind}")
    if isinstance(n, P.JoinNode) and n.kind not in (
        "inner", "left", "full", "semi", "anti", "cross", "mark", "mark_exists",
    ):
        raise MeshUnsupported(f"join {n.kind}")
    for c in n.children():
        _check_node(c)


def _scan_nodes(n: P.PlanNode) -> List[P.ScanNode]:
    out = []
    if isinstance(n, P.ScanNode):
        out.append(n)
    for c in n.children():
        out.extend(_scan_nodes(c))
    return out


def _contains_scan(n: P.PlanNode) -> bool:
    return bool(_scan_nodes(n))


# ---------------------------------------------------------------------------
# Exchange primitives: per-shard helpers, and the collectives over shards
# ---------------------------------------------------------------------------


def _partition_ids(batch: RelBatch, channels: Sequence[int], n: int) -> torch.Tensor:
    """Row -> destination shard by canonicalized key hash (dictionary
    codes mapped through value-hash LUTs so co-partitioned producers
    agree: the exchange_ops._partition_ids contract). Dead rows -> -1."""
    lanes, valids = [], []
    for ch in channels:
        col = batch.columns[ch]
        lut = dictionary_lut(col.dictionary)
        if lut is not None:
            lut_t = torch.from_numpy(lut.astype(np.int64)).to(col.device)
            lanes.append(canonical_hash_input(col.data, lut_t))
        else:
            lanes.append(canonical_hash_input(col.data))
        valids.append(col.valid_mask())
    pid = partition_of(hash32(lanes, valids), n)
    return torch.where(batch.live_mask(), pid, -1)


def _scatter_to_blocks(arrays, live, pid, n: int, block: int):
    """Scatter one shard's rows into (n, block) destination blocks (the
    PagePartitioner analogue). pid < 0 drops the row (a trash slot at
    n * block replaces the reference's mode="drop"). With block == the
    batch capacity overflow is impossible."""
    dev = live.device
    tgt = torch.where(pid < 0, n, pid).to(torch.int32)
    order = torch.sort(tgt, stable=True).indices
    st = take_clip(tgt, order)
    idx = torch.arange(st.shape[0], dtype=torch.int64, device=dev)
    dest_start = torch.searchsorted(st, torch.arange(n, dtype=torch.int32, device=dev))
    slot = idx - take_clip(dest_start, torch.clamp(st, 0, n - 1))
    flat = torch.where(
        st < n,
        torch.clamp(st, 0, n - 1).to(torch.int64) * block + torch.clamp(slot, 0, block - 1),
        n * block,
    )

    def scat(col):
        # trailing lanes (long-decimal (cap, 2) limb pairs) scatter
        # row-wise into (n, block, lanes) blocks
        tail = tuple(col.shape[1:])
        z = torch.zeros((n * block + 1,) + tail, dtype=col.dtype, device=dev)
        z[flat] = col.index_select(0, order)
        return z[:-1].reshape((n, block) + tail)

    return [scat(a) for a in arrays], scat(live)


def _rows(batch: RelBatch) -> int:
    """A batch's capacity, read off its live mask when it has no
    columns (count(*) over a projection of nothing)."""
    return batch.live.shape[0] if batch.live is not None else batch.capacity


def _flat_columns(batches: Shards, what: str) -> None:
    for c in batches[0].columns:
        if type(c) is not Column:
            raise MeshUnsupported(f"nested column in mesh {what}")


def _trim(mesh: ShardMesh, batches: Shards) -> Shards:
    """The shards' received batches front-packed (stable) and cut to
    one capacity: the rung of the largest shard's live-row count. An
    exchange delivers n * block rows a shard, most of them dead; the
    reference keeps them (its programs are compiled for that static
    shape), the port reads the counts once (one device->host sync an
    exchange) and drops them, so the operators downstream do not scan
    dead rows n-fold per exchange."""
    home = mesh.devices[0]
    counts = torch.stack([torch.sum(b.live_mask()).to(home) for b in batches]).cpu().tolist()
    cap = bucket_capacity(max(max(counts), 1))
    if cap >= _rows(batches[0]):
        return batches
    out = []
    for b, count in zip(batches, counts):
        order = torch.sort((~b.live_mask()).to(torch.int8), stable=True).indices[:cap]
        live = torch.arange(cap, device=order.device) < count
        out.append(RelBatch([c.gather(order) for c in b.columns], live))
    return out


def _exchange_with_pids(mesh: ShardMesh, batches: Shards, pids) -> Shards:
    """Scatter + all_to_all with caller-supplied destination ids per
    shard (the shared tail of the plain and salted hash exchanges). A
    width-1 mesh runs no collective: its one shard keeps its rows, in
    order (the reference's block holds them front-packed)."""
    n = mesh.n
    if n == 1:
        return list(batches)
    _flat_columns(batches, "exchange")
    block = _rows(batches[0])
    if any(_rows(b) != block for b in batches):
        raise AssertionError("mesh exchange over shards of unequal capacity")
    sent = []
    for b, pid in zip(batches, pids):
        arrays = []
        for c in b.columns:
            arrays.append(c.data)
            arrays.append(c.valid_mask())
        blocks, live_b = _scatter_to_blocks(arrays, b.live_mask(), pid, n, block)
        sent.append(blocks + [live_b])
    bump_mesh_counter("all_to_all")
    ex = [all_to_all(mesh, [s[i] for s in sent]) for i in range(len(sent[0]))]
    out = []
    for s in range(n):
        cols = []
        for i, c in enumerate(batches[s].columns):
            d = ex[2 * i][s]
            # (n, block, lanes...) -> rows-major local layout
            d = d.reshape((-1,) + tuple(d.shape[2:]))
            cols.append(Column(c.type, d, ex[2 * i + 1][s].reshape(-1), c.dictionary))
        out.append(RelBatch(cols, ex[-1][s].reshape(-1)))
    return _trim(mesh, out)


def _exchange_hash(mesh: ShardMesh, batches: Shards, channels: Sequence[int]) -> Shards:
    """FIXED_HASH remote exchange as partition + all_to_all (none on a
    width-1 mesh)."""
    if mesh.n == 1:
        return list(batches)
    return _exchange_with_pids(
        mesh, batches, [_partition_ids(b, channels, mesh.n) for b in batches])


# -- skew-aware salted repartition ---------------------------------------
#
# A hash exchange serializes every row of one key onto one shard; with a
# heavy hitter that IS the wall-clock. The salted form keeps cold keys on
# the normal hash path and treats the observed hot keys specially: hot
# BUILD rows are replicated to every shard (riding the all_gather a
# FIXED_BROADCAST uses), hot PROBE rows are dealt round-robin across
# shards. Every probe row still appears on exactly one shard and finds
# ALL build rows of its key there. The plan annotation that turns this on
# comes from the adaptive controller (adaptive/controller.py).


def _hot_mask(batch: RelBatch, channels: Sequence[int], hot_values) -> torch.Tensor:
    """Live rows whose (single) key column holds a hot value. Guarded
    to plain integer columns: dictionary codes must never be compared
    against observed key VALUES, and both join sides share the key
    type, so the guard degrades both sides together."""
    col = batch.columns[channels[0]]
    if col.dictionary is not None or col.data.dim() != 1:
        return torch.zeros(batch.capacity, dtype=torch.bool, device=batch.device)
    hv = torch.tensor(list(hot_values), dtype=col.data.dtype, device=col.device)
    eq = (col.data[:, None] == hv[None, :]).any(dim=1)
    return eq & col.valid_mask() & batch.live_mask()


def _salted_exchange_hash(mesh: ShardMesh, batches: Shards, channels: Sequence[int],
                          hot_values, role: str) -> Shards:
    """Salted FIXED_HASH exchange for one side of a skew-annotated join.
    role="build": cold rows all_to_all as usual, hot rows all_gather to
    every shard (output capacity 2*n*cap). role="probe": hot rows'
    destination is a round-robin salt offset by the shard index (so
    shard locality doesn't re-converge on one destination)."""
    n = mesh.n
    hots = [_hot_mask(b, channels, hot_values) for b in batches]
    if role == "build":
        colds = [b.mask(~h) for b, h in zip(batches, hots)]
        out = _exchange_with_pids(mesh, colds, [_partition_ids(c, channels, n) for c in colds])
        rep = _replicate(mesh, [b.mask(h) for b, h in zip(batches, hots)])
        return [concat_batches((o, r)) for o, r in zip(out, rep)]
    pids = []
    for me, (b, hot) in enumerate(zip(batches, hots)):
        pid = _partition_ids(b, channels, n)
        salt = (torch.cumsum(hot.to(torch.int32), 0) - 1 + me) % n
        pids.append(torch.where(hot, salt.to(pid.dtype), pid))
    return _exchange_with_pids(mesh, batches, pids)


def _salted_local_partition(batch: RelBatch, channels: Sequence[int], n: int,
                            hot_values, role: str, me: int) -> RelBatch:
    """Salted hash output of a REPLICATED producer on shard `me` (every
    shard already holds all rows). build: keep own partition plus every
    hot row. probe: deal each hot row to exactly one shard by its
    position; the batch is identical on every shard, so the deal is
    globally consistent without any collective."""
    pid = _partition_ids(batch, channels, n)
    hot = _hot_mask(batch, channels, hot_values)
    if role == "build":
        return batch.mask((pid == me) | hot)
    salt = (torch.cumsum(hot.to(torch.int32), 0) - 1) % n
    return batch.mask(torch.where(hot, salt == me, pid == me))


def _replicate(mesh: ShardMesh, batches: Shards) -> Shards:
    """FIXED_BROADCAST exchange as all_gather (every shard gets all
    rows); a width-1 mesh runs no collective."""
    if mesh.n == 1:
        return list(batches)
    _flat_columns(batches, "broadcast")
    bump_mesh_counter("all_gather")
    width = batches[0].width
    datas = [all_gather(mesh, [b.columns[i].data for b in batches]) for i in range(width)]
    valids = [all_gather(mesh, [b.columns[i].valid_mask() for b in batches])
              for i in range(width)]
    lives = all_gather(mesh, [b.live_mask() for b in batches])
    return _trim(mesh, [
        RelBatch([Column(c.type, datas[i][s], valids[i][s], c.dictionary)
                  for i, c in enumerate(batches[s].columns)], lives[s])
        for s in range(mesh.n)
    ])


def _local_partition(batch: RelBatch, channels: Sequence[int], n: int, me: int) -> RelBatch:
    """Hash output of a REPLICATED producer on shard `me`: every shard
    already holds all rows, so each keeps only its own partition (no
    collective)."""
    return batch.mask(_partition_ids(batch, channels, n) == me)


# ---------------------------------------------------------------------------
# Fragment-body compiler
# ---------------------------------------------------------------------------


class _FragVisitor:
    """Runs one fragment's plan tree as per-shard torch ops over the
    shards' RelBatches (the LocalExecutionPlanner analogue for the mesh
    data plane). Every visit returns the list of per-shard batches."""

    def __init__(self, executor: "MeshExecutor", frag_id: int,
                 feeds: Dict[int, Shards], ctx: Dict[int, Shards],
                 caps: Dict[str, int], flags: List[Tuple[str, list]]):
        self.ex = executor
        self.mesh = executor.mesh
        self.frag_id = frag_id
        self.feeds = feeds  # id(ScanNode) -> per-shard batches
        self.ctx = ctx  # fragment id -> post-exchange per-shard batches
        self.caps = caps
        self.flags = flags  # (site, per-shard int scalars)
        self._site_counter = 0

    def _site(self, kind: str) -> str:
        self._site_counter += 1
        return f"f{self.frag_id}:{kind}{self._site_counter}"

    def visit(self, node: P.PlanNode) -> Shards:
        m = getattr(self, f"_visit_{type(node).__name__}", None)
        if m is None:
            raise MeshUnsupported(type(node).__name__)
        return m(node)

    # -- leaves --
    def _visit_ScanNode(self, node):
        return self.feeds[id(node)]

    def _visit_ValuesNode(self, node):
        keys = [f.name or f"_c{i}" for i, f in enumerate(node.fields)]
        if len(set(keys)) != len(keys):
            # spooled join subtrees repeat column names (k, name, k,
            # name); a name-keyed dict would silently drop channels
            keys = [f"{k}_{i}" for i, k in enumerate(keys)]
        data = {k: [] for k in keys}
        for row in node.rows:
            for k, v in zip(keys, row):
                data[k].append(v)
        schema_t = [(k, f.type) for k, f in zip(keys, node.fields)]
        return [RelBatch.from_pydict(schema_t, data, device=dev) for dev in self.mesh.devices]

    _visit_SpooledValuesNode = _visit_ValuesNode

    def _visit_RemoteSourceNode(self, node):
        parts = [self.ctx[fid] for fid in node.fragment_ids]
        out = parts[0] if len(parts) == 1 else [concat_batches(p) for p in zip(*parts)]
        if node.merge_keys:
            # a merge-gather consumed mid-mesh arrives as an all_gather
            # of locally-sorted runs (shard-major, globally unsorted);
            # restore the global order with a full re-sort (the mesh
            # form of the MergeOperator)
            out = [self._sorted(b, node.merge_keys) for b in out]
        return out

    # -- row transforms --
    def _bind(self, e, batch: RelBatch):
        types = [c.type for c in batch.columns]
        dicts = [c.dictionary for c in batch.columns]
        return ExprBinder(types, dicts).bind(e)

    def _identity(self, batch: RelBatch):
        from trino_tpu_torch.expr.ir import InputRef

        return [self._bind(InputRef(i, c.type), batch) for i, c in enumerate(batch.columns)]

    def _visit_FilterNode(self, node):
        batches = self.visit(node.child)
        flt = self._bind(node.predicate, batches[0])
        fn = make_filter_project_fn(flt, self._identity(batches[0]))
        return [fn(b) for b in batches]

    def _visit_ProjectNode(self, node):
        child = node.child
        flt = None
        if isinstance(child, P.FilterNode):
            batches = self.visit(child.child)
            flt = self._bind(child.predicate, batches[0])
        else:
            batches = self.visit(child)
        bounds = [self._bind(e, batches[0]) for e in node.exprs]
        fn = make_filter_project_fn(flt, bounds)
        return [fn(b) for b in batches]

    # -- aggregation --
    def _agg_specs(self, node) -> Tuple[AggSpec, ...]:
        return tuple(
            AggSpec(a.kind, a.arg_channel, a.out_type, a.distinct,
                    a.arg2_channel, a.percentile, a.separator,
                    a.arg3_channel, a.param, a.post)
            for a in node.aggs
        )

    def _initial_agg_cap(self, node, batch: RelBatch) -> int:
        """Dictionary/boolean-bounded key domains fix the capacity at
        plan time (the HashAggregationOperator static-bound rule)."""
        bound = 1
        for ch in node.group_channels:
            c = batch.columns[ch]
            if c.type.is_string and c.dictionary is not None and len(c.dictionary) > 0:
                bound *= len(c.dictionary) + 1
            elif c.type.kind == T.TypeKind.BOOLEAN:
                bound *= 3
            else:
                return 1024
        if 0 < bound <= (1 << 16):
            return max(bucket_capacity(bound), 16)
        return 1024

    def _batch_agg_inputs(self, aggs, batch: RelBatch):
        """Value slots + reducers per aggregate (long-decimal args split
        into their limb-slot layout, same as the local _agg_ingest)."""
        live = batch.live_mask()
        values, vvalids, reds = [], [], []
        for a in aggs:
            if a.arg_channel is None:
                values.append(live.to(torch.int64))
                vvalids.append(None)
            elif batch.columns[a.arg_channel].data.dim() == 2:
                _append_long_decimal_slots(
                    a, batch.columns[a.arg_channel], live, values, vvalids, reds)
                continue
            else:
                col = batch.columns[a.arg_channel]
                values.append(col.data)
                vvalids.append(col.valid)
            reds.append(_BATCH_REDUCER[a.kind])
        return live, values, vvalids, reds

    def _visit_AggregateNode(self, node):
        batches = self.visit(node.child)
        if node.step == "final":
            return self._agg_final(node, batches)
        if not node.group_channels:
            if node.step != "partial":
                raise MeshUnsupported("global single-step agg in mesh fragment")
            return [self._global_partial(node, b) for b in batches]
        return self._agg_grouped(node, batches)

    def _group_reduce(self, site: str, cap: int, keys, valids, live, values, vvalids, reds):
        """One shard's sort_group_reduce and its overflow flag."""
        gk, gv, used, vals, cnts, ngroups, ovf = G.sort_group_reduce(
            tuple(keys), tuple(valids), live, tuple(values), tuple(vvalids),
            tuple(reds), cap,
        )
        flag = torch.where(ovf, ngroups, 0).to(torch.int32)
        return gk, gv, used, vals, cnts, flag

    def _agg_grouped(self, node, batches: Shards) -> Shards:
        """Grouped partial OR single-step aggregation (raw rows in)."""
        aggs = self._agg_specs(node)
        groups = tuple(node.group_channels)
        site = self._site("agg")
        cap = self.caps.setdefault(site, self._initial_agg_cap(node, batches[0]))
        out, flags = [], []
        for batch in batches:
            keys = [batch.columns[c].data for c in groups]
            valids = [batch.columns[c].valid_mask() for c in groups]
            live, values, vvalids, reds = self._batch_agg_inputs(aggs, batch)
            gk, gv, used, vals, cnts, flag = self._group_reduce(
                site, cap, keys, valids, live, values, vvalids, reds)
            flags.append(flag)
            cols: List[Column] = []
            for ch, kk, vv in zip(groups, gk, gv):
                c = batch.columns[ch]
                cols.append(Column(c.type, kk, vv, c.dictionary))
            schema = [(c.type, c.dictionary) for c in batch.columns]
            if node.step == "partial":
                # accumulator wire format (operators.partial_output_schema):
                # long-decimal limb slots join into ONE (n, 2) value column
                si = 0
                for a in aggs:
                    arg_t = schema[a.arg_channel][0] if a.arg_channel is not None else None
                    vt, vd = agg_state_meta(a, schema)[0]
                    cnt = cnts[si]
                    col, si = _slots_to_wire_column(a, arg_t, vt, vd, vals, si)
                    cols.append(col)
                    cols.append(Column(T.BIGINT, cnt.to(torch.int64), None, None))
                out.append(RelBatch(cols, used))
                continue
            # single step: finalize in place (the operator finish path)
            si = 0
            for a in aggs:
                arg_t, arg_d = (
                    schema[a.arg_channel] if a.arg_channel is not None else (None, None))
                state, si = _slots_to_state(a, arg_t, vals, cnts, si)
                res = _agg_output(a, state, arg_t, None)
                d = arg_d if a.kind in ("min", "max", "any") else None
                cols.append(Column(a.out_type, res.data, res.valid, d))
            out.append(RelBatch(cols, used))
        self.flags.append((site, flags))
        return out

    def _global_partial(self, node, batch: RelBatch) -> RelBatch:
        """GROUP-BY-less partial: one wire row of accumulator state."""
        aggs = self._agg_specs(node)
        live = batch.live_mask()
        dev = live.device
        schema = [(c.type, c.dictionary) for c in batch.columns]
        cols: List[Column] = []
        for a in aggs:
            if a.arg_channel is None:
                data, vvalid = live.to(torch.int64), None
            else:
                col = batch.columns[a.arg_channel]
                data, vvalid = col.data, col.valid
            w = live if vvalid is None else (live & vvalid)
            n = torch.sum(w.to(torch.int64))
            red = _BATCH_REDUCER[a.kind]
            vt, vd = agg_state_meta(a, schema)[0]
            if data.dim() == 2 and red != "count":
                # Int128 arg: one (1, 2) limb-pair state value (count
                # states stay scalar BIGINT regardless of arg type)
                if red == "sum":
                    zero = torch.zeros((), dtype=torch.int64, device=dev)
                    h, lo = _limb_join([torch.sum(torch.where(w, piece, zero))
                                        for piece in _limb_split(data)])
                elif red in ("min", "max"):
                    h, lo = _lex128_reduce(data[:, 0], data[:, 1], w, red)
                else:  # first
                    first = data[torch.argmax(w.to(torch.int8))]
                    h, lo = first[0], first[1]
                val = torch.stack([h, lo])[None, :]
                cols.append(Column(vt, val, None, vd))
                cols.append(Column(T.BIGINT, n[None].to(torch.int64), None, None))
                continue
            if red == "count":
                val = n
            elif red == "sum":
                acc_dt = torch.float64 if data.dtype.is_floating_point else torch.int64
                val = torch.sum(torch.where(w, data.to(acc_dt),
                                            torch.zeros((), dtype=acc_dt, device=dev)))
            elif red in ("min", "max"):
                neutral = torch.tensor(G.minmax_neutral(data.dtype, red), dtype=data.dtype,
                                       device=dev)
                masked = torch.where(w, data, neutral)
                val = torch.min(masked) if red == "min" else torch.max(masked)
            else:  # first
                val = data[torch.argmax(w.to(torch.int8))]
            cols.append(Column(vt, val[None].to(vt.dtype), None, vd))
            cols.append(Column(T.BIGINT, n[None].to(torch.int64), None, None))
        return RelBatch(cols, torch.ones(1, dtype=torch.bool, device=dev))

    def _agg_final(self, node, batches: Shards) -> Shards:
        """FINAL step over partial-wire-format state rows: merge-reduce
        per group then finalize (HashAggregationOperator final mode).
        Long-decimal state values arrive as (n, 2) limb pairs and split
        into their internal slot layout for the merge."""
        k = len(node.group_channels)
        site = self._site("aggf")
        cap = self.caps.setdefault(site, self._initial_agg_cap(node, batches[0]))
        out, flags = [], []
        for batch in batches:
            keys = [batch.columns[c].data for c in range(k)]
            valids = [batch.columns[c].valid_mask() for c in range(k)]
            live = batch.live_mask()
            values, vvalids, reds = [], [], []
            for a in node.aggs:
                val_col = batch.columns[a.arg_channel]
                cnt = batch.columns[a.arg_channel + 1].data
                mreds = _slot_merge_reducers(a, val_col.type)
                if val_col.data.dim() == 2:
                    pieces = (
                        _limb_split(val_col.data) if a.kind in ("sum", "avg")
                        else [val_col.data[:, 0], val_col.data[:, 1]]
                    )
                else:
                    pieces = [val_col.data]
                for p, mred in zip(pieces, mreds):
                    values.append(p)
                    vvalids.append((cnt > 0) if mred == "first" else None)
                    reds.append(mred)
                    values.append(cnt)
                    vvalids.append(None)
                    reds.append("sum")
            gk, gv, used, vals, _, flag = self._group_reduce(
                site, cap, keys, valids, live, values, vvalids, reds)
            flags.append(flag)
            cols: List[Column] = []
            for c_idx, kk, vv in zip(range(k), gk, gv):
                c = batch.columns[c_idx]
                cols.append(Column(c.type, kk, vv, c.dictionary))
            # de-interleave the merged (value, cnt) stream into slot lists
            vals_v = list(vals[0::2])
            vals_c = [c.to(torch.int64) for c in vals[1::2]]
            si = 0
            for a in node.aggs:
                arg_col = batch.columns[a.arg_channel]
                state, si = _slots_to_state(a, arg_col.type, vals_v, vals_c, si)
                res = _agg_output(a, state, arg_col.type, None)
                d = arg_col.dictionary if a.kind in ("min", "max", "any") else None
                cols.append(Column(a.out_type, res.data, res.valid, d))
            out.append(RelBatch(cols, used))
        self.flags.append((site, flags))
        return out

    # -- joins --
    def _visit_JoinNode(self, node):
        builds = self.visit(node.right)
        probes = self.visit(node.left)
        if node.kind == "cross":
            return self._cross_join(node, probes, builds)
        rkeys = list(node.right_keys)
        lkeys = list(node.left_keys)
        site = self._site("join")
        out_cap = self.caps.setdefault(site, bucket_capacity(max(probes[0].capacity, 16)))
        staged, flags = [], []
        for probe, build in zip(probes, builds):
            b_keys, b_valids = [], []
            for c in rkeys:
                col = build.columns[c]
                v = col.valid_mask()
                if col.data.dim() == 2:
                    # long-decimal key: build/probe by its two int64 limbs
                    b_keys.extend([col.data[:, 0], col.data[:, 1]])
                    b_valids.extend([v, v])
                else:
                    b_keys.append(col.data)
                    b_valids.append(v)
            ls = J.build_lookup(b_keys, b_valids, build.live_mask())
            keys, valids = [], []
            for i, c in enumerate(lkeys):
                col = probe.columns[c]
                v = col.valid_mask()
                bd = build.columns[rkeys[i]].dictionary
                if col.data.dim() == 2:
                    keys.extend([col.data[:, 0], col.data[:, 1]])
                    valids.extend([v, v])
                    continue
                if col.dictionary is not None and bd is not None and col.dictionary != bd:
                    # cross-dictionary string join: remap probe codes onto
                    # the build dictionary by value (LookupJoinOperator rule)
                    remap = torch.tensor([bd.code(x) for x in col.dictionary.values],
                                         dtype=torch.int32, device=col.device)
                    keys.append(take_clip(remap, col.data))
                else:
                    keys.append(col.data)
                valids.append(v)
            lo, counts, total = J.probe_counts(ls, keys, valids, probe.live_mask())
            flags.append(torch.where(total > out_cap, total, 0).to(torch.int32))
            pi, bi, ok, pairs = _expand_pairs(ls, probe, build, keys, valids, lo, counts,
                                              out_cap)
            if node.residual is not None:
                rfn = make_residual_fn(self._bind_pair(node.residual, probe, build))
                ok = ok & rfn(pairs)
                pairs = RelBatch(pairs.columns, ok)
            staged.append((probe, build, valids, counts, pi, bi, ok, pairs))
        self.flags.append((site, flags))
        if node.kind == "inner":
            return [st[-1] for st in staged]
        matched = [_segment_any(counts, pi, ok, probe.capacity)
                   for probe, _b, _v, counts, pi, _bi, ok, _p in staged]
        if node.kind == "semi":
            return [st[0].mask(m) for st, m in zip(staged, matched)]
        if node.kind == "anti":
            return [st[0].mask(~m) for st, m in zip(staged, matched)]
        if node.kind in ("mark", "mark_exists"):
            return self._mark(node, staged, matched, rkeys)
        if node.kind == "full":
            # hash-partitioned full outer: every build row lives on
            # exactly one shard, so shard-local matched flags are
            # complete (the fragmenter never broadcasts full joins)
            out = []
            for (probe, build, _v, _c, _pi, bi, ok, pairs), m in zip(staged, matched):
                matched_b = J.build_matched_flags(build.capacity, bi, ok)
                out.append(concat_batches([
                    pairs,
                    _left_unmatched(probe, build, m),
                    _right_unmatched([(c.type, c.dictionary) for c in probe.columns],
                                     build, matched_b),
                ]))
            return out
        # left outer: matched pairs + unmatched probe rows with NULL build
        return [concat_batches([st[-1], _left_unmatched(st[0], st[1], m)])
                for st, m in zip(staged, matched)]

    def _mark(self, node, staged, matched, rkeys) -> Shards:
        """Appended BOOLEAN match column; "mark" (IN) adds the
        three-valued lanes. Build-side emptiness and NULL flags are
        GLOBAL properties: psum over the shards (a shard with an empty
        build slice must not report empty)."""
        nonempty = has_null = None
        if node.kind == "mark":
            nonempty = psum(self.mesh, [torch.any(st[1].live_mask()).to(torch.int32)
                                        for st in staged])
            hns = []
            for st in staged:
                b_live = st[1].live_mask()
                hn = torch.zeros((), dtype=torch.bool, device=b_live.device)
                for c in rkeys:
                    bc = st[1].columns[c]
                    if bc.valid is not None:
                        hn = hn | torch.any(b_live & ~bc.valid)
                hns.append(hn.to(torch.int32))
            has_null = psum(self.mesh, hns)
        out = []
        for s, ((probe, _b, valids, *_rest), m) in enumerate(zip(staged, matched)):
            valid = None
            if node.kind == "mark":
                pv = None
                for vv in valids:
                    pv = vv if pv is None else (pv & vv)
                probe_null = ~pv if pv is not None else torch.zeros_like(m)
                unknown = (~m) & ((probe_null & (nonempty[s] > 0)) | (has_null[s] > 0))
                valid = ~unknown
            col = Column(T.BOOLEAN, m, valid, None)
            out.append(RelBatch(list(probe.columns) + [col], probe.live_mask()))
        return out

    def _bind_pair(self, e, probe: RelBatch, build: RelBatch):
        cols = list(probe.columns) + list(build.columns)
        return ExprBinder([c.type for c in cols], [c.dictionary for c in cols]).bind(e)

    def _cross_join(self, node, probes: Shards, builds: Shards) -> Shards:
        site = self._site("cross")
        nb = self.caps.setdefault(site, 16)
        out, flags = [], []
        for probe, build in zip(probes, builds):
            probe_c = probe.compact()
            build_c = build.compact()
            dev = probe_c.device
            n_l = torch.sum(probe_c.live_mask().to(torch.int32))
            n_r = torch.sum(build_c.live_mask().to(torch.int32))
            flags.append(torch.where(n_r > nb, n_r, 0).to(torch.int32))
            k = torch.arange(probe_c.capacity * nb, dtype=torch.int32, device=dev)
            pi = k // nb
            bi = k % nb
            live = (pi < n_l) & (bi < n_r)
            cols = [c.gather(pi) for c in probe_c.columns]
            cols += [c.gather(bi) for c in build_c.columns]
            out.append(RelBatch(cols, live))
        self.flags.append((site, flags))
        return out

    def _visit_UnionAllNode(self, node):
        outs = [self.visit(c) for c in node.inputs]
        # string columns must share dictionaries for the concatenated
        # column to stay bindable (same rule as the local UnionAll);
        # all-NULL/empty inputs are compatible with anything
        base = outs[0][0]
        for other in outs[1:]:
            for c0, c1 in zip(base.columns, other[0].columns):
                if not c0.type.is_string:
                    continue
                d0, d1 = c0.dictionary, c1.dictionary
                if d0 is not None and len(d0) > 0 and d1 is not None and len(d1) > 0 \
                        and d0 != d1:
                    raise MeshUnsupported("union dictionary mismatch")
        return [concat_batches(parts) for parts in zip(*outs)]

    def _visit_EnforceSingleRowNode(self, node):
        full = _replicate(self.mesh, self.visit(node.child))  # every shard sees all rows
        site = f"err:single_row:{self._site('sr')}"
        out, flags = [], []
        for b in full:
            live = b.live_mask()
            dev = live.device
            n = torch.sum(live.to(torch.int32))
            # >1 rows is a QUERY ERROR (not a capacity retry): err: flags
            # raise in the executor instead of resizing
            flags.append(torch.where(n > 1, n, 0).to(torch.int32))
            order = torch.sort(torch.where(live, 0, 1).to(torch.int32), stable=True).indices
            pos = order[:16]
            idx = torch.arange(16, dtype=torch.int32, device=dev)
            cols = []
            for c in b.columns:
                g = c.gather(pos)
                cols.append(g.with_data(g.data, g.valid_mask() & (idx < n)))  # 0 rows -> NULL row
            out.append(RelBatch(cols, torch.where(n > 0, idx < n, idx == 0)))
        self.flags.append((site, flags))
        return out

    # -- ordering / limits --
    def _sorted(self, batch: RelBatch, keys) -> RelBatch:
        datas = [batch.columns[k.channel].data for k in keys]
        valids = [batch.columns[k.channel].valid for k in keys]
        order = sort_order(datas, valids, [k.descending for k in keys],
                           [k.nulls_first for k in keys], batch.live_mask())
        return batch.gather(order, take_clip(batch.live_mask(), order))

    def _visit_SortNode(self, node):
        return [self._sorted(b, node.keys) for b in self.visit(node.child)]

    def _visit_TopNNode(self, node):
        out = []
        for b in self.visit(node.child):
            s = self._sorted(b, node.keys)
            idx = torch.arange(s.capacity, dtype=torch.int32, device=s.device)
            out.append(s.mask(idx < node.count))
        return out

    def _visit_LimitNode(self, node):
        out = []
        for b in self.visit(node.child):
            c = b.compact()
            idx = torch.arange(c.capacity, dtype=torch.int32, device=c.device)
            keep = idx >= node.offset
            if node.count is not None:
                keep = keep & (idx < node.offset + node.count)
            out.append(c.mask(keep))
        return out

    def _visit_WindowNode(self, node):
        """Window over hash-distributed partition keys: the fragmenter
        repartitioned the child on PARTITION BY (an all_to_all on this
        plane), so every window partition is shard-local and the local
        window kernel applies per shard unchanged
        (optimizations/AddExchanges.java:140 window distribution)."""
        from trino_tpu_torch.exec.operators import _window_compute, window_fn_tuples

        out = []
        for batch in self.visit(node.child):
            schema = [(c.type, c.dictionary) for c in batch.columns]
            fns = window_fn_tuples(list(node.functions), schema)
            s_cols, s_live, out_cols = _window_compute(
                batch, tuple(node.partition_channels), tuple(node.order_keys), fns,
                node.frame)
            cols = list(s_cols)
            for spec, (data, valid) in zip(node.functions, out_cols):
                d = None
                if spec.arg_channel is not None and spec.kind in (
                    "lead", "lag", "first_value", "last_value", "nth_value", "min", "max"
                ):
                    d = s_cols[spec.arg_channel].dictionary
                cols.append(Column(spec.out_type, data, valid, d))
            out.append(RelBatch(cols, s_live))
        return out


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class _ListSource:
    """make_remote_source duck type over pre-materialized pages."""

    def __init__(self, pages: List[Page]):
        self._pages = list(pages)

    def poll(self) -> Optional[Page]:
        return self._pages.pop(0) if self._pages else None

    def is_finished(self) -> bool:
        return not self._pages


def _replicated_map(mesh_sps) -> Dict[int, bool]:
    """Data placement per fragment: a fragment with no scans whose
    inputs are all replicated executes replicated (every shard computes
    the full result deterministically)."""
    repl: Dict[int, bool] = {}
    for sp in mesh_sps:
        frag = sp.fragment
        if _contains_scan(frag.root):
            repl[frag.id] = False
            continue
        # hash input -> sharded; broadcast/gather input -> the exchange
        # itself replicates it
        repl[frag.id] = all(c.fragment.output_kind != "hash" for c in sp.children)
    return repl


def _split(subplan: SubPlan):
    """(mesh fragments, root fragment, root's child ids), or
    MeshUnsupported for plan shapes the mesh plane cannot run."""
    from trino_tpu_torch.runtime.stages import topo_order

    order = topo_order(subplan)
    if len(order) < 2:
        raise MeshUnsupported("single-fragment plan")
    mesh_sps = order[:-1]
    root_sp = order[-1]
    for sp in mesh_sps:
        _check_node(sp.fragment.root)
    return mesh_sps, root_sp, {c.fragment.id for c in root_sp.children}


def mesh_eligibility(subplan: SubPlan) -> Dict[str, int]:
    """Static mesh-plane eligibility check (no execution, no device
    work): raises MeshUnsupported with the fallback reason for plan
    shapes the mesh compiler cannot run, else returns a structural
    summary with the per-pass collective census, so EXPLAIN surfaces
    stay deterministic."""
    from trino_tpu_torch.parallel.mesh_chunk import static_collective_counts

    mesh_sps, _root, root_child_ids = _split(subplan)
    a2a, ag = static_collective_counts(mesh_sps, root_child_ids, _replicated_map(mesh_sps))
    return {"fragments": len(mesh_sps), "all_to_all": a2a, "all_gather": ag}


class MeshExecutor:
    """Runs a SubPlan with the shard mesh as the exchange data plane.

    All non-root fragments run over the shards (parallel/mesh_chunk.py
    splits them into prelude, chunk-step and flush programs); the root
    fragment consumes the gathered results through the ordinary local
    pipeline on the runner's `device`, so sort-merge gathers, final
    TopN/limit and output decoration share code with the page plane.
    `devices` lists the shard devices (ShardMesh.resolve: None is every
    visible card of the runner's device type, one shard on the CPU).
    On a replica (runtime/replicas.py) `devices` is the replica's row,
    `replica_id` labels it (the chunk loop exports it as
    mesh_chunk.active_replica()), and `drain_check` raises
    MeshReplicaDraining at a chunk boundary once the replica leaves
    rotation. The coordinator sets `sched_job` (the scheduler seat the
    chunk loop consults at every boundary) and `steal_ctx` (a
    mesh_chunk.StealContext) per execution."""

    def __init__(self, catalogs, session, devices=None, device=None, replica_id=None,
                 drain_check=None):
        from trino_tpu_torch.engine import resolve_device

        self.catalogs = catalogs
        self.session = session
        self.device = resolve_device(device)
        self.mesh = ShardMesh.resolve(devices, self.device)
        self.n = self.mesh.n
        self.replica_id = replica_id
        self.drain_check = drain_check
        self.last_run: Dict[str, object] = {}
        self.sched_job = None
        self.steal_ctx = None

    # -- public --
    def execute(self, subplan: SubPlan, preempt=None, query_span=None) -> List[list]:
        """Run the SubPlan over the mesh. `preempt(done, total)` is the
        coordinator's program-boundary hook (deadline / abandonment
        checks); `query_span` roots the mesh stage/task/operator spans.
        The chunked runner splits the plan into prelude / chunk-step /
        flush programs when mesh_chunk_rows > 0, else runs one program;
        either way preemption checks bracket every program boundary."""
        from trino_tpu_torch.parallel.mesh_chunk import ChunkedMeshRunner

        mesh_sps, root_sp, root_child_ids = _split(subplan)
        repl = _replicated_map(mesh_sps)
        # each feed's source table (aligned with host_feeds): the
        # generation-snapshot domain of a pinned prelude
        self._feed_tables: List[tuple] = []
        feeds, host_feeds = self._load_scans(mesh_sps)
        runner = ChunkedMeshRunner(self, mesh_sps, root_child_ids, repl, feeds, host_feeds,
                                   feed_tables=tuple(self._feed_tables))
        if self.steal_ctx is not None and self.steal_ctx.mode == "emit":
            # a work-stealing helper: chunks [mid, K) for the primary to
            # merge; no root fragment, no result
            runner.run_steal_helper(self.steal_ctx)
            return []
        sources = runner.run(preempt=preempt, query_span=query_span)
        # count only after the programs have produced results: a
        # fallback from above must not register as a mesh-run query
        bump_mesh_counter("queries")
        self.last_run = dict(runner.info)
        return self._run_root(subplan, root_sp, sources)

    # -- planning helpers --
    def _load_scans(self, mesh_sps):
        """Host side of SOURCE distribution: each shard scans its slice
        of the connector splits (on the host); slices stack into one
        host RelBatch per ScanNode of global shape (n * cap,) (the
        SourcePartitionedScheduler assignment collapsed onto the mesh).
        The shards' slices are generated in parallel threads, as the
        page plane's source tasks generate theirs. The chunk runner
        places shard s's rows on devices[s], after re-padding the driver
        feed to a chunk-aligned capacity."""
        from concurrent.futures import ThreadPoolExecutor

        from trino_tpu_torch.analysis import threadreg
        from trino_tpu_torch.exec.operators import TableScanOperator

        host = torch.device("cpu")
        feeds: Dict[int, int] = {}  # id(node) -> feed position
        host_feeds: List[RelBatch] = []
        for sp in mesh_sps:
            for node in _scan_nodes(sp.fragment.root):
                if id(node) in feeds:
                    # the planner may reuse one ScanNode object in
                    # several plan positions (e.g. the NOT IN rewrite's
                    # subquery); one feed serves them all
                    continue
                conn = self.catalogs.get(node.catalog)
                splits = conn.split_manager.get_splits(
                    node.handle, max(self.session.target_splits, self.n))
                schema = [
                    (f.type, conn.metadata.column_dictionary(node.handle, c))
                    for c, f in zip(node.columns, node.fields)
                ]

                def scan(s, conn=conn, node=node, splits=splits, schema=schema):
                    op = TableScanOperator(conn.page_source, splits[s:: self.n],
                                           list(node.columns), self.session.batch_rows, host)
                    parts = []
                    while not op.is_finished():
                        b = op.get_output()
                        if b is None:
                            break
                        parts.append(b)
                    return concat_batches(parts) if parts else _empty_batch(schema)

                with ThreadPoolExecutor(
                        max_workers=self.n, thread_name_prefix="mesh-scan",
                        initializer=functools.partial(
                            threadreg.THREADS.adopt_current, owner="MeshExecutor")) as pool:
                    shard_batches = list(pool.map(scan, range(self.n)))
                feeds[id(node)] = len(host_feeds)
                host_feeds.append(_stack_shards(shard_batches, self.n))
                self._feed_tables.append((str(node.catalog).lower(),
                                          str(node.handle.schema).lower(),
                                          str(node.handle.table).lower()))
        return feeds, host_feeds

    # -- host boundary --
    def _shard_pages(self, batches: Shards, replicated: bool) -> List[Page]:
        """The shards' live rows as wire pages, in shard order (shard 0
        alone for a replicated fragment)."""
        pages = []
        for b in batches[:1] if replicated else batches:
            page = Page.from_batch(b)
            if page.row_count:
                pages.append(page)
        return pages

    def _run_root(self, subplan, root_sp, sources: Dict[int, List[Page]]):
        """Execute the root (single-partition) fragment on the host
        local pipeline, consuming the mesh results as its remote
        sources."""
        from trino_tpu_torch.exec import CollectorSink, Driver, Pipeline
        from trino_tpu_torch.runtime.stages import fragment_schema, topo_order
        from trino_tpu_torch.sql.local_planner import LocalPlanner

        schemas: Dict[int, list] = {}
        for sp in topo_order(subplan):
            remote = {c.fragment.id: schemas[c.fragment.id] for c in sp.children}
            schemas[sp.fragment.id] = fragment_schema(
                self.catalogs, self.session, sp, remote, self.device)
        planner = LocalPlanner(
            self.catalogs,
            self.device,
            batch_rows=self.session.batch_rows,
            remote_schemas={c.fragment.id: schemas[c.fragment.id] for c in root_sp.children},
            dynamic_filtering=False,
        )
        physical = planner.plan(root_sp.fragment.root)
        ctx = {
            "make_remote_source": lambda fids: _ListSource(
                [p for fid in fids for p in sources[fid]])
        }
        pipelines, chain = physical.instantiate(ctx)
        sink = CollectorSink()
        chain.append(sink)
        for p in pipelines:
            Driver(p).run()
        Driver(Pipeline(chain)).run()
        rows: List[list] = []
        for b in sink.batches:
            rows.extend(b.to_pylists())
        return rows


# ---------------------------------------------------------------------------
# Host-side batch assembly
# ---------------------------------------------------------------------------


def _empty_batch(schema) -> RelBatch:
    cols = [Column(t, phys_zeros(t, 16), torch.zeros(16, dtype=torch.bool), d)
            for t, d in schema]
    return RelBatch(cols, torch.zeros(16, dtype=torch.bool))


def _stack_shards(batches: List[RelBatch], n: int) -> RelBatch:
    """Pad per-shard batches to one capacity, unify dictionaries, and
    stack into host tensors of shape (n * cap,): shard s's rows are
    rows [s * cap, (s + 1) * cap)."""
    assert len(batches) == n
    cap = bucket_capacity(max(b.capacity for b in batches))
    _flat_columns(batches, "scan")
    cols: List[Column] = []
    for i in range(batches[0].width):
        parts = unify_column_dicts([b.columns[i] for b in batches])
        datas, valids = [], []
        for p in parts:
            d = p.data.cpu()
            v = p.valid.cpu() if p.valid is not None else torch.ones(d.shape[0], dtype=torch.bool)
            if d.shape[0] < cap:
                d = torch.cat([d, torch.zeros((cap - d.shape[0],) + tuple(d.shape[1:]),
                                              dtype=d.dtype)])
                v = torch.cat([v, torch.zeros(cap - v.shape[0], dtype=torch.bool)])
            datas.append(d)
            valids.append(v)
        cols.append(Column(parts[0].type, torch.cat(datas), torch.cat(valids),
                           parts[0].dictionary))
    lives = []
    for b in batches:
        lv = b.live_mask().cpu()
        if lv.shape[0] < cap:
            lv = torch.cat([lv, torch.zeros(cap - lv.shape[0], dtype=torch.bool)])
        lives.append(lv)
    return RelBatch(cols, torch.cat(lives))
