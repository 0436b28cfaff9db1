"""Chunked mesh execution: preemptible programs over the shard mesh.

Counterpart of trino_tpu/parallel/mesh_chunk.py, as it runs on one
mesh. The mesh compiler's output splits at batch granularity:

- **prelude**: every fragment whose subtree does not depend on the
  driver scan runs once (build sides of joins, dimension tables,
  uncorrelated subqueries); its exchange outputs stay on the shards'
  devices;
- **step**: fragments that stream over the driver scan run once per
  chunk of it, each shard slicing its own rows; group/join state
  between steps lives in carries (accumulator RelBatches with explicit
  live/valid lanes, one per shard). Each fragment group (producer, its
  exchange, consumer) runs inside the step;
- **flush**: fragments that need the complete driver relation (final
  aggregations, sorts, limits) run once over the accumulated carries.

Between program boundaries the host regains control: the coordinator's
preemption hook (deadline / abandonment checks) and the stuck-task
watchdog run there. Chunking engages only when `mesh_chunk_rows > 0`;
with the default 0 the whole plan is one prelude program, preemption
checks still around it.

The reference traces each program once under `jax.eval_shape` and
caches the record in PROGRAM_CACHE. Eager torch has nothing to trace, so
a record is host metadata (the fragment split, carry metadata, caps and
the three programs' shape classes); it is cached in PROGRAM_CACHE under
the reference's key (the fragments' structure, the feed schemas and
capacities, the devices, the chunk plan and the caps), so a replanned
query with the same structure builds nothing, and carries take their
shape from the first chunk's contribution. A successful run registers
the record's WarmupEntrys (MESH_WARMUP_ENTRIES) and notes its classes
warm. With `resident_pin_budget_mb` > 0 the prelude's outputs are
pinned in the resident tier under the feed tables' generations, and a
later run of the same record reuses them instead of running the prelude.
Static capacities and the reference's retry protocol stay: device
overflow flags are read at every program boundary (one device->host
sync, where `preempt` runs) and an overflow restarts the run under
doubled capacities, at most 12 times.

Checkpoints (recovery/checkpoint.py): with
`mesh_checkpoint_interval_chunks` = N > 0 a chunked run copies its
carries to host numpy arrays every N chunk boundaries (after the flag
readback, which has synced the device) into the generation-guarded
CHECKPOINTS store. A MeshStuck or MeshDeviceLost then resumes in-run
from the last checkpoint, at most `mesh_resume_attempts` times: each
shard's carry goes back onto that shard's device as a tensor of its
own, re-padded through `_pad_shards` when its rung grew, and the loop
continues at the checkpoint's chunk. A run with no checkpoint yet keeps
the fault's type, and the coordinator falls back to the page plane. A
checkpoint is resumed also on entry to a later run of the same program
(the fallback leaves it in the store); a successful run discards it.
`MESH_FAULT_HOOK` is the fault-injection seam at every chunk boundary.
Unlike the reference, a snapshot that fails propagates (the reference's
is best-effort), and a restore declines only on a typed condition
counted in `recovery.restore_declined.<reason>` (carry count, shape,
rung that shrank); any other error propagates.

The scheduler and the replica plane (runtime/scheduler.py,
runtime/replicas.py): an executor's `sched_job` is a MeshJob whose seat
the run acquires at device-phase entry (after host planning and the feed
builds). At every completed boundary the job decides: keep the mesh,
yield it in place, or park. `_park` copies the carries to the host store
(`CHECKPOINTS.park`, against park_max_bytes), drops every device carry,
waits for the grant, and restores the same snapshot onto the same
rungs, each shard's tensors its own. A replica's `drain_check` raises
MeshReplicaDraining at a boundary (or out of a parked wait), which a
sibling replica resumes from the host snapshot. On such a drain the
coordinator may split the unstarted chunks between two siblings:
`run_steal_helper` runs [mid, K) from empty carries and publishes them
under the steal key, and the primary's `_steal_merge` appends them at
its `mid` boundary (`_merge_out_carry`). A merge declines on a typed
disagreement, counted in `scheduler.steal_declined.<reason>` (timeout,
a helper's mesh fault or overflow, no published carries, caps, a carry
that is not an append accumulator, a merge `_merge_out_carry` refuses);
any other error of the helper is kept and raised by the primary at the
merge. `CHECKPOINT_PUSH_HOOK` (runtime/fabric.py) is called with the key
of every snapshot and park; it only enqueues.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import Column, RelBatch, bucket_capacity
from trino_tpu_torch.compile.cache import PROGRAM_CACHE, expr_fingerprint, schema_cache_key
from trino_tpu_torch.compile.shapes import CapacityLadder
from trino_tpu_torch.compile.warmup import WarmupEntry, note_classes_warm
from trino_tpu_torch.parallel.mesh_plan import (
    MeshUnsupported,
    Shards,
    _exchange_hash,
    _FragVisitor,
    _local_partition,
    _replicate,
    _rows,
    _salted_exchange_hash,
    _salted_local_partition,
)
from trino_tpu_torch.sql import plan as P
from trino_tpu_torch.analysis.witness import named_lock

# Most recent chunked run, for tests and EXPLAIN surfaces: chunk shape,
# fragment classification and attempt count. Written by chunk loops of
# concurrent queries: the clear()+update() must not expose an empty
# dict mid-publish.
_run_info_lock = named_lock("mesh_chunk._run_info_lock")
LAST_RUN_INFO: Dict[str, object] = {}  # guarded_by: _run_info_lock


def last_run_info() -> Dict[str, object]:
    """Snapshot of the most recent chunked run's info dict."""
    with _run_info_lock:
        return dict(LAST_RUN_INFO)


def publish_run_info(info: Dict[str, object]) -> None:
    """Atomically replace LAST_RUN_INFO with `info`."""
    with _run_info_lock:
        LAST_RUN_INFO.clear()
        LAST_RUN_INFO.update(info)


# WarmupEntry registry of the mesh programs (the local planner's entries'
# counterpart): bounded, oldest dropped; written by concurrent query
# threads
_warmup_entries_lock = named_lock("mesh_chunk._warmup_entries_lock")
MESH_WARMUP_ENTRIES: List[WarmupEntry] = []  # guarded_by: _warmup_entries_lock
_MAX_WARMUP_ENTRIES = 128


def register_mesh_warmup(entries) -> None:
    with _warmup_entries_lock:
        known = {id(e.fn) for e in MESH_WARMUP_ENTRIES}
        MESH_WARMUP_ENTRIES.extend(e for e in entries if id(e.fn) not in known)
        del MESH_WARMUP_ENTRIES[:-_MAX_WARMUP_ENTRIES]


def mesh_warmup_entries() -> List[WarmupEntry]:
    with _warmup_entries_lock:
        return list(MESH_WARMUP_ENTRIES)


class MeshStuck(RuntimeError):
    """A chunk step exceeded the stuck-task watchdog threshold. Treated
    as retryable (a program hung here may succeed on the page plane), so
    the coordinator falls back rather than failing the query."""


class MeshDeviceLost(RuntimeError):
    """A device backing the mesh failed mid-run (or a fault injected
    through MESH_FAULT_HOOK simulated one). Retryable like MeshStuck:
    the checkpointed remainder replays on the same mesh, on a sibling
    replica, or the whole query falls back to the page plane."""

    # an in-run resume retries on the SAME mesh; a fault a sibling
    # replica must take over for (a drain) turns this off
    in_run_resumable = True


class MeshReplicaDraining(MeshDeviceLost):
    """The replica serving this run started draining (or left the
    membership) mid-query: the chunk loop stops at the next boundary so
    the coordinator fails the query over to a sibling, which resumes
    from the host checkpoint. Resuming in-run would land back on the
    draining replica, so that is off for this fault."""

    in_run_resumable = False


# Fault-injection seam: when set, called as hook(chunk_index, n_chunks)
# at every chunk boundary BEFORE the step runs. Tests and chip_smoke
# raise MeshStuck / MeshDeviceLost from here to inject deterministic
# mid-run faults. Process-wide.
MESH_FAULT_HOOK: Optional[Callable[[int, int], None]] = None

# The checkpoint fabric's seam (runtime/fabric.py): when set, called as
# hook(key) right after a checkpoint or a park snapshot lands in the
# host store; it only offers the key to a bounded push queue.
CHECKPOINT_PUSH_HOOK: Optional[Callable[[tuple], None]] = None

# The replica whose sub-mesh the calling thread's chunk loop runs on
# (None outside a run, or on the single full-width mesh). Thread-local:
# chunk loops of several replicas interleave under serving load, and a
# replica-targeted fault hook must see the replica of the loop that
# called it.
_ACTIVE_REPLICA = threading.local()


def active_replica() -> Optional[int]:
    """Replica id of the sub-mesh the current thread's chunk loop runs
    on, or None."""
    return getattr(_ACTIVE_REPLICA, "replica", None)


class StealCancelled(Exception):
    """The split's dispatcher called a steal helper off (the primary
    finished or faulted without its rows): it stops at its next chunk
    boundary, or in its wait for the seat, and publishes nothing."""


@dataclasses.dataclass
class StealContext:
    """One side of a drain-failover split. The helper (mode "emit")
    runs chunks [mid, K) from empty carries and puts them under `key`;
    the primary (mode "merge") appends them at its `mid` boundary. Both
    sides share `done`, `cancel` and `errors` (dataclasses.replace keeps
    them)."""

    mode: str
    mid: int
    key: tuple
    caps: Dict[str, int]
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    timeout_s: float = 120.0
    # errors the helper met; a DECLINABLE one is a decline, any other is
    # raised by the primary at the merge or by the dispatcher
    errors: list = dataclasses.field(default_factory=list)
    cancel: threading.Event = dataclasses.field(default_factory=threading.Event)

    def check_cancel(self) -> None:
        if self.cancel.is_set():
            raise StealCancelled(f"steal helper for chunks [{self.mid}, K) called off")


class _Overflow(Exception):
    """Device overflow flags fired; restart the run with bumped caps."""

    def __init__(self, sites: List[Tuple[str, int]]):
        super().__init__(f"capacity overflow at {sites}")
        self.sites = sites


# a steal helper's errors that decline the split (the primary runs
# [mid, K) itself); any other propagates
STEAL_DECLINABLE = (MeshStuck, MeshDeviceLost, _Overflow, StealCancelled)


# ---------------------------------------------------------------------------
# Fragment classification: prelude / stream / flush
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """How one SubPlan splits across the three mesh programs."""

    driver_pos: Optional[int]  # feed position of the driver scan (None = unchunked)
    driver_ids: frozenset  # id(ScanNode) values served by that feed
    chunk_cap: int  # per-shard rows per chunk (capacity-ladder rung)
    n_chunks: int
    prelude_fids: frozenset
    stream_fids: frozenset
    flush_fids: frozenset

    @property
    def chunked(self) -> bool:
        return self.driver_pos is not None


def _classify(mesh_sps, root_child_ids, driver_ids):
    """Split fragments by their relationship to the driver scan.

    dep      = subtree reads the driver scan (directly or via a dep
               fragment's exchange)
    stream   = dep AND every operator on the dep path distributes over
               chunk-wise union (safe to run per chunk and accumulate)
    flush    = dep but not stream (needs the complete driver relation)
    prelude  = not dep (driver-independent; runs once, results stay)
    """
    dep_fids: set = set()
    dep_cache: Dict[int, bool] = {}

    def node_dep(node) -> bool:
        r = dep_cache.get(id(node))
        if r is None:
            if isinstance(node, P.ScanNode):
                r = id(node) in driver_ids
            elif isinstance(node, P.RemoteSourceNode):
                r = any(fid in dep_fids for fid in node.fragment_ids)
            else:
                r = any(node_dep(c) for c in node.children())
            dep_cache[id(node)] = r
        return r

    def safe(node, is_root: bool) -> bool:
        # a driver-independent subtree recomputes identically every
        # chunk: always safe (its cost is paid K times, but prelude
        # exchanges keep the heavy driver-independent work out of here)
        if not node_dep(node):
            return True
        if isinstance(node, P.ScanNode):
            return True
        if isinstance(node, (P.FilterNode, P.ProjectNode)):
            return all(safe(c, False) for c in node.children())
        if isinstance(node, P.AggregateNode):
            # only a PARTIAL agg at the fragment root: per-chunk partials
            # are more (but valid) partial rows under the partial/final
            # contract. Grouped single-step or FINAL aggs need it all.
            return is_root and node.step == "partial" and safe(node.child, False)
        if isinstance(node, P.JoinNode):
            ld, rd = node_dep(node.left), node_dep(node.right)
            if ld and rd:
                return False  # chunk x chunk misses cross-chunk pairs
            if node.kind == "cross":
                return safe(node.left if ld else node.right, False)
            if rd:
                # chunked BUILD side: only inner joins distribute over a
                # partition of the build relation
                return node.kind == "inner" and safe(node.right, False)
            # chunked PROBE side: per-probe-row verdicts against the
            # complete build side are exact for every kind except FULL
            return node.kind != "full" and safe(node.left, False)
        if isinstance(node, P.RemoteSourceNode):
            if node.merge_keys:
                return False  # chunk concat breaks merge-sorted runs
            deps = [fid in dep_fids for fid in node.fragment_ids]
            if any(deps) and not all(deps):
                # a union of dep + non-dep sources would replay the
                # non-dep source once per chunk (duplication)
                return False
            return True
        # Sort/TopN/Limit/Window/EnforceSingleRow/UnionAll/Values...:
        # order- or cardinality-global: conservative flush
        return False

    for sp in mesh_sps:
        if node_dep(sp.fragment.root):
            dep_fids.add(sp.fragment.id)

    stream: set = set()
    for sp in mesh_sps:
        fid = sp.fragment.id
        if fid not in dep_fids:
            continue
        if sp.fragment.output_merge_keys:
            # chunk-major accumulation is not merge-sorted; consumers
            # expecting sorted runs must see the full relation
            continue
        if any(c.fragment.id in dep_fids and c.fragment.id not in stream
               for c in sp.children):
            continue
        if safe(sp.fragment.root, True):
            stream.add(fid)

    all_fids = {sp.fragment.id for sp in mesh_sps}
    prelude = all_fids - dep_fids
    flush = dep_fids - stream
    return frozenset(prelude), frozenset(stream), frozenset(flush)


def build_chunk_plan(mesh_sps, root_child_ids, feeds, shard_caps, session):
    """Pick a driver scan and classify fragments. Chunking engages only
    when the session asks for it (mesh_chunk_rows > 0) and some feed
    admits a non-empty stream set; otherwise every fragment lands in the
    prelude (single-program execution, preemption checks around it)."""
    all_fids = frozenset(sp.fragment.id for sp in mesh_sps)
    chunk_rows = int(getattr(session, "mesh_chunk_rows", 0) or 0)
    if chunk_rows > 0 and feeds:
        ladder = CapacityLadder(base=int(getattr(session, "capacity_ladder_base", 2) or 2))
        by_pos: Dict[int, List[int]] = {}
        for key, pos in feeds.items():
            by_pos.setdefault(pos, []).append(key)
        # largest scan first: chunking the biggest relation buys the
        # most preemption granularity per program
        for pos in sorted(by_pos, key=lambda p: -shard_caps[p]):
            driver_ids = frozenset(by_pos[pos])
            prelude, stream, flush = _classify(mesh_sps, root_child_ids, driver_ids)
            if not stream:
                continue
            chunk_cap = ladder.rung(min(chunk_rows, shard_caps[pos]))
            n_chunks = max(1, math.ceil(shard_caps[pos] / chunk_cap))
            return ChunkPlan(pos, driver_ids, chunk_cap, n_chunks, prelude, stream, flush)
    return ChunkPlan(None, frozenset(), 0, 1, all_fids, frozenset(), frozenset())


# Join kinds whose per-probe-row verdict stays exact when hot build rows
# are replicated to every shard and hot probe rows are salted off their
# canonical shard. FULL and MARK need globally consistent build-side
# placement, so they never salt.
_SALTED_JOIN_KINDS = ("inner", "left", "semi", "anti")


def _skew_exchange_map(mesh_sps, root_child_ids):
    """{producer fid: ("build"|"probe", hot_values)} for every exchange
    edge that should take the salted repartition.

    A JoinNode annotated with `skew_hot_keys` (the adaptive controller,
    adaptive/controller.py) qualifies only when salting changes nothing
    but row routing: kind inner/left/semi/anti with a single integer-like
    equi key on both sides; both inputs RemoteSourceNode leaves whose
    producers each emit a single-channel FIXED_HASH exchange feeding
    only this edge; above the join only Filter/Project and PARTIAL
    aggregations. All-or-nothing per join: both sides resolve, or
    neither is salted.
    """
    frag_by_id = {sp.fragment.id: sp.fragment for sp in mesh_sps}
    ref_count: Dict[int, int] = {}

    def count_refs(node):
        if isinstance(node, P.RemoteSourceNode):
            for fid in node.fragment_ids:
                ref_count[fid] = ref_count.get(fid, 0) + 1
        for c in node.children():
            count_refs(c)

    for sp in mesh_sps:
        count_refs(sp.fragment.root)

    out: Dict[int, Tuple[str, tuple]] = {}

    def consider(join):
        if join.kind not in _SALTED_JOIN_KINDS:
            return
        if len(join.left_keys) != 1 or len(join.right_keys) != 1:
            return
        for node, ch in ((join.left, join.left_keys[0]), (join.right, join.right_keys[0])):
            t = node.fields[ch].type
            if t.is_nested or t.lanes != 1 or not t.is_integerlike:
                return
        if not (isinstance(join.left, P.RemoteSourceNode)
                and isinstance(join.right, P.RemoteSourceNode)):
            return
        probe_fids = tuple(join.left.fragment_ids)
        build_fids = tuple(join.right.fragment_ids)
        for fid in probe_fids + build_fids:
            frag = frag_by_id.get(fid)
            if (
                frag is None
                or ref_count.get(fid, 0) != 1
                or fid in root_child_ids
                or fid in out
                or frag.output_kind != "hash"
                or len(frag.output_channels) != 1
            ):
                return
        hot = tuple(join.skew_hot_keys)
        for fid in build_fids:
            out[fid] = ("build", hot)
        for fid in probe_fids:
            out[fid] = ("probe", hot)

    def walk(node, clean):
        if isinstance(node, P.JoinNode) and getattr(node, "skew_hot_keys", ()) and clean:
            consider(node)
        kid_clean = clean and (
            isinstance(node, (P.FilterNode, P.ProjectNode))
            or (isinstance(node, P.AggregateNode) and node.step == "partial")
        )
        for c in node.children():
            walk(c, kid_clean)

    for sp in mesh_sps:
        walk(sp.fragment.root, True)
    return out


def static_collective_counts(mesh_sps, root_child_ids, repl) -> Tuple[int, int]:
    """Structural collective census for one pass over the plan: each
    non-replicated hash edge is one all_to_all, each non-replicated
    broadcast/gather edge one all_gather, plus one all_gather per
    EnforceSingleRow occurrence and one per salted non-replicated BUILD
    edge. Static (no execution), so EXPLAIN surfaces stay deterministic.
    A chunked run executes a stream fragment's exchanges once a chunk."""

    def count_sr(node) -> int:
        own = 1 if isinstance(node, P.EnforceSingleRowNode) else 0
        return own + sum(count_sr(c) for c in node.children())

    skew = _skew_exchange_map(mesh_sps, root_child_ids)
    a2a = ag = 0
    for sp in mesh_sps:
        frag = sp.fragment
        ag += count_sr(frag.root)
        if frag.id in root_child_ids:
            continue
        if repl.get(frag.id):
            continue  # replicated producers exchange without collectives
        if frag.output_kind == "hash":
            a2a += 1
            if skew.get(frag.id, ("", ()))[0] == "build":
                ag += 1
        else:
            ag += 1
    return a2a, ag


# ---------------------------------------------------------------------------
# Chunk primitives (per shard)
# ---------------------------------------------------------------------------


def _slice_chunk(batch: RelBatch, k: int, cap: int) -> RelBatch:
    """Chunk k of one shard's (padded) driver feed: rows [k*cap, (k+1)*cap)."""
    start = k * cap

    def sl(a):
        return a.narrow(0, start, cap)

    cols = [Column(c.type, sl(c.data), None if c.valid is None else sl(c.valid),
                   c.dictionary) for c in batch.columns]
    return RelBatch(cols, None if batch.live is None else sl(batch.live))


def _put(arr: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """arr with arr[tgt] = vals, rows with tgt >= len(arr) dropped (the
    reference's scatter with mode="drop", through one trash row)."""
    cap = arr.shape[0]
    ext = torch.cat([arr, torch.zeros((1,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                                      device=arr.device)])
    ext[torch.clamp(tgt, max=cap)] = vals.to(arr.dtype)
    return ext[:cap]


def _accumulate(carry: RelBatch, contrib: RelBatch):
    """Append contrib's live rows to one shard's carry accumulator.

    The carry keeps live rows densely packed at the front, so appended
    chunks preserve scan order (chunk-major = scan-major after compact).
    Returns (new_carry, overflow_flag): the flag carries the exact
    needed capacity when the carry would overflow, 0 otherwise (the
    agg/join sites' protocol, so the restart ladder handles it).
    """
    cap_c = _rows(carry)
    comp = contrib.compact()
    live_in = comp.live_mask()
    count = torch.sum(carry.live_mask().to(torch.int64))
    idx = torch.arange(live_in.shape[0], dtype=torch.int64, device=live_in.device)
    # dead rows and overflow both land out of range -> dropped
    tgt = torch.where(live_in, count + idx, cap_c)
    cols = []
    for cc, sc in zip(carry.columns, comp.columns):
        cols.append(Column(cc.type, _put(cc.data, tgt, sc.data),
                           _put(cc.valid, tgt, sc.valid_mask()), cc.dictionary))
    live = _put(carry.live, tgt, live_in)
    needed = count + torch.sum(live_in.to(torch.int64))
    flag = torch.where(needed > cap_c, needed, 0).to(torch.int32)
    return RelBatch(cols, live), flag


def _carry_template(contrib: RelBatch, cap: int) -> RelBatch:
    """One shard's empty carry accumulator of `cap` rows shaped like
    `contrib`. live and valid lanes are always explicit tensors, so
    `_accumulate` writes every lane in place."""
    dev = contrib.device
    cols = []
    for c in contrib.columns:
        if type(c) is not Column:
            raise MeshUnsupported("nested column in mesh carry")
        cols.append(Column(
            c.type,
            torch.zeros((cap,) + tuple(c.data.shape[1:]), dtype=c.data.dtype, device=dev),
            torch.zeros(cap, dtype=torch.bool, device=dev),
            c.dictionary,
        ))
    return RelBatch(cols, torch.zeros(cap, dtype=torch.bool, device=dev))


def _host_lanes(batch: RelBatch, n: int, cap: int):
    """(data, valid) per column and the live mask of a host-stacked
    (n * cap,) batch, each reshaped to (n, cap, ...) (valid None stays
    None; live None means all live)."""
    cols = []
    for c in batch.columns:
        d = c.data.cpu().numpy()
        v = None if c.valid is None else c.valid.cpu().numpy().astype(bool).reshape(n, cap)
        cols.append((d.reshape((n, cap) + d.shape[1:]), v))
    live = (np.ones((n, cap), dtype=bool) if batch.live is None
            else batch.live.cpu().numpy().astype(bool).reshape(n, cap))
    return cols, live


def _pad_shards(batch: RelBatch, n: int, old_cap: int, new_cap: int) -> RelBatch:
    """Re-pad a host-stacked (n * old_cap,) feed to (n * new_cap,) so the
    per-shard extent divides evenly into chunk_cap slices. Padding rows
    are dead (live=False)."""
    if new_cap == old_cap:
        return batch
    pad = new_cap - old_cap
    cols_np, live = _host_lanes(batch, n, old_cap)
    cols = []
    for c, (d, v) in zip(batch.columns, cols_np):
        d = np.pad(d, [(0, 0), (0, pad)] + [(0, 0)] * (d.ndim - 2))
        v = np.ones((n, old_cap), dtype=bool) if v is None else v
        v = np.pad(v, [(0, 0), (0, pad)])
        cols.append(Column(c.type, torch.from_numpy(d.reshape((n * new_cap,) + d.shape[2:])),
                           torch.from_numpy(v.reshape(-1)), c.dictionary))
    return RelBatch(cols, torch.from_numpy(np.pad(live, [(0, 0), (0, pad)]).reshape(-1)))


def _merge_out_carry(mine: RelBatch, theirs: RelBatch, n: int) -> Optional[RelBatch]:
    """Append `theirs`'s packed live rows after `mine`'s per-shard live
    count, both host-stacked (n * cap,) carries (the drain-failover
    merge of work stealing: `mine` holds chunks [k0, mid), `theirs`
    [mid, K) run from empty carries on a sibling). `_accumulate` packs live rows densely at the shard front
    in chunk order, so this concatenation equals the sequential layout.
    Returns None when the combined rows overflow a shard or the packing
    precondition fails."""
    if mine.width != theirs.width or mine.capacity != theirs.capacity:
        return None
    cap = mine.capacity // n
    m_cols, m_live = _host_lanes(mine, n, cap)
    t_cols, t_live = _host_lanes(theirs, n, cap)
    datas = [d.copy() for d, _v in m_cols]
    valids = [None if v is None else v.copy() for _d, v in m_cols]
    new_live = m_live.copy()
    for s in range(n):
        cm = int(m_live[s].sum())
        idx_t = np.nonzero(t_live[s])[0]
        ct = len(idx_t)
        if cm + ct > cap:
            return None
        if (cm and not m_live[s][:cm].all()) or (ct and int(idx_t[-1]) != ct - 1):
            return None  # rows not packed at the front
        if ct == 0:
            continue
        for j, (td, tv) in enumerate(t_cols):
            datas[j][s, cm:cm + ct] = td[s, idx_t]
            if valids[j] is not None:
                valids[j][s, cm:cm + ct] = (np.ones(cap, dtype=bool) if tv is None
                                            else tv[s])[idx_t]
        new_live[s, cm:cm + ct] = True
    cols = [
        Column(c.type, torch.from_numpy(datas[j].reshape((n * cap,) + datas[j].shape[2:])),
               None if valids[j] is None else torch.from_numpy(valids[j].reshape(-1)),
               c.dictionary)
        for j, c in enumerate(mine.columns)
    ]
    return RelBatch(cols, torch.from_numpy(new_live.reshape(-1)))


def _place(batch: RelBatch, devices, own: bool = False) -> Shards:
    """A host-stacked (n * cap,) batch cut into its n shards, shard s on
    devices[s]. With `own` every shard's tensors are copies that share
    no storage with `batch` or with each other (a restored carry is
    written in place by later steps)."""
    n = len(devices)
    cap = _rows(batch) // n

    def part(t, s):
        if t is None:
            return None
        return t.narrow(0, s * cap, cap).to(devices[s], copy=own)

    return [
        RelBatch([Column(c.type, part(c.data, s), part(c.valid, s), c.dictionary)
                  for c in batch.columns], part(batch.live, s))
        for s in range(n)
    ]


def _carry_to_host(shards: Shards):
    """A carry's shards as one host-stacked HostCarry of numpy copies
    (np.concatenate always copies, so the snapshot never aliases a
    live carry, on the CPU either)."""
    from trino_tpu_torch.recovery.checkpoint import HostCarry

    def lane(ts, default):
        return np.concatenate([default(b) if t is None else t.cpu().numpy()
                               for t, b in zip(ts, shards)])

    cols = []
    for i, c in enumerate(shards[0].columns):
        data = lane([b.columns[i].data for b in shards], None)
        valid = lane([b.columns[i].valid for b in shards],
                     lambda b: np.ones(_rows(b), dtype=bool))
        cols.append((c.type, data, valid, c.dictionary))
    live = lane([b.live for b in shards], lambda b: np.ones(_rows(b), dtype=bool))
    return HostCarry(tuple(cols), live)


def _host_to_batch(hc) -> RelBatch:
    """A HostCarry as a host-stacked CPU RelBatch over copies of its
    arrays (the checkpoint stays intact whatever the run does next)."""
    cols = [Column(t, torch.from_numpy(np.array(d, copy=True)),
                   torch.from_numpy(np.array(v, copy=True)), dic)
            for t, d, v, dic in hc.columns]
    return RelBatch(cols, torch.from_numpy(np.array(hc.live, copy=True)))


# ---------------------------------------------------------------------------
# Program record: the host metadata of the three programs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshProgramRecord:
    n_chunks: int
    chunk_cap: int
    # the caps the run starts from; every site a visitor reaches sets
    # its own (setdefault), so after a run this holds all of them
    resolved_caps: Dict[str, int]
    pctx_fids: Tuple[int, ...]
    carry_meta: Tuple[Tuple[str, int], ...]  # ("out"|"ctx", fid)
    prelude_sps: list
    stream_sps: list
    flush_sps: list
    warmup_entries: List[WarmupEntry] = dataclasses.field(default_factory=list)
    class_keys: set = dataclasses.field(default_factory=set)


class _ProgramWarmer:
    """WarmupEntry.fn of a mesh program. The port's programs are the
    local operators' kernels launched shard by shard, so warming one
    means building those kernels for the shard devices
    (ops/cuda_build.py); on the CPU there is nothing to build. It loads
    no library: each wrapper's first launch loads its own with its
    functions' argument types bound, and `load` hands back a loaded
    library as it is (unbound, ctypes would pass a 64-bit pointer as a
    32-bit int)."""

    def __init__(self, devices):
        self.devices = tuple(str(d) for d in devices)

    def __call__(self, _batch=None) -> None:
        if any(torch.device(d).type == "cuda" for d in self.devices):
            from trino_tpu_torch.ops import cuda_build

            cuda_build.build_all()


def _record_key(ex, mesh_sps, root_child_ids, repl, feed_sigs, cplan, caps):
    """The record's PROGRAM_CACHE key: the fragments by repr
    fingerprint (a structurally identical fresh plan reuses the record),
    the feeds' schemas and capacities, the shard devices, the chunk plan
    and the caps. None (uncached) when a repr leaks object identity or a
    feed's dictionary exists only at run time."""
    frag_parts = []
    for sp in mesh_sps:
        f = sp.fragment
        frag_parts.append((f.id, f.partitioning, f.output_kind, tuple(f.output_channels),
                           tuple(f.output_merge_keys or ()), f.root,
                           tuple(c.fragment.id for c in sp.children)))
    fp = expr_fingerprint(tuple(frag_parts))
    if fp is None or any(sig is None for sig, _cap in feed_sigs):
        return None
    return ("mesh-chunk", ex.n, tuple(str(d) for d in ex.mesh.devices), fp,
            tuple(sorted(root_child_ids)), tuple(sorted(repl.items())), tuple(feed_sigs),
            cplan.driver_pos, cplan.chunk_cap, cplan.n_chunks, tuple(sorted(caps.items())))


def _record_entries(ex, cplan, record) -> None:
    """The record's WarmupEntrys (one per program it runs) and their
    class keys, as the reference's _build_record makes them."""
    sig = (f"frags{len(record.prelude_sps) + len(record.stream_sps) + len(record.flush_sps)}",
           f"k{cplan.n_chunks}", f"n{ex.n}")
    warm_cap = cplan.chunk_cap or 16
    warmer = _ProgramWarmer(ex.mesh.devices)
    for operator, sps in (("MeshPrelude", record.prelude_sps),
                          ("MeshChunkStep", record.stream_sps),
                          ("MeshFlush", record.flush_sps)):
        if sps:
            record.warmup_entries.append(WarmupEntry(
                operator=operator, fn=warmer, in_schema=[(T.BIGINT, None)], out_dtypes=sig,
                capacities=(warm_cap,), device=ex.mesh.devices[0]))
    record.class_keys = set().union(*(e.keys() for e in record.warmup_entries))


def _build_record(mesh_sps, root_child_ids, cplan, caps_in) -> MeshProgramRecord:
    prelude_sps = [sp for sp in mesh_sps if sp.fragment.id in cplan.prelude_fids]
    stream_sps = [sp for sp in mesh_sps if sp.fragment.id in cplan.stream_fids]
    flush_sps = [sp for sp in mesh_sps if sp.fragment.id in cplan.flush_fids]
    consumer: Dict[int, int] = {}
    for sp in mesh_sps:
        for c in sp.children:
            consumer[c.fragment.id] = sp.fragment.id
    # prelude exchange outputs consumed by later programs stay resident
    pctx_fids = tuple(sorted({
        c.fragment.id
        for sp in stream_sps + flush_sps
        for c in sp.children
        if c.fragment.id in cplan.prelude_fids
    }))
    carry_meta: List[Tuple[str, int]] = []
    for sp in stream_sps:
        fid = sp.fragment.id
        if fid in root_child_ids:
            carry_meta.append(("out", fid))
        elif consumer.get(fid) in cplan.flush_fids:
            carry_meta.append(("ctx", fid))
    return MeshProgramRecord(
        n_chunks=cplan.n_chunks,
        chunk_cap=cplan.chunk_cap,
        resolved_caps=dict(caps_in),
        pctx_fids=pctx_fids,
        carry_meta=tuple(carry_meta),
        prelude_sps=prelude_sps,
        stream_sps=stream_sps,
        flush_sps=flush_sps,
    )


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


class ChunkedMeshRunner:
    """Drives one query's mesh programs: prelude once, K chunk steps
    with host preemption/watchdog checks at every boundary, flush once;
    restarts the whole loop under bumped capacities on device overflow
    (a deterministic ladder: a second execution replays the same
    capacity sequence)."""

    def __init__(self, ex, mesh_sps, root_child_ids, repl, feeds, host_feeds,
                 feed_tables=()):
        self.ex = ex
        self.feed_tables = tuple(feed_tables)
        self.session = ex.session
        self.mesh_sps = mesh_sps
        self.root_child_ids = root_child_ids
        self.repl = repl
        self.feeds = feeds
        self.skew_map = _skew_exchange_map(mesh_sps, root_child_ids)
        n = ex.n
        shard_caps = [_rows(b) // n for b in host_feeds]
        self.cplan = build_chunk_plan(mesh_sps, root_child_ids, feeds, shard_caps,
                                      self.session)
        host_feeds = list(host_feeds)
        if self.cplan.chunked:
            pos = self.cplan.driver_pos
            host_feeds[pos] = _pad_shards(host_feeds[pos], n, shard_caps[pos],
                                          self.cplan.n_chunks * self.cplan.chunk_cap)
        self.feed_sigs = tuple(
            (schema_cache_key([(c.type, c.dictionary) for c in b.columns]), _rows(b))
            for b in host_feeds)
        self.feed_args = [_place(b, ex.mesh.devices) for b in host_feeds]
        self.info: Dict[str, object] = {}
        # the current run's ledger: chunk steps executed (over every
        # attempt), checkpoints taken and their bytes and wall, resumes
        self._run_stats: Dict[str, object] = {}
        self._last_record_key = None
        self._prelude_resident = False  # the run reused a pinned prelude

    def _record(self, caps) -> MeshProgramRecord:
        """The record for `caps`, from PROGRAM_CACHE when this plan's
        structure was recorded before. The cached record is a template:
        the run gets its fragments (this plan's nodes, which the feeds
        are keyed by) and its own copy of the caps, which the run
        extends."""
        def build():
            record = _build_record(self.mesh_sps, self.root_child_ids, self.cplan, caps)
            _record_entries(self.ex, self.cplan, record)
            return record

        key = _record_key(self.ex, self.mesh_sps, self.root_child_ids, self.repl,
                          self.feed_sigs, self.cplan, caps)
        self._last_record_key = key
        if key is None:
            return build()
        template = PROGRAM_CACHE.get_or_create(key, build)
        fresh = _build_record(self.mesh_sps, self.root_child_ids, self.cplan,
                              template.resolved_caps)
        fresh.warmup_entries = template.warmup_entries
        fresh.class_keys = template.class_keys
        return fresh

    def _ckpt_key(self) -> Optional[tuple]:
        """Checkpoint-store key: the program identity minus the caps
        element (the record key's last component), so a resume after an
        overflow cap bump still finds its checkpoint, and minus the
        device identity (record-key element 2), so the checkpoint is
        host-portable — a sibling mesh of the same width n restores it.
        The shard count n stays in the key: carries from a
        different-width mesh could never be re-placed shape-exactly.
        None when the program itself is uncacheable (repr identity leak)
        — such plans never checkpoint."""
        if self._last_record_key is None:
            return None
        key = self._last_record_key
        return ("mesh-ckpt", key[1]) + tuple(key[3:-1])

    # -- execution ---------------------------------------------------
    def run(self, preempt=None, query_span=None) -> Dict[int, list]:
        from trino_tpu_torch.runtime.tracing import KIND_STAGE, KIND_TASK

        stage_span = task_span = None
        if query_span is not None:
            stage_span = query_span.child("stage mesh", KIND_STAGE, data_plane="mesh",
                                          fragments=len(self.mesh_sps))
            task_span = stage_span.child("task mesh.0", KIND_TASK, chunks=self.cplan.n_chunks,
                                         chunk_rows=self.cplan.chunk_cap)
        prev_replica = active_replica()
        _ACTIVE_REPLICA.replica = getattr(self.ex, "replica_id", None)
        try:
            sched_job = getattr(self.ex, "sched_job", None)
            if sched_job is not None:
                # the seat guards the device phases only: planning and
                # the feed builds ran before this point, so a fast
                # arrival never queues behind another query's host prep
                sched_job.scheduler.acquire(sched_job)
            caps: Dict[str, int] = {}
            self._run_stats = {"executed_chunk_steps": 0, "checkpoints": 0,
                               "checkpoint_bytes": 0, "checkpoint_s": 0.0,
                               "resumes": 0, "resumed_from_chunk": None,
                               "parks": 0, "unparks": 0, "steals": 0}
            resume_budget = int(getattr(self.session, "mesh_resume_attempts", 2) or 0)
            overflows = 0
            attempt = 0
            while True:
                record = self._record(caps)
                try:
                    sources = self._execute(record, preempt, task_span, attempt)
                    break
                except _Overflow as ov:
                    for site, _needed in ov.sites:
                        if site.startswith("err:single_row"):
                            raise RuntimeError(
                                "Scalar sub-query has returned multiple rows") from None
                    overflows += 1
                    if overflows >= 12:
                        raise RuntimeError("mesh capacity retry limit exceeded")
                    # restart from the record's fully resolved caps so
                    # the ladder is deterministic across executions
                    caps = dict(record.resolved_caps)
                    for site, needed in ov.sites:
                        caps[site] = max(caps.get(site, 16) * 2,
                                         bucket_capacity(max(needed, 16)))
                    attempt += 1
                except (MeshStuck, MeshDeviceLost) as e:
                    # in-run resume: only when a live checkpoint exists
                    # and budget remains; otherwise the fault keeps its
                    # type and the coordinator's fallback takes over.
                    # Typed deadline / abandonment errors never land
                    # here: they propagate from preempt() uncaught.
                    key = self._ckpt_key()
                    ckpt = None
                    if (key is not None and resume_budget > 0
                            and getattr(e, "in_run_resumable", True)):
                        from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS

                        ckpt = CHECKPOINTS.get(key)
                    if ckpt is None:
                        # what the replica plane's failover reads: the
                        # checkpoint key, and whether every carry is an
                        # append accumulator (work stealing; group
                        # carries hold cross-chunk state that cannot merge)
                        e.ckpt_key = key
                        e.steal_ok = bool(record.carry_meta) and all(
                            kind == "out" for kind, _fid in record.carry_meta)
                        raise
                    resume_budget -= 1
                    if task_span is not None:
                        task_span.event("mesh_fault", error=type(e).__name__,
                                        resume_from=ckpt.next_chunk)
                    attempt += 1
            if record.warmup_entries:
                register_mesh_warmup(record.warmup_entries)
                note_classes_warm(record.class_keys)
            if self.skew_map:
                from trino_tpu_torch.runtime.metrics import METRICS

                METRICS.increment("skew.salted_exchanges", len(self.skew_map))
            self.info = {
                "chunked": self.cplan.chunked,
                "chunks": record.n_chunks,
                "chunk_cap": record.chunk_cap,
                "driver_pos": self.cplan.driver_pos,
                "prelude_fragments": sorted(self.cplan.prelude_fids),
                "stream_fragments": sorted(self.cplan.stream_fids),
                "flush_fragments": sorted(self.cplan.flush_fids),
                "attempts": attempt + 1,
                "salted_exchanges": len(self.skew_map),
                "shards": self.ex.n,
                **self._run_stats,
            }
            if self._prelude_resident:
                self.info["prelude_resident"] = True
            key = self._ckpt_key()
            if key is not None:
                # a completed run's checkpoint is spent: a later
                # identical query must start fresh, not resume
                from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS

                CHECKPOINTS.discard(key)
            publish_run_info(self.info)
            self._record_divergences(sources, query_span)
            return sources
        finally:
            _ACTIVE_REPLICA.replica = prev_replica
            if task_span is not None:
                task_span.end()
                stage_span.end()

    def _emit_exchange(self, frag, batches: Shards, ctx) -> None:
        mesh, n = self.ex.mesh, self.ex.n
        repl = self.repl[frag.id]
        if frag.output_kind == "hash":
            sk = self.skew_map.get(frag.id)
            chans = frag.output_channels
            if sk is not None:
                role, hot = sk
                ctx[frag.id] = (
                    [_salted_local_partition(b, chans, n, hot, role, s)
                     for s, b in enumerate(batches)]
                    if repl else _salted_exchange_hash(mesh, batches, chans, hot, role))
            else:
                ctx[frag.id] = (
                    [_local_partition(b, chans, n, s) for s, b in enumerate(batches)]
                    if repl else _exchange_hash(mesh, batches, chans))
        else:  # broadcast, or gather consumed by another mesh fragment
            ctx[frag.id] = batches if repl else _replicate(mesh, batches)

    def _run_frags(self, record, sps, local_feeds, ctx, flags, outputs) -> None:
        for sp in sps:
            frag = sp.fragment
            vis = _FragVisitor(self.ex, frag.id, local_feeds, ctx, record.resolved_caps,
                               flags)
            batches = vis.visit(frag.root)
            if frag.id in self.root_child_ids:
                outputs[frag.id] = (batches, self.repl[frag.id])
                continue
            self._emit_exchange(frag, batches, ctx)

    def _local_feeds(self, k: Optional[int]) -> Dict[int, Shards]:
        out = {}
        for key, pos in self.feeds.items():
            b = self.feed_args[pos]
            if k is not None and pos == self.cplan.driver_pos:
                b = [_slice_chunk(x, k, self.cplan.chunk_cap) for x in b]
            out[key] = b
        return out

    def _execute(self, record: MeshProgramRecord, preempt, task_span,
                 attempt: int) -> Dict[int, list]:
        from trino_tpu_torch.runtime.metrics import METRICS
        from trino_tpu_torch.runtime.tracing import KIND_OPERATOR

        def op_span(name, **attrs):
            if task_span is None:
                return contextlib.nullcontext()
            return task_span.child(name, KIND_OPERATOR, **attrs)

        K = record.n_chunks
        watchdog_s = float(getattr(self.session, "stuck_task_interrupt_s", 0.0) or 0.0)
        outs: Dict[int, Tuple[Shards, bool]] = {}
        if preempt is not None:
            preempt(0, K)
        pctx: Dict[int, Shards] = {}
        if record.prelude_sps:
            outs, pctx = self._run_prelude(record, op_span, task_span, attempt)
            outs = dict(outs)

        interval = int(getattr(self.session, "mesh_checkpoint_interval_chunks", 0) or 0)
        # the program identity for the resume-on-entry lookup; ckpt_key
        # additionally gates the every-N-chunks snapshots
        park_key = self._ckpt_key() if self.cplan.chunked else None
        ckpt_key = park_key if interval > 0 else None
        carries: List[Optional[Shards]] = [None] * len(record.carry_meta)
        if record.stream_sps:
            k0 = 0
            if park_key is not None:
                from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS

                ck = CHECKPOINTS.get(park_key)
                if ck is not None and ck.n_chunks == K and 0 < ck.next_chunk <= K:
                    # resume on the checkpoint's rungs (or larger ones):
                    # the chunks before it may have raised a capacity
                    # this run would not meet again, and a work-stealing
                    # helper starts from exactly these
                    for site, cap in ck.resolved_caps.items():
                        record.resolved_caps[site] = max(
                            int(cap), int(record.resolved_caps.get(site, 0)))
                    restored = self._restore_carries(ck, record)
                    if restored is not None:
                        carries, k0 = restored, ck.next_chunk
                        CHECKPOINTS.note_resume()
                        self._run_stats["resumes"] += 1
                        self._run_stats["resumed_from_chunk"] = k0
                        # a deadline kill during the resumed stretch
                        # names the resume point (query_tracker embeds
                        # it in the typed [EXCEEDED_TIME_LIMIT] message)
                        try:
                            preempt.resumed_from = k0
                            preempt.resumed_on = active_replica()
                        except AttributeError:
                            pass  # None, or a hook that takes no attributes
                        if task_span is not None:
                            task_span.event("resume", from_chunk=k0, of=K)
            carry_index = {fid: i for i, (_k, fid) in enumerate(record.carry_meta)}
            # the replica's lifecycle hook, the scheduler seat, and the
            # primary side of a work-stealing split
            drain_check = getattr(self.ex, "drain_check", None)
            sched_job = getattr(self.ex, "sched_job", None)
            steal = getattr(self.ex, "steal_ctx", None)
            if steal is not None and steal.mode != "merge":
                steal = None
            with op_span("MeshChunkStep", attempt=attempt, chunks=K):
                for k in range(k0, K):
                    if preempt is not None:
                        preempt(k, K)
                    if drain_check is not None:
                        drain_check()
                    if MESH_FAULT_HOOK is not None:
                        MESH_FAULT_HOOK(k, K)
                    t0 = time.monotonic()
                    self._checked_step(record, k, pctx, carries, carry_index)
                    dt = time.monotonic() - t0
                    self._run_stats["executed_chunk_steps"] += 1
                    METRICS.increment("mesh.chunk_steps")
                    # a completed boundary is a safe snapshot point: the
                    # flag readback synced the device
                    if ckpt_key is not None and (k + 1) % interval == 0 and (k + 1) < K:
                        self._checkpoint(ckpt_key, record, carries, k + 1, K, task_span)
                    if task_span is not None:
                        task_span.event("chunk", index=k, of=K, wall_s=round(dt, 6))
                    # chunk 0 pays the cold start; boundary progress is
                    # only meaningful from the second chunk on
                    if watchdog_s and k >= 1 and dt > watchdog_s:
                        raise MeshStuck(
                            f"mesh chunk {k} made no boundary progress for {dt:.3f}s "
                            f"(stuck_task_interrupt_s={watchdog_s}); retryable on the "
                            "page plane")
                    if steal is not None and (k + 1) == steal.mid and (k + 1) < K:
                        merged = self._steal_merge(record, carries, steal)
                        steal = None
                        if merged is not None:
                            carries[:] = merged
                            self._run_stats["steals"] += 1
                            METRICS.increment("scheduler.steals")
                            if task_span is not None:
                                task_span.event("steal_merge", at_chunk=k + 1, of=K)
                            break  # the helper ran [mid, K)
                    if sched_job is not None and (k + 1) < K:
                        decision = sched_job.boundary(k + 1, K, dt,
                                                      parkable=park_key is not None)
                        if decision == "park":
                            self._park(park_key, record, carries, k + 1, K, task_span,
                                       sched_job)

        if preempt is not None:
            preempt(K, K)
        if record.flush_sps:
            with op_span("MeshFlush", attempt=attempt):
                ctx = dict(pctx)
                for (kind, fid), cb in zip(record.carry_meta, carries):
                    if kind == "ctx":
                        ctx[fid] = cb
                flags = []
                self._run_frags(record, record.flush_sps, self._local_feeds(None), ctx,
                                flags, outs)
                self._check_flags(flags)
        for (kind, fid), c in zip(record.carry_meta, carries):
            if kind == "out":
                outs[fid] = (c, self.repl[fid])
        return {fid: self.ex._shard_pages(batches, rep)
                for fid, (batches, rep) in outs.items()}

    def _run_prelude(self, record, op_span, task_span, attempt: int):
        """(outputs, pctx) of the prelude, with a resident-tier consult:
        a hit reuses the pinned shards and skips the prelude (nothing
        writes into them later: the steps only read pctx, and carries
        are fresh tensors); a miss runs it and pins what it exported
        under the feed tables' generation snapshot. Keyed by the program
        record's key, so an uncached record never pins."""
        rkey = None
        budget_mb = int(getattr(self.session, "resident_pin_budget_mb", 64) or 0)
        if self._last_record_key is not None and budget_mb > 0:
            from trino_tpu_torch.resident import GENERATIONS, RESIDENT

            rkey = ("resident-mesh", self._last_record_key,
                    GENERATIONS.snapshot(self.feed_tables))
            cached = RESIDENT.lookup(rkey)
            if cached is not None:
                if task_span is not None:
                    task_span.event("resident_hit", tier="mesh-prelude")
                self._prelude_resident = True
                return cached
            # an entry under a stale generation is unreachable by key:
            # reclaim its device memory now
            for stale in RESIDENT.entries_for_prefix(("resident-mesh", self._last_record_key)):
                if stale != rkey and RESIDENT.evict(stale) and task_span is not None:
                    task_span.event("resident_evict", tier="mesh-prelude")
        outs: Dict[int, Tuple[Shards, bool]] = {}
        with op_span("MeshPrelude", attempt=attempt):
            ctx: Dict[int, Shards] = {}
            flags: list = []
            self._run_frags(record, record.prelude_sps, self._local_feeds(None), ctx,
                            flags, outs)
            self._check_flags(flags)
        pctx = {fid: ctx[fid] for fid in record.pctx_fids}
        if rkey is not None:
            from trino_tpu_torch.resident import RESIDENT
            from trino_tpu_torch.runtime.memory import batch_bytes

            shards = [b for batches, _ in outs.values() for b in batches]
            shards += [b for batches in pctx.values() for b in batches]
            RESIDENT.configure(budget_mb << 20)
            RESIDENT.pin(rkey, (dict(outs), pctx), sum(batch_bytes(b) for b in shards),
                         set(self.feed_tables))
        return outs, pctx

    def _checkpoint(self, key, record, carries, next_chunk: int, K: int,
                    task_span) -> None:
        """Snapshot the carries to the host checkpoint store as of having
        completed chunks [0, next_chunk). Unlike the reference's
        best-effort snapshot, a failure here propagates: on the card it
        is a device error the run would meet next anyway."""
        from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS

        t0 = time.perf_counter()
        ckpt = self._snapshot(record, carries, next_chunk, K)
        CHECKPOINTS.put(key, ckpt)
        stats = self._run_stats
        stats["checkpoints"] += 1
        stats["checkpoint_bytes"] = sum(c.nbytes() for c in ckpt.carries_host)
        stats["checkpoint_s"] += time.perf_counter() - t0
        if task_span is not None:
            task_span.event("checkpoint", chunk=next_chunk, of=K)
        if CHECKPOINT_PUSH_HOOK is not None:
            CHECKPOINT_PUSH_HOOK(key)

    def _restore_carries(self, ck, record) -> Optional[List[Shards]]:
        """Re-place a checkpoint's host carries on the mesh, shard i's
        on mesh.devices[i] as tensors of its own, re-padding each
        accumulator whose capacity rung grew since the snapshot (live
        rows stay densely packed at the front, so tail padding with dead
        rows is exact). None — start fresh — on a typed disagreement,
        counted in recovery.restore_declined.<reason>: the carry count,
        a carry's shape, or a rung that shrank. Any other error
        propagates (the reference starts fresh on any)."""
        from trino_tpu_torch.runtime.metrics import METRICS

        def decline(reason: str) -> None:
            METRICS.increment(f"recovery.restore_declined.{reason}")
            return None

        n = self.ex.n
        if len(ck.carries_host) != len(record.carry_meta):
            return decline("carry_count")
        out = []
        for (_kind, fid), hc in zip(record.carry_meta, ck.carries_host):
            site = f"carry:f{fid}"
            old_cap = int(ck.resolved_caps.get(site, 0))
            new_cap = int(record.resolved_caps.setdefault(site, old_cap))
            rows = n * old_cap
            if (not old_cap or hc.live.shape[0] != rows
                    or any(d.shape[0] != rows or v.shape != (rows,)
                           for _t, d, v, _dic in hc.columns)):
                return decline("shape")
            if new_cap < old_cap:
                return decline("rung_shrank")  # rows may not fit
            batch = _pad_shards(_host_to_batch(hc), n, old_cap, new_cap)
            out.append(_place(batch, self.ex.mesh.devices, own=True))
        return out

    def _snapshot(self, record, carries, next_chunk: int, K: int):
        """A MeshCheckpoint of `carries` as of chunks [0, next_chunk)."""
        from trino_tpu_torch.recovery.checkpoint import MeshCheckpoint
        from trino_tpu_torch.resident import GENERATIONS

        return MeshCheckpoint(
            next_chunk=next_chunk,
            n_chunks=K,
            chunk_cap=record.chunk_cap,
            resolved_caps=dict(record.resolved_caps),
            carries_host=tuple(_carry_to_host(c) for c in carries),
            tables=self.feed_tables,
            generations=GENERATIONS.snapshot(self.feed_tables),
        )

    def _park(self, key, record, carries: list, next_chunk: int, K: int, task_span,
              job) -> None:
        """Park this run: copy the carries to the host store (accounted
        against park_max_bytes, or the group's share of
        mesh_park_max_bytes), drop every device carry from `carries`,
        wait in the scheduler for the grant, then put the same snapshot
        back into `carries` (each shard's tensors its own) and go on at
        `next_chunk`.

        A budget refusal leaves the carries in place (the query keeps
        the mesh and runs to completion). A typed kill while parked
        (deadline, abandonment) drops the snapshot: a dead query never
        resumes. A mesh fault while parked (a drain) keeps it, so a
        sibling replica restores it."""
        from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS

        ckpt = self._snapshot(record, carries, next_chunk, K)
        budget = int(getattr(self.session, "park_max_bytes", 256 << 20))
        group = None
        pool = int(getattr(self.session, "mesh_park_max_bytes", 0) or 0)
        if pool > 0:
            budget = job.scheduler.park_budget_for(job, pool)
            group = job.group
        if not CHECKPOINTS.park(key, ckpt, budget, group=group):
            job.park_refused()
            if task_span is not None:
                task_span.event("park_refused", chunk=next_chunk, of=K)
            return
        # the snapshot is now the only copy: the parked run holds no
        # carry tensor, so the caching allocator gets the blocks back
        for i in range(len(carries)):
            carries[i] = None
        self._run_stats["parks"] += 1
        if task_span is not None:
            task_span.event("park", chunk=next_chunk, of=K)
        if CHECKPOINT_PUSH_HOOK is not None:
            CHECKPOINT_PUSH_HOOK(key)
        try:
            job.park_wait(next_chunk, K)
        except (MeshStuck, MeshDeviceLost):
            CHECKPOINTS.unpark(key, keep=True)
            raise
        except BaseException:
            CHECKPOINTS.unpark(key, keep=False)
            raise
        # regranted: restore the local snapshot object (this run's feeds
        # are an immutable copy, so its carries stay exact even if a
        # write invalidated the store entry meanwhile)
        restored = self._restore_carries(ckpt, record)
        CHECKPOINTS.unpark(key, keep=True)
        if restored is None:
            raise MeshDeviceLost(f"parked carries failed to restore at chunk {next_chunk}")
        carries[:] = restored
        self._run_stats["unparks"] += 1
        if task_span is not None:
            task_span.event("unpark", chunk=next_chunk, of=K)

    # -- drain-failover work stealing --------------------------------
    def run_steal_helper(self, steal: StealContext) -> None:
        """Helper side of a split: chunks [steal.mid, K) from empty
        carries, published under steal.key for the primary to merge. No
        resume on entry, no periodic checkpoints, no flush and no
        output; it stops at the boundary after steal.cancel is set.
        Whatever it raises is kept in steal.errors (a STEAL_DECLINABLE
        one declines, anything else is raised); `done` is set either
        way."""
        from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS
        from trino_tpu_torch.runtime.metrics import METRICS

        prev_replica = active_replica()
        _ACTIVE_REPLICA.replica = getattr(self.ex, "replica_id", None)
        try:
            record = self._record(dict(steal.caps))
            K = record.n_chunks
            if not (0 < steal.mid < K) or not record.stream_sps:
                return
            pctx: Dict[int, Shards] = {}
            if record.prelude_sps:
                _outs, pctx = self._run_prelude(
                    record, lambda name, **attrs: contextlib.nullcontext(), None, 0)
            carries: List[Optional[Shards]] = [None] * len(record.carry_meta)
            carry_index = {fid: i for i, (_k, fid) in enumerate(record.carry_meta)}
            drain_check = getattr(self.ex, "drain_check", None)
            for k in range(steal.mid, K):
                steal.check_cancel()
                if drain_check is not None:
                    drain_check()
                self._checked_step(record, k, pctx, carries, carry_index)
                METRICS.increment("mesh.chunk_steps")
            CHECKPOINTS.put(steal.key, self._snapshot(record, carries, K, K))
        except BaseException as e:  # kept for the primary (see above)
            steal.errors.append(e)
        finally:
            _ACTIVE_REPLICA.replica = prev_replica
            steal.done.set()

    def _steal_merge(self, record, carries, steal: StealContext) -> Optional[List[Shards]]:
        """Primary side: the helper's [mid, K) carries appended to ours
        (`_merge_out_carry`: live rows are packed at each shard's front
        in chunk order, so the concatenation is the sequential layout).
        None, counted in scheduler.steal_declined.<reason>, on a typed
        disagreement; the primary then runs [mid, K) itself. A helper
        error that is not STEAL_DECLINABLE is raised here."""
        from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS
        from trino_tpu_torch.runtime.metrics import METRICS

        def decline(reason: str) -> None:
            METRICS.increment(f"scheduler.steal_declined.{reason}")
            return None

        if not steal.done.wait(steal.timeout_s):
            return decline("timeout")
        for e in steal.errors:
            if not isinstance(e, STEAL_DECLINABLE):
                raise e
        ck = CHECKPOINTS.get(steal.key)
        CHECKPOINTS.discard(steal.key)
        if steal.errors:
            return decline("helper_fault")
        if ck is None:
            return decline("no_carries")
        if (ck.n_chunks != record.n_chunks or ck.resolved_caps != dict(record.resolved_caps)
                or len(ck.carries_host) != len(record.carry_meta)):
            return decline("caps")
        n = self.ex.n
        merged = []
        for (kind, _fid), mine, theirs in zip(record.carry_meta, carries, ck.carries_host):
            if kind != "out":
                return decline("not_append")
            m = _merge_out_carry(_host_to_batch(_carry_to_host(mine)), _host_to_batch(theirs), n)
            if m is None:
                return decline("disagreement")
            merged.append(_place(m, self.ex.mesh.devices, own=True))
        return merged

    def _checked_step(self, record, k: int, pctx, carries, carry_index) -> None:
        """Chunk k's step, then its overflow flags read back (one
        device->host sync). The flags stay local, so between steps the
        loop holds no tensor but the carries."""
        flags: list = []
        self._step(record, k, pctx, carries, carry_index, flags)
        self._check_flags(flags)

    def _step(self, record, k: int, pctx, carries, carry_index, flags) -> None:
        """Chunk k through the stream fragments, appending each carried
        fragment's contribution to its carry."""
        ctx: Dict[int, Shards] = dict(pctx)
        local_feeds = self._local_feeds(k)
        for sp in record.stream_sps:
            frag = sp.fragment
            vis = _FragVisitor(self.ex, frag.id, local_feeds, ctx, record.resolved_caps,
                               flags)
            batches = vis.visit(frag.root)
            if frag.id not in self.root_child_ids:
                self._emit_exchange(frag, batches, ctx)
            i = carry_index.get(frag.id)
            if i is None:
                continue  # stream->stream link: flows within the step
            kind = record.carry_meta[i][0]
            contribs = batches if kind == "out" else ctx[frag.id]
            if carries[i] is None:
                contrib_cap = max(1, _rows(contribs[0]))
                # start near the expected total contribution, capped so
                # a huge K doesn't pre-allocate the world; the overflow
                # ladder jumps straight to the flagged exact size
                initial = bucket_capacity(max(
                    16, min(record.n_chunks * contrib_cap, max(contrib_cap, 8192))))
                cap = record.resolved_caps.setdefault(f"carry:f{frag.id}", initial)
                carries[i] = [_carry_template(c, cap) for c in contribs]
            new, fl = [], []
            for carry, contrib in zip(carries[i], contribs):
                c2, f = _accumulate(carry, contrib)
                new.append(c2)
                fl.append(f)
            carries[i] = new
            flags.append((f"carry:f{frag.id}", fl))

    def _record_divergences(self, sources, query_span) -> None:
        """Observability at the mesh barrier: each mesh fragment's
        exported row count against the optimizer's estimate, as an
        instant event on the query span, counting `adaptive.divergences`
        past adaptive_replan_threshold. The mesh plane never re-plans
        mid-flight; a divergent query's next execution re-plans through
        the adaptive controller. Never fails the run."""
        try:
            from trino_tpu_torch.adaptive.observer import fragment_estimates, record_observation

            threshold = float(getattr(self.session, "adaptive_replan_threshold", 4.0) or 4.0)
            frag_rows = fragment_estimates(self.ex.catalogs, self.mesh_sps)
            for sp in self.mesh_sps:
                fid = sp.fragment.id
                pages = sources.get(fid)
                if pages is None:
                    continue
                observed = sum(int(p.row_count) for p in pages)
                record_observation(f"mesh-fragment:{fid}", frag_rows.get(fid, 1.0),
                                   observed, threshold, span=query_span)
        except Exception:
            pass  # observability must never fail the run

    def _check_flags(self, flags) -> None:
        """One device->host read of every site's per-shard flags; raise
        _Overflow naming each site whose max over shards is nonzero."""
        if not flags:
            return
        home = self.ex.mesh.devices[0]
        vals = torch.stack([
            torch.stack([f.to(home).to(torch.int64).reshape(()) for f in per_shard])
            for _site, per_shard in flags
        ]).cpu()
        over = vals.max(dim=1).values.tolist()
        sites_over = [(site, int(v)) for (site, _f), v in zip(flags, over) if v]
        if sites_over:
            raise _Overflow(sites_over)

