"""Shard-mesh exchange: hash repartition as a collective.

Counterpart of trino_tpu/parallel/exchange.py. The remote-exchange data
plane (AddExchanges inserting FIXED_HASH repartitions between stages +
the page shuffle, PartitionedOutputOperator.java:46) as every shard
scattering its rows into per-destination blocks and one `all_to_all`
over the shard mesh (parallel/mesh.py) in place of HTTP page streams.

Static-shape discipline: each shard owns R rows and sends at most B rows
to each destination (B bounded by R). Overflow cannot happen when
B == R; smaller B trades memory for a host-visible overflow flag the
caller can react to (grow + retry, like the group table).
"""

from __future__ import annotations

from typing import Sequence

import torch

from trino_tpu_torch.ops import groupby as G
from trino_tpu_torch.ops.gather import take_clip
from trino_tpu_torch.ops.hashing import hash64
from trino_tpu_torch.parallel.mesh import ShardMesh, all_to_all


def partition_for_exchange(
    keys: Sequence[torch.Tensor],
    valids: Sequence[torch.Tensor],
    live: torch.Tensor,
    payloads: Sequence[torch.Tensor],
    n_shards: int,
    block_rows: int,
):
    """Per-shard half of the exchange: scatter one shard's rows into
    (n_shards, block_rows) destination blocks by key hash.

    Returns (key_blocks, valid_blocks, live_blocks, payload_blocks,
    overflowed). The PagePartitioner analogue
    (output/PartitionedOutputOperator.java:191): a stable argsort by
    destination, the slot rank within a destination from searchsorted.
    """
    dev = live.device
    h = hash64(list(keys), list(valids))  # int64 carrier of [0, 2^62)
    target = (h % n_shards).to(torch.int32)
    target = torch.where(live, target, n_shards)  # dead rows go nowhere
    order = torch.sort(target, stable=True).indices
    sorted_target = take_clip(target, order)
    idx = torch.arange(sorted_target.shape[0], dtype=torch.int64, device=dev)
    dest_start = torch.searchsorted(
        sorted_target, torch.arange(n_shards, dtype=torch.int32, device=dev))
    slot = idx - take_clip(dest_start, torch.clamp(sorted_target, 0, n_shards - 1))
    overflowed = torch.any((slot >= block_rows) & (sorted_target < n_shards))
    flat = torch.where(
        sorted_target < n_shards,
        torch.clamp(sorted_target, 0, n_shards - 1).to(torch.int64) * block_rows
        + torch.clamp(slot, 0, block_rows - 1),
        n_shards * block_rows,
    )

    def scatter(col):
        z = torch.zeros(n_shards * block_rows + 1, dtype=col.dtype, device=dev)
        z[flat] = take_clip(col, order)
        return z[:-1].reshape(n_shards, block_rows)

    live_blocks = scatter(live)
    key_blocks = [scatter(k) for k in keys]
    valid_blocks = [scatter(v) for v in valids]
    payload_blocks = [scatter(p) for p in payloads]
    return key_blocks, valid_blocks, live_blocks, payload_blocks, overflowed


def distributed_groupby_step(mesh: ShardMesh, table_capacity: int, n_aggs: int):
    """Build the distributed aggregation step: rows sharded over the
    mesh -> local partial aggregation into a GroupTable -> all_to_all
    hash repartition of the group states -> final aggregation per shard.

    This is the partial -> FIXED_HASH exchange -> final pattern Trino
    plans for every GROUP BY (AddExchanges.java:276 + HashAggregation
    PARTIAL/FINAL steps). Returns step(keys, valids, live, values):
    each argument is a global (n * R,) tensor (keys, valids and values
    lists of them) cut into n shards of R rows, shard s placed on
    mesh.devices[s]. The step returns the shards' (C,) outputs
    concatenated in shard order on mesh.devices[0]: (group_keys,
    group_valids, used, sums, counts, overflowed), every group on
    exactly one shard; a nonzero `overflowed` (one flag a shard) means
    some shard's table filled and the caller reruns at 2x capacity.
    Float sums accumulate in float32, as the reference's do.
    """
    n = mesh.n
    C = table_capacity

    def shard_of(x, s):
        r = x.shape[0] // n
        return x.narrow(0, s * r, r).to(mesh.devices[s])

    def partial(s, keys, valids, live, values):
        gid, table, _ = G.assign_group_ids(keys, valids, live, C)
        sums = [
            G.seg_sum(gid, v, live, C,
                      dtype=torch.float32 if v.dtype.is_floating_point else torch.int64)
            for v in values
        ]
        counts = G.seg_count(gid, live, C)
        # rows = table slots; block == capacity absorbs every slot of a
        # source shard, so the flag stays False by construction
        return partition_for_exchange(
            table.slot_keys, table.slot_valids, table.slot_used,
            sums + [counts], n, C)

    def final(kb, vb, lb, pb):
        fkeys = [k.reshape(-1) for k in kb]
        fvalids = [v.reshape(-1) for v in vb]
        flive = lb.reshape(-1)
        fsums = [p.reshape(-1) for p in pb[:-1]]
        fcounts = pb[-1].reshape(-1)
        fgid, ftable, final_overflow = G.assign_group_ids(fkeys, fvalids, flive, C)
        out_sums = [G.seg_sum(fgid, x, flive, C, dtype=x.dtype) for x in fsums]
        out_counts = G.seg_sum(fgid, fcounts, flive, C, dtype=torch.int64)
        return ftable, out_sums, out_counts, final_overflow

    def step(keys, valids, live, values):
        parts = [
            partial(s, [shard_of(k, s) for k in keys], [shard_of(v, s) for v in valids],
                    shard_of(live, s), [shard_of(v, s) for v in values])
            for s in range(n)
        ]
        ex = [all_to_all(mesh, [p[0][i] for p in parts]) for i in range(len(keys))]
        exv = [all_to_all(mesh, [p[1][i] for p in parts]) for i in range(len(keys))]
        exl = all_to_all(mesh, [p[2] for p in parts])
        exp = [all_to_all(mesh, [p[3][i] for p in parts]) for i in range(len(values) + 1)]
        outs = [final([e[s] for e in ex], [e[s] for e in exv], exl[s], [e[s] for e in exp])
                for s in range(n)]
        overflow = [bool(p[4]) or bool(o[3]) for p, o in zip(parts, outs)]
        home = mesh.devices[0]

        def cat(xs):
            return torch.cat([x.to(home) for x in xs])

        any_overflow = torch.full((n,), int(any(overflow)), dtype=torch.int32, device=home)
        return (
            [cat([o[0].slot_keys[i] for o in outs]) for i in range(len(keys))],
            [cat([o[0].slot_valids[i] for o in outs]) for i in range(len(keys))],
            cat([o[0].slot_used for o in outs]),
            [cat([o[1][i] for o in outs]) for i in range(len(values))],
            cat([o[2] for o in outs]),
            any_overflow,
        )

    return step
