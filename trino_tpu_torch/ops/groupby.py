"""Group-by reducers.

Counterpart of trino_tpu/ops/groupby.py (the GroupByHash + accumulate
analogue). Three reducers share one output contract:

    (group_keys, group_valids, used, results, counts, n_groups, overflowed)

with group arrays of shape (out_capacity,), `results[i]` reducer i's
per-group value and `counts[i]` its non-null contribution count.

- `dense_group_reduce`: plan-time-bounded key domains (dictionary or
  boolean codes) get a mixed-radix slot id, no sort.
- `mxu_group_reduce`: the same slot ids, summed by the hand-written
  grouped-sum kernel (ops/mxu_groupby.py) for the mid-size band.
- `sort_group_reduce`: everything else — a stable sort by the exact key
  (one key) or the reference's 62-bit tuple hash (several keys), then
  segment reductions. Groups come out in the reference's order, dense
  from slot 0, with the same hash-collision detector.

The order statistics of the holistic aggregates (key_order,
grouped_argbest, grouped_percentile, grouped_weighted_percentile,
grouped_count_distinct, grouped_rows_order/_sorted) sort by the same
keys, so their slots align with sort_group_reduce's.

The streaming group table (GroupTable, insert_group_ids,
assign_group_ids, grow_table) is the reference's fixed-capacity
putIfAbsent by linear probing, which the mesh plane's
distributed_groupby_step (parallel/exchange.py) uses. The reference
loops its rounds in a `lax.while_loop`; here each round is a claim
(scatter_reduce amin of the row id over the slot), a verify and an
advance of the losers, looped on the host. Which row of a colliding
set wins a slot is backend-defined in both packages, so slot positions
may differ; the table's contract (same key, same id; distinct keys,
distinct ids; the group count; the overflow flag; the set of slot keys)
is the reference's.

Integer outputs are bit-equal to the reference; float sums may differ
in the last bits (another summation order).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from trino_tpu_torch.ops.gather import take_clip
from trino_tpu_torch.ops.hashing import hash32, hash64
from trino_tpu_torch.ops.sort import _order_value, stable_argsort

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
_DEAD_ROW_HASH = _I64_MAX  # above every 62-bit hash


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.float64 if dt.is_floating_point else torch.int64


def minmax_neutral(dt: torch.dtype, red: str):
    """Identity element of a min/max reducer for a dtype (shared by every
    aggregation path so batch, global and merged states agree)."""
    if dt.is_floating_point:
        return float("inf") if red == "min" else float("-inf")
    if dt == torch.bool:
        return red == "min"
    info = torch.iinfo(dt)
    return info.max if red == "min" else info.min


def _segment_sum(idx, contrib, size: int):
    """Sum contrib into `size` slots by idx (idx == size drops)."""
    z = torch.zeros(size + 1, dtype=contrib.dtype, device=contrib.device)
    return z.index_add_(0, idx, contrib)[:size]


def _segment_extreme(idx, contrib, size: int, red: str):
    """Per-slot min/max with the reducer's identity in empty slots."""
    as_bool = contrib.dtype == torch.bool
    if as_bool:
        contrib = contrib.to(torch.int8)
    z = torch.full(
        (size + 1,), minmax_neutral(contrib.dtype, red), dtype=contrib.dtype,
        device=contrib.device,
    )
    out = z.scatter_reduce(
        0, idx, contrib, "amin" if red == "min" else "amax", include_self=True
    )[:size]
    return out.to(torch.bool) if as_bool else out


# ---------------------------------------------------------------------------
# Streaming group table (GroupByHash putIfAbsent analogue)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GroupTable:
    """Fixed-capacity group table: slot i holds the keys of group id i."""

    slot_keys: List[torch.Tensor]  # each (C,)
    slot_valids: List[torch.Tensor]  # each (C,) bool
    slot_used: torch.Tensor  # (C,) bool

    @property
    def capacity(self) -> int:
        return int(self.slot_used.shape[0])

    def num_groups(self) -> torch.Tensor:
        return torch.sum(self.slot_used)


def _keys_equal(a_keys, a_valids, b_keys, b_valids):
    """GROUP-BY equality: NULL == NULL (IS NOT DISTINCT FROM)."""
    eq = None
    for ak, av, bk, bv in zip(a_keys, a_valids, b_keys, b_valids):
        e = ((ak == bk) & av & bv) | (~av & ~bv)
        eq = e if eq is None else (eq & e)
    return eq


def new_group_table(key_dtypes: Sequence, capacity: int, device="cpu") -> GroupTable:
    """Fresh empty table (host helper for streaming aggregation)."""
    assert capacity & (capacity - 1) == 0
    return GroupTable(
        [torch.zeros(capacity, dtype=dt, device=device) for dt in key_dtypes],
        [torch.zeros(capacity, dtype=torch.bool, device=device) for _ in key_dtypes],
        torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def _set_slots(arr: torch.Tensor, wpos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """arr with arr[wpos] = vals where wpos < C; wpos == C drops (the
    reference's scatter with mode='drop')."""
    ext = torch.cat([arr, arr[:1]])
    ext[wpos] = vals.to(arr.dtype)
    return ext[:-1]


def insert_group_ids(table: GroupTable, keys: Sequence[torch.Tensor],
                     valids: Sequence[torch.Tensor], mask: torch.Tensor):
    """Map each live row to a group id in [0, C), inserting new groups
    into `table` (the putIfAbsent analogue, MultiChannelGroupByHash.java:264).

    Returns (group_ids, table', overflowed). Dead rows get id = C
    (callers scatter with a drop slot). `overflowed` is True if the
    table filled up: the caller rebuilds at 2x capacity (rehash).
    Rounds: unresolved rows read their probe slot; a matching key takes
    it, an empty slot is claimed by the smallest row id wanting it
    (losers retry the same slot next round), an occupied slot with
    another key advances the probe."""
    C = table.capacity
    n = keys[0].shape[0]
    dev = mask.device
    keys, valids = list(keys), list(valids)
    h = hash32(keys, valids) & (C - 1)
    slot_keys = list(table.slot_keys)
    slot_valids = list(table.slot_valids)
    slot_used = table.slot_used
    gid = torch.where(mask, -1, C).to(torch.int64)
    probe = torch.zeros(n, dtype=torch.int64, device=dev)
    row_id = torch.arange(n, dtype=torch.int64, device=dev)
    it = 0
    while it < C + 2 and bool(torch.any(gid < 0)):
        active = gid < 0
        pos = (h + probe) & (C - 1)
        occ = take_clip(slot_used, pos)
        slot_k = [take_clip(sk, pos) for sk in slot_keys]
        slot_v = [take_clip(sv, pos) for sv in slot_valids]
        match = occ & _keys_equal(slot_k, slot_v, keys, valids)
        gid = torch.where(active & match, pos, gid)
        want = active & ~occ & ~match
        claim = torch.full((C + 1,), n, dtype=torch.int64, device=dev)
        claim = claim.scatter_reduce(0, torch.where(want, pos, C), row_id, "amin")
        winner = want & (take_clip(claim, pos) == row_id)
        wpos = torch.where(winner, pos, C)
        for i in range(len(keys)):
            slot_keys[i] = _set_slots(slot_keys[i], wpos, keys[i])
            slot_valids[i] = _set_slots(slot_valids[i], wpos, valids[i])
        slot_used = _set_slots(slot_used, wpos, torch.ones_like(winner))
        gid = torch.where(winner, pos, gid)
        probe = torch.where(active & occ & ~match, probe + 1, probe)
        it += 1
    overflowed = torch.any(gid < 0)
    gid = torch.where(gid < 0, C, gid).to(torch.int32)
    return gid, GroupTable(slot_keys, slot_valids, slot_used), overflowed


def assign_group_ids(keys: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                     mask: torch.Tensor, capacity: int):
    """One-shot form: insert a single batch into a fresh table."""
    table = new_group_table([k.dtype for k in keys], capacity, mask.device)
    return insert_group_ids(table, keys, valids, mask)


def grow_table(table: GroupTable, new_capacity: int):
    """Rebuild at a larger capacity, the tryRehash analogue
    (MultiChannelGroupByHash.java:350). Returns (new_table, remap) where
    remap[old_slot] = new group id (or new_capacity for unused slots) so
    callers migrate accumulator state with a scatter."""
    remap, table2, overflowed = insert_group_ids(
        new_group_table([k.dtype for k in table.slot_keys], new_capacity,
                        table.slot_used.device),
        table.slot_keys, table.slot_valids, table.slot_used,
    )
    assert not bool(overflowed)
    return table2, remap


# ---------------------------------------------------------------------------
# Masked segment accumulators (GroupedAccumulator analogue)
# ---------------------------------------------------------------------------


def seg_sum(gid, values, weight_mask, capacity, dtype=None):
    dtype = dtype or values.dtype
    contrib = torch.where(
        weight_mask, values.to(dtype), torch.zeros((), dtype=dtype, device=values.device)
    )
    return _segment_sum(gid.to(torch.int64), contrib, capacity)


def seg_count(gid, weight_mask, capacity):
    return _segment_sum(gid.to(torch.int64), weight_mask.to(torch.int64), capacity)


def seg_min(gid, values, weight_mask, capacity):
    big = torch.tensor(minmax_neutral(values.dtype, "min"), dtype=values.dtype, device=values.device)
    contrib = torch.where(weight_mask, values, big)
    return _segment_extreme(gid.to(torch.int64), contrib, capacity, "min")


def seg_max(gid, values, weight_mask, capacity):
    small = torch.tensor(minmax_neutral(values.dtype, "max"), dtype=values.dtype, device=values.device)
    contrib = torch.where(weight_mask, values, small)
    return _segment_extreme(gid.to(torch.int64), contrib, capacity, "max")


def seg_any(gid, flags, weight_mask, capacity):
    return _segment_extreme(
        gid.to(torch.int64), flags & weight_mask, capacity, "max"
    )


# ---------------------------------------------------------------------------
# Bounded-domain reducers
# ---------------------------------------------------------------------------


def _dense_gid(keys, valids, mask, dims, radices):
    """Mixed-radix dense group id for plan-time-bounded key domains;
    NULL takes the extra digit d. Returns (gid, out_of_domain) where
    out_of_domain flags a live valid code outside [0, d)."""
    n = mask.shape[0]
    gid = torch.zeros(n, dtype=torch.int32, device=mask.device)
    out_of_domain = torch.zeros((), dtype=torch.bool, device=mask.device)
    for k, v, d, r in zip(keys, valids, dims, radices):
        raw = k.to(torch.int32)
        out_of_domain = out_of_domain | torch.any(
            mask & v & ((raw < 0) | (raw >= d))
        )
        code = torch.clamp(raw, 0, d - 1)
        code = torch.where(v, code, torch.full_like(code, d))
        gid = gid * r + code
    return gid, out_of_domain


def _decode_slots(keys, dims, radices, total, out_capacity, device):
    """Slot -> key codes/valids (mixed radix, last key fastest)."""
    rem = torch.arange(total, dtype=torch.int32, device=device)
    digits = []
    for r in reversed(radices):
        digits.append(rem % r)
        rem = rem // r
    digits.reverse()
    group_keys, group_valids = [], []
    for k, d, digit in zip(keys, dims, digits):
        group_keys.append(_pad(torch.clamp(digit, 0, d - 1).to(k.dtype), out_capacity))
        group_valids.append(_pad(digit < d, out_capacity, False))
    return group_keys, group_valids


def _pad(x, out_capacity: int, fill=0):
    extra = out_capacity - x.shape[0]
    if extra <= 0:
        return x
    return torch.cat(
        [x, torch.full((extra,), fill, dtype=x.dtype, device=x.device)]
    )


def _radices(dims, out_capacity):
    radices = tuple(d + 1 for d in dims)  # one extra slot per key: NULL
    total = 1
    for r in radices:
        total *= r
    assert total <= out_capacity
    return radices, total


def dense_group_reduce(
    keys: Sequence[torch.Tensor],
    valids: Sequence[torch.Tensor],
    mask: torch.Tensor,
    values: Sequence[torch.Tensor],
    value_valids: Sequence[Optional[torch.Tensor]],
    reducers: tuple,
    dims: tuple,
    out_capacity: int,
):
    """Group-reduce for plan-time-bounded key domains: the group id is
    the mixed-radix composition of the codes; each reducer scatters into
    the domain's slots. Slot positions, not dense-from-zero ids."""
    radices, total = _radices(dims, out_capacity)
    gid, out_of_domain = _dense_gid(keys, valids, mask, dims, radices)
    gid = gid.to(torch.int64)
    group_keys, group_valids = _decode_slots(
        keys, dims, radices, total, out_capacity, mask.device
    )
    results, counts = [], []
    for v, vv, red in zip(values, value_valids, reducers):
        w = mask if vv is None else (mask & vv)
        idx = torch.where(w, gid, total)
        cnt = _segment_sum(idx, w.to(torch.int64), total)
        if red == "count":
            out = cnt
        elif red == "sum":
            acc = _acc_dtype(v.dtype)
            out = _segment_sum(idx, v.to(acc), total)
        elif red in ("min", "max"):
            out = _segment_extreme(idx, v, total, red)
        else:
            raise ValueError(red)
        results.append(_pad(out, out_capacity))
        counts.append(_pad(cnt, out_capacity))
    row_cnt = _segment_sum(
        torch.where(mask, gid, total), mask.to(torch.int64), total
    )
    used = _pad(row_cnt > 0, out_capacity, False)
    n_groups = torch.sum(used.to(torch.int32))
    return group_keys, group_valids, used, results, counts, n_groups, out_of_domain


def mxu_group_reduce(
    keys: Sequence[torch.Tensor],
    valids: Sequence[torch.Tensor],
    mask: torch.Tensor,
    values: Sequence[torch.Tensor],
    value_valids: Sequence[Optional[torch.Tensor]],
    reducers: tuple,
    dims: tuple,
    out_capacity: int,
):
    """dense_group_reduce's contract, summed by the grouped-sum kernel
    (ops/mxu_groupby.py). Reducers in {sum, count}; integer-kind value
    dtypes. Past MAX_ROWS it falls back to the sort path, as the
    reference does."""
    from trino_tpu_torch.ops.mxu_groupby import MAX_ROWS, grouped_sum

    assert all(r in ("sum", "count") for r in reducers), reducers
    if mask.shape[0] > MAX_ROWS:
        return sort_group_reduce(
            tuple(keys), tuple(valids), mask, tuple(values),
            tuple(value_valids), reducers, out_capacity,
        )
    radices, total = _radices(dims, out_capacity)
    gid, out_of_domain = _dense_gid(keys, valids, mask, dims, radices)

    # per aggregate: one valid-count column plus a zero-masked value
    # column (for count reducers the count IS the value), written
    # straight into the kernel's (k, n) input
    col_of_value, col_of_count = [], []
    k = 0
    for red in reducers:
        col_of_count.append(k)
        col_of_value.append(k + 1 if red == "sum" else k)
        k += 2 if red == "sum" else 1
    cols = torch.empty((k, mask.shape[0]), dtype=torch.int64, device=mask.device)
    for v, vv, red, ci, vi in zip(
        values, value_valids, reducers, col_of_count, col_of_value
    ):
        w = mask if vv is None else (mask & vv)
        cols[ci] = w
        if red == "sum":
            torch.mul(v, w, out=cols[vi])
    sums = grouped_sum(gid, cols, mask, total)
    row_count = sums[-1]
    group_keys, group_valids = _decode_slots(
        keys, dims, radices, total, out_capacity, mask.device
    )
    results = [_pad(sums[i], out_capacity) for i in col_of_value]
    counts = [_pad(sums[i], out_capacity) for i in col_of_count]
    used = _pad(row_count > 0, out_capacity, False)
    n_groups = torch.sum(used.to(torch.int32))
    return group_keys, group_valids, used, results, counts, n_groups, out_of_domain


# ---------------------------------------------------------------------------
# Sort-based group-reduce
# ---------------------------------------------------------------------------


def _order_seed(out_capacity: int) -> int:
    """Hash seed tied to the retry capacity: every overflow doubling
    also reseeds, so a detected 62-bit hash collision cannot recur."""
    return out_capacity.bit_length() * 0x9E37


def _group_hash(keys, valids, mask, seed: int):
    """62-bit key-tuple hash (NULL == NULL), dead rows forced last."""
    if keys:
        h = hash64(list(keys), list(valids), seed=seed)
    else:
        h = torch.zeros(mask.shape[0], dtype=torch.int64, device=mask.device)
    return torch.where(mask, h, torch.full_like(h, _DEAD_ROW_HASH))


def split_limb_keys(keys, valids):
    """Expand long-decimal (n, 2) limb-pair keys into two int64 lanes."""
    if not any(k.dim() == 2 for k in keys):
        return tuple(keys), tuple(valids)
    nk, nv = [], []
    for k, v in zip(keys, valids):
        if k.dim() == 2:
            nk.extend([k[:, 0], k[:, 1]])
            nv.extend([v, v])
        else:
            nk.append(k)
            nv.append(v)
    return tuple(nk), tuple(nv)


def _eq_vals(a, b):
    """Grouping equality: NaN equals NaN."""
    eq = a == b
    if a.dtype.is_floating_point:
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return eq


def _roll1(x):
    return torch.roll(x, 1, 0)


def sort_group_reduce(
    keys: Sequence[torch.Tensor],
    valids: Sequence[torch.Tensor],
    mask: torch.Tensor,
    values: Sequence[torch.Tensor],
    value_valids: Sequence[Optional[torch.Tensor]],
    reducers: tuple,
    out_capacity: int,
):
    """Group by `keys` and reduce each value column in one pass
    (reducers: sum | count | min | max | first | min128h/l | max128h/l).
    Groups are dense from slot 0 in the reference's order: (class, key)
    for a single key, the 62-bit tuple hash for several."""
    n = mask.shape[0]
    dev = mask.device
    seed = _order_seed(out_capacity)
    key_lanes = [2 if k.dim() == 2 else 1 for k in keys]
    keys, valids = split_limb_keys(keys, valids)
    single_key = len(keys) == 1

    if single_key:
        k, v = keys[0], valids[0]
        kb = _order_value(k, False) if k.dtype.is_floating_point else k
        if kb.dtype == torch.bool:
            kb = kb.to(torch.int8)
        kb = torch.where(v & mask, kb, torch.zeros((), dtype=kb.dtype, device=dev))
        cls = torch.where(
            mask, torch.where(v, 0, 1), 2
        ).to(torch.int8)
        order = stable_argsort(kb)
        order = take_clip(order, stable_argsort(take_clip(cls, order)))
        s_cls = take_clip(cls, order)
        s_kb = take_clip(kb, order)
        sm = s_cls < 2
        changed = (s_cls != _roll1(s_cls)) | ~_eq_vals(s_kb, _roll1(s_kb))
        first = torch.arange(n, device=dev) == 0
        boundary = sm & (first | changed)
        collision = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        hm = _group_hash(keys, valids, mask, seed)
        order = stable_argsort(hm)
        hs = take_clip(hm, order)
        sm = hs != _DEAD_ROW_HASH
        first = torch.arange(n, device=dev) == 0
        boundary = sm & (first | (hs != _roll1(hs)))
        if keys:
            h2s = take_clip(
                hash32(list(keys), list(valids), seed=seed + 0x7F4A), order
            )
            collision = torch.any(sm & ~boundary & (h2s != _roll1(h2s)))
        else:
            collision = torch.zeros((), dtype=torch.bool, device=dev)

    # segment ordinal per sorted row; slots past the capacity drop
    g = torch.cumsum(boundary.to(torch.int64), 0) - 1
    in_cap = (g >= 0) & (g < out_capacity)
    seg = torch.where(in_cap, g, out_capacity)
    n_groups = torch.sum(boundary.to(torch.int32))
    overflowed = (n_groups > out_capacity) | collision
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    starts = torch.full((out_capacity + 1,), n, dtype=torch.int64, device=dev)
    starts = starts.scatter(
        0, torch.where(boundary, seg, out_capacity), pos
    )[:out_capacity]
    used = starts < n
    safe_starts = torch.clamp(starts, 0, max(n - 1, 0))

    if single_key:
        if keys[0].dtype.is_floating_point:
            kvals = take_clip(keys[0], take_clip(order, safe_starts))
        else:
            kvals = take_clip(s_kb, safe_starts).to(keys[0].dtype)
        zero_k = torch.zeros((), dtype=keys[0].dtype, device=dev)
        group_keys = [torch.where(used, kvals, zero_k)]
        group_valids = [(take_clip(s_cls, safe_starts) == 0) & used]
    else:
        group_keys, group_valids = [], []
        for k, v in zip(keys, valids):
            sk = take_clip(take_clip(k, order), safe_starts)
            sv = take_clip(take_clip(v, order), safe_starts)
            group_keys.append(
                torch.where(used, sk, torch.zeros((), dtype=k.dtype, device=dev))
            )
            group_valids.append(sv & used)

    seg_live = torch.where(sm, seg, out_capacity)
    seg_rows = _segment_sum(seg_live, torch.ones(n, dtype=torch.int64, device=dev), out_capacity)

    results, counts = [], []
    for i, (val, vv, red) in enumerate(zip(values, value_valids, reducers)):
        svv = None if vv is None else take_clip(vv, order)
        w = sm if svv is None else (sm & svv)
        idx = torch.where(w, seg, out_capacity)
        cnt = seg_rows if svv is None else _segment_sum(
            idx, torch.ones(n, dtype=torch.int64, device=dev), out_capacity
        )
        counts.append(cnt)
        if red == "count":
            results.append(cnt)
            continue
        sv_ = take_clip(val, order)
        if red == "sum":
            out = _segment_sum(idx, sv_.to(_acc_dtype(sv_.dtype)), out_capacity)
        elif red in ("min", "max"):
            out = _segment_extreme(idx, sv_, out_capacity, red)
        elif red in ("min128h", "max128h"):
            out = _segment_extreme(idx, sv_, out_capacity, red[:3])
        elif red in ("min128l", "max128l"):
            # low limb: unsigned extreme among rows whose high limb
            # equals the group's extreme (Int128 lexicographic order)
            base = red[:3]
            hi_idx = max(j for j in range(i) if reducers[j] == f"{base}128h")
            s_hi = take_clip(values[hi_idx], order)
            hi_row = take_clip(results[hi_idx], torch.clamp(g, 0, out_capacity - 1))
            sel = w & (s_hi == hi_row)
            sidx = torch.where(sel, seg, out_capacity)
            out = _segment_extreme(sidx, sv_ ^ _I64_MIN, out_capacity, base) ^ _I64_MIN
        elif red == "first":
            first_pos = torch.full((out_capacity + 1,), n, dtype=torch.int64, device=dev)
            first_pos = first_pos.scatter_reduce(
                0, idx, pos, "amin", include_self=True
            )[:out_capacity]
            out = take_clip(sv_, first_pos)
        else:
            raise ValueError(red)
        results.append(out)

    if any(l == 2 for l in key_lanes):
        gk2, gv2 = [], []
        i = 0
        for l in key_lanes:
            if l == 2:
                gk2.append(torch.stack([group_keys[i], group_keys[i + 1]], dim=-1))
            else:
                gk2.append(group_keys[i])
            gv2.append(group_valids[i])
            i += l
        group_keys, group_valids = gk2, gv2
    return group_keys, group_valids, used, results, counts, n_groups, overflowed


# ---------------------------------------------------------------------------
# Order-statistic (holistic) grouped aggregates: min_by/max_by,
# approx_percentile and its pctl_merge half, approx_distinct, and the
# group-contiguous row order listagg reads. Each sorts by the grouping
# keys exactly as sort_group_reduce orders its groups, so per-slot
# outputs align with its group slots.
# ---------------------------------------------------------------------------


def _key_order(keys, valids, mask, order=None, seed: int = 0):
    """Stable permutation grouping equal key tuples (NULL == NULL), live
    rows first, groups in sort_group_reduce's order: (class, key) for a
    single key, the 62-bit tuple hash for several. An incoming `order`
    is the least-significant pre-ordering (the within-group value
    order of the order statistics)."""
    keys, valids = split_limb_keys(keys, valids)
    n = mask.shape[0]
    dev = mask.device
    if order is None:
        order = torch.arange(n, dtype=torch.int64, device=dev)
    if len(keys) == 1:
        k, v = keys[0], valids[0]
        kb = _order_value(k, False) if k.dtype.is_floating_point else k
        if kb.dtype == torch.bool:
            kb = kb.to(torch.int8)
        kb = torch.where(v & mask, kb, torch.zeros((), dtype=kb.dtype, device=dev))
        cls = torch.where(mask, torch.where(v, 0, 1), 2).to(torch.int8)
        order = take_clip(order, stable_argsort(take_clip(kb, order)))
        return take_clip(order, stable_argsort(take_clip(cls, order)))
    hm = _group_hash(keys, valids, mask, seed)
    return take_clip(order, stable_argsort(take_clip(hm, order)))


def key_order(keys, valids, mask, out_capacity: int = 0):
    """The grouping sort permutation, for callers that compute several
    order statistics over the same keys and capacity (the capacity
    seeds the group hash, so it must match the reducers')."""
    return _key_order(keys, valids, mask, seed=_order_seed(out_capacity))


def _segment_bounds(sk, sv, sm, n: int, out_capacity: int):
    """Segment geometry over key-sorted rows: boundary flags, then per
    slot (starts, safe_starts, ends, used), n_groups and overflowed."""
    dev = sm.device
    same = None
    for k, v in zip(sk, sv):
        eq = (_eq_vals(k, _roll1(k)) & v & _roll1(v)) | (~v & ~_roll1(v))
        same = eq if same is None else (same & eq)
    if same is None:  # no keys: one segment
        same = torch.ones(n, dtype=torch.bool, device=dev)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    first_row = pos == 0
    prev_live = _roll1(sm) & ~first_row
    boundary = sm & (first_row | ~same | ~prev_live)
    n_groups = torch.sum(boundary.to(torch.int32))
    overflowed = n_groups > out_capacity
    sidx = torch.where(boundary, pos, n)
    starts = torch.sort(sidx).values[:out_capacity]
    starts = _pad(starts, out_capacity, n)
    used = starts < n
    safe_starts = torch.clamp(starts, 0, max(n - 1, 0))
    next_starts = torch.cat([starts[1:], torch.full((1,), n, dtype=torch.int64, device=dev)])
    ends = torch.clamp(torch.where(used, next_starts, 1) - 1, 0, max(n - 1, 0))
    return boundary, starts, safe_starts, ends, used, n_groups, overflowed


def _seg_id(boundary):
    """Per sorted row, its segment ordinal (-1 before the first)."""
    return torch.cumsum(boundary.to(torch.int64), 0) - 1


def _seg_slot(boundary, out_capacity: int):
    """Per sorted row, its slot, or out_capacity (dropped) outside."""
    g = _seg_id(boundary)
    return torch.where((g >= 0) & (g < out_capacity), g, out_capacity)


def _seg_reduce(red: str, contrib, boundary, out_capacity: int):
    """Per-segment min/max, the reducer's identity in empty slots."""
    return _segment_extreme(_seg_slot(boundary, out_capacity), contrib, out_capacity, red)


def _seg_first_pos(flag, boundary, n: int, out_capacity: int):
    """Per segment, the first sorted row where `flag` holds; n where
    none does."""
    idx = torch.where(flag, _seg_slot(boundary, out_capacity), out_capacity)
    pos = torch.arange(n, dtype=torch.int64, device=flag.device)
    first = torch.full((out_capacity + 1,), n, dtype=torch.int64, device=flag.device)
    return first.scatter_reduce(0, idx, pos, "amin", include_self=True)[:out_capacity]


def _value_pre_order(x, x_valid):
    """Rows by x ascending (floats by their order value), NULL x last."""
    n = x.shape[0]
    xv = torch.ones(n, dtype=torch.bool, device=x.device) if x_valid is None else x_valid
    pre = stable_argsort(_order_value(x, False))
    return take_clip(pre, stable_argsort(take_clip(~xv, pre))), xv


def _sorted_segments(keys, valids, mask, out_capacity: int, order=None, pre=None):
    """Group-sort the rows (optionally after a pre-ordering) and return
    (order, sorted live mask, segment geometry)."""
    n = mask.shape[0]
    keys, valids = split_limb_keys(keys, valids)
    if order is None:
        order = _key_order(keys, valids, mask, order=pre, seed=_order_seed(out_capacity))
    sm = take_clip(mask, order)
    sk = [take_clip(k, order) for k in keys]
    sv = [take_clip(v, order) for v in valids]
    return order, sm, _segment_bounds(sk, sv, sm, n, out_capacity)


def grouped_argbest(keys, valids, mask, by, by_valid, x, x_valid, kind: str,
                    out_capacity: int, order=None):
    """min_by/max_by: x at the row with the smallest/largest non-NULL
    `by` per group; ties keep the first row in sort order. Int128 (n, 2)
    `by` compares lexicographically (signed high limb, unsigned low);
    (n, 2) `x` gathers row-wise. Returns (x_data, x_valid) aligned with
    sort_group_reduce's group slots."""
    n = mask.shape[0]
    dev = mask.device
    order, sm, (boundary, _, _, _, used, _, _) = _sorted_segments(
        keys, valids, mask, out_capacity, order=order)
    w = sm if by_valid is None else (sm & take_clip(by_valid, order))
    s_x = take_clip(x, order)
    s_xv = (torch.ones(n, dtype=torch.bool, device=dev) if x_valid is None
            else take_clip(x_valid, order))
    g = _seg_id(boundary)
    red = "min" if kind == "min_by" else "max"
    if by.dim() == 2:
        s_bh = take_clip(by[:, 0], order)
        s_bl = take_clip(by[:, 1], order)
        neutral = torch.tensor(_I64_MAX if kind == "min_by" else _I64_MIN,
                               dtype=torch.int64, device=dev)
        best_h = _seg_reduce(red, torch.where(w, s_bh, neutral), boundary, out_capacity)
        at_h = w & (s_bh == take_clip(best_h, g))
        lo_u = s_bl ^ _I64_MIN
        best_l = _seg_reduce(red, torch.where(at_h, lo_u, neutral), boundary, out_capacity)
        is_best = at_h & (lo_u == take_clip(best_l, g))
    else:
        s_by = take_clip(by, order)
        neutral = torch.tensor(minmax_neutral(s_by.dtype, red), dtype=s_by.dtype, device=dev)
        nb = torch.where(w, s_by, neutral)
        best = _seg_reduce(red, nb, boundary, out_capacity)
        is_best = w & (nb == take_clip(best, g))
    pos = _seg_first_pos(is_best, boundary, n, out_capacity)
    out_x = take_clip(s_x, pos)
    out_valid = (pos < n) & take_clip(s_xv, pos) & used
    used_b = used[:, None] if out_x.dim() == 2 else used
    return torch.where(used_b, out_x, torch.zeros((), dtype=out_x.dtype, device=dev)), out_valid


def _segment_rank_of(fraction: float, total):
    """Nearest rank floor(fraction * (total - 1) + 0.5), clipped into
    [0, total - 1]."""
    r = torch.floor(fraction * (total - 1).to(torch.float64) + 0.5).to(torch.int64)
    return torch.minimum(torch.clamp(r, min=0), torch.clamp(total - 1, min=0))


def grouped_weighted_percentile(keys, valids, mask, mn, mn_valid, cnt, mx,
                                fraction: float, out_capacity: int):
    """Percentile over per-bucket summaries (count, min, max), the merge
    half of the mergeable approx_percentile: weights are element counts
    and the estimate interpolates between the chosen bucket's min and
    max. Returns (data, valid) aligned with sort_group_reduce's slots."""
    n = mask.shape[0]
    dev = mask.device
    pre, mv = _value_pre_order(mn, mn_valid)
    order, sm, (boundary, _, safe_starts, ends, used, _, _) = _sorted_segments(
        keys, valids, mask, out_capacity, pre=pre)
    w = sm & take_clip(mv, order)
    s_mn = take_clip(mn, order)
    s_mx = take_clip(mx, order)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    s_c = torch.where(w, take_clip(cnt, order).to(torch.int64), zero)
    cum = torch.cumsum(s_c, 0)
    cum_ex = cum - s_c
    total = take_clip(cum, ends) - take_clip(cum_ex, safe_starts)
    rank = _segment_rank_of(fraction, total)
    g = _seg_id(boundary)
    cum_in = cum - take_clip(take_clip(cum_ex, safe_starts), g)
    hit = w & (cum_in > take_clip(rank, g))
    pos = _seg_first_pos(hit, boundary, n, out_capacity)
    safe_pos = torch.clamp(pos, 0, max(n - 1, 0))
    c_at = torch.clamp(take_clip(s_c, safe_pos), min=1)
    p_in = rank - (take_clip(cum_in, safe_pos) - c_at)
    lo_v = take_clip(s_mn, safe_pos).to(torch.float64)
    hi_v = take_clip(s_mx, safe_pos).to(torch.float64)
    frac_in = torch.where(
        c_at > 1,
        p_in.to(torch.float64) / (c_at - 1).to(torch.float64),
        torch.zeros((), dtype=torch.float64, device=dev),
    )
    est = lo_v + (hi_v - lo_v) * frac_in
    if mn.dtype.is_floating_point:
        out = est.to(mn.dtype)
    else:
        out = (torch.sign(est) * torch.floor(torch.abs(est) + 0.5)).to(mn.dtype)
    valid = used & (total > 0) & (pos < n)
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=dev)), valid


def grouped_percentile(keys, valids, mask, x, x_valid, fraction: float,
                       out_capacity: int):
    """approx_percentile(x, fraction) per group, exact by nearest rank
    over the sorted segment; NULL x rows are excluded. Returns (data,
    valid) aligned with sort_group_reduce's group slots."""
    n = mask.shape[0]
    dev = mask.device
    pre, xv = _value_pre_order(x, x_valid)
    order, sm, (_, _, safe_starts, ends, used, _, _) = _sorted_segments(
        keys, valids, mask, out_capacity, pre=pre)
    w = (sm & take_clip(xv, order)).to(torch.int64)
    s_x = take_clip(x, order)
    cnt_c = torch.cumsum(w, 0)
    cnt = take_clip(cnt_c, ends) - take_clip(cnt_c - w, safe_starts)
    # the valid rows lead each segment (NULL x sorted to its tail)
    idx = torch.clamp(safe_starts + _segment_rank_of(fraction, cnt), 0, max(n - 1, 0))
    out = take_clip(s_x, idx)
    valid = used & (cnt > 0)
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=dev)), valid


def grouped_count_distinct(keys, valids, mask, x, x_valid, out_capacity: int):
    """Distinct non-NULL x per group (approx_distinct's holistic path,
    exact). Rows pre-order by (valid first, x ascending), so a distinct
    value is a valid row at a group boundary or where x changes."""
    n = mask.shape[0]
    dev = mask.device
    xb = _order_value(x, False) if x.dtype.is_floating_point else x
    pre, xv = _value_pre_order(xb, x_valid)
    order, sm, (boundary, _, safe_starts, ends, used, _, _) = _sorted_segments(
        keys, valids, mask, out_capacity, pre=pre)
    sx = take_clip(xb, order)
    sxv = take_clip(xv, order) & sm
    first = torch.arange(n, device=dev) == 0
    flag = (sxv & (boundary | first | ~_eq_vals(sx, _roll1(sx)))).to(torch.int64)
    c = torch.cumsum(flag, 0)
    cnt = take_clip(c, ends) - take_clip(c - flag, safe_starts)
    return torch.where(used, cnt, torch.zeros((), dtype=torch.int64, device=dev))


def grouped_rows_order(keys, valids, mask, x, x_valid, out_capacity: int):
    """Rows grouped and value-ordered, for host-side assembly: returns
    (dense group id per sorted row, sorted live mask, order, n_groups,
    overflowed); the dense ids index sort_group_reduce's slots."""
    pre, _ = _value_pre_order(x, x_valid)
    order, sm, (boundary, _, _, _, _, n_groups, overflowed) = _sorted_segments(
        keys, valids, mask, out_capacity, pre=pre)
    return _seg_id(boundary), sm, order, n_groups, overflowed


def grouped_rows_sorted(keys, valids, mask, x, x_valid, out_capacity: int):
    """grouped_rows_order with x gathered into that order: (dense group
    id, weight = live and non-NULL x, sorted x, n_groups, overflowed)."""
    gid, sm, order, n_groups, overflowed = grouped_rows_order(
        keys, valids, mask, x, x_valid, out_capacity)
    n = mask.shape[0]
    xv = torch.ones(n, dtype=torch.bool, device=mask.device) if x_valid is None else x_valid
    w = sm & take_clip(xv, order)
    return gid, w, take_clip(x, order), n_groups, overflowed
