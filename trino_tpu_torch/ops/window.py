"""Window functions: segmented scans over partition-sorted rows.

Counterpart of trino_tpu/ops/window.py (Trino's WindowOperator and its
window function implementations). One multi-key sort puts the rows in
(partition, order) order; every function is then a vectorized segmented
scan over the whole column, with no per-row frame loop. Frames:

- whole partition  (no ORDER BY, or ROWS/RANGE UNBOUNDED..UNBOUNDED)
- running rows     (ROWS UNBOUNDED PRECEDING..CURRENT ROW)
- running range    (the default RANGE frame: current row + peers)

Every function takes `part_start` (True at each partition's first row)
and, where peers matter, `peer_start` (True at each peer group's first
row), both over the sorted row order with dead rows at the tail in a
partition of their own. Indices are int64 (torch's index type); results
are the reference's: int64 ranks and counts, float64 percent_rank and
cume_dist, and running sums by the same global-cumsum formula.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trino_tpu_torch.ops.floatbits import _f32_lane, f64_lanes
from trino_tpu_torch.ops.gather import take_clip

_M32 = 0xFFFFFFFF


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _rows_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a != b
    return d.any(dim=-1) if d.dim() == 2 else d  # long-decimal limb pairs


def segment_starts(part_cols, part_valids, n: int) -> torch.Tensor:
    """True where any partition key differs from the previous row (and
    at row 0). `part_cols` holds at least one column."""
    start = torch.zeros(n, dtype=torch.bool, device=part_cols[0].device)
    if n:
        start[0] = True
    for data, valid in zip(part_cols, part_valids):
        diff = _rows_differ(data, torch.roll(data, 1, 0))
        if valid is not None:
            diff = diff | (valid != torch.roll(valid, 1, 0))
        start = start | diff
    return start


def _seg_start_index(part_start: torch.Tensor) -> torch.Tensor:
    """For each row, the index of its partition's first row."""
    idx = _iota(part_start.shape[0], part_start)
    if idx.numel() == 0:
        return idx
    return torch.cummax(torch.where(part_start, idx, 0), 0).values


def _reverse_cummin(x: torch.Tensor) -> torch.Tensor:
    """Suffix minimum (torch has no reverse cummin)."""
    if x.numel() == 0:
        return x
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def _last_of_run(starts: torch.Tensor) -> torch.Tensor:
    """For each row, the index of the last row before the next start."""
    n = starts.shape[0]
    idx = _iota(n, starts)
    if n == 0:
        return idx
    nxt = torch.roll(starts, -1, 0)
    nxt[n - 1] = True
    return _reverse_cummin(torch.where(nxt, idx, n - 1))


def _seg_end_index(part_start: torch.Tensor) -> torch.Tensor:
    """For each row, the index of its partition's last row."""
    return _last_of_run(part_start)


def _peer_end_index(part_start: torch.Tensor, peer_start: torch.Tensor) -> torch.Tensor:
    return _last_of_run(peer_start | part_start)


def row_number(part_start: torch.Tensor) -> torch.Tensor:
    idx = _iota(part_start.shape[0], part_start)
    return idx - _seg_start_index(part_start) + 1


def rank(part_start: torch.Tensor, peer_start: torch.Tensor) -> torch.Tensor:
    idx = _iota(part_start.shape[0], part_start)
    if idx.numel() == 0:
        return idx
    peer_first = torch.cummax(torch.where(peer_start, idx, 0), 0).values
    return peer_first - _seg_start_index(part_start) + 1


def percent_rank(part_start: torch.Tensor, peer_start: torch.Tensor) -> torch.Tensor:
    """(rank - 1) / (partition rows - 1); 0 for single-row partitions."""
    size = (_seg_end_index(part_start) - _seg_start_index(part_start) + 1).to(
        torch.float64)
    r = rank(part_start, peer_start).to(torch.float64)
    return torch.where(size > 1, (r - 1) / torch.clamp(size - 1, min=1), 0.0)


def cume_dist(part_start: torch.Tensor, peer_start: torch.Tensor) -> torch.Tensor:
    """(rows at or before the current peer group's end) / partition rows."""
    start = _seg_start_index(part_start)
    size = (_seg_end_index(part_start) - start + 1).to(torch.float64)
    end = _peer_end_index(part_start, peer_start)
    return (end - start + 1).to(torch.float64) / size


def dense_rank(part_start: torch.Tensor, peer_start: torch.Tensor) -> torch.Tensor:
    groups = torch.cumsum(peer_start.to(torch.int64), 0)
    at_seg_start = take_clip(groups, _seg_start_index(part_start))
    return groups - at_seg_start + 1


def _running_sum(vals: torch.Tensor, part_start: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive cumulative sum: the global cumsum minus the
    cumsum before each segment's first row (the reference's formula, so
    double sums round alike; integer sums wrap alike)."""
    cs = torch.cumsum(vals, 0)
    seg_start = _seg_start_index(part_start)
    base = take_clip(cs, seg_start) - take_clip(vals, seg_start)
    return cs - base


def _minmax_lanes(vals: torch.Tensor, kind: str):
    """Order-encode values as [0, 2^32) lanes (int64 carriers) whose
    lexicographic order is the value order: doubles through f64_lanes
    (-0.0 == +0.0, NaN largest, as the reference orders them), 64-bit
    integers as offset high and low words. For "min" each lane is
    complemented."""
    if vals.dtype == torch.float64:
        lanes = list(f64_lanes(vals))
    elif vals.dtype == torch.float32:
        lanes = [_f32_lane(vals)]
    elif vals.dtype == torch.bool:
        lanes = [vals.to(torch.int64)]
    else:
        v = vals.to(torch.int64)
        lanes = [((v >> 32) & _M32) ^ 0x80000000, v & _M32]
    if kind == "min":
        lanes = [(~l) & _M32 for l in lanes]
    return lanes


def _scan_minmax(vals: torch.Tensor, part_start: torch.Tensor, kind: str) -> torch.Tensor:
    """Segmented running min/max, as the reference computes it: one
    cummax per order lane over (segment id << 32 | lane), where a later
    segment's id dominates (the reset) and rows not attaining the running
    prefix contribute 0 to later lanes; the last lane is the row index,
    so the result is gathered from the latest row that attains the
    running extreme (which decides between -0.0 and +0.0 as the
    reference does)."""
    n = vals.shape[0]
    if n == 0:
        return vals
    first = _iota(n, vals) == 0
    g = torch.clamp(torch.cumsum(part_start.to(torch.int64), 0) - 1, min=0)
    lanes = _minmax_lanes(vals, kind) + [_iota(n, vals)]
    attained = torch.ones(n, dtype=torch.bool, device=vals.device)
    g_cur = g
    run_lane = None
    for i, lane in enumerate(lanes):
        contrib = torch.where(attained, lane, 0)
        run = torch.cummax((g_cur << 32) | contrib, 0).values
        run_lane = run & _M32
        if i + 1 < len(lanes):
            change = (run != torch.roll(run, 1, 0)) | first
            g_cur = torch.clamp(torch.cumsum(change.to(torch.int64), 0) - 1, min=0)
            attained = attained & (lane == run_lane)
    return take_clip(vals, run_lane)


def windowed_agg(
    kind: str,  # sum | avg | min | max | count | count_star
    vals: Optional[torch.Tensor],
    valid: Optional[torch.Tensor],
    live: torch.Tensor,
    part_start: torch.Tensor,
    peer_start: Optional[torch.Tensor],
    frame: str,  # "partition" | "rows" | "range"
    neutral,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregate over the window frame. Returns (value, count); a count
    of 0 makes sum/min/max/avg NULL, as Trino's aggregate window
    functions."""
    w = live if valid is None else (live & valid)
    cnt_run = _running_sum(w.to(torch.int64), part_start)
    if kind in ("count", "count_star"):
        out_run = cnt_run
    elif kind in ("min", "max"):
        fill = torch.tensor(neutral, dtype=vals.dtype, device=vals.device)
        out_run = _scan_minmax(torch.where(w, vals, fill), part_start, kind)
    else:  # sum / avg accumulate in the wide dtype the caller chose
        out_run = _running_sum(torch.where(w, vals, torch.zeros_like(vals)),
                               part_start)
    if frame == "rows":
        return out_run, cnt_run
    if frame == "partition":
        end = _seg_end_index(part_start)
    else:  # "range": the value at the end of the current peer group
        assert peer_start is not None
        end = _peer_end_index(part_start, peer_start)
    return take_clip(out_run, end), take_clip(cnt_run, end)


def shift_in_partition(
    vals: torch.Tensor,
    valid: Optional[torch.Tensor],
    part_start: torch.Tensor,
    offset: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """lead (offset < 0) / lag (offset > 0): the value `offset` rows
    back, NULL outside the partition."""
    n = vals.shape[0]
    idx = _iota(n, part_start)
    src = torch.clamp(idx - offset, 0, max(n - 1, 0))
    seg = torch.cumsum(part_start.to(torch.int64), 0)
    ok = (idx - offset >= 0) & (idx - offset < n)
    ok = ok & (take_clip(seg, src) == seg)
    out = take_clip(vals, src)  # long-decimal (n, 2) pairs gather row-wise
    return out, ok if valid is None else (ok & take_clip(valid, src))


def value_at(
    vals: torch.Tensor,
    valid: Optional[torch.Tensor],
    index: torch.Tensor,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """first_value/last_value: gather at a per-row frame boundary."""
    out = take_clip(vals, index)
    return out, None if valid is None else take_clip(valid, index)


def _frame_end(part_start, peer_start, frame: str) -> torch.Tensor:
    if frame == "rows":
        return _iota(part_start.shape[0], part_start)
    if frame == "partition":
        return _seg_end_index(part_start)
    return _peer_end_index(part_start, peer_start)


def first_value(vals, valid, part_start):
    return value_at(vals, valid, _seg_start_index(part_start))


def last_value(vals, valid, part_start, peer_start, frame: str):
    return value_at(vals, valid, _frame_end(part_start, peer_start, frame))


def nth_value(vals, valid, part_start, peer_start, frame: str, n: int):
    """nth_value(x, n): frame start + (n - 1), NULL when the frame holds
    fewer than n rows. The frame's end follows last_value."""
    end = _frame_end(part_start, peer_start, frame)
    idx = _seg_start_index(part_start) + (n - 1)
    data, v = value_at(vals, valid, torch.minimum(idx, end))
    in_frame = idx <= end
    return data, in_frame if v is None else (v & in_frame)


def ntile(n_buckets: int, part_start: torch.Tensor) -> torch.Tensor:
    """ntile(n): bucket 1..n by position within the partition; the first
    (size % n) buckets take one row more (Trino's rule)."""
    rn = row_number(part_start) - 1
    size = _seg_end_index(part_start) - _seg_start_index(part_start) + 1
    base = torch.div(size, n_buckets, rounding_mode="floor")
    rem = size % n_buckets
    big = rem * (base + 1)
    bucket = torch.where(
        rn < big,
        torch.div(rn, torch.clamp(base + 1, min=1), rounding_mode="floor"),
        rem + torch.div(rn - big, torch.clamp(base, min=1), rounding_mode="floor"),
    )
    return bucket + 1
