"""On-card smoke test of trino_tpu_torch: build, check and drive the port.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. identity  — the card's name and power limit (nvidia-smi) and the
                 torch device name.
  2. build     — nvcc builds every kernel from csrc/, one process per
                 source, all started together.
  3. kernel    — each kernel against its plain PyTorch version on the
                 card, bit-exact, at the explorers' shapes and at edge
                 shapes; kernel, plain and one-library-call times beside
                 the bound.
  4. main      — LocalQueryRunner(device="cuda") answers TPC-H Q1, Q6 and
                 the bounded-domain GROUP BY (Q-MXU) at sf1 cold, and the
                 joins Q3 and Q18 at sf1 cold and warm; kernel launch
                 counts are read per query (each join run launches the
                 bounds kernel once per probe batch, the run-owner fill
                 and the flat gather, and no searched rank; Q1/Q6/Q-MXU
                 launch no join kernel); Q-MXU rolled up over (shipmode,
                 shipinstruct) must equal Q1, and Q18 must agree with the
                 join-free group-by of lineitem.
  5. explore   — both explorer entry points (trino_tpu_torch.explore),
                 each output held against its plain version.
  6. parity    — the queries at tpch.tiny, and Q3/Q18 at sf0.1, on the
                 card and on the CPU must be row-equal.
  7. summary   — each kind of join-path call (the probe's bounds, the
                 expansion's run owners, the flat gather) timed on the
                 largest arguments the main path gave it, a `kernels` JSON
                 line, the card line, then the result line
                 {"ok": true, "device": {...}} last.

`--phases` picks a subset (comma-separated) for a quick check.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM: device memory rate (NVIDIA data sheet), and the INT32 issue
# rate outside the tensor cores: 64 INT32 lanes per SM per clock (Hopper
# architecture whitepaper) x 132 SMs x 1.98 GHz boost. An int64 add
# counts as two 32-bit ops.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

Q_MXU = """select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       count(*) as count_order
from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
order by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct"""

Q1 = """select
    l_returnflag, l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus"""

Q6 = """select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.06 - 0.01 and 0.06 + 0.01
  and l_quantity < 24"""

Q3 = """select
    l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10"""

Q18 = """select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (
        select l_orderkey
        from lineitem
        group by l_orderkey
        having sum(l_quantity) > 300)
  and c_custkey = o_custkey
  and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100"""

# Q18's answer by the join-free route: every order's total quantity
Q18_CHECK = """select l_orderkey, sum(l_quantity) from lineitem
group by 1 having sum(l_quantity) > 300"""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int, mode: str = "cold") -> float:
    """Mean ms of one call on the card (CUDA events after a warm-up);
    by default each call alone after the L2 was emptied, the time to hold
    against a bound on device-memory bytes (explore.device_ms's modes)."""
    from trino_tpu_torch.explore import device_ms

    return device_ms(fn, iters, mode)


def timings(rec: dict, iters: int, kernel, wrapper, plain, library,
            plain_iters: int = 0) -> None:
    """The timed keys of a kernel record: `ms` the bare launch cold,
    `warm_ms` back to back with inputs warm in L2, `wrapper_ms` the
    wrapper called from Python one call after another (its host cost),
    `plain_ms` and `library_ms` (one PyTorch call, None where there is
    none) cold."""
    rec["ms"] = time_ms(kernel, iters)
    rec["warm_ms"] = time_ms(kernel, iters, "warm")
    rec["wrapper_ms"] = time_ms(wrapper, iters, "host")
    rec["plain_ms"] = time_ms(plain, plain_iters or iters)
    rec["library_ms"] = time_ms(library, iters) if library else None


# ---------------------------------------------------------------------------
# phase 3: grouped_sum against its plain version
# ---------------------------------------------------------------------------


def grouped_sum_inputs(n, k, capacity, seed, dead_frac=0.0, extreme=False,
                       out_of_range=0, ids="even"):
    """ids: "even" (drawn evenly over the slots), "one_slot" (every row
    in slot 0), "sorted" (the even ids sorted, so long runs of one slot)
    or "q_mxu" (explore.q_mxu_like_ids)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gid = rng.integers(0, capacity, n, dtype=np.int32)
    if ids == "one_slot":
        gid[:] = 0
    elif ids == "sorted":
        gid.sort()
    elif ids == "q_mxu":
        from trino_tpu_torch.explore import q_mxu_like_ids

        gid = q_mxu_like_ids(rng, n)
    if out_of_range:
        # live rows with ids outside [0, capacity) must add nothing
        pos = rng.choice(n, size=out_of_range, replace=False)
        gid[pos] = np.where(rng.random(out_of_range) < 0.5, -1, capacity)
    live = rng.random(n) >= dead_frac
    if extreme:
        big = np.int64(2 ** 63 - 1)
        vals = np.where(
            rng.random((k, n)) < 0.5, big - rng.integers(0, 1000, (k, n)),
            -big - 1 + rng.integers(0, 1000, (k, n)),
        ).astype(np.int64)
    else:
        vals = rng.integers(-(10 ** 12), 10 ** 12, (k, n), dtype=np.int64)
    dev = torch.device("cuda")
    return (
        torch.from_numpy(gid).to(dev),
        torch.from_numpy(vals).to(dev),
        torch.from_numpy(live).to(dev),
    )


def grouped_sum_bound_ms(n: int, n_used: int, k: int, capacity: int) -> tuple:
    """(bound_ms, bound_by): bytes read once (gid and live for all n
    rows, k values for the n_used live, in-range rows) and written once
    ((k+1) x capacity sums) over the memory rate, against (k+1) int64
    adds per used row over the INT32 rate."""
    bytes_moved = n * (4 + 1) + n_used * 8 * k + (k + 1) * capacity * 8
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_used * (k + 1) / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_grouped_sum(n, k, capacity, seed, iters=0, args=None, **kw):
    """Holds the kernel against its plain version on (gid, values, live):
    `args` when given (captured from the main path), else inputs made
    from `seed`. With `iters`, also times kernel, plain version and one
    index_add_ call."""
    import torch
    from trino_tpu_torch.ops import mxu_groupby as M

    gid, vals, live = args or grouped_sum_inputs(n, k, capacity, seed, **kw)
    got = M.grouped_sum(gid, vals, live, capacity)
    want = M.grouped_sum_reference(gid, vals, live, capacity)
    torch.cuda.synchronize()
    # exact integer contract: any differing element fails the phase
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"grouped_sum disagrees with its plain version at "
                f"n={n} k={k} capacity={capacity}"
            )
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    used = live & (gid >= 0) & (gid < capacity)
    n_used = int(used.sum())
    rec = {"n": n, "k": k, "capacity": capacity, "max_abs_err": err,
           "live_rows": n_used,
           "column_chunks": -(-(k + 1) // M.columns_per_block(k + 1, capacity))}
    if iters:
        rec["ms"] = time_ms(lambda: M.grouped_sum(gid, vals, live, capacity), iters)
        rec["plain_ms"] = time_ms(
            lambda: M.grouped_sum_reference(gid, vals, live, capacity), iters
        )
        g64 = torch.where(used, gid.to(torch.int64), capacity)
        src = vals.T

        def library():
            return torch.zeros(
                (capacity + 1, k), dtype=torch.int64, device=gid.device
            ).index_add_(0, g64, src)

        rec["library_ms"] = time_ms(library, iters)
        # what one streaming read of the values costs: a PyTorch sum over
        # each value column (the bytes the kernel must read, nothing else)
        rec["stream_ms"] = time_ms(lambda: vals.sum(dim=1), iters)
        rec["bound_ms"], rec["bound_by"] = grouped_sum_bound_ms(
            n, n_used, k, capacity)
        # contention: rows per slot, and how many of a warp's 32 rows
        # share one slot, on average over warps
        hits = torch.bincount(gid[used].to(torch.int64), minlength=capacity)
        rec["slots_hit"] = int((hits > 0).sum())
        # slots one tile of the kernel touches: how much its sort gathers
        tiles = -(-n // M.TILE_ROWS)
        tile_of = torch.arange(n, device=gid.device) // M.TILE_ROWS
        pairs = torch.unique((tile_of * capacity + gid.to(torch.int64))[used])
        per_tile = torch.bincount(pairs // capacity, minlength=tiles)
        rec["tile_slots_mean"] = float(per_tile.float().mean())
        rec["tile_slots_max"] = int(per_tile.max())
        rec["top_slot_share"] = float(hits.max()) / max(n_used, 1)
        w = n // 32 * 32
        g = torch.where(used[:w], gid[:w].to(torch.int64), -1).view(-1, 32)
        g, _ = torch.sort(g, dim=1)
        run = torch.ones_like(g)
        for j in range(1, 32):
            same = (g[:, j] == g[:, j - 1]) & (g[:, j] >= 0)
            run[:, j] = torch.where(same, run[:, j - 1] + 1, 1)
        run = torch.where(g >= 0, run, 0)
        rec["warp_max_same_slot"] = float(run.max(dim=1).values.float().mean())
    return rec


def phase_kernel(results: dict) -> None:
    shapes = [
        ("q_mxu_sf1", dict(n=4_194_304, k=13, capacity=480, seed=1, iters=20)),
        ("dead_rows", dict(n=1001, k=2, capacity=17, seed=2, dead_frac=0.3)),
        ("column_split", dict(n=1 << 20, k=13, capacity=2048, seed=3, iters=20)),
        ("one_column", dict(n=1 << 20, k=1, capacity=480, seed=4)),
        ("wraparound", dict(n=1 << 16, k=3, capacity=64, seed=5, extreme=True)),
        ("out_of_range_ids", dict(n=5000, k=2, capacity=100, seed=6,
                                  out_of_range=500)),
        # the shapes a per-tile sort finds hard: one hot slot, long runs,
        # ragged tiles, and ids shaped like the query's
        ("one_slot", dict(n=1 << 20, k=13, capacity=480, seed=8, ids="one_slot",
                          iters=20)),
        ("sorted_runs", dict(n=4_194_304, k=13, capacity=480, seed=9, ids="sorted",
                             iters=20)),
        ("tile_plus_one", dict(n=4097, k=13, capacity=480, seed=10, dead_frac=0.1)),
        ("three_rows", dict(n=3, k=13, capacity=480, seed=11)),
        ("q_mxu_like_ids", dict(n=4_194_304, k=13, capacity=480, seed=12, ids="q_mxu",
                                iters=20)),
    ]
    recs = {}
    for name, kw in shapes:
        rec = check_grouped_sum(**kw)
        recs[name] = rec
        line = (f"[kernel] grouped_sum {name}: n={rec['n']} k={rec['k']} "
                f"capacity={rec['capacity']} chunks={rec['column_chunks']} "
                f"bit-exact")
        if "ms" in rec:
            line += " " + timing_text(rec)
        log(line)
    results["grouped_sum_checks"] = recs


def timing_text(rec: dict) -> str:
    return (f"ms={rec['ms']} plain_ms={rec['plain_ms']} "
            f"library_ms={rec['library_ms']} stream_ms={rec['stream_ms']} "
            f"bound_us={rec['bound_ms'] * 1e3} ({rec['bound_by']}) "
            f"live_rows={rec['live_rows']} slots_hit={rec['slots_hit']} "
            f"tile_slots_mean={rec['tile_slots_mean']} "
            f"tile_slots_max={rec['tile_slots_max']} "
            f"top_slot_share={rec['top_slot_share']} "
            f"warp_max_same_slot={rec['warp_max_same_slot']}")


# ---------------------------------------------------------------------------
# phase 3: the rank and gather kernels against their plain versions
# ---------------------------------------------------------------------------

# name -> (source, the TPU kernel it replaces)
NEW_KERNELS = {
    "window_rank": ("trino_tpu_torch/csrc/window_rank.cu",
                    "benchmarks/explore_kernel_costs.py:42"),
    "take_flat": ("trino_tpu_torch/csrc/gather.cu",
                  "benchmarks/explore_pallas_gather.py:59"),
    "take_rows_sum": ("trino_tpu_torch/csrc/gather.cu",
                      "benchmarks/explore_pallas_gather.py:88"),
    "take_along_lanes": ("trino_tpu_torch/csrc/gather.cu",
                         "benchmarks/explore_pallas_gather.py:117"),
}
DEAD_HASH, NO_MATCH_HASH = 0xFFFFFFFF, 0xFFFFFFFE


def bound(bytes_moved: int, int_ops: int) -> tuple:
    """(bound_ms, bound_by): bytes over the memory rate against 32-bit
    operations over the INT32 rate, the larger of the two."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def held(name: str, got, want) -> int:
    """Exact agreement of a kernel with its plain version; returns the
    largest absolute difference (0)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name} disagrees with its plain version")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def rank_bound(n_a: int, n_b: int, elem: int, searched: bool, w0: int = 0,
               nwin: int = 1) -> tuple:
    """Fixed mode: one compare and one add per (element, window position
    in range), an int64 compare counting two ops. Searched mode: one
    compare and one select per bisection step over the window heads and
    inside the window. Bytes: a, the part of b the mode reads, out."""
    per = 2 if elem == 4 else 3
    if searched:
        steps = (-(-n_b // 128)).bit_length() + 8
        return bound(n_a * (elem + 4) + n_b * elem, n_a * steps * per)
    m = max(0, min(n_b - w0 * 128, nwin * 128))
    return bound(n_a * (elem + 4) + m * elem, n_a * m * per)


def check_rank(name, a, b, searched, w0=0, nwin=1, edge=False, iters=0,
               library=True) -> dict:
    import torch
    from trino_tpu_torch.ops import window_rank as W

    got = W.rank(a, b, searched, w0, nwin, edge)
    want = W.rank_reference(a, b, searched, w0, nwin, edge)
    torch.cuda.synchronize()
    rec = {"case": name, "n_a": a.numel(), "n_b": int(b.shape[0]),
           "dtype": str(a.dtype), "mode": "searched" if searched else "fixed",
           "nwin": nwin, "max_abs_err": held(f"window_rank {name}", got, want)}
    if searched:
        # the searched mode is the lower bound #{b < a}
        lb = torch.searchsorted(b, a.reshape(-1)).to(torch.int32).reshape(a.shape)
        if not torch.equal(got, lb):
            raise AssertionError(f"window_rank {name}: not the lower bound")
    if iters:
        timings(rec, iters, W.launcher(a, b, searched, w0, nwin, edge)[0],
                lambda: W.rank(a, b, searched, w0, nwin, edge),
                lambda: W.rank_reference(a, b, searched, w0, nwin, edge),
                (lambda: torch.searchsorted(b, a)) if searched and library else None,
                max(1, iters // 10))
        rec["bound_ms"], rec["bound_by"] = rank_bound(
            a.numel(), int(b.shape[0]), a.element_size(), searched, w0, nwin)
    return rec


def check_bounds(name, q, b, iters=0) -> dict:
    """The bounds kernel against its plain version (two lower bounds)
    and against torch.searchsorted, left and right (q below the type's
    maximum). With `iters`, times kernel, wrapper, plain version and the
    two searchsorted calls."""
    import torch
    from trino_tpu_torch.ops import window_rank as W

    lo, hi = W.bounds(q, b)
    want_lo, want_hi = W.bounds_reference(q, b)
    torch.cuda.synchronize()
    rec = {"case": name, "n_a": q.numel(), "n_b": int(b.shape[0]),
           "dtype": str(q.dtype), "mode": "bounds",
           "max_abs_err": max(held(f"bounds {name} lo", lo, want_lo),
                              held(f"bounds {name} hi", hi, want_hi))}
    for got, right in ((lo, False), (hi, True)):
        if not torch.equal(got, torch.searchsorted(b, q, right=right, out_int32=True)):
            raise AssertionError(f"bounds {name}: not searchsorted(right={right})")
    if iters:
        def library():
            torch.searchsorted(b, q, out_int32=True)
            torch.searchsorted(b, q, right=True, out_int32=True)

        timings(rec, iters, W.bounds_launcher(q, b)[0], lambda: W.bounds(q, b),
                lambda: W.bounds_reference(q, b), library, max(1, iters // 10))
        elem, n, n_b = q.element_size(), q.numel(), int(b.shape[0])
        steps = (-(-n_b // 128)).bit_length() + 8 + 2  # heads, window, gallop
        rec["bound_ms"], rec["bound_by"] = bound(
            n * (elem + 8) + n_b * elem, n * steps * (2 if elem == 4 else 3))
    return rec


def check_run_owner(name, off, n_out, iters=0) -> dict:
    """The run-owner kernel against its plain version and against
    torch.searchsorted(off, arange(n_out), right=True). With `iters`,
    times kernel, wrapper, plain version and that searchsorted call (on
    an arange made beforehand)."""
    import torch
    from trino_tpu_torch.ops import window_rank as W

    got = W.run_owner(off, n_out)
    want = W.run_owner_reference(off, n_out)
    torch.cuda.synchronize()
    j = torch.arange(n_out, dtype=torch.int32, device=off.device)
    rec = {"case": name, "n_a": n_out, "n_b": int(off.shape[0]),
           "dtype": str(off.dtype), "mode": "run_owner",
           "max_abs_err": held(f"run_owner {name}", got, want)}
    if not torch.equal(got, torch.searchsorted(off, j, right=True, out_int32=True)):
        raise AssertionError(f"run_owner {name}: not searchsorted(right=True)")
    if iters:
        timings(rec, iters, W.run_owner_launcher(off, n_out)[0],
                lambda: W.run_owner(off, n_out), lambda: W.run_owner_reference(off, n_out),
                lambda: torch.searchsorted(off, j, right=True, out_int32=True),
                max(1, iters // 10))
        # off read once, out written once; the fill computes nothing
        rec["bound_ms"], rec["bound_by"] = bound(4 * (int(off.shape[0]) + n_out), 0)
    return rec


def run_owner_offsets(counts):
    """Inclusive int32 cumulative sum of numpy counts, on the card."""
    import numpy as np
    import torch

    return torch.from_numpy(np.cumsum(counts).astype(np.int32)).to("cuda")


def check_take_flat(name, table, idx, iters=0) -> dict:
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK

    got = GK.take_flat(table, idx)
    want = GK.take_flat_reference(table, idx)
    torch.cuda.synchronize()
    rec = {"case": name, "n_table": int(table.shape[0]), "n": idx.numel(),
           "elem_bytes": table.element_size(), "idx_bytes": idx.element_size(),
           "max_abs_err": held(f"take_flat {name}", got, want)}
    if iters:
        n = idx.numel()
        in_range = bool(((idx >= 0) & (idx < table.shape[0])).all())
        # torch.take computes the same function when no index clips
        idx64 = idx.to(torch.int64)  # torch.take indexes with int64 only
        timings(rec, iters, GK.flat_launcher(table, idx)[0], lambda: GK.take_flat(table, idx),
                lambda: GK.take_flat_reference(table, idx),
                (lambda: torch.take(table, idx64)) if in_range else None)
        rec["bound_ms"], rec["bound_by"] = bound(
            n * (idx.element_size() + table.element_size())
            + int(table.shape[0]) * table.element_size(), 0)
    return rec


def check_take_rows_sum(name, table2d, ridx, iters=0) -> dict:
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK

    got = GK.take_rows_sum(table2d, ridx)
    want = GK.take_rows_sum_reference(table2d, ridx)
    torch.cuda.synchronize()
    rows, width = int(table2d.shape[0]), int(table2d.shape[1])
    n = ridx.numel()
    rec = {"case": name, "rows": rows, "width": width, "n": n,
           "path": GK.rows_sum_path(rows, n),
           "max_abs_err": held(f"take_rows_sum {name}", got, want)}
    if iters:
        # no single PyTorch call sums gathered rows
        timings(rec, iters, GK.rows_sum_launcher(table2d, ridx)[0],
                lambda: GK.take_rows_sum(table2d, ridx),
                lambda: GK.take_rows_sum_reference(table2d, ridx), None)
        # the least work: each index read and each output written once,
        # and each row an output needs summed once (at most n of them)
        needed = min(rows, n)
        rec["bound_ms"], rec["bound_by"] = bound(
            n * (ridx.element_size() + 4) + needed * width * 4, needed * (width - 1))
    return rec


def check_take_along_lanes(name, src, sel, iters=0) -> dict:
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK

    got = GK.take_along_lanes(src, sel)
    want = GK.take_along_lanes_reference(src, sel)
    torch.cuda.synchronize()
    rec = {"case": name, "rows": int(src.shape[0]), "width": int(src.shape[1]),
           "max_abs_err": held(f"take_along_lanes {name}", got, want)}
    if iters:
        sel64 = sel.to(torch.int64)
        timings(rec, iters, GK.along_launcher(src, sel)[0],
                lambda: GK.take_along_lanes(src, sel),
                lambda: GK.take_along_lanes_reference(src, sel),
                lambda: torch.gather(src, 1, sel64))
        rec["bound_ms"], rec["bound_by"] = bound(src.numel() * 4 * 3, 0)
    return rec


def phase_kernel_join(results: dict) -> None:
    """The four kernels of this slice at the explorers' shapes and at
    edge shapes: ragged lengths, empty inputs, clipped indices, the
    join's sentinel hashes and int64 values beyond 2^32."""
    import numpy as np
    import torch
    from trino_tpu_torch.explore import kernel_costs, pallas_gather

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    recs = {k: [] for k in NEW_KERNELS}
    # -- window rank: the explorer's k0..k4, then edges --
    at, b = kernel_costs.make_inputs(dev)
    for tag, nwin, edge in kernel_costs.VARIANTS[2:]:  # v0, v1 == v2
        recs["window_rank"].append(check_rank(
            f"explorer {tag}", at, b, False, 0, nwin, edge, iters=20))
    a_r = t(rng.integers(-(1 << 31), (1 << 31) - 1, 1001).astype(np.int32))
    b_r = t(rng.integers(-(1 << 31), (1 << 31) - 1, 1000).astype(np.int32))
    recs["window_rank"] += [
        check_rank("ragged fixed w0=7", a_r, b_r, False, 7, 2),
        check_rank("ragged fixed edge", a_r, b_r, False, 0, 3, True),
        check_rank("empty a", a_r[:0], b_r, False, 0, 2),
        check_rank("empty b fixed", a_r, b_r[:0], False, 0, 2),
        check_rank("empty b searched", a_r, t(np.zeros(0, np.int32)), True),
    ]
    # the join's u32 hash domain in int64 carriers, sentinels included
    hashes = np.sort(np.concatenate([
        rng.integers(0, 0xFFFFFFFE, 100_003),
        rng.integers(0, 1000, 5000),  # long runs of equal hashes
        np.full(777, DEAD_HASH),
    ])).astype(np.int64)
    probes = np.concatenate([
        rng.integers(0, 1 << 32, 50_001), hashes[::7],
        np.full(33, NO_MATCH_HASH), np.full(3, DEAD_HASH),
    ]).astype(np.int64)
    hb, hp = t(hashes), t(probes)
    recs["window_rank"] += [
        check_rank("hashes lo", hp, hb, True),
        check_rank("hashes hi (q+1)", hp + 1, hb, True),
    ]
    wide = np.sort(rng.integers(-(1 << 40), 1 << 40, 4097)).astype(np.int64)
    recs["window_rank"].append(check_rank(
        "int64 beyond 2^32", t(rng.integers(-(1 << 41), 1 << 41, 3000)), t(wide), True))
    counts = rng.integers(0, 4, 300_000).astype(np.int32)
    off = np.cumsum(counts).astype(np.int32)
    j1 = np.arange(1, int(off[-1]) + 17, dtype=np.int32)
    recs["window_rank"].append(check_rank("offsets int32 (j+1)", t(j1), t(off), True))
    big_b = t(np.sort(rng.integers(0, 0xFFFFFFFE, 1_500_000)).astype(np.int64))
    big_a = t(rng.integers(0, 1 << 32, 4_194_304).astype(np.int64))
    recs["window_rank"].append(check_rank(
        "probe batch 4,194,304 x 1.5M hashes", big_a, big_b, True, iters=20))
    # -- bounds: the probe's (lo, hi) in one launch --
    recs["window_rank"].append(check_bounds(
        "probe batch 4,194,304 x 1.5M hashes", big_a, big_b, iters=20))
    del big_a, big_b
    long_runs = np.sort(np.concatenate([
        rng.integers(0, (1 << 31) - 2, 20_000), np.full(300, 77), np.full(5000, 1 << 30)]))
    for dt in (np.int32, np.int64):
        lr = long_runs.astype(dt)
        q_lr = np.concatenate([rng.integers(0, (1 << 31) - 2, 7001), lr[::3]]).astype(dt)
        recs["window_rank"] += [
            check_bounds(f"runs of 300 and 5000 across windows, {dt.__name__}",
                         t(q_lr), t(lr)),
            check_bounds(f"n_b 77 < 128, {dt.__name__}", t(q_lr[:999] % 60),
                         t(np.sort(rng.integers(0, 50, 77)).astype(dt))),
            check_bounds(f"n_b 1000, ragged, {dt.__name__}", t(q_lr),
                         t(np.sort(rng.integers(0, 1 << 31, 1000)).astype(dt))),
            check_bounds(f"empty b, {dt.__name__}", t(q_lr), t(np.zeros(0, dt))),
            check_bounds(f"empty q, {dt.__name__}", t(q_lr[:0]), t(lr)),
        ]
    recs["window_rank"] += [
        check_bounds("hashes with sentinels", hp, hb),
        check_bounds("int64 beyond 2^32", t(rng.integers(-(1 << 41), 1 << 41, 3000)),
                     t(wide)),
    ]
    # heads past the 200 KB shared-memory budget: every 2^k-th head staged
    many = t(np.sort(rng.integers(0, 1 << 40, 5_000_000)))
    recs["window_rank"].append(check_bounds(
        "5M int64 (heads strided)", t(rng.integers(0, 1 << 40, 1_000_003)), many))
    del many
    # -- run_owner: the expansion's row of each output --
    plateaus = rng.integers(0, 3, 300_000) * (rng.random(300_000) < 0.4)
    one_run = np.zeros(64, np.int64)
    one_run[17], one_run[40:43] = 10_000, 1
    skew = np.zeros(1000, np.int64)
    skew[500] = 3_000_000  # one build key matching three million rows
    empty_stretch = np.zeros(1_000_000, np.int64)  # a million probe rows with
    empty_stretch[::250_000] = 5                   # no match between matches
    recs["window_rank"] += [
        check_run_owner("zero-count plateaus", run_owner_offsets(plateaus),
                        int(plateaus.sum())),
        check_run_owner("n_out past the total", run_owner_offsets(counts),
                        int(counts.sum()) + 333),
        check_run_owner("n_out below the total", run_owner_offsets(counts),
                        int(counts.sum()) // 3),
        check_run_owner("one run of 10,000", run_owner_offsets(one_run), 16_384),
        check_run_owner("one run of 3,000,000", run_owner_offsets(skew), 1 << 22,
                        iters=20),
        check_run_owner("empty runs between runs of 5", run_owner_offsets(empty_stretch),
                        30, iters=20),
        check_run_owner("one row", run_owner_offsets(np.array([3])), 7),
        check_run_owner("no rows", run_owner_offsets(np.zeros(0, np.int64)), 100),
        check_run_owner("no outputs", run_owner_offsets(counts), 0),
    ]
    # the expansion's sf1 shape: 4,194,304 probe rows with one match each
    # and a few hash-collision pairs, into 8,388,608 outputs
    sf1 = 1 + (rng.random(4_194_304) < 0.001)
    recs["window_rank"].append(check_run_owner(
        "expansion 8,388,608 outputs over 4,194,304 offsets",
        run_owner_offsets(sf1), 1 << 23, iters=20))
    # -- gathers: the explorer's shapes, then edges --
    x = pallas_gather.make_inputs(dev)
    table = x["table2d"].reshape(-1)
    recs["take_flat"] += [
        check_take_flat("explorer v1", table, x["idx2d"], iters=20),
        check_take_flat("clipped int32", table[:1001],
                        t(rng.integers(-50, 1100, 4999).astype(np.int32))),
        check_take_flat("int64 beyond 2^32, int64 idx",
                        t(rng.integers(-(1 << 50), 1 << 50, 1000)),
                        t(rng.integers(-3, 1004, 5001))),
        check_take_flat("empty idx", table, t(np.zeros(0, np.int32))),
    ]
    recs["take_rows_sum"] += [
        check_take_rows_sum("explorer v2", x["table2d"], x["ridx2d"], iters=20),
        check_take_rows_sum(
            "wrapping sums, clipped rows",
            t(rng.integers((1 << 31) - 100, (1 << 31) - 1, (33, 128)).astype(np.int32)),
            t(rng.integers(-5, 40, 1001).astype(np.int32))),
        check_take_rows_sum("width 100", t(rng.integers(
            -(1 << 31), (1 << 31) - 1, (17, 100)).astype(np.int32)),
            t(rng.integers(0, 17, 999))),
        check_take_rows_sum("empty", x["table2d"], t(np.zeros(0, np.int32))),
        # more rows than indices: the per-output path
        check_take_rows_sum(
            "1,000,000 rows, 1,000 indices",
            t(rng.integers(-(1 << 31), (1 << 31) - 1, (1_000_000, 128)).astype(np.int32)),
            t(rng.integers(-10, 1_000_010, 1000).astype(np.int32)), iters=20),
        check_take_rows_sum("width 100, more rows than indices", t(rng.integers(
            -(1 << 31), (1 << 31) - 1, (5000, 100)).astype(np.int32)),
            t(rng.integers(-3, 5003, 999))),
        check_take_rows_sum(
            "one row", t(rng.integers(-(1 << 31), (1 << 31) - 1, (1, 128)).astype(np.int32)),
            t(rng.integers(-3, 4, 5000))),
    ]
    # width 128 from a buffer offset by one element: not 16-byte aligned
    odd = torch.empty(1001 * 128 + 1, dtype=torch.int32, device=dev)[1:].view(1001, 128)
    odd.copy_(t(rng.integers(-(1 << 31), (1 << 31) - 1, (1001, 128)).astype(np.int32)))
    recs["take_along_lanes"] += [
        check_take_along_lanes("explorer v3", x["src"], x["sel"], iters=20),
        check_take_along_lanes(
            "1001 rows, clipped selectors",
            t(rng.integers(-(1 << 31), (1 << 31) - 1, (1001, 128)).astype(np.int32)),
            t(rng.integers(-9, 140, (1001, 128)).astype(np.int32))),
        check_take_along_lanes(
            "width 100", t(rng.integers(0, 1 << 30, (999, 100)).astype(np.int32)),
            t(rng.integers(-5, 105, (999, 100)).astype(np.int32))),
        check_take_along_lanes(
            "width 128, unaligned", odd, t(rng.integers(-5, 133, (1001, 128)).astype(np.int32))),
        check_take_along_lanes("empty", x["src"][:0], x["sel"][:0]),
    ]
    for name, rs in recs.items():
        for rec in rs:
            line = f"[kernel] {name} {rec['case']}: bit-exact"
            if "path" in rec:
                line += f" path={rec['path']}"
            if "bound_ms" in rec:
                line += (f" ms={rec['ms']} warm_ms={rec['warm_ms']} "
                         f"wrapper_ms={rec['wrapper_ms']} plain_ms={rec['plain_ms']} "
                         f"library_ms={rec['library_ms']} "
                         f"bound_us={rec['bound_ms'] * 1e3} ({rec['bound_by']})")
            log(line)
    results["join_kernel_checks"] = recs


# ---------------------------------------------------------------------------
# phase 4/5: the engine
# ---------------------------------------------------------------------------


def runner(schema: str, device: str):
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    r = LocalQueryRunner(Session(catalog="tpch", schema=schema), device=device)
    r.register_catalog("tpch", create_tpch_connector())
    return r


class TimedPageSource:
    """Wraps a connector's page source and adds up the host seconds
    spent producing batches (data generation + copy to the card)."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds = 0.0

    def batches(self, *args, **kwargs):
        it = self.inner.batches(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.seconds += time.perf_counter() - t0
            if batch is None:
                return
            yield batch


def scaled(v: float, scale: int) -> int:
    """A decoded decimal back to its exact scaled integer."""
    x = v * 10 ** scale
    r = round(x)
    assert abs(x - r) < 1e-3, (v, scale)
    return r


def launch_counters() -> dict:
    """{name: wrapper function carrying `launches` and `shapes`}; the
    window_rank source has three entry points (searched or fixed rank,
    bounds, run_owner)."""
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import mxu_groupby as M
    from trino_tpu_torch.ops import window_rank as W

    return {"grouped_sum": M.grouped_sum, "window_rank": W.rank, "bounds": W.bounds,
            "run_owner": W.run_owner, "take_flat": GK.take_flat,
            "take_rows_sum": GK.take_rows_sum, "take_along_lanes": GK.take_along_lanes}


def join_kernel_counts() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def reset_kernel_counts() -> None:
    for fn in launch_counters().values():
        fn.launches = 0
        fn.shapes.clear()


class Capture:
    """Wraps a module's function and keeps the arguments of its first
    call per key (argument shapes); `calls` counts the calls whose key is
    not None."""

    def __init__(self, module, attr: str, key):
        self.module, self.attr, self.key = module, attr, key
        self.inner = getattr(module, attr)
        self.args: dict = {}
        self.calls = 0

    def __enter__(self):
        def capturing(*args):
            k = self.key(*args)
            if k is not None:
                self.calls += 1
                self.args.setdefault(k, args)
            return self.inner(*args)

        setattr(self.module, self.attr, capturing)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)

    def largest(self, order=lambda key: key):
        """The arguments whose key is largest under `order`."""
        return max(self.args.items(), key=lambda kv: order(kv[0]))[1] if self.args else None


def run_query(r, scan, name, run, sql, per_query, probes=None) -> list:
    """Runs one query and records its wall, scan seconds, rows and the
    kernel launches it caused; with `probes` (the Capture around
    sorted_run_bounds), also its non-empty probe batches."""
    import torch

    before = join_kernel_counts()
    batches_before = probes.calls if probes else 0
    scan.seconds = 0.0
    t0 = time.perf_counter()
    res = r.execute(sql)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = join_kernel_counts()
    n = {k: after[k] - before[k] for k in after}
    batches = (probes.calls if probes else 0) - batches_before
    per_query[f"{name}_{run}"] = {"wall_s": wall, "scan_s": scan.seconds,
                                  "launches": n, "probe_batches": batches,
                                  "rows": len(res.rows)}
    log(f"[main] {name} {run}: {len(res.rows)} rows, wall_s={wall}, "
        f"scan_s={scan.seconds} (host generation + copy to the card), "
        f"rest_s={wall - scan.seconds}, probe_batches={batches}, launches={n}")
    return res.rows


def phase_main(results: dict) -> None:
    from trino_tpu_torch.connectors.tpch import base_row_count
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import join as TJ
    from trino_tpu_torch.ops import mxu_groupby as M
    from trino_tpu_torch.ops import window_rank as W

    r = runner("sf1", "cuda")
    conn = r.catalogs.get("tpch")
    scan = conn.page_source = TimedPageSource(conn.page_source)
    batches = -(-base_row_count("lineitem", 1.0) // r.session.batch_rows)
    rows, per_query = {}, {}
    # keep the arguments the main path gives each kernel, to time the
    # kernels on the queries' own data afterwards
    gs = Capture(M, "_launch", lambda gid, v, live, cap: (int(gid.shape[0]), int(v.shape[0]), cap))
    bd = Capture(W, "_launch_bounds", lambda q, b: (q.numel(), int(b.shape[0]), q.element_size()))
    ro = Capture(W, "_launch_run_owner", lambda off, n_out: (n_out, int(off.shape[0])))
    tf = Capture(GK, "_launch_flat", lambda table, idx: (
        idx.numel(), int(table.shape[0]), table.element_size()))
    # the probe batches that reach a kernel (both sides non-empty)
    probes = Capture(TJ, "sorted_run_bounds", lambda sorted_arr, q: (
        (q.numel(), int(sorted_arr.shape[0])) if q.numel() and sorted_arr.numel() else None))
    reset_kernel_counts()
    with gs, bd, ro, tf, probes:
        # slice 1's queries run cold only (their warm runs were dropped to
        # keep the script inside its time limit); the joins cold and warm
        for name, sql, runs in (("q1", Q1, ("cold",)), ("q6", Q6, ("cold",)),
                                ("q_mxu", Q_MXU, ("cold",)),
                                ("q3", Q3, ("cold", "warm")),
                                ("q18", Q18, ("cold", "warm"))):
            for run in runs:
                got = run_query(r, scan, name, run, sql, per_query, probes)
                if run == "warm" and got != rows[name]:
                    raise AssertionError(f"{name}: warm rows differ from cold rows")
                rows[name] = got
    results["main_launches"] = join_kernel_counts()
    results["main_shapes"] = sorted(M.grouped_sum.shapes, reverse=True)
    # bounds twice: the call with the most queries, and the one into the
    # largest build side (its search goes deepest)
    results["main_args"] = {"grouped_sum": gs.args, "bounds": bd.largest(),
                            "bounds_largest_build": bd.largest(lambda k: (k[1], k[0])),
                            "run_owner": ro.largest(), "take_flat": tf.largest()}
    results["main_join_shapes"] = {
        name: sorted(launch_counters()[name].shapes, reverse=True)
        for name in ("window_rank", "bounds", "run_owner", "take_flat")}
    results["main"] = per_query
    cross = run_query(r, scan, "q18_check", "cold", Q18_CHECK, per_query)
    for name in ("q1", "q6", "q_mxu", "q3", "q18"):
        for row in rows[name][:6]:
            log(f"[main] {name} row: {row}")
    check_main(rows, per_query, cross, batches)
    log(f"[main] launches over the main path: {results['main_launches']}")


def check_main(rows, per_query, cross, batches) -> None:
    import math

    if per_query["q_mxu_cold"]["launches"]["grouped_sum"] < batches:
        raise AssertionError("Q-MXU launched grouped_sum fewer times than scan batches")
    for q in ("q1_cold", "q6_cold"):
        if per_query[q]["launches"]["grouped_sum"]:
            raise AssertionError("Q1/Q6 are expected on the dense/global routes")
    for q, n in per_query.items():
        launched = n["launches"]
        joins = [launched[k] for k in ("bounds", "run_owner", "take_flat")]
        if q.startswith(("q3_", "q18_")) and not q.startswith("q18_check"):
            if min(joins) <= 0:
                raise AssertionError(f"{q}: the join ran without its kernels {launched}")
            # one bounds launch per probe batch, and no searched rank
            if launched["bounds"] != n["probe_batches"] or launched["window_rank"]:
                raise AssertionError(
                    f"{q}: {launched['bounds']} bounds launches for "
                    f"{n['probe_batches']} probe batches, "
                    f"{launched['window_rank']} rank launches")
        elif q.startswith(("q1_", "q6_", "q_mxu_")) and \
                max(joins + [launched["window_rank"]]) > 0:
            raise AssertionError(f"{q}: join kernels launched on a join-free query")
    # Q-MXU rolled up over (shipmode, shipinstruct) is Q1's measures
    rollup = {}
    for rf, ls, _, _, qty, base, disc, cnt in rows["q_mxu"]:
        acc = rollup.setdefault((rf, ls), [0, 0, 0, 0])
        acc[0] += scaled(qty, 2)
        acc[1] += scaled(base, 2)
        acc[2] += scaled(disc, 4)
        acc[3] += cnt
    q1 = {(row[0], row[1]): [scaled(row[2], 2), scaled(row[3], 2),
                             scaled(row[4], 4), row[9]] for row in rows["q1"]}
    if rollup != q1:
        raise AssertionError(f"Q-MXU roll-up {rollup} != Q1 {q1}")
    if len(rows["q_mxu"]) == 0 or len(rows["q6"]) != 1:
        raise AssertionError("unexpected result sizes")
    # Q3: ten rows, finite revenues in descending order
    rev = [row[1] for row in rows["q3"]]
    if len(rev) != 10 or not all(math.isfinite(v) and v > 0 for v in rev) \
            or rev != sorted(rev, reverse=True):
        raise AssertionError(f"Q3 rows out of shape: {rows['q3']}")
    # Q18 against the join-free route: each row's sum(l_quantity) is its
    # order's total, and the orders are exactly those over 300
    totals = {row[0]: scaled(row[1], 2) for row in cross}
    got = {row[2]: scaled(row[5], 2) for row in rows["q18"]}
    if not got or any(totals.get(k) != v for k, v in got.items()):
        raise AssertionError("Q18 sums differ from the join-free group-by")
    if len(totals) <= 100 and set(got) != set(totals):
        raise AssertionError("Q18 orders differ from the join-free group-by")
    log(f"[main] Q-MXU roll-up equals Q1 over {len(q1)} groups; Q18's "
        f"{len(got)} orders equal the join-free group-by's {len(totals)}")


def phase_explore(results: dict) -> None:
    """Both explorer entry points, with the launch counts they cause."""
    from trino_tpu_torch.explore import kernel_costs, pallas_gather

    reset_kernel_counts()
    recs = {"pallas_gather": pallas_gather.run(), "kernel_costs": kernel_costs.run()}
    counts = join_kernel_counts()
    results["explore"] = recs
    results["explore_launches"] = counts
    bad = [r for rs in recs.values() for r in rs if not r["correct"]]
    if bad:
        raise AssertionError(f"explorer outputs differ from the plain versions: {bad}")
    for k in ("window_rank", "take_flat", "take_rows_sum", "take_along_lanes"):
        if counts[k] <= 0:
            raise AssertionError(f"the explorers never launched {k}")
    log(f"[explore] launches: {counts}")


def phase_parity(results: dict) -> None:
    for schema, queries in (
        ("tiny", (("q1", Q1), ("q6", Q6), ("q_mxu", Q_MXU), ("q3", Q3), ("q18", Q18))),
        ("sf0.1", (("q3", Q3), ("q18", Q18))),
    ):
        gpu, cpu = runner(schema, "cuda"), runner(schema, "cpu")
        for name, sql in queries:
            a, b = gpu.execute(sql).rows, cpu.execute(sql).rows
            if a != b:
                raise AssertionError(f"{name}: card and CPU rows differ at {schema}")
            log(f"[parity] {name} {schema}: {len(a)} rows, card == CPU")


def timed_main_args(results: dict) -> dict:
    """Each kind of join-path call timed on the largest arguments the
    main path gave it: the probe's bounds, the expansion's run owners and
    the flat gather."""
    args = results.get("main_args", {})
    out = {}
    if args.get("bounds"):
        out["bounds"] = check_bounds("main path, most queries", *args["bounds"], iters=20)
    if args.get("bounds_largest_build"):
        out["bounds_largest_build"] = check_bounds(
            "main path, largest build", *args["bounds_largest_build"], iters=20)
    if args.get("run_owner"):
        out["run_owner"] = check_run_owner("main path", *args["run_owner"], iters=20)
    if args.get("take_flat"):
        out["take_flat"] = check_take_flat("main path", *args["take_flat"], iters=20)
    for name, rec in out.items():
        log(f"[kernel] {name} main-path arguments: n={rec.get('n_a', rec.get('n'))} "
            f"n_b={rec.get('n_b', rec.get('n_table'))} "
            f"ms={rec['ms']} warm_ms={rec['warm_ms']} wrapper_ms={rec['wrapper_ms']} "
            f"plain_ms={rec['plain_ms']} "
            f"library_ms={rec['library_ms']} "
            f"bound_us={rec['bound_ms'] * 1e3} ({rec['bound_by']})")
    results["main_arg_join_timings"] = out
    return out


def mode_record(rec: dict, launches: int) -> dict:
    """The numbers of one timed record, as the `kernels` line shows them."""
    return {"launches": launches, "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"), "wrapper_ms": rec.get("wrapper_ms"),
            "warm_ms": rec.get("warm_ms"),
            "shape": {k: v for k, v in rec.items()
                      if k in ("n_a", "n_b", "n", "n_table", "rows", "width", "dtype")}}


def kernels_line(results: dict) -> dict:
    checks = results.get("grouped_sum_checks", {})
    timed = checks.get("q_mxu_sf1", {})
    # time again on the main path's own arguments at each shape it gave
    # the kernel, beside inputs of that shape with ids spread evenly;
    # the line reports the query's own data at the largest shape
    captured = results.get("main_args", {}).get("grouped_sum", {})
    for i, (n, k, cap) in enumerate(results.get("main_shapes", [])):
        rec = check_grouped_sum(n=n, k=k, capacity=cap, seed=7 + i, iters=20,
                                args=captured[(n, k, cap)][:3])
        even = check_grouped_sum(n=n, k=k, capacity=cap, seed=7 + i, iters=20)
        log(f"[kernel] grouped_sum main-path arguments n={n} k={k} "
            f"capacity={cap}: {timing_text(rec)}")
        log(f"[kernel] grouped_sum same shape, ids spread evenly: "
            f"{timing_text(even)}")
        results.setdefault("main_arg_timings", []).append(
            {"main_path": rec, "even_ids": even})
        if i == 0:
            timed = rec
    launches = results.get("main_launches", {})
    line = [{
        "name": "grouped_sum",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/grouped_sum.cu",
        "replaces": "trino_tpu/ops/mxu_groupby.py:77",
        "launches": launches.get("grouped_sum", 0),
        "max_abs_err": max(
            [c["max_abs_err"] for c in checks.values()]
            + [t["main_path"]["max_abs_err"]
               for t in results.get("main_arg_timings", [])], default=0),
        "ms": timed.get("ms"),
        "plain_ms": timed.get("plain_ms"),
        "bound_ms": timed.get("bound_ms"),
        "bound_by": timed.get("bound_by"),
        "library_ms": timed.get("library_ms"),
        "shape": {"n": timed.get("n"), "k": timed.get("k"),
                  "capacity": timed.get("capacity")},
    }]
    join_checks = results.get("join_kernel_checks", {})
    on_path = timed_main_args(results)
    explore_launches = results.get("explore_launches", {})
    for name, (source, replaces) in NEW_KERNELS.items():
        recs = join_checks.get(name, [])
        modes = None
        if name == "window_rank":
            # one source, three entry points: the probe's bounds (the
            # entry's own numbers), the expansion's run owners, and rank
            # (searched: the probe shape of phase kernel; fixed: the
            # explorer's k0, launched by phase explore)
            timed = {m: next((c for c in recs if c.get("mode") == m and "ms" in c), {})
                     for m in ("searched", "fixed")}
            modes = {
                "bounds": mode_record(on_path.get("bounds", {}), launches.get("bounds", 0)),
                "bounds_largest_build": mode_record(on_path.get("bounds_largest_build", {}),
                                                    launches.get("bounds", 0)),
                "run_owner": mode_record(on_path.get("run_owner", {}),
                                         launches.get("run_owner", 0)),
                "searched": mode_record(timed["searched"], launches.get("window_rank", 0)),
                "fixed": mode_record(timed["fixed"], explore_launches.get("window_rank", 0)),
            }
            recs = recs + [on_path[m] for m in ("bounds", "bounds_largest_build", "run_owner")
                           if m in on_path]
            rec = on_path.get("bounds", {})
            n = sum(launches.get(m, 0) for m in ("window_rank", "bounds", "run_owner"))
        elif name in on_path:
            # the join path: its own largest arguments and its launches
            rec, n = on_path[name], launches.get(name, 0)
            recs = recs + [rec]
        else:
            # the explorer entry point is this kernel's only path
            rec = next((c for c in recs if "ms" in c), {})
            n = explore_launches.get(name, 0)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "max_abs_err": max([c["max_abs_err"] for c in recs], default=None),
                 **mode_record(rec, n)}
        if modes:
            entry["modes"] = modes
        line.append(entry)
    return {"kernels": line}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="identity,build,kernel,main,explore,parity",
                    help="comma-separated subset of the phases to run")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from trino_tpu_torch.ops import cuda_build

    results: dict = {}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[identity] nvidia-smi: {card}")
    log(f"[identity] torch: {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    cuda_build.build_all()  # one nvcc per source, all started together
    log(f"[build] {', '.join(f'{n}.cu' for n in cuda_build.SOURCES)} built "
        f"in {time.perf_counter() - t0:.2f} s")
    for name, text in cuda_build.PTXAS_LOG.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line}")
    from trino_tpu_torch.explore import atomic_opcodes

    results["sass_atomics"] = {n: atomic_opcodes(cuda_build.library_path(n))
                               for n in cuda_build.SOURCES}
    for name, ops in results["sass_atomics"].items():
        log(f"[build] {name} SASS atomics: {ops}")
    if "kernel" in phases:
        phase_kernel(results)
        phase_kernel_join(results)
    if "main" in phases:
        phase_main(results)
    if "explore" in phases:
        phase_explore(results)
    if "parity" in phases:
        phase_parity(results)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    line = kernels_line(results)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        results.pop("main_args", None)
        json.dump({"card": card, **results, **line}, fh, indent=1, default=str)
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
