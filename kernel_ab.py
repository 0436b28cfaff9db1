"""Before/after times of the redesigned kernels on one NVIDIA card: two
checkouts of the port, the same inputs, one timing method.

    python3 kernel_ab.py OLD_ROOT NEW_ROOT

Each root's `trino_tpu_torch` runs in a process of its own, in the order
old, new, new, old, so that a drift of the card's clock shows as a gap
between the two runs of one root. The cases, on inputs made from a fixed
seed:

- take_along_lanes at (8192, 128) int32, against torch.gather;
- the probe's run bounds, 4,194,304 random int64 hashes into 1,500,000
  sorted ones: `bounds` where the root has it, else two searched `rank`
  launches (lo, and hi as the lower bound of q + 1); against two
  torch.searchsorted calls;
- the expansion's run owners, 8,388,608 outputs over 4,194,304 offsets,
  and one run of 3,000,000 outputs among 1,000 rows: `run_owner` where
  the root has it, else searched `rank` of arange(1, n_out + 1); against
  torch.searchsorted(right=True);
- grouped_sum (the wrapper, which launches the kernel once) at Q-MXU's
  batch, 4,194,304 rows, k = 13, capacity 480, with ids spread evenly and
  with ids shaped like the query's (112 slots hit,
  `explore.q_mxu_like_ids`), and at 1,048,576 rows, k = 13, capacity
  2048, ids spread evenly (the column split); against one index_add_
  over the (n, k) values and the live count;
- take_rows_sum at the explorer's shape, 1,048,576 int32 indices into a
  (1024, 128) int32 table; against its plain version (no single PyTorch
  call computes it);
- take_flat at the main path's shapes, against torch.take: q72's
  expansion gather, 33,554,432 int32 indices into a 33,554,432-entry
  int32 permutation, the first 18,720,000 (q72's widest join) in runs of
  consecutive positions (lengths 1 to 512, starts uniform) and the rest
  clamped to the tail; the TPC-DS packed lo|start gather, 262,144
  nondecreasing int32 indices into 1,048,576 int64; TPC-H's, 8,388,608
  indices into 4,194,304 int64, each row's output position (rows of one
  or, one in a thousand, two pairs) and the rest clamped to the last row;
  the explorer's, 1,048,576 random int32 indices into a 131,072-entry
  int32 table (`explore.pallas_gather`); and 1,024 of the TPC-DS
  indices, whose time is the launch and two dependent memory latencies
  and next to no bytes. Each record adds the table sectors the indices
  touch and the bound (chip_smoke.flat_sectors, flat_bytes).

Every output is held against the yardstick's before it is timed. Each
run also records the atomic SASS opcodes of its root's built
grouped_sum library (`explore.atomic_opcodes`, cuobjdump).
Whichever root runs, the times and the Q-MXU-like ids come from this
checkout's `trino_tpu_torch/explore/__init__.py` (`device_ms`, cold and
warm).
Prints one JSON line per run, the card's name and power limit, and a
JSON summary last; writes them to chiprun_out/kernel_ab.json. Exits
nonzero without a CUDA card, when a run fails or when an output differs.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ITERS = 20
ORDER = ("old", "new", "new", "old")


def explore_helpers():
    """This checkout's explore module (timing, Q-MXU-like ids), loaded
    from its file so that the root under test provides the kernels and
    nothing else."""
    path = os.path.join(HERE, "trino_tpu_torch", "explore", "__init__.py")
    spec = importlib.util.spec_from_file_location("kernel_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke_helpers():
    """This checkout's chip_smoke.py (the take_flat bound), loaded from its
    file. Load it after the root's package: it puts this checkout first on
    sys.path."""
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flat_cases(rng, t, dev):
    """(name, table, idx) of the take_flat cases, on the card."""
    import numpy as np
    from trino_tpu_torch.explore import pallas_gather

    n, pairs = 1 << 25, 18_720_000
    runs = rng.integers(1, 513, pairs // 128)
    ends = np.cumsum(runs)
    runs = runs[:np.searchsorted(ends, pairs) + 1]
    runs[-1] -= int(runs.sum()) - pairs
    first = np.repeat(np.cumsum(runs) - runs, runs)  # each pair's run start in the output
    idx = np.full(n, n - 1, np.int64)
    idx[:pairs] = np.repeat(rng.integers(0, n - 512, runs.shape[0]), runs) + (
        np.arange(pairs) - first)
    yield ("take_flat, q72 expansion: 33,554,432 int32 idx into an int32 permutation",
           t(rng.permutation(n).astype(np.int32)), t(idx.astype(np.int32)))
    packed = t(rng.integers(0, 1 << 62, 1 << 20))
    sorted_idx = t(np.sort(rng.integers(0, 1 << 20, 1 << 18)).astype(np.int32))
    yield ("take_flat, TPC-DS packed: 262,144 nondecreasing int32 idx into 1,048,576 int64",
           packed, sorted_idx)
    yield ("take_flat, floor: 1,024 of the TPC-DS idx", packed, sorted_idx[::256].clone())
    rows = 1 << 22
    off = np.cumsum(1 + (rng.random(rows) < 0.001))
    owner = np.searchsorted(off, np.arange(1 << 23), side="right")
    yield ("take_flat, TPC-H: 8,388,608 idx into 4,194,304 int64",
           t(rng.integers(0, 1 << 62, rows)), t(np.minimum(owner, rows - 1).astype(np.int32)))
    x = pallas_gather.make_inputs(dev)
    yield ("take_flat, explorer: 1,048,576 int32 idx into 131,072 int32",
           x["table2d"].reshape(-1), x["idx2d"])


def run_one(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import mxu_groupby as M
    from trino_tpu_torch.ops import window_rank as W

    helpers = explore_helpers()
    smoke = smoke_helpers()
    timed = helpers.device_ms
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    new = hasattr(W, "bounds")
    cases = {}

    def case(name, kernel, outs, library, yardstick="library"):
        """Times `kernel` (which fills `outs`) and `library`, after holding
        the outputs equal; the yardstick's keys carry its kind."""
        kernel()
        want = library()
        torch.cuda.synchronize()
        for got, w in zip(outs, want if isinstance(want, tuple) else (want,)):
            if not torch.equal(got, w):
                raise AssertionError(f"{name}: the kernel differs from the {yardstick}")
        cases[name] = {"ms": timed(kernel, ITERS, "cold"), "warm_ms": timed(kernel, ITERS, "warm"),
                       f"{yardstick}_ms": timed(library, ITERS, "cold"),
                       f"{yardstick}_warm_ms": timed(library, ITERS, "warm")}

    src = t(rng.integers(-(1 << 31), (1 << 31) - 1, (8192, 128)).astype(np.int32))
    sel = t(rng.integers(0, 128, (8192, 128)).astype(np.int32))
    sel64 = sel.to(torch.int64)  # torch.gather takes int64 selectors only
    go, out = GK.along_launcher(src, sel)
    case("take_along_lanes (8192, 128)", go, [out], lambda: torch.gather(src, 1, sel64))

    b = t(np.sort(rng.integers(0, 0xFFFFFFFE, 1_500_000)).astype(np.int64))
    q = t(rng.integers(0, 1 << 32, 4_194_304).astype(np.int64))
    if new:
        go, (lo, hi) = W.bounds_launcher(q, b)
    else:
        go_lo, lo = W.launcher(q, b, True)
        go_hi, hi = W.launcher(q + 1, b, True)

        def go():
            go_lo()
            go_hi()
    case("probe bounds, 4,194,304 int64 into 1.5 M", go, [lo, hi],
         lambda: (torch.searchsorted(b, q, out_int32=True),
                  torch.searchsorted(b, q, right=True, out_int32=True)))

    sf1 = 1 + (rng.random(4_194_304) < 0.001)
    skew = np.zeros(1000, np.int64)
    skew[500] = 3_000_000
    for name, counts, n_out in (
            ("run owners, 8,388,608 outputs over 4,194,304 offsets", sf1, 1 << 23),
            ("run owners, one run of 3,000,000 among 1,000 rows", skew, 1 << 22)):
        off = t(np.cumsum(counts).astype(np.int32))
        j = torch.arange(n_out, dtype=torch.int32, device=dev)
        go, out = (W.run_owner_launcher(off, n_out) if new
                   else W.launcher(j + 1, off, True))
        case(name, go, [out],
             lambda off=off, j=j: torch.searchsorted(off, j, right=True, out_int32=True))

    for name, n, k, cap, ids in (
            ("grouped_sum, Q-MXU batch, ids spread evenly", 4_194_304, 13, 480, "even"),
            ("grouped_sum, Q-MXU batch, ids shaped like the query's", 4_194_304, 13, 480,
             "q_mxu"),
            ("grouped_sum, column split, capacity 2048", 1 << 20, 13, 2048, "even")):
        gid = (helpers.q_mxu_like_ids(rng, n) if ids == "q_mxu"
               else rng.integers(0, cap, n).astype(np.int32))
        g, live = t(gid), t(rng.random(n) < 0.98)
        vals = t(rng.integers(-(10 ** 12), 10 ** 12, (k, n)))
        got = [None]

        def kernel(g=g, vals=vals, live=live, cap=cap):
            got[0] = M.grouped_sum(g, vals, live, cap)

        idx = torch.where(live, g.to(torch.int64), cap)
        src = torch.cat([vals, torch.ones((1, n), dtype=torch.int64, device=dev)]).T

        def library(idx=idx, src=src, cap=cap):
            return torch.zeros((cap + 1, src.shape[1]), dtype=torch.int64,
                               device=dev).index_add_(0, idx, src)

        kernel()
        want = library()[:cap].T
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got[0], want.unbind(0))):
            raise AssertionError(f"{name}: the kernel differs from index_add_")
        case(name, kernel, [], library)

    table2d = t(rng.integers(0, 1 << 30, (1024, 128)).astype(np.int32))
    ridx = t(rng.integers(0, 1024, 1 << 20).astype(np.int32))
    go, out = GK.rows_sum_launcher(table2d, ridx)
    case("take_rows_sum, 1,048,576 indices into (1024, 128)", go, [out],
         lambda: GK.take_rows_sum_reference(table2d, ridx), "plain")
    for name, table, idx in flat_cases(rng, t, dev):
        go, out = GK.flat_launcher(table, idx)
        case(name, go, [out], lambda table=table, idx64=idx.long(): torch.take(table, idx64))
        sectors = smoke.flat_sectors(table, idx)
        cases[name]["sectors"] = sectors
        cases[name]["bound_ms"] = smoke.bound(smoke.flat_bytes(
            idx.numel(), idx.element_size(), int(table.shape[0]), table.element_size(),
            sectors), 0)[0]
        del table, idx, out
    lib = os.path.join(root, "trino_tpu_torch", "_build", "libgrouped_sum.so")
    design = {"bounds": new, "grouped_sum_tile_rows": getattr(M, "TILE_ROWS", None),
              "rows_sum_paths": hasattr(GK, "rows_sum_path"),
              "grouped_sum_sass_atomics": helpers.atomic_opcodes(lib)}
    print(json.dumps({"root": root, "design": design, "cases": cases}))
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        return run_one(sys.argv[2])
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    roots = {"old": sys.argv[1], "new": sys.argv[2]}
    runs = []
    for which in ORDER:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", roots[which]],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr)
        if proc.returncode:
            print(proc.stdout, file=sys.stderr)
            print(f"kernel_ab: the {which} run failed", file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["as"] = which
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()
    summary = {}
    for rec in runs:
        for name, times in rec["cases"].items():
            row = summary.setdefault(name, {})
            for key, ms in times.items():
                tag = (key if key.startswith(("library", "plain", "bound", "sectors"))
                       else f"{rec['as']}_{key}")
                row.setdefault(tag, []).append(ms)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "kernel_ab.json"), "w") as fh:
        json.dump({"card": card, "order": ORDER, "runs": runs, "summary": summary}, fh, indent=1)
    print(card, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
