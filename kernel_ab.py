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
  call computes it).

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


def run_one(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import mxu_groupby as M
    from trino_tpu_torch.ops import window_rank as W

    helpers = explore_helpers()
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
                tag = key if key.startswith(("library", "plain")) else f"{rec['as']}_{key}"
                row.setdefault(tag, []).append(ms)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "kernel_ab.json"), "w") as fh:
        json.dump({"card": card, "order": ORDER, "runs": runs, "summary": summary}, fh, indent=1)
    print(card, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
