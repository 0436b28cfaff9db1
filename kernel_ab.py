"""Before/after times of the redesigned join kernels on one NVIDIA card:
two checkouts of the port, the same inputs, one timing method.

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
  torch.searchsorted(right=True).

Every output is held against the library call's before it is timed.
Whichever root runs, the times come from this checkout's
`trino_tpu_torch/explore/__init__.py` (`device_ms`, cold and warm).
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


def device_ms():
    """This checkout's timing function, loaded from its file so that the
    root under test provides the kernels and nothing else."""
    path = os.path.join(HERE, "trino_tpu_torch", "explore", "__init__.py")
    spec = importlib.util.spec_from_file_location("kernel_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def run_one(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import window_rank as W

    timed = device_ms()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    new = hasattr(W, "bounds")
    cases = {}

    def case(name, kernel, outs, library):
        kernel()
        want = library()
        torch.cuda.synchronize()
        for got, w in zip(outs, want if isinstance(want, tuple) else (want,)):
            if not torch.equal(got, w):
                raise AssertionError(f"{name}: the kernel differs from the library call")
        cases[name] = {"ms": timed(kernel, ITERS, "cold"), "warm_ms": timed(kernel, ITERS, "warm"),
                       "library_ms": timed(library, ITERS, "cold"),
                       "library_warm_ms": timed(library, ITERS, "warm")}

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
    print(json.dumps({"root": root, "design": "new" if new else "old", "cases": cases}))
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
                tag = key if key.startswith("library") else f"{rec['as']}_{key}"
                row.setdefault(tag, []).append(ms)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "kernel_ab.json"), "w") as fh:
        json.dump({"card": card, "order": ORDER, "runs": runs, "summary": summary}, fh, indent=1)
    print(card, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
