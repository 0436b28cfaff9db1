"""Before/after host cost of the port's named locks on one NVIDIA card:
two checkouts of the port, the same chip_smoke.py phases, one method.

    python3 lock_ab.py OLD_ROOT NEW_ROOT

Each root's `chip_smoke.py` runs in a process of its own with the phases
of PHASES, the paths where the port's locks are taken most (every
kernel launch counts itself under one), in the order old, new, new, old, so
that a drift of the card or of the host shows as a gap between the two
runs of one root. From each run it keeps the phase walls, every
`wrapper_ms` in the kernels line (a kernel's wrapper called from Python
one call after another: the launch's host cost, `cuda_build.count_launch`
included) and every latency percentile of phase serve.

Then, in a process of each root, the host cost of one lock round trip
(acquire and release, microseconds, 200,000 calls, five repeats):
`cuda_build.count_launch` in both roots; in the new root also a
`named_lock` with the witness off and on, against a bare
`threading.Lock` in the same process.

Prints one JSON line per run, the card's name and power limit, and a
JSON summary last; writes them all to chiprun_out/lock_ab.json. Exits
nonzero without a CUDA card or when a run fails.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = "build,kernel,nested,distributed,mesh,serve"
CALLS = 200_000
REPEATS = 5


def per_call_us(fn) -> list:
    out = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        out.append((time.perf_counter() - t0) / CALLS * 1e6)
    return out


def lock_costs() -> dict:
    """The round trips of this process's `trino_tpu_torch` (on sys.path)."""
    import threading

    from trino_tpu_torch.ops import cuda_build

    class Wrapper:
        launches = 0
        shapes: set = set()

    w = Wrapper()
    out = {"count_launch_us": per_call_us(lambda: cuda_build.count_launch(w, (1,)))}
    try:
        from trino_tpu_torch.analysis import witness
    except ImportError:
        return out
    bare = threading.Lock()
    named = witness.named_lock("lock_ab.probe")

    def round_trip(lk):
        def go():
            with lk:
                pass
        return go

    was = witness.witness_enabled()
    try:
        witness.enable_witness(False)
        out["bare_lock_us"] = per_call_us(round_trip(bare))
        out["named_lock_witness_off_us"] = per_call_us(round_trip(named))
        witness.enable_witness(True)
        out["named_lock_witness_on_us"] = per_call_us(round_trip(named))
    finally:
        witness.enable_witness(was)
    return out


def collect(node, path, key, out) -> None:
    """Every `key` under `node`, by its path of keys and kernel names."""
    if isinstance(node, dict):
        for k, v in node.items():
            if k == key and isinstance(v, (int, float)):
                out[path] = v
            else:
                collect(v, f"{path}/{k}" if path else str(k), key, out)
    elif isinstance(node, list):
        for item in node:
            name = item.get("name", "?") if isinstance(item, dict) else "?"
            collect(item, f"{path}/{name}" if path else name, key, out)


def run_smoke(root: str, label: str) -> dict:
    root = os.path.abspath(root)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", PHASES], cwd=root,
                          capture_output=True, text=True)
    wall = time.perf_counter() - t0
    out_dir = os.path.join(HERE, "chiprun_out", "lock_ab")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{label}.log"), "w") as fh:
        fh.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"{label}: chip_smoke.py exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    src = os.path.join(root, "chiprun_out", "chip_smoke.json")
    shutil.copyfile(src, os.path.join(out_dir, f"{label}.json"))
    with open(src) as fh:
        res = json.load(fh)
    wrappers, latencies = {}, {}
    collect(res["kernels"], "", "wrapper_ms", wrappers)
    for key in ("latency_p50_ms", "latency_p99_ms", "p50_ms", "p99_ms"):
        collect(res.get("serve", {}), key, key, latencies)
    return {"run": label, "command_s": wall, "phase_walls_s": res["phase_walls_s"],
            "wrapper_ms": wrappers, "serve_latency_ms": latencies}


def run_locks(root: str, label: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--locks"],
                          cwd=os.path.abspath(root), capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{label}: lock costs exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return {"run": label, **json.loads(proc.stdout.strip().splitlines()[-1])}


def main() -> int:
    if sys.argv[1:] == ["--locks"]:
        sys.path.insert(0, os.getcwd())
        print(json.dumps(lock_costs()))
        return 0
    args = sys.argv[1:]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("lock_ab: no CUDA device", file=sys.stderr)
        return 2
    roots = {"old": args[0], "new": args[1]}
    runs, locks = [], []
    for i, which in enumerate(("old", "new", "new", "old")):
        rec = run_smoke(roots[which], f"{which}{i}")
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    for i, which in enumerate(("old", "new", "new", "old")):
        rec = run_locks(roots[which], f"{which}{i}")
        locks.append(rec)
        print(json.dumps(rec), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    with open(os.path.join(HERE, "chiprun_out", "lock_ab.json"), "w") as fh:
        json.dump({"card": card, "phases": PHASES, "runs": runs, "locks": locks}, fh, indent=1)
    print(json.dumps({"card": card, "runs": len(runs), "locks": len(locks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
