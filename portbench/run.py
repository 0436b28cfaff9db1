"""Run one cell of BENCHMARK.json on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up generates the configuration's tables on the card from its fixed
`data_seed` (the same tables in every run), moves them to host numpy,
loads them into the port's memory connector behind a LocalQueryRunner on
the card and runs every distinct statement
instance of the cell's streams once through a CoordinatorServer (the scan,
plan and kernel caches fill). The run's --seed deals the instances to the
streams and orders each stream. The window: a fresh CoordinatorServer, and
the cell's closed-loop streams in a child process, for --seconds. Then
every statement answered is held against the plain reference. The last
line of standard output is the result; the numbers compared, with their
limits, end standard error and the result line.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time


def _process_start() -> float:
    """This process's start on the monotonic clock (the clock the window
    and the clients use)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_PROCESS = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
# every build and kernel cache of the program at a fixed path in the checkout
CACHE_ENV = {
    "TRINO_TPU_TORCH_KERNEL_CACHE": os.path.join(CACHE, "kernels"),
    "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
    "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
    "TORCHINDUCTOR_CACHE_DIR": os.path.join(CACHE, "inductor"),
    "USE_FLAX": "0",
    "USE_JAX": "0",
}
FORBIDDEN = ("jax", "jaxlib", "flax", "trino_tpu")
# a statement in flight at the close is waited for: a late answer is late,
# not wrong, and its latency counts the wait
STATEMENT_TIMEOUT_S = 120.0
CHILD_GRACE_S = STATEMENT_TIMEOUT_S + 30.0
PORT_PACKAGE = "trino_tpu_torch"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def read_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_spec(workload: str):
    spec = read_benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    return spec, cell, config


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metrics_of(spec: dict, cell_name: str, trace: bool) -> list:
    """The cell's metrics of the run's kind: end-to-end ones without the
    trace, per-layer ones with it."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             scale_factor=None, t_process=None) -> dict:
    """One run; returns {"result": the result line's object, "checks":
    [(name, value, relation, limit)]}. `device` and `scale_factor` other
    than the configuration's serve the CPU tests."""
    import torch

    from portbench import compare, data, traffic
    from portbench.record import RunRecord, Statement
    from portbench.reference.common import Ctx
    from portbench.sut import Sut
    from portbench.trace import Profiler, port_kernel_names

    spec, cell, config = load_spec(workload)
    mix = traffic.load_mix(cell["traffic"])
    sf = config["scale_factor"] if scale_factor is None else scale_factor
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_gen = time.monotonic()
    tables = data.generate(config["generator"], sf, config["data_seed"], device)
    sync()
    if on_card:
        torch.cuda.empty_cache()
    log(f"generated {sum(t.rows for t in tables.values())} rows, "
        f"{sum(t.nbytes() for t in tables.values())} bytes in {time.monotonic() - t_gen:.3f} s")

    t_load = time.monotonic()
    sut = Sut(tables, config["session"], device)
    log(f"loaded in {time.monotonic() - t_load:.3f} s")
    stream_list = traffic.streams(mix, seed)
    instances = traffic.distinct(stream_list)
    sql_of = {i.id: i.sql for i in instances}

    from trino_tpu_torch.client import Client

    uri = sut.start_server()
    warm = Client(uri)
    for inst in instances:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        try:
            warm.execute(inst.sql)
            took = f"{time.monotonic() - t0:.3f} s"
        except Exception as e:  # the window's statements will fail alike and show it
            took = f"failed: {type(e).__name__}: {str(e)[:300]}"
        mem = (f"; allocated {torch.cuda.memory_allocated()} B, peak "
               f"{torch.cuda.max_memory_allocated()} B" if on_card else "")
        log(f"warm {inst.id} {dict(inst.params)} {took}{mem}")
    sut.stop_server()

    child = subprocess.Popen([sys.executable, "-m", "portbench.streams"], cwd=ROOT,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        child.stdin.write(json.dumps({
            "seconds": seconds, "timeout": STATEMENT_TIMEOUT_S,
            "streams": [[[i.id, i.sql] for i in s] for s in stream_list]}) + "\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the client process did not start")
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sut.completed.take()
        launches0 = Sut.launches()
        prof = Profiler() if trace else None
        if prof:
            prof.start()
        uri = sut.start_server()
        start = time.monotonic()
        setup_s = start - (T_PROCESS if t_process is None else t_process)
        child.stdin.write(f"go {start!r} {uri}\n")
        child.stdin.flush()
        out, _ = child.communicate(timeout=seconds + CHILD_GRACE_S)
    except BaseException:
        child.kill()
        child.wait()
        raise
    sync()
    device_trace = prof.stop() if prof else None
    if device_trace is not None:
        log(f"trace: {len(device_trace.device)} device operations, "
            f"{device_trace.h2d_count} host-to-device copies of {device_trace.h2d_bytes} bytes "
            "(None: unread), "
            f"{len(device_trace.host)} host operations")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = Sut.launches() - launches0
    events = sut.completed.take()
    sut.stop_server()
    del sut
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    statements = [Statement(*r) for r in json.loads(out.strip().splitlines()[-1])]
    record = RunRecord(start, start + seconds, statements, sql_of, events, launches,
                       memory_peak, setup_s, device_trace,
                       port_kernel_names(os.path.join(ROOT, PORT_PACKAGE)))

    # the plain reference, once an instance, over the same host arrays
    t_ref = time.monotonic()
    ctx = Ctx(tables, device)
    answers = {}
    for inst in instances:
        mod = importlib.import_module(f"portbench.reference.{mix['family']}.{inst.query}")
        answers[inst.id] = mod.run(ctx, inst.param_dict)
    off = [compare.mismatched_cells(s.rows, answers[s.id]) for s in statements]
    mismatched = sum(off)
    failed = sum(not s.ok for s in statements)
    wrong = [(s, n) for s, n in zip(statements, off) if n or not s.ok]
    for s, n in wrong[:8]:
        log(f"wrong: {s.id} (stream {s.stream}, sent at +{s.t0 - start:.3f} s, "
            f"{s.latency_s:.3f} s): {n} cells off; "
            + (f"error {s.error[:400]}" if s.error else
               f"{len(s.rows)} rows, first {json.dumps(s.rows[:2])[:300]}"))
    log(f"reference in {time.monotonic() - t_ref:.3f} s")

    names = metrics_of(spec, workload, trace)
    metrics = {}
    for m in names:
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for k in sorted({s.stream for s in statements}):
        log(f"stream {k}: " + ", ".join(
            f"{s.id} {s.latency_s:.2f}" for s in statements if s.stream == k))
    in_window = len(record.in_window())
    log(f"statements: {len(statements)} sent, {in_window} answered in the window, "
        f"{failed} failed; latency samples {in_window}")
    checks = [("mismatched_cells", mismatched, "<=", 0),
              ("failed_statements", failed, "<=", 0),
              ("answered_in_window", in_window, ">=", 1)]
    correct = all(v <= lim if rel == "<=" else v >= lim for _, v, rel, lim in checks)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(statements), "failed": failed,
              "metrics": metrics, "device": dev}
    if device_trace is not None:
        dev["busy_s"] = device_trace.busy_s()
        dev["window_s"] = device_trace.window_s
        result["breakdown"] = device_trace.breakdown()
    result["checks"] = {n: {"value": v, "holds": rel, "limit": lim} for n, v, rel, lim in checks}
    return {"result": result, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.update(CACHE_ENV)

    import torch

    _, cell, _ = load_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"no result: the cell needs {cell['chips']} CUDA device(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"no result: the run loaded {', '.join(bad)}")
        return 3
    for name, value, rel, limit in out["checks"]:
        log(f"check {name} = {value} (must be {rel} {limit})")
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
