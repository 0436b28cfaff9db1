"""Open-loop load harness for the serving tier.

Counterpart of trino_tpu/serving/harness.py (`bench.py --serve` there;
`python3 chip_smoke.py --phases build,serve` runs `serve_smoke` on the
card). The reference's gate "zero new XLA lowerings after warm-up"
reads the port's compile counter here: METRICS `programs_built`, the
programs the ProgramCache built plus the kernel libraries nvcc built
(compile/cache.py). `rows_equal` is runtime/chaos.rows_equal, as in
the reference. The batched phase's `mesh_fast_lane` counts the fast-lane
submissions of the runner's mesh schedulers (0 for a LocalQueryRunner,
which has none).

Open-loop means arrivals follow a PRECOMPUTED schedule that does not
slow down when the server does — the honest model of a client
population that keeps clicking while you degrade. Latency is measured
from each query's SCHEDULED arrival, so queue wait under overload
counts against the server (closed-loop harnesses hide it: a stalled
client stops generating load, flattening the tail it should expose).

The run has three phases:

1. **oracle/warm-up** — every distinct statement in the mix executes
   once directly on the runner: results become the per-statement
   oracle, plans land in the plan cache, and every program and kernel
   library the mix needs is built. The measured phase must build ZERO
   more.
2. **measured open-loop phase** — N client threads drain the arrival
   schedule through the HTTP statement protocol; each completion is
   checked against the oracle. Percentiles are computed EXACTLY from
   the raw samples (the metrics registry's geometric-bucket
   distributions carry ~2x quantile error — useless for a p99/p50
   gate).
3. **batched burst phase** (optional) — a second server with micro-
   batching enabled takes a closed-loop burst of point lookups from
   every client at once, asserting coalescing happened AND every
   demultiplexed result still matches the oracle.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.runtime.chaos import rows_equal
from trino_tpu_torch.analysis import threadreg
from trino_tpu_torch.analysis.witness import named_lock

DEFAULT_POINT_TEMPLATE = (
    "select o_custkey, o_totalprice from orders where o_orderkey = {key}"
)
DEFAULT_POINT_KEYS = (1, 2, 3, 4, 5, 6, 7)


def exact_percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile over the raw sample list."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = max(0, min(len(s) - 1, int(round(q * (len(s) - 1)))))
    return s[idx]


def build_tiny_runner(device, **session_kw):
    """The harness's default target: a LocalQueryRunner over TPC-H tiny
    on `device` (None: the card)."""
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny", **session_kw),
                         device=device)
    r.register_catalog("tpch", create_tpch_connector())
    return r


def _mesh_fast_submitted(runner) -> int:
    """Sum of fast-lane submissions across the runner's mesh
    schedulers: how the batched phase proves its combined point lookups
    rode the MeshScheduler's fast lane (the single-mesh run queue plus
    any replica run queues)."""
    total = 0
    sched = getattr(runner, "_mesh_scheduler", None)
    if sched is not None:
        total += int(getattr(sched, "fast_submitted", 0))
    rm = getattr(runner, "_replicas", None)
    if rm is not None:
        total += sum(
            int(getattr(r.scheduler, "fast_submitted", 0))
            for r in rm.replicas
        )
    return total


def _weighted_schedule(
    rng: random.Random,
    names: List[str],
    weights: List[float],
    rate_qps: float,
    duration_s: float,
) -> List[Tuple[float, str]]:
    """Poisson arrivals at rate_qps over duration_s, each tagged with a
    weighted statement pick. Times are offsets from the phase start."""
    out: List[Tuple[float, str]] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_qps)
        if t >= duration_s:
            return out
        out.append((t, rng.choices(names, weights=weights)[0]))


def run_serve_load(
    queries: Optional[Dict[str, str]] = None,
    weights: Optional[Dict[str, float]] = None,
    point_template: str = DEFAULT_POINT_TEMPLATE,
    point_keys: Tuple[int, ...] = DEFAULT_POINT_KEYS,
    point_weight: float = 0.3,
    n_clients: int = 8,
    duration_s: float = 6.0,
    rate_qps: Optional[float] = None,
    utilization: float = 0.5,
    batch_phase_s: float = 1.5,
    micro_batch_window_ms: float = 3.0,
    seed: int = 7,
    runner=None,
    warmup_rounds: int = 1,
    device=None,
) -> dict:
    """Drive the statement protocol with an open-loop mixed workload;
    returns a report dict (the keys `serve_smoke` gates on, and more).
    `rate_qps=None` sizes the arrival rate from the warm-up latencies so
    the offered load lands at `utilization` of measured capacity.
    `warmup_rounds` repeats the cold pass — a runner with N replicated
    sub-meshes needs N rounds so every replica compiles its programs
    before the measured phase (placements round-robin, so sequential
    rounds land on distinct replicas). Without a `runner`, one over
    TPC-H tiny on `device`."""
    from trino_tpu_torch.client import Client
    from trino_tpu_torch.runtime.metrics import METRICS
    from trino_tpu_torch.runtime.server import CoordinatorServer

    rng = random.Random(seed)
    if runner is None:
        runner = build_tiny_runner(device)
    statements: Dict[str, str] = dict(queries or {})
    analytic_names = list(statements)
    for k in point_keys:
        statements[f"point_{k}"] = point_template.format(key=k)
    point_names = [f"point_{k}" for k in point_keys]

    # -- phase 1: oracle + warm-up (plans, lowerings, service times) --
    oracle: Dict[str, list] = {}
    warm_s: Dict[str, float] = {}
    for name, sql in statements.items():
        for _ in range(max(1, warmup_rounds)):
            runner.execute(sql)  # cold pass: compiles don't skew timing
        t0 = time.perf_counter()
        oracle[name] = runner.execute(sql).rows
        warm_s[name] = time.perf_counter() - t0

    names = list(statements)
    if weights is None:
        # default mix: points share `point_weight`, analytics split the
        # rest evenly — the shape of a serving tier fronting dashboards
        w = {
            n: (1.0 - point_weight) / max(1, len(analytic_names))
            for n in analytic_names
        }
        w.update({n: point_weight / len(point_names) for n in point_names})
        weights = w
    wlist = [weights.get(n, 0.0) for n in names]
    mean_service = sum(
        warm_s[n] * weights.get(n, 0.0) for n in names
    ) / max(sum(wlist), 1e-9)
    if rate_qps is None:
        rate_qps = max(1.0, utilization / max(mean_service, 1e-4))

    schedule = _weighted_schedule(rng, names, wlist, rate_qps, duration_s)

    # -- phase 2: measured open-loop phase (batching OFF: the gated
    # metrics isolate plan-cache + admission behavior) --
    cache = runner._plan_cache
    hits0, misses0 = cache.hits, cache.misses
    compiles0 = METRICS.counter("programs_built")
    server = CoordinatorServer(runner, max_concurrent=n_clients)
    samples: List[Tuple[str, float]] = []  # (name, open-loop latency s)
    mismatches: List[str] = []
    sheds = [0]
    errors: List[str] = []
    lock = named_lock("harness.load_stats_lock")
    idx = [0]
    t_start = time.perf_counter()

    def client_loop():
        import urllib.error

        c = Client(server.uri, timeout=60.0, poll_interval=0.002)
        while True:
            with lock:
                if idx[0] >= len(schedule):
                    return
                at, name = schedule[idx[0]]
                idx[0] += 1
            delay = (t_start + at) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            try:
                res = c.execute(statements[name])
                lat = time.perf_counter() - (t_start + at)
                ok = rows_equal(res.rows, oracle[name])
                with lock:
                    samples.append((name, lat))
                    if not ok:
                        mismatches.append(name)
            except urllib.error.HTTPError as e:
                with lock:
                    if e.code == 429:
                        sheds[0] += 1
                    else:
                        errors.append(f"{name}: HTTP {e.code}")
            except Exception as e:
                with lock:
                    errors.append(f"{name}: {e!r}")

    threads = [
        threadreg.spawn(f"serving-client-{i}", client_loop,
                        owner="serving-harness", start=False)
        for i in range(n_clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    server.stop()

    lats = [lat for _, lat in samples]
    hits1, misses1 = cache.hits, cache.misses
    compiles1 = METRICS.counter("programs_built")
    d_hits, d_misses = hits1 - hits0, misses1 - misses0
    hit_rate = d_hits / max(1, d_hits + d_misses)
    p50 = exact_percentile(lats, 0.50)
    report = {
        "clients": n_clients,
        "rate_qps": round(rate_qps, 2),
        "offered": len(schedule),
        "completed": len(samples),
        "shed": sheds[0],
        "errors": errors[:5],
        "error_count": len(errors),
        "mismatches": len(mismatches),
        "wall_s": round(wall, 2),
        "qps": round(len(samples) / max(wall, 1e-9), 2),
        "p50_ms": round(p50 * 1e3, 1),
        "p95_ms": round(exact_percentile(lats, 0.95) * 1e3, 1),
        "p99_ms": round(exact_percentile(lats, 0.99) * 1e3, 1),
        "p99_over_p50": round(
            exact_percentile(lats, 0.99) / max(p50, 1e-9), 2
        ),
        "plan_cache_hit_rate": round(hit_rate, 4),
        "plan_cache": cache.stats(),
        "programs_built_after_warmup": int(compiles1 - compiles0),
        "per_query_p50_ms": {
            n: round(
                exact_percentile(
                    [l for nm, l in samples if nm == n], 0.50
                ) * 1e3, 1,
            )
            for n in names
            if any(nm == n for nm, _ in samples)
        },
    }

    # -- phase 3: batched burst (micro-batching ON; closed-loop so every
    # client fires simultaneously and the window has peers to coalesce)
    if batch_phase_s > 0:
        from trino_tpu_torch.serving.batcher import MicroBatcher

        batcher = MicroBatcher(
            runner, window_s=micro_batch_window_ms / 1e3, max_batch=16
        )
        bserver = CoordinatorServer(
            runner, max_concurrent=n_clients, batcher=batcher
        )
        b_mismatch = [0]
        b_done = [0]
        b_errors: List[str] = []
        fast0 = _mesh_fast_submitted(runner)
        stop_at = time.perf_counter() + batch_phase_s

        def burst_loop(i: int):
            r = random.Random(seed * 1000 + i)
            c = Client(bserver.uri, timeout=60.0, poll_interval=0.002)
            while time.perf_counter() < stop_at:
                k = r.choice(point_keys)
                name = f"point_{k}"
                try:
                    res = c.execute(statements[name])
                    with lock:
                        b_done[0] += 1
                        if not rows_equal(res.rows, oracle[name]):
                            b_mismatch[0] += 1
                except Exception as e:
                    with lock:
                        b_errors.append(f"{name}: {e!r}")

        bts = [
            threadreg.spawn(f"serving-burst-{i}", burst_loop, args=(i,),
                            owner="serving-harness", start=False)
            for i in range(n_clients)
        ]
        for t in bts:
            t.start()
        for t in bts:
            t.join()
        bserver.stop()
        report["batch_phase"] = {
            "queries": b_done[0],
            "mismatches": b_mismatch[0],
            "errors": b_errors[:5],
            "error_count": len(b_errors),
            "mesh_fast_lane": _mesh_fast_submitted(runner) - fast0,
            **batcher.stats(),
        }
    return report


def serve_smoke(
    queries: Dict[str, str],
    n_clients: int = 8,
    duration_s: float = 6.0,
    seed: int = 7,
    device=None,
    runner=None,
) -> Tuple[dict, List[str]]:
    """The serving gate. Returns (report, violations); empty violations
    = pass. Gates, the reference's: every query oracle-equal, plan-cache
    hit rate >= 90%, zero programs built after warm-up, p99 <= 5x p50,
    and the batched phase coalesces while staying oracle-equal."""
    report = run_serve_load(
        queries=queries, n_clients=n_clients, duration_s=duration_s,
        seed=seed, device=device, runner=runner,
    )
    v: List[str] = []
    if report["completed"] < max(10, report["offered"] // 2):
        v.append(
            f"only {report['completed']}/{report['offered']} completed"
        )
    if report["mismatches"]:
        v.append(f"{report['mismatches']} results diverged from oracle")
    if report["error_count"]:
        v.append(
            f"{report['error_count']} client errors "
            f"(first: {report['errors'][:1]})"
        )
    if report["shed"]:
        v.append(
            f"{report['shed']} sheds at nominal load (lanes undersized)"
        )
    if report["plan_cache_hit_rate"] < 0.90:
        v.append(
            f"plan-cache hit rate {report['plan_cache_hit_rate']:.2%} < 90%"
        )
    if report["programs_built_after_warmup"] != 0:
        v.append(
            f"{report['programs_built_after_warmup']} programs built "
            "after warm-up"
        )
    if report["p99_over_p50"] > 5.0:
        v.append(
            f"p99/p50 = {report['p99_over_p50']:.2f} > 5.0 "
            f"(p50={report['p50_ms']}ms p99={report['p99_ms']}ms)"
        )
    bp = report.get("batch_phase", {})
    if bp:
        if bp["mismatches"] or bp["error_count"]:
            v.append(
                f"batch phase: {bp['mismatches']} mismatches, "
                f"{bp['error_count']} errors"
            )
        if bp["batches"] == 0 or bp["batched_queries"] <= bp["batches"]:
            v.append(
                "batch phase never coalesced "
                f"(batches={bp['batches']}, "
                f"batched_queries={bp['batched_queries']})"
            )
    return report, v
