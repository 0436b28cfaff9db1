"""The serving path on trino_tpu_torch (device="cpu") against trino_tpu:
the micro-batcher, the worker-local deadline, the resident fast lane in
front of the coordinator server and the open-loop harness.

- tests/test_serving.py's five cases that waited for the batcher, the
  worker deadline and the harness run on the port's names
  (tests/test_torch_compile.port_names).
- A burst of point lookups through a server with micro-batching
  coalesces, and every demultiplexed row equals the reference's; a
  server with `resident_tables` serves the same lookups from its pin.
- The harness runs at tiny with a short load: every completion equal to
  its oracle, nothing shed, a plan-cache hit rate of at least 90 %, zero
  programs built after warm-up, and a burst that coalesced. (The p99 to
  p50 gate is a chip measurement: chip_smoke.py's phase serve holds it.)
  Against a DistributedQueryRunner over 2 CPU shards every coalesced
  lookup rides the mesh scheduler's fast lane (`mesh_fast_lane`).
"""

import inspect
import threading

import pytest

import tests.test_serving as serving_corpus
from tests.test_torch_compile import isolated_registries, port_names  # noqa: F401
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu_torch.client import Client
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.resident import RESIDENT
from trino_tpu_torch.runtime.server import CoordinatorServer
from trino_tpu_torch.serving import harness

# the cases tests/test_torch_statements.py sends here
SERVING = ["test_classify_is_strict", "test_batcher_demux_interleaved_clients",
           "test_batcher_propagates_shared_failure", "test_on_batch_enforces_local_deadline",
           "test_exact_percentile"]


@pytest.mark.parametrize("name", SERVING)
def test_serving_corpus(name, monkeypatch):
    port_names(monkeypatch, serving_corpus)
    fn = getattr(serving_corpus, name)
    if "runner" in inspect.signature(fn).parameters:
        return fn(serving_corpus.runner.__wrapped__())
    fn()


def test_the_statements_file_sends_these_cases_here():
    from tests.test_torch_statements import ELSEWHERE

    sent = {k.split("::")[1] for k, v in ELSEWHERE.items() if v == "tests/test_torch_serving.py"}
    assert sent == set(SERVING)
    assert sent <= {n for _, n in _cases(serving_corpus)}


POINT = "select o_custkey, o_totalprice from orders where o_orderkey = {}"
KEYS = [1, 2, 3, 4, 5, 6, 7, 32, 33, 34, 35, 36, 37, 38, 39, 64]


@pytest.fixture(scope="module")
def oracle():
    ref = JRunner(JSession(catalog="tpch", schema="tiny"))
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    return {k: ref.execute(POINT.format(k)).rows for k in KEYS}


def _runner(**session):
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny", **session), device="cpu")
    r.register_catalog("tpch", ttpch.create_tpch_connector())
    return r


def _burst(srv, keys):
    got, errors = {}, []

    def ask(k):
        try:
            got[k] = Client(srv.uri, timeout=60).execute(POINT.format(k)).rows
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(repr(e))

    ts = [threading.Thread(target=ask, args=(k,)) for k in keys]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errors, errors
    return got


def test_a_burst_coalesces_and_demultiplexes_to_the_references_rows(oracle):
    r = _runner(micro_batch_window_ms=300.0, micro_batch_max=len(KEYS))
    srv = CoordinatorServer(r, max_concurrent=len(KEYS))
    try:
        assert _burst(srv, KEYS) == oracle
        st = srv.batcher.stats()
        assert st["batched_queries"] == len(KEYS) and 1 <= st["batches"] < len(KEYS)
        assert st["open_groups"] == 0
    finally:
        srv.stop()


def test_lookups_that_arrive_while_their_keys_batch_executes_coalesce(oracle):
    """A leader whose window ends while a batch of its key still executes
    keeps its group open: a lookup that arrives well after that window,
    but before the batch in flight is done, joins it, and the two run as
    one combined statement after the first."""
    import time

    from trino_tpu_torch.serving.batcher import MicroBatcher

    r = _runner()
    sqls, started, release = [], threading.Event(), threading.Event()

    class Gated:  # the first execution holds until released
        def execute(self, sql, **kw):
            sqls.append(sql)
            if len(sqls) == 1:
                started.set()
                release.wait(30)
            return r.execute(sql, **kw)

    b = MicroBatcher(Gated(), window_s=0.05, max_batch=16)
    got = {}

    def ask(k):
        got[k] = b.submit(POINT.format(k)).rows

    ts = [threading.Thread(target=ask, args=(1,))]
    ts[0].start()
    try:
        assert started.wait(30)
        for k in (2, 3):
            ts.append(threading.Thread(target=ask, args=(k,)))
            ts[-1].start()
            time.sleep(0.3)  # six windows: key 2's leader has long stopped waiting
        assert [[m.value for m in g.members] for g in b._groups.values()] == [[2, 3]]
    finally:
        release.set()
        for t in ts:
            t.join(60)
    assert got == {k: oracle[k] for k in (1, 2, 3)}
    assert b.stats() == {"batches": 2, "batched_queries": 3, "open_groups": 0}
    assert len(sqls) == 2 and "IN (2, 3)" in sqls[1]


def test_the_fast_lane_serves_pinned_lookups_before_the_batcher(oracle):
    """With resident_tables and micro-batching both on, the first lookup
    pins orders and every later one probes the pin: the batcher sees
    none of them."""
    RESIDENT.evict_all()
    r = _runner(resident_tables="orders", micro_batch_window_ms=50.0)
    srv = CoordinatorServer(r, max_concurrent=4)
    try:
        assert _burst(srv, KEYS[:1]) == {KEYS[0]: oracle[KEYS[0]]}
        hits0 = RESIDENT.stats()["hits"]
        assert _burst(srv, KEYS) == oracle
        assert RESIDENT.stats()["hits"] - hits0 == len(KEYS)
        assert srv.batcher.stats()["batched_queries"] == 0
    finally:
        srv.stop()
        RESIDENT.evict_all()


def test_inside_a_transaction_a_lookup_takes_neither_arm(oracle):
    """A statement in an open transaction reads through the runner (the
    pin and the batcher read committed state outside it)."""
    RESIDENT.evict_all()
    r = _runner(resident_tables="orders", micro_batch_window_ms=50.0)
    srv = CoordinatorServer(r, max_concurrent=2)
    try:
        c = Client(srv.uri, timeout=60)
        c.execute("start transaction")
        assert c.execute(POINT.format(7)).rows == oracle[7]
        c.execute("commit")
        assert len(RESIDENT) == 0 and srv.batcher.stats()["batches"] == 0
    finally:
        srv.stop()
        RESIDENT.evict_all()


def test_the_harness_gates_hold_at_tiny():
    """run_serve_load over q6 and point lookups, 8 clients, a short
    open-loop phase at a fixed rate and a burst: the reference's gates
    but the timing one hold (every arrival completes oracle-equal,
    nothing shed, the plan cache hit, nothing built after warm-up, the
    burst coalesced). The batch phase counts the mesh scheduler's fast
    lane: none on a LocalQueryRunner (it has no mesh), and every combined
    lookup of a DistributedQueryRunner over 2 CPU shards."""
    import torch

    from tests.tpch_queries import QUERIES
    from trino_tpu_torch.runtime import DistributedQueryRunner

    report = harness.run_serve_load(queries={"q6": QUERIES[6]}, n_clients=8, duration_s=2.0,
                                    rate_qps=10.0, seed=7, device="cpu")
    assert report["offered"] >= 10 and report["completed"] == report["offered"]
    assert report["mismatches"] == 0 and report["error_count"] == 0 and report["shed"] == 0
    assert report["plan_cache_hit_rate"] >= 0.90
    assert report["programs_built_after_warmup"] == 0
    bp = report["batch_phase"]
    assert bp["mismatches"] == 0 and bp["error_count"] == 0
    assert bp["batched_queries"] > bp["batches"] > 0
    assert bp["mesh_fast_lane"] == 0  # a LocalQueryRunner has no mesh scheduler
    mesh = DistributedQueryRunner(Session(catalog="tpch", schema="tiny"), n_workers=2,
                                  hash_partitions=2, device="cpu",
                                  mesh_devices=[torch.device("cpu")] * 2)
    mesh.register_catalog("tpch", ttpch.create_tpch_connector())
    report = harness.run_serve_load(queries={"q6": QUERIES[6]}, n_clients=4, duration_s=1.0,
                                    rate_qps=5.0, batch_phase_s=1.0, seed=7, runner=mesh)
    assert report["completed"] == report["offered"] and report["mismatches"] == 0
    bp = report["batch_phase"]
    assert bp["mismatches"] == 0 and bp["error_count"] == 0
    assert bp["mesh_fast_lane"] == bp["batches"] > 0


def test_exact_percentile_and_rows_equal():
    assert harness.exact_percentile([5.0, 1.0, 3.0], 0.5) == 3.0
    assert harness.rows_equal([[1, 0.1 + 0.2]], [[1, 0.3]])
    assert not harness.rows_equal([[1, 2]], [[2, 1]], ordered=True)


def test_the_harness_needs_a_card_or_device_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.build_tiny_runner(None)


@pytest.mark.parametrize("kind", ["bigint", "integer", "date", "decimal(12,2)", "decimal(18,4)",
                                  "decimal(18,18)", "double", "real", "boolean", "varchar"])
def test_a_whole_column_decodes_as_value_by_value(kind):
    """block.decode_values' whole-array rules (the pins' and every
    result's host rows) give the values and types of the per-value rule
    that decoded them before, NULLs included; decimals past 2^53 divide
    as Python ints."""
    import numpy as np

    from trino_tpu_torch import block as B
    from trino_tpu_torch import types as T
    from trino_tpu_torch.sql.analyzer import resolve_type
    from trino_tpu_torch.sql.parser import parse

    t = resolve_type(parse(f"select cast(null as {kind})").body.select[0].expr.target)
    rng = np.random.default_rng(len(kind))
    data = {"double": rng.standard_normal(2000), "real": rng.standard_normal(2000).astype(np.float32),
            "boolean": rng.random(2000) < 0.5}.get(
        kind, rng.integers(-10**17, 10**17, 2000) if kind.startswith("decimal(18")
        else rng.integers(0, 5, 2000).astype(np.int32))
    valid = rng.random(2000) < 0.9
    dv = ["a", "b", "c", "d", "e"] if kind == "varchar" else None
    fast = B.decode_values(t, data, valid, dv)
    slow = [None if not ok
            else (dv[int(x)] if kind == "varchar"
                  else int(x) / T.decimal_scale_factor(t) if t.is_decimal
                  else bool(x) if kind == "boolean"
                  else float(x) if t.is_floating else int(x))
            for x, ok in zip(data, valid)]
    assert fast == slow and [type(v) for v in fast] == [type(v) for v in slow]
