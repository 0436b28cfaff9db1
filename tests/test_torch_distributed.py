"""The distributed runner of trino_tpu_torch (device="cpu") against
trino_tpu: fragments, the runtime's corpora, the raising arms and the
teardown.

- Fragments: for each TPC-H query the port's plan_distributed renders
  (explain_distributed) to the reference's text.
- Against the reference: Q1, Q3 and Q18 through both packages'
  DistributedQueryRunners (4 workers, 4 hash partitions, page exchange)
  give equal rows (integers and decimals bit-equal, doubles within the
  oracle's tolerance). tests/test_torch_distributed_a.py and _b.py hold
  all 22 queries against the port's LocalQueryRunner.
- The corpora run as written with their names bound to the port's
  (`portify`: every public name of a reference module that the port
  module also has, in the reference module and in the corpus; runners,
  workers and tasks built on the CPU): tests/test_distributed.py's
  buffer, exchange-client, fragmenter, EXPLAIN, EXPLAIN ANALYZE and
  discovery cases, tests/test_node_scheduler.py, test_state_machine.py,
  test_stats.py, test_observability.py, test_tracing.py's tracer, metrics,
  listener and runner cases, and test_pushdown.py's tpch and memory
  cases. test_the_corpora_are_covered lists every other case: where it
  runs instead (the HTTP wire, FTE and the spool in
  tests/test_torch_wire.py, the servers in tests/test_torch_front_door.py),
  or the item it waits for (the census and the chaos harness: 13).
- The arms of later items raise, naming the item; without a card the
  runner and a Worker raise; no task thread outlives a failed or
  cancelled query; zoned values cross the exchange intact, in process
  and over HTTP; retry_policy="query" replays a failed attempt;
  retry_policy="task", HTTP and spooled locations and a spooled output
  run.
- TPC-H Q13 under a 1 MiB pool: the reference's low-memory killer ends
  it, the port answers (ROADMAP §3): both outcomes pinned.
"""

import importlib
import inspect
import re
import threading
import time

import pytest

import tests.test_distributed as dist_corpus
import tests.test_node_scheduler as ns_corpus
import tests.test_observability as obs_corpus
import tests.test_pushdown as pushdown_corpus
import tests.test_state_machine as sm_corpus
import tests.test_stats as stats_corpus
import tests.test_tracing as tracing_corpus
from tests.oracle import assert_rows_match
from tests.test_torch_statements import _cases
from tests.tpch_queries import QUERIES
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.connectors.spi import CatalogManager as JCatalogManager
from trino_tpu.engine import Session as JSession
from trino_tpu.runtime.coordinator import DistributedQueryRunner as JDistributed
from trino_tpu.sql import fragmenter as jfragmenter
from trino_tpu.sql.analyzer import Analyzer as JAnalyzer
from trino_tpu.sql.parser import parse as jparse
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.connectors.spi import CatalogManager
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.runtime import DistributedQueryRunner, Worker
from trino_tpu_torch.runtime.failure import FailureInjector
from trino_tpu_torch.runtime.task import TaskExecution, TaskId, TaskSpec
from trino_tpu_torch.sql import fragmenter as tfragmenter
from trino_tpu_torch.sql.analyzer import Analyzer
from trino_tpu_torch.sql.parser import parse

# ---- the port's names for a corpus ------------------------------------------

_MODULES = [
    "types", "block", "engine", "connectors.spi", "connectors.tpch",
    "connectors.memory", "connectors.file", "expr.ir", "sql.plan", "sql.analyzer", "sql.parser",
    "sql.optimizer", "sql.fragmenter", "sql.stats", "exec.serde",
    "runtime.buffers", "runtime.exchange", "runtime.metrics", "runtime.tracing",
    "runtime.events", "runtime.state_machine", "runtime.failure",
    "runtime.query_tracker", "runtime.task", "runtime.worker",
    "runtime.coordinator", "runtime.discovery", "runtime.node_scheduler",
    "runtime.queryinfo", "config", "security", "runtime.codec", "runtime.spool",
    "runtime.http", "runtime.fte", "runtime.resource_groups", "runtime.server",
    "serving.admission", "client", "dbapi", "cli", "service.proxy", "service.verifier",
    "transaction", "sql.ast", "sql.cost",
]
# constructors that take the port's device: built on the CPU
_ON_CPU = {"LocalQueryRunner", "DistributedQueryRunner", "Worker", "TaskExecution"}


def _cpu(cls):
    def make(*args, **kw):
        kw.setdefault("device", "cpu")
        return cls(*args, **kw)

    return make


# each reference module's names as imported, before any test patches them
_ORIGINAL = {name: dict(vars(importlib.import_module("trino_tpu." + name)))
             for name in _MODULES}


def portify(mp, *corpora) -> None:
    """Bind every public name of the reference modules above that the
    port's module also has to the port's, in the reference module (for
    the corpora's function-level imports) and in each corpus module."""
    swap = {}
    for name in _MODULES:
        j = importlib.import_module("trino_tpu." + name)
        t = importlib.import_module("trino_tpu_torch." + name)
        swap[id(j)] = t
        parent, _, leaf = ("trino_tpu." + name).rpartition(".")
        mp.setattr(importlib.import_module(parent), leaf, t)
        for attr, obj in _ORIGINAL[name].items():
            if attr.startswith("_") or inspect.ismodule(obj) or not hasattr(t, attr):
                continue
            new = getattr(t, attr)
            if attr in _ON_CPU:
                new = _cpu(new)
            mp.setattr(j, attr, new)
            swap.setdefault(id(obj), new)
    import trino_tpu.runtime as jruntime

    for attr in ("DistributedQueryRunner", "Worker", "OutputBuffer"):
        mp.setattr(jruntime, attr, swap[id(_ORIGINAL["runtime." + {
            "DistributedQueryRunner": "coordinator", "Worker": "worker",
            "OutputBuffer": "buffers"}[attr]][attr])])
    for corpus in corpora:
        for attr, obj in list(vars(corpus).items()):
            if id(obj) in swap:
                mp.setattr(corpus, attr, swap[id(obj)])


def _port_cluster(**session):
    r = DistributedQueryRunner(
        Session(catalog="tpch", schema="tiny", mesh_execution=False, **session),
        n_workers=4, hash_partitions=4, device="cpu")
    r.register_catalog("tpch", ttpch.create_tpch_connector())
    return r


@pytest.fixture(scope="module")
def cluster():
    return _port_cluster()


@pytest.fixture(scope="module")
def catalogs():
    c = CatalogManager()
    c.register("tpch", ttpch.create_tpch_connector())
    return c


@pytest.fixture(scope="module")
def local_runner():
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    r.register_catalog("tpch", ttpch.create_tpch_connector())
    return r


def call_case(module, case, args):
    """A corpus case, (class or None, name) as test_torch_statements._cases
    lists them, with its parameters from `args` (zero-argument callables)."""
    cls, name = case
    fn = getattr(cls(), name) if cls else getattr(module, name)
    fn(**{p: args[p]() for p in inspect.signature(fn).parameters})


def _run(corpus, name, mp, args):
    """The corpus case on the port's names; its parameters from `args`
    (zero-argument callables, made after portify)."""
    portify(mp, corpus)
    fn = getattr(corpus, name)
    params = inspect.signature(fn).parameters
    fn(**{p: args[p]() for p in params})


# ---- fragments --------------------------------------------------------------


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_fragments_equal_the_reference(qid, catalogs):
    jc = JCatalogManager()
    jc.register("tpch", jtpch.create_tpch_connector())
    want = jfragmenter.explain_distributed(jfragmenter.plan_distributed(
        JAnalyzer(jc, "tpch", "tiny").plan(jparse(QUERIES[qid])), jc))
    got = tfragmenter.explain_distributed(tfragmenter.plan_distributed(
        Analyzer(catalogs, "tpch", "tiny").plan(parse(QUERIES[qid])), catalogs))
    assert got == want


# ---- against the reference's distributed runner -----------------------------


@pytest.mark.parametrize("qid", [1, 3, 18])
def test_rows_equal_the_reference_distributed_runner(qid, cluster):
    ref = JDistributed(JSession(catalog="tpch", schema="tiny", mesh_execution=False),
                       n_workers=4, hash_partitions=4)
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    want = ref.execute(QUERIES[qid])
    got = cluster.execute(QUERIES[qid])
    assert got.column_names == want.column_names
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types]
    exact = [i for i, t in enumerate(want.column_types) if not t.is_floating]
    assert [[r[i] for i in exact] for r in got.rows] == [[r[i] for i in exact]
                                                         for r in want.rows]
    assert_rows_match(got.rows, want.rows, ordered=True, abs_tol=1e-2)


# ---- tests/test_distributed.py ---------------------------------------------

_DIST_UNITS = ["test_output_buffer_token_ack", "test_output_buffer_backpressure_unblocks",
               "test_exchange_client_pulls_all_locations", "test_aborted_buffer_fails_consumer",
               "test_discovery_heartbeat_marks_failed_worker"]
_DIST_PLANS = ["test_fragmenter_groupby_shape", "test_fragmenter_broadcast_join",
               "test_fragmenter_distributed_sort"]
_DIST_RUNS = ["test_distributed_explain", "test_distributed_explain_analyze"]


@pytest.mark.parametrize("name", _DIST_UNITS + _DIST_PLANS + _DIST_RUNS)
def test_distributed_corpus(name, monkeypatch, catalogs, cluster):
    _run(dist_corpus, name, monkeypatch,
         {"catalogs": lambda: catalogs, "runner": lambda: cluster})


# ---- tests/test_node_scheduler.py, test_state_machine.py, test_stats.py ----

_NS = [n for _, n in _cases(ns_corpus) if n != "test_fte_speculation_beats_straggler"]
_SM = [n for _, n in _cases(sm_corpus) if n != "test_metrics_endpoint"]
_STATS = [n for _, n in _cases(stats_corpus)
          if n not in ("test_estimate_accuracy", "test_explain_analyze_device_inclusive_attribution")]


@pytest.mark.parametrize("name", _NS)
def test_node_scheduler_corpus(name, monkeypatch):
    _run(ns_corpus, name, monkeypatch, {})


@pytest.mark.parametrize("name", _SM)
def test_state_machine_corpus(name, monkeypatch):
    _run(sm_corpus, name, monkeypatch, {})


def _estimator(catalogs):
    from trino_tpu_torch.sql.stats import StatsCalculator

    an, calc = Analyzer(catalogs, "tpch", "tiny"), StatsCalculator(catalogs)
    return lambda sql: calc.stats(an.plan(parse(sql))).row_count


@pytest.mark.parametrize("sql,actual,tol", stats_corpus.CASES)
def test_stats_estimate_accuracy(sql, actual, tol, catalogs, monkeypatch):
    portify(monkeypatch, stats_corpus)
    stats_corpus.test_estimate_accuracy(sql, actual, tol, _estimator(catalogs))


@pytest.mark.parametrize("name", _STATS)
def test_stats_corpus(name, monkeypatch, catalogs):
    _run(stats_corpus, name, monkeypatch, {"catalogs": lambda: catalogs})


# ---- tests/test_observability.py -------------------------------------------

_OBS = ["test_event_listener_lifecycle", "test_event_listener_failure_state",
        "test_tracer_span_tree", "test_dynamic_filter_correctness"]


@pytest.mark.parametrize("name", _OBS)
def test_observability_corpus(name, monkeypatch, local_runner):
    _run(obs_corpus, name, monkeypatch, {"runner": lambda: local_runner})


# ---- tests/test_tracing.py -------------------------------------------------

_TRACING_TRACED = ["test_traced_query_exports_complete_span_tree",
                   "test_traced_query_chrome_export_loads",
                   "test_wall_time_distributions_recorded"]
_TRACING = [n for _, n in _cases(tracing_corpus)
            if "traced" not in inspect.signature(getattr(tracing_corpus, n)).parameters
            and n not in ("test_fte_retry_and_chaos_annotations_land_on_spans",
                          "test_watchdog_fires_fast_on_warm_hung_operator",
                          "test_query_endpoints_over_http",
                          "test_jsonl_event_listener_writes_one_line_per_query")]


@pytest.fixture(scope="module")
def traced():
    """The corpus's traced cluster, built on the port's names."""
    mp = pytest.MonkeyPatch()
    portify(mp, tracing_corpus)
    try:
        return tracing_corpus.traced.__wrapped__()
    finally:
        mp.undo()


@pytest.mark.parametrize("name", _TRACING)
def test_tracing_corpus(name, monkeypatch):
    _run(tracing_corpus, name, monkeypatch, {})


@pytest.mark.parametrize("name", _TRACING_TRACED)
def test_tracing_traced_corpus(name, monkeypatch, traced):
    _run(tracing_corpus, name, monkeypatch, {"traced": lambda: traced})


def test_jsonl_event_listener_on_the_port(monkeypatch, tmp_path):
    portify(monkeypatch, tracing_corpus)
    tracing_corpus.test_jsonl_event_listener_writes_one_line_per_query(tmp_path)


def test_query_info_stage_rollups(traced):
    """tests/test_tracing.py::test_query_info_aggregates_stage_and_operator_stats
    but its lowering counts (the shape census, item 13): per-stage
    operator rollups and per-task walls."""
    _, runner, qid = traced
    info = runner.query_info(qid)
    assert info["query_id"] == qid and info["state"] == "finished"
    assert info["wall_s"] > 0 and info["compile_count"] == 0
    summaries = [op for st in info["stages"] for group in st["operator_summaries"]
                 for op in group]
    assert any(op["input_rows"] > 0 for op in summaries)
    leaf = info["stages"][-1]
    assert leaf["tasks"] >= 1 and len(leaf["task_infos"]) == leaf["tasks"]
    assert all(t["wall_s"] is not None for t in leaf["task_infos"])
    assert "expected_lowerings" not in leaf and "observed_lowerings" not in leaf


# ---- tests/test_pushdown.py ------------------------------------------------

_PARQUET_PUSHDOWN = {"test_parquet_bytes_scanned_drops_with_pushdown",
                     "test_parquet_row_groups_pruned_by_in_list"}
_PUSHDOWN = [n for _, n in _cases(pushdown_corpus)
             if n not in _PARQUET_PUSHDOWN and n != "test_tpch_rows_scanned_drops_with_pushdown"]


@pytest.fixture(scope="module")
def tpch_oracle():
    yield from pushdown_corpus.tpch_oracle.__wrapped__()


@pytest.mark.parametrize("name", _PUSHDOWN)
def test_pushdown_corpus(name, monkeypatch):
    _run(pushdown_corpus, name, monkeypatch,
         {"mem_runner": lambda: pushdown_corpus.mem_runner.__wrapped__()})


@pytest.mark.parametrize("qname,sql", [("q6", pushdown_corpus.Q6), ("q3", pushdown_corpus.Q3)])
def test_pushdown_tpch_rows_scanned(qname, sql, monkeypatch, tpch_oracle):
    portify(monkeypatch, pushdown_corpus)
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    r.register_catalog("tpch", ttpch.create_tpch_connector())
    pushdown_corpus.test_tpch_rows_scanned_drops_with_pushdown(qname, sql, r, tpch_oracle)


# ---- the corpora's coverage ------------------------------------------------

_ELSEWHERE = {
    # tests/test_torch_serde.py runs the serde cases
    **{f"test_distributed.py::{n}": "tests/test_torch_serde.py"
       for n in ("test_serde_roundtrip", "test_serde_compression_roundtrip",
                 "test_serde_wire_is_not_pickle", "test_serde_all_types_roundtrip",
                 "test_serde_rejects_corrupt_frames", "test_page_concat_unifies_dictionaries")},
    "test_distributed.py::test_distributed_tpch":
        "tests/test_torch_distributed_a.py and _b.py (the port's local rows, which "
        "tests/test_torch_tpch_a.py and _b.py hold against sqlite)",
    "test_stats.py::test_explain_analyze_device_inclusive_attribution":
        "tests/test_torch_explain_analyze.py",
    "test_observability.py::test_explain_analyze_stats": "tests/test_torch_explain_analyze.py",
    "test_observability.py::test_dynamic_filter_prunes_probe":
        "tests/test_torch_explain_analyze.py",
    "test_tracing.py::test_jsonl_event_listener_writes_one_line_per_query":
        "test_jsonl_event_listener_on_the_port",
    "test_pushdown.py::test_tpch_rows_scanned_drops_with_pushdown":
        "test_pushdown_tpch_rows_scanned",
    **{f"test_pushdown.py::{n}": "tests/test_torch_files.py" for n in _PARQUET_PUSHDOWN},
    "test_stats.py::test_estimate_accuracy": "test_stats_estimate_accuracy",
}
_ELSEWHERE.update({
    **{f"test_distributed.py::{n}": "tests/test_torch_wire.py"
       for n in ("test_http_worker_topology", "test_internal_auth_rejects_unauthenticated",
                 "test_http_task_failure_reported", "test_worker_refuses_to_start_without_secret",
                 "test_fte_survives_task_failure_at_start",
                 "test_fte_survives_task_failure_after_output", "test_fte_injection_matrix",
                 "test_fte_retries_exhausted", "test_query_retry_policy",
                 "test_spool_commit_roundtrip", "test_task_spec_wire_is_typed_json_not_pickle")},
    "test_node_scheduler.py::test_fte_speculation_beats_straggler": "tests/test_torch_wire.py",
    "test_tracing.py::test_fte_retry_and_chaos_annotations_land_on_spans":
        "tests/test_torch_wire.py",
    "test_state_machine.py::test_metrics_endpoint": "tests/test_torch_front_door.py",
    "test_tracing.py::test_query_endpoints_over_http": "tests/test_torch_front_door.py",
})
WAITING = {
    "test_tracing.py::test_query_info_aggregates_stage_and_operator_stats":
        "item 13 (its lowering counts are the shape census's)",
    "test_tracing.py::test_watchdog_fires_fast_on_warm_hung_operator":
        "item 13 (the chaos harness)",
}


def test_the_corpora_are_covered():
    ran = {f"test_distributed.py::{n}" for n in _DIST_UNITS + _DIST_PLANS + _DIST_RUNS}
    ran |= {f"test_node_scheduler.py::{n}" for n in _NS}
    ran |= {f"test_state_machine.py::{n}" for n in _SM}
    ran |= {f"test_stats.py::{n}" for n in _STATS}
    ran |= {f"test_observability.py::{n}" for n in _OBS}
    ran |= {f"test_tracing.py::{n}" for n in _TRACING + _TRACING_TRACED}
    ran |= {f"test_pushdown.py::{n}" for n in _PUSHDOWN}
    for f, module in (("test_distributed.py", dist_corpus), ("test_node_scheduler.py", ns_corpus),
                      ("test_state_machine.py", sm_corpus), ("test_stats.py", stats_corpus),
                      ("test_observability.py", obs_corpus), ("test_tracing.py", tracing_corpus),
                      ("test_pushdown.py", pushdown_corpus)):
        every = {f"{f}::{n}" for _, n in _cases(module)}
        accounted = ran | set(WAITING) | set(_ELSEWHERE)
        assert every == accounted & every, sorted(every - accounted)
    assert not ran & set(WAITING) and not ran & set(_ELSEWHERE)
    assert all(re.match(r"item (12|13) ", v) for v in WAITING.values())


# ---- the arms of later items raise ------------------------------------------


def test_mesh_execution_with_in_process_workers_raises_item_12():
    r = DistributedQueryRunner(Session(catalog="tpch", schema="tiny"), n_workers=2,
                               device="cpu")
    r.register_catalog("tpch", ttpch.create_tpch_connector())
    with pytest.raises(NotImplementedError, match="item 12"):
        r.execute("select count(*) from nation")


def test_retry_policy_task_raises_item_11b():
    """retry_policy = 'task' (item 11b, since ported) runs the FTE
    scheduler over the spooled exchange and answers as the page plane."""
    r = _port_cluster(retry_policy="task")
    res = r.execute("select n_regionkey, count(*) from nation group by 1 order by 1")
    assert res.rows == [[k, 5] for k in range(5)] and res.data_plane == "fte"
    assert r.last_fte_stats["retries"] == 0


def test_recovery_spool_stages_raises_item_13():
    r = _port_cluster(retry_policy="query", recovery_spool_stages=True)
    with pytest.raises(NotImplementedError, match="item 13"):
        r.execute("select count(*) from nation")


def _values_spec(task_id, locations):
    from trino_tpu_torch import types as T
    from trino_tpu_torch.sql.plan import Field, RemoteSourceNode

    node = RemoteSourceNode((1,), (Field("a", T.BIGINT),))
    frag = tfragmenter.PlanFragment(0, node, "single", "single")
    return TaskSpec(task_id=task_id, fragment=frag, n_output_partitions=1,
                    remote_schemas={1: [(T.BIGINT, None)]}, scan_slice=None,
                    input_locations={1: locations})


@pytest.mark.parametrize("location", [("http", "http://127.0.0.1:1", "q1.1.0"),
                                      ("spool", "/nonexistent", "q1.1.0")])
def test_a_remote_or_spooled_location_raises_item_11b(location, monkeypatch):
    """An ("http", ...) or ("spool", ...) location (item 11b, since
    ported) resolves to its fetch: against a closed port or a missing
    spool the task fails with the transport's own error once the retry
    budget (cut to 0.2 s here) is spent, never a NotImplementedError."""
    from trino_tpu_torch.runtime import error_tracker, exchange

    fast = error_tracker.RetryPolicy(max_error_duration_s=0.2)
    monkeypatch.setattr(error_tracker, "RetryPolicy", lambda: fast)
    monkeypatch.setattr(exchange, "RetryPolicy", lambda: fast)
    if location[0] == "http":
        import trino_tpu_torch.runtime.http as thttp

        with pytest.raises(Exception) as e:
            thttp.http_fetch(location[1], location[2])(0, 0, 1, 0.0)
        assert not isinstance(e.value, NotImplementedError)
    t = TaskExecution(_values_spec(TaskId("qloc", 0, 0), [location]), CatalogManager(),
                      device="cpu")
    t.start()
    t.join(60)
    assert t.state == "failed"
    assert "NotImplementedError" not in t.failure and "11b" not in t.failure
    if location[0] == "spool":
        assert "FileNotFoundError" in t.failure


def test_a_spooled_output_raises_item_11b(tmp_path):
    """TaskSpec.spool_dir (item 11b, since ported): the task's output is
    spooled and committed, and reads back through a ("spool", ...)
    location in a consumer task."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.sql.plan import Field, ValuesNode
    from trino_tpu_torch.runtime.coordinator import _page_rows
    from trino_tpu_torch.runtime.spool import is_committed

    node = ValuesNode((Field("a", T.BIGINT),), ((1,), (2,), (3,)))
    frag = tfragmenter.PlanFragment(1, node, "single", "single")
    spec = TaskSpec(task_id=TaskId("qspool", 1, 0), fragment=frag, n_output_partitions=1,
                    remote_schemas={}, scan_slice=None, input_locations={},
                    spool_dir=str(tmp_path))
    producer = TaskExecution(spec, CatalogManager(), device="cpu")
    producer.start()
    producer.join(60)
    assert producer.state == "finished" and is_committed(str(tmp_path), "qspool.1.0")
    consumer = TaskExecution(
        _values_spec(TaskId("qspool", 0, 0), [("spool", str(tmp_path), "qspool.1.0")]),
        CatalogManager(), device="cpu")
    consumer.start()
    consumer.join(60)
    assert consumer.state == "finished", consumer.failure
    rows, token, done = [], 0, False
    while not done:
        pages, token, done = consumer.buffer.get_pages(0, token, 16)
        rows += [r for p in pages for r in _page_rows(p)]
    assert rows == [[1], [2], [3]]


def test_a_capacity_ladder_raises_item_13():
    from trino_tpu_torch.exec.exchange_ops import RemoteSourceOperator

    with pytest.raises(NotImplementedError, match="item 13"):
        RemoteSourceOperator(None, None, ladder=object(), device="cpu")


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="checks the no-card path")
def test_without_a_card_the_runner_and_a_worker_raise():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedQueryRunner(Session(mesh_execution=False), n_workers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker("w0", CatalogManager())


# ---- teardown ------------------------------------------------------------------


def _task_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("task-", "pipeline-producer-", "exchange-pull-"))]


def _no_task_threads_left():
    deadline = time.monotonic() + 10
    while _task_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _task_threads(), [t.name for t in _task_threads()]


def test_no_task_thread_outlives_a_failed_or_cancelled_query():
    """A task failure (an injected crash in the source stage) and a
    cancel (the client stops polling) each end their query with every
    task thread joined."""
    inj = FailureInjector()
    cats = CatalogManager()
    cats.register("tpch", ttpch.create_tpch_connector())
    workers = [Worker(f"td-w{i}", cats, failure_injector=inj, device="cpu")
               for i in range(2)]
    r = DistributedQueryRunner(Session(catalog="tpch", schema="tiny", mesh_execution=False),
                               worker_handles=workers, hash_partitions=2, device="cpu")
    r.catalogs = cats
    sql = "select o_orderstatus, count(*) from orders group by 1 order by 1"
    want = r.execute(sql).rows
    _no_task_threads_left()
    inj.inject(fragment_id=0, partition=1, attempts=(0,), where="mid")
    with pytest.raises(RuntimeError, match="injected mid failure"):
        r.execute(sql)
    _no_task_threads_left()
    inj.clear()
    inj.inject(where="batch", stall_s=5.0, max_hits=1)
    calls = []
    with pytest.raises(RuntimeError, match="abandoned"):
        r.execute(sql, cancel=lambda: calls.append(1) or len(calls) > 3)
    _no_task_threads_left()
    inj.clear()
    assert r.execute(sql).rows == want
    assert all(not w.task_ids() for w in workers)


def test_query_retry_replays_a_failed_attempt():
    """retry_policy = 'query': the first attempt's task dies at start,
    the second attempt (a fresh task namespace) answers."""
    inj = FailureInjector()
    cats = CatalogManager()
    cats.register("tpch", ttpch.create_tpch_connector())
    workers = [Worker(f"qr-w{i}", cats, failure_injector=inj, device="cpu") for i in range(2)]
    r = DistributedQueryRunner(Session(catalog="tpch", schema="tiny", retry_policy="query"),
                               worker_handles=workers, hash_partitions=2, device="cpu")
    r.catalogs = cats
    sql = "select l_returnflag, sum(l_quantity), count(*) from lineitem group by 1 order by 1"
    want = r.execute(sql).rows
    assert r.last_query_attempts == 1
    inj.inject(fragment_id=0, partition=0, attempts=(0,), where="start", max_hits=1)
    assert r.execute(sql).rows == want
    assert r.last_query_attempts == 2
    assert r.query_info(r.last_query_id)["retry_count"] == 1


# ---- zone ids across the exchange ---------------------------------------------


def test_zoned_values_cross_the_exchange_intact():
    """A GROUP BY of a TIMESTAMP WITH TIME ZONE column through 4 workers
    (hash partitioned on the zoned key, min/max carried through the
    partial state) equals the local runner's rows. The pages carry the
    packed value with the host registry's zone id (ROADMAP §3)."""
    from trino_tpu_torch.connectors.memory import create_memory_connector

    setup = ["create table memory.z.ev (id bigint, t timestamp(3) with time zone)",
             "insert into memory.z.ev values "
             "(1, timestamp '2021-03-14 01:30:00 America/New_York'), "
             "(2, timestamp '2021-03-14 09:30:00 UTC'), "
             "(3, timestamp '2021-03-14 08:30:00 Europe/Berlin'), "
             "(4, timestamp '2021-03-14 01:30:00 America/New_York'), "
             "(5, timestamp '2022-01-01 00:00:00 Asia/Tokyo'), "
             "(6, timestamp '2021-03-14 15:30:00 Asia/Tokyo')"]
    mem = create_memory_connector()
    local = LocalQueryRunner(Session(catalog="memory", schema="z"), device="cpu")
    local.register_catalog("memory", mem)
    for sql in setup:
        local.execute(sql)
    r = DistributedQueryRunner(Session(catalog="memory", schema="z", mesh_execution=False),
                               n_workers=4, hash_partitions=4, device="cpu")
    r.register_catalog("memory", mem)
    # rows 1-5 hold four distinct instants (1 and 4 are equal in one zone)
    for sql in ("select t, count(*), min(id) from ev where id < 6 group by t order by 3",
                "select id % 2, min(t), max(t) from ev where id < 6 group by 1 order by 1",
                "select count(*) c from ev group by t order by 1"):
        assert r.execute(sql).rows == local.execute(sql).rows
    # 01:30 New York and 15:30 Tokyo are one instant: one group, across
    # the hash partitions too
    assert sorted(r.execute("select count(*) from ev group by t").rows) == [
        [1], [1], [1], [3]]


def http_cluster(package, session, catalogs, n_workers=2, hash_partitions=2, **worker):
    """A DistributedQueryRunner of `package` ("trino_tpu" or
    "trino_tpu_torch") over `n_workers` WorkerServers on 127.0.0.1 that
    share `catalogs`, without internal auth (the caller clears
    TRINO_TPU_INTERNAL_SECRET). Returns (runner, servers); the caller
    stops the servers."""
    http = importlib.import_module(package + ".runtime.http")
    rt = importlib.import_module(package + ".runtime")
    on = {"device": "cpu"} if package == "trino_tpu_torch" else {}
    servers = [http.WorkerServer(rt.Worker(f"{package}-w{i}", catalogs, **worker, **on),
                                 internal_secret=None, require_secret=False)
               for i in range(n_workers)]
    runner = rt.DistributedQueryRunner(
        session, worker_handles=[http.HttpWorkerClient(s.uri, internal_secret=None)
                                 for s in servers],
        hash_partitions=hash_partitions, **on)
    runner.catalogs = catalogs
    return runner, servers


def reference_codec_with_constraints(mp):
    """The reference's codec registry plus connectors.spi.ColumnConstraint,
    the one wire class it lacks (ROADMAP §3): without it no scan with a
    pushed-down predicate crosses the reference's wire."""
    from trino_tpu.connectors.spi import ColumnConstraint as JConstraint
    from trino_tpu.runtime import codec as jcodec

    mp.setattr(jcodec, "_REGISTRY", {**jcodec.registry(), "ColumnConstraint": JConstraint})


def test_zoned_values_cross_the_http_wire_intact(monkeypatch):
    """test_zoned_values_cross_the_exchange_intact's GROUP BYs over two
    WorkerServers, in both packages: the rows equal each package's
    in-process runner's. The page wire carries the host registry's zone
    id, so the two ends agree here (one host); across hosts with other
    zone files (498 named zones on the card machine, 599 here) both
    packages would misname a zone (ROADMAP §3, shared deviations)."""
    from trino_tpu.connectors.memory import create_memory_connector as jmem
    from trino_tpu.connectors.spi import CatalogManager as JCats
    from trino_tpu_torch.connectors.memory import create_memory_connector

    monkeypatch.delenv("TRINO_TPU_INTERNAL_SECRET", raising=False)
    reference_codec_with_constraints(monkeypatch)
    setup = ["create table memory.z.ev (id bigint, t timestamp(3) with time zone)",
             "insert into memory.z.ev values "
             "(1, timestamp '2021-03-14 01:30:00 America/New_York'), "
             "(2, timestamp '2021-03-14 09:30:00 UTC'), "
             "(3, timestamp '2021-03-14 08:30:00 Europe/Berlin'), "
             "(4, timestamp '2021-03-14 01:30:00 America/New_York'), "
             "(5, timestamp '2022-01-01 00:00:00 Asia/Tokyo'), "
             "(6, timestamp '2021-03-14 15:30:00 Asia/Tokyo')"]
    queries = ("select t, count(*), min(id) from ev where id < 6 group by t order by 3",
               "select id % 2, min(t), max(t) from ev where id < 6 group by 1 order by 1",
               "select count(*) c from ev group by t order by 1")
    answers = {}
    for package, mem, cats, local_kw in (
            ("trino_tpu", jmem(), JCats(), {}),
            ("trino_tpu_torch", create_memory_connector(), CatalogManager(),
             {"device": "cpu"})):
        engine = importlib.import_module(package + ".engine")
        local = engine.LocalQueryRunner(engine.Session(catalog="memory", schema="z"), **local_kw)
        local.register_catalog("memory", mem)
        for sql in setup:
            local.execute(sql)
        cats.register("memory", mem)
        r, servers = http_cluster(package, engine.Session(catalog="memory", schema="z",
                                                           mesh_execution=False), cats)
        try:
            got = [r.execute(sql).rows for sql in queries]
        finally:
            for srv in servers:
                srv.stop()
        assert got == [local.execute(sql).rows for sql in queries]
        answers[package] = [[[str(v) for v in row] for row in rows] for rows in got]
    assert answers["trino_tpu"] == answers["trino_tpu_torch"]


# ---- TPC-H Q13 under a 1 MiB pool (ROADMAP §3) -------------------------------


def test_q13_under_a_one_mib_pool_the_reference_kills_and_the_port_answers():
    """One worker, one hash partition, a 1 MiB pool, 4,096-row batches.
    The reference's partial aggregation over the join's output reserves
    1,615,872 bytes: 26,624 of group state plus 1,589,248 for the one
    16,384-row input batch its deferred-rehash queue holds, so its
    low-memory killer ends the query. The port settles each batch's
    overflow before taking the next and holds no input batch, so it
    reserves the state alone and answers the local runner's 23 rows."""
    from trino_tpu.runtime.memory import ExceededMemoryLimitError as JExceeded

    kw = dict(catalog="tpch", schema="tiny", mesh_execution=False,
              memory_pool_bytes=1 << 20, batch_rows=4096)
    ref = JDistributed(JSession(**kw), n_workers=1, hash_partitions=1)
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    with pytest.raises(JExceeded, match="victim held 868352 bytes, request was 1615872 bytes"):
        ref.execute(QUERIES[13])
    port = DistributedQueryRunner(Session(**kw), n_workers=1, hash_partitions=1, device="cpu")
    port.register_catalog("tpch", ttpch.create_tpch_connector())
    local = LocalQueryRunner(Session(catalog="tpch", schema="tiny", batch_rows=4096),
                             device="cpu")
    local.register_catalog("tpch", ttpch.create_tpch_connector())
    rows = port.execute(QUERIES[13]).rows
    assert rows == local.execute(QUERIES[13]).rows
    assert len(rows) == 23 and rows[0] == [0, 500]
    assert all(w.memory_pool.reserved_bytes == 0 for w in port.workers)


# ---- chip_smoke.py's phase distributed ----------------------------------------


def test_phase_distributed_identities():
    """Phase distributed's statements and checks at tiny on the CPU (the
    card runs them at sf1): every statement row-equal to its local twin,
    the expected fragments, the join's inputs through the exchange."""
    import chip_smoke as CS

    steps = CS.distributed_identities("tiny", "cpu", lambda *a: None)
    assert set(steps) == {name for name, _ in CS.DIST_STATEMENTS}
    assert steps["full_sort"]["rows"] == 15000 and steps["count"]["rows"] == 1
    assert CS.rows_match([[1.0, 2]], [[1.0 + 1e-12, 2]]) and not CS.rows_match([[1.0]], [[1.1]])


@pytest.mark.parametrize("lo,hi", [(0, 15000), (7, 9), (3, 3), (14999, 15000)])
def test_lineitem_rows_equal_the_reference(lo, hi):
    """The tpch generator's (order, line number) expansion, vectorized in
    the port (every lineitem scan, each task's split included), equals
    the reference's row for row."""
    import numpy as np

    want = jtpch._lineitem_rows(lo, hi, 0.01)
    got = ttpch._lineitem_rows(lo, hi, 0.01)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---- the coordinator's other arms -------------------------------------------------


def test_statements_run_through_the_embedded_runner_and_drop_cached_plans():
    """CREATE/INSERT go through the runner's one LocalQueryRunner; an
    INSERT drops the cached distributed plans over its table only."""
    from trino_tpu_torch.connectors.memory import create_memory_connector

    r = DistributedQueryRunner(Session(catalog="memory", schema="s", mesh_execution=False),
                               n_workers=2, hash_partitions=2, device="cpu")
    r.register_catalog("memory", create_memory_connector())
    r.register_catalog("tpch", ttpch.create_tpch_connector())
    r.execute("create table k (a bigint, g varchar)")
    r.execute("insert into k values (1, 'x'), (2, 'y'), (3, 'x')")
    q = "select g, count(*), sum(a) from k group by g order by g"
    other = "select count(*) from tpch.tiny.nation"
    assert r.execute(q).rows == [["x", 2, 4], ["y", 1, 2]]
    assert r.execute(other).rows == [[25]]
    hits = r._plan_cache.hits
    r.execute("insert into k values (5, 'y')")
    assert r.execute(other).rows == [[25]] and r._plan_cache.hits == hits + 1
    assert r.execute(q).rows == [["x", 2, 4], ["y", 2, 7]]
    assert r._plan_cache.hits == hits + 1


def test_access_control_guards_the_distributed_path():
    from trino_tpu_torch.security import AccessDeniedError, FileBasedAccessControl, Identity

    rules = [{"user": "alice", "table": "customer", "privileges": []},
             {"user": ".*", "privileges": ["SELECT"]}]
    r = DistributedQueryRunner(Session(catalog="tpch", schema="tiny", mesh_execution=False,
                                       user="alice"),
                               n_workers=2, hash_partitions=2, device="cpu",
                               access_control=FileBasedAccessControl(rules))
    r.register_catalog("tpch", ttpch.create_tpch_connector())
    assert r.execute("select count(*) from nation").rows == [[25]]
    with pytest.raises(AccessDeniedError):
        r.execute("select count(*) from customer")
    with pytest.raises(AccessDeniedError):
        r.execute("explain select count(*) from customer")
    assert r.execute("select count(*) from customer", identity=Identity("bob")).rows == [[1500]]


def test_a_drained_worker_takes_no_new_tasks():
    r = _port_cluster()
    sql = "select o_orderstatus, count(*) from orders group by 1 order by 1"
    want = r.execute(sql).rows
    assert r.drain("worker-0", timeout_s=5.0)
    assert r.execute(sql).rows == want
    assert not r.workers[0].task_ids() and r.workers[0].state == "shutting_down"


def test_worker_pools_under_the_cluster_memory_manager():
    """memory_pool_bytes gives every in-process worker a pool under one
    ClusterMemoryManager. Under a roomy pool the GROUP BY answers as the
    local runner does. Under a 128 KiB pool its tasks reserve side by
    side, so whether revocation makes room in time depends on their
    interleaving (the reference, too, is killed at this size): the query
    either spills and answers the same rows or is killed with the typed
    error. Either way every pool and task thread is released."""
    from trino_tpu_torch.runtime.memory import ExceededMemoryLimitError

    sql = "select o_custkey, count(*), sum(o_totalprice) from orders group by 1 order by 1"
    local = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    local.register_catalog("tpch", ttpch.create_tpch_connector())
    want = local.execute(sql).rows
    roomy = _port_cluster(memory_pool_bytes=16 << 20, batch_rows=8192)
    assert roomy.memory_manager is not None
    assert roomy.execute(sql).rows == want
    tight = _port_cluster(memory_pool_bytes=128 * 1024, batch_rows=8192)
    try:
        assert tight.execute(sql).rows == want
    except ExceededMemoryLimitError as e:
        assert "low-memory killer" in str(e)
        assert tight.query_info(tight.last_query_id)["error_code"] == "EXCEEDED_MEMORY_LIMIT"
    _no_task_threads_left()
    for r in (roomy, tight):
        assert all(w.memory_pool.reserved_bytes == 0 for w in r.workers)
