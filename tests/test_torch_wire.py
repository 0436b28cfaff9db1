"""The wire of trino_tpu_torch (device="cpu") against trino_tpu: the typed
TaskSpec codec, the page frames, HTTP workers, the spool and task-retry
fault-tolerant execution (FTE).

- The codec's bytes: for every fragment of TPC-H Q1, Q3 and Q18 at tiny,
  as the distributed runner plans them, the port's codec.dumps(TaskSpec)
  equals the reference's once the three TaskSpec fields the port lacks
  (shape_stabilization, capacity_ladder_base, record_output) are dropped
  from the reference's JSON. Those scans carry pushed-down predicates,
  and the reference's registry lacks ColumnConstraint (ROADMAP §3), so
  its registry is given that class for the comparison; unpatched it
  refuses the spec. loads refuses pickle and unknown tags as the
  reference does.
- The page frames: pack_pages of the same pages is byte-equal, and the
  reference's unpack_pages reads the port's bytes.
- HTTP workers: Q1, Q3 and Q18 through two WorkerServers on 127.0.0.1
  give the reference's rows (integers and decimals bit-equal, doubles
  within the oracle's tolerance).
- FTE: every shape of tests/test_distributed.py's injection matrix
  answers the reference's rows with every task's first attempt killed.
- The corpora run as written with their names bound to the port's
  (tests/test_torch_distributed.portify): tests/test_distributed.py's
  HTTP, FTE, spool and codec cases, test_node_scheduler.py's speculation
  case, test_tracing.py's FTE span case and tests/test_deadlines.py.
  test_the_corpora_are_covered accounts for every case; the chaos
  harness's wait for ROADMAP §1 item 13.
- Every server is stopped, and no task or server thread outlives a test.
"""

import importlib
import inspect
import json
import pickle
import threading
import time

import pytest

import tests.test_deadlines as deadlines_corpus
import tests.test_distributed as dist_corpus
import tests.test_node_scheduler as ns_corpus
import tests.test_tracing as tracing_corpus
from tests.oracle import assert_rows_match
from tests.test_torch_distributed import (
    _run,
    http_cluster,
    portify,
    reference_codec_with_constraints,
)
from tests.test_torch_distributed import WAITING as DIST_WAITING
from tests.test_torch_statements import _cases
from tests.tpch_queries import QUERIES
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.connectors.spi import CatalogManager as JCatalogManager
from trino_tpu.engine import LocalQueryRunner as JLocal
from trino_tpu.engine import Session as JSession
from trino_tpu.runtime import codec as jcodec
from trino_tpu.runtime import http as jhttp
from trino_tpu.runtime.coordinator import DistributedQueryRunner as JDistributed
from trino_tpu.runtime.task import TaskId as JTaskId
from trino_tpu.runtime.task import TaskSpec as JTaskSpec
from trino_tpu.sql import fragmenter as jfragmenter
from trino_tpu.sql.parser import parse as jparse
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.connectors.spi import CatalogManager
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.runtime import DistributedQueryRunner, Worker
from trino_tpu_torch.runtime import codec
from trino_tpu_torch.runtime import http as thttp
from trino_tpu_torch.runtime.failure import FailureInjector
from trino_tpu_torch.runtime.task import TaskId, TaskSpec
from trino_tpu_torch.sql import fragmenter as tfragmenter
from trino_tpu_torch.sql.parser import parse

# TaskSpec fields of the reference's compile and recovery tiers (item 13)
_UNPORTED_FIELDS = ("shape_stabilization", "capacity_ladder_base", "record_output")


def _threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("task-", "pipeline-producer-", "exchange-pull-",
                                  "worker-http-"))]


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test(monkeypatch):
    """Internal auth off unless a case sets it; afterwards every task,
    exchange and server thread is gone."""
    monkeypatch.delenv("TRINO_TPU_INTERNAL_SECRET", raising=False)
    before = {t.ident for t in _threads()}
    yield
    deadline = time.monotonic() + 15
    while [t for t in _threads() if t.ident not in before] and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [t.name for t in _threads() if t.ident not in before]


# ---- the codec's bytes --------------------------------------------------------


def _fragments(package, qid):
    """The fragments the package's runner would send for TPC-H `qid`:
    its LocalQueryRunner's optimized plan through plan_distributed."""
    if package == "trino_tpu":
        r = JLocal(JSession(catalog="tpch", schema="tiny"))
        r.register_catalog("tpch", jtpch.create_tpch_connector())
        return jfragmenter.plan_distributed(r._analyze(jparse(QUERIES[qid])),
                                            r.catalogs).all_fragments()
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    r.register_catalog("tpch", ttpch.create_tpch_connector())
    return tfragmenter.plan_distributed(r._analyze(parse(QUERIES[qid])),
                                        r.catalogs).all_fragments()


def _spec(spec, tid, fragment):
    return spec(task_id=tid("q7", fragment.id, 1, 2), fragment=fragment, n_output_partitions=3,
                remote_schemas={}, scan_slice=(1, 2) if fragment.partitioning == "source" else None,
                input_locations={9: [("http", "http://127.0.0.1:1", "q7.9.0"),
                                     ("spool", "/s", "q7.9.1")]},
                batch_rows=4096, deadline_epoch_s=12.5)


@pytest.mark.parametrize("qid", [1, 3, 18])
def test_codec_bytes_equal_the_reference(qid, monkeypatch):
    want_frags, got_frags = _fragments("trino_tpu", qid), _fragments("trino_tpu_torch", qid)
    assert len(want_frags) == len(got_frags)
    constrained = False
    for jf, tf in zip(want_frags, got_frags):
        got = codec.dumps(_spec(TaskSpec, TaskId, tf))
        assert codec.loads(got) == _spec(TaskSpec, TaskId, tf)
        constrained |= b'"ColumnConstraint"' in got
        with monkeypatch.context() as mp:
            reference_codec_with_constraints(mp)
            wire = json.loads(jcodec.dumps(_spec(JTaskSpec, JTaskId, jf)))
        for name in _UNPORTED_FIELDS:
            wire["f"].pop(name)
        assert json.dumps(wire, separators=(",", ":")).encode() == got
    # Q1's and Q3's scans carry pushed-down predicates; Q18's filter is a
    # HAVING
    assert constrained == (qid != 18)
    if qid == 1:
        # unpatched, the reference refuses a scan with a pushed predicate
        with pytest.raises(jcodec.CodecError, match="ColumnConstraint"):
            for jf in want_frags:
                jcodec.dumps(_spec(JTaskSpec, JTaskId, jf))


@pytest.mark.parametrize("payload", [
    "pickle", "unknown_class", "untagged", "unknown_enum", "unknown_field"])
def test_codec_refuses_what_the_reference_refuses(payload):
    spec = _spec(TaskSpec, TaskId, _fragments("trino_tpu_torch", 1)[-1])
    bad = {"pickle": lambda: pickle.dumps({"a": 1}),
           "unknown_class": lambda: b'{"$":"os.system","f":{}}',
           "untagged": lambda: b'{"a":1}',
           "unknown_enum": lambda: b'{"$":"~enum","c":"Signals","v":"SIGKILL"}',
           "unknown_field": lambda: b'{"$":"TaskId","f":{"query_id":"q","evil":1}}'}[payload]()
    errors = []
    for mod in (jcodec, codec):
        with pytest.raises(Exception) as e:
            mod.loads(bad)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]
    with pytest.raises(codec.CodecError):
        codec.dumps(lambda: None)
    assert codec.loads(codec.dumps(spec)) == spec


def test_codec_refuses_tensors_and_unported_classes():
    import dataclasses

    import torch

    with pytest.raises(codec.CodecError, match="torch.Tensor"):
        codec.dumps({"x": torch.zeros(2)})

    @dataclasses.dataclass(frozen=True)
    class SpooledValuesNode:
        rows: tuple = ()

    with pytest.raises(codec.CodecError, match="item 13"):
        codec.dumps(SpooledValuesNode())
    with pytest.raises(codec.CodecError, match="item 13"):
        codec.loads(b'{"$":"SpooledValuesNode","f":{}}')


# ---- the page frames -------------------------------------------------------------


def test_pack_pages_bytes_equal_the_reference():
    from tests.test_torch_serde import CASES
    from trino_tpu.exec import serde as jserde
    from trino_tpu_torch.exec import serde

    pairs = [CASES[n]() for n in ("bigint", "varchar", "decimal(30,2)", "array(varchar)",
                                  "timestamp with time zone")]
    want = jhttp.pack_pages([jserde.Page.from_batch(j) for j, _ in pairs])
    got = thttp.pack_pages([serde.Page.from_batch(t) for _, t in pairs])
    assert got == want
    assert jhttp.pack_pages([]) == thttp.pack_pages([])
    back = jhttp.unpack_pages(got)
    assert [jserde.serialize_page(p) for p in back] == [
        serde.serialize_page(serde.Page.from_batch(t)) for _, t in pairs]
    mine = thttp.unpack_pages(got)
    assert [p.to_batch(device="cpu").to_pylists() for p in mine] == [
        t.to_pylists() for _, t in pairs]


# ---- HTTP workers against the reference --------------------------------------------


@pytest.fixture(scope="module")
def reference_rows():
    """The reference's rows through its own HTTP workers (its codec given
    ColumnConstraint), per query."""
    mp = pytest.MonkeyPatch()
    mp.delenv("TRINO_TPU_INTERNAL_SECRET", raising=False)
    reference_codec_with_constraints(mp)
    cats = JCatalogManager()
    cats.register("tpch", jtpch.create_tpch_connector())
    r, servers = http_cluster("trino_tpu", JSession(catalog="tpch", schema="tiny"), cats)
    try:
        return {q: r.execute(QUERIES[q]) for q in (1, 3, 18)}
    finally:
        for s in servers:
            s.stop()
        mp.undo()


@pytest.mark.parametrize("qid", [1, 3, 18])
def test_http_rows_equal_the_reference(qid, reference_rows):
    cats = CatalogManager()
    cats.register("tpch", ttpch.create_tpch_connector())
    r, servers = http_cluster("trino_tpu_torch", Session(catalog="tpch", schema="tiny"), cats)
    try:
        got = r.execute(QUERIES[qid])
    finally:
        for s in servers:
            s.stop()
    want = reference_rows[qid]
    assert got.column_names == want.column_names
    exact = [i for i, t in enumerate(want.column_types) if not t.is_floating]
    assert [[row[i] for i in exact] for row in got.rows] == [
        [row[i] for i in exact] for row in want.rows]
    assert_rows_match(got.rows, want.rows, ordered=True, abs_tol=1e-2)


def test_the_reference_cannot_send_a_constrained_scan():
    """Reference fault (ROADMAP §3): trino_tpu's codec registry lacks
    ColumnConstraint, so its HTTP runner fails a query with a pushed-down
    predicate before any task starts; the port's answers it."""
    sql = "select count(*) from orders where o_orderkey < 100"
    cats = JCatalogManager()
    cats.register("tpch", jtpch.create_tpch_connector())
    r, servers = http_cluster("trino_tpu", JSession(catalog="tpch", schema="tiny"), cats)
    try:
        with pytest.raises(jcodec.CodecError, match="unregistered dataclass 'ColumnConstraint'"):
            r.execute(sql)
    finally:
        for s in servers:
            s.stop()
    tcats = CatalogManager()
    tcats.register("tpch", ttpch.create_tpch_connector())
    local = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    local.catalogs = tcats
    r, servers = http_cluster("trino_tpu_torch", Session(catalog="tpch", schema="tiny"), tcats)
    try:
        assert r.execute(sql).rows == local.execute(sql).rows == [[27]]
    finally:
        for s in servers:
            s.stop()


# ---- FTE against the reference ------------------------------------------------------

_SHAPES = sorted(dist_corpus.FTE_SHAPES)


@pytest.fixture(scope="module")
def reference_fte_rows():
    inj_free = {}
    cats = JCatalogManager()
    cats.register("tpch", jtpch.create_tpch_connector())
    from trino_tpu.runtime.worker import Worker as JWorker

    r = JDistributed(JSession(catalog="tpch", schema="tiny", retry_policy="task"),
                     worker_handles=[JWorker(f"jw{i}", cats) for i in range(2)],
                     hash_partitions=2)
    r.catalogs = cats
    for shape in _SHAPES:
        inj_free[shape] = r.execute(dist_corpus.FTE_SHAPES[shape]).rows
    return inj_free


@pytest.fixture(scope="module")
def port_fte():
    inj = FailureInjector()
    cats = CatalogManager()
    cats.register("tpch", ttpch.create_tpch_connector())
    workers = [Worker(f"fw{i}", cats, failure_injector=inj, device="cpu") for i in range(2)]
    r = DistributedQueryRunner(Session(catalog="tpch", schema="tiny", retry_policy="task"),
                               worker_handles=workers, hash_partitions=2, device="cpu")
    r.catalogs = cats
    return r, inj


@pytest.mark.parametrize("where", ["start", "mid"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_fte_injection_matrix_equals_the_reference(shape, where, port_fte, reference_fte_rows):
    r, inj = port_fte
    inj.clear()
    inj.inject(attempts=(0,), where=where)
    try:
        rows = r.execute(dist_corpus.FTE_SHAPES[shape]).rows
    finally:
        inj.clear()
    assert rows == reference_fte_rows[shape]
    assert r.last_fte_stats["retries"] >= 1
    assert r.query_info(r.last_query_id)["data_plane"] == "fte"


# ---- tests/test_distributed.py ------------------------------------------------------

_DIST_HTTP = ["test_http_worker_topology", "test_internal_auth_rejects_unauthenticated",
              "test_http_task_failure_reported", "test_worker_refuses_to_start_without_secret"]
_DIST_FTE = ["test_fte_survives_task_failure_at_start",
             "test_fte_survives_task_failure_after_output", "test_fte_retries_exhausted",
             "test_query_retry_policy", "test_spool_commit_roundtrip",
             "test_task_spec_wire_is_typed_json_not_pickle"]


def _args(corpus, mp, tmp_path):
    return {"fte_cluster": lambda: corpus.fte_cluster.__wrapped__(),
            "tmp_path": lambda: tmp_path, "monkeypatch": lambda: mp}


@pytest.mark.parametrize("name", _DIST_HTTP + _DIST_FTE)
def test_distributed_corpus(name, monkeypatch, tmp_path):
    _run(dist_corpus, name, monkeypatch, _args(dist_corpus, monkeypatch, tmp_path))


@pytest.mark.parametrize("where", ["start", "mid"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_distributed_corpus_injection_matrix(shape, where, monkeypatch):
    portify(monkeypatch, dist_corpus)
    dist_corpus.test_fte_injection_matrix(dist_corpus.fte_cluster.__wrapped__(), shape, where)


# ---- test_node_scheduler.py, test_tracing.py ---------------------------------------


def test_fte_speculation_beats_straggler(monkeypatch, tmp_path):
    _run(ns_corpus, "test_fte_speculation_beats_straggler", monkeypatch,
         _args(ns_corpus, monkeypatch, tmp_path))


def test_fte_retry_and_chaos_annotations_land_on_spans(monkeypatch):
    _run(tracing_corpus, "test_fte_retry_and_chaos_annotations_land_on_spans", monkeypatch, {})


# ---- tests/test_deadlines.py ------------------------------------------------------

_DEADLINES_WAIT = {"test_abandoned_client_is_reaped_slot_and_memory_drained",
                   "test_timebound_soak"}
_DEADLINES = [n for _, n in _cases(deadlines_corpus) if n not in _DEADLINES_WAIT]


@pytest.fixture(scope="module")
def deadlines_oracle():
    yield from deadlines_corpus.oracle.__wrapped__()


@pytest.mark.parametrize("name", _DEADLINES)
def test_deadlines_corpus(name, monkeypatch, tmp_path, deadlines_oracle):
    portify(monkeypatch, deadlines_corpus)
    fn = getattr(deadlines_corpus, name)
    args = {"oracle": lambda: deadlines_oracle, "tmp_path": lambda: tmp_path,
            "monkeypatch": lambda: monkeypatch}
    fn(**{p: args[p]() for p in inspect.signature(fn).parameters})


# ---- chip_smoke.py's phase wire ----------------------------------------------------


def test_phase_wire_identities():
    """Phase wire's three parts at tiny on the CPU (the card runs the
    HTTP part at sf1): HTTP rows equal the in-process twin's with bytes
    pulled over the wire, FTE rows under failures equal the clean run's
    with retries and spooled bytes, the Client, DB-API and CLI equal
    execute's."""
    import chip_smoke as CS

    http = CS.wire_http("tiny", "cpu", lambda *a: None)
    assert set(http) == set(CS.WIRE_STATEMENTS)
    assert all(rec["http_bytes"] > 0 for rec in http.values())
    fte = CS.wire_fte("tiny", "cpu", lambda *a: None)
    for shape, rec in fte.items():
        assert rec["none"]["retries"] == 0 and rec["none"]["spool.bytes_written"] > 0
        assert rec["start"]["retries"] >= 1 and rec["mid"]["retries"] >= 1
    front = CS.wire_front_door("tiny", "cpu", lambda *a: None)
    assert set(front) == {f"q{q}" for q in CS.WIRE_FRONT_DOOR} | {"cli_s"}


def test_phase_wire_fte_shapes_are_the_corpus():
    import chip_smoke as CS

    assert CS.WIRE_FTE_SHAPES.items() <= dist_corpus.FTE_SHAPES.items()


# ---- the corpora's coverage ------------------------------------------------------

WAITING = {
    **{f"test_deadlines.py::{n}": "item 13 (the chaos harness)" for n in _DEADLINES_WAIT},
}


def test_the_corpora_are_covered():
    """Every case of tests/test_deadlines.py runs above or waits for its
    item, and this file runs every test_distributed.py, test_node_scheduler.py
    and test_tracing.py case that tests/test_torch_distributed.py sends here.
    No WAITING map names item 11b."""
    from tests.test_torch_distributed import _ELSEWHERE as DIST_ELSEWHERE

    ran = {f"test_distributed.py::{n}" for n in _DIST_HTTP + _DIST_FTE}
    ran |= {"test_distributed.py::test_fte_injection_matrix",
            "test_node_scheduler.py::test_fte_speculation_beats_straggler",
            "test_tracing.py::test_fte_retry_and_chaos_annotations_land_on_spans"}
    ran |= {f"test_deadlines.py::{n}" for n in _DEADLINES}
    every = {f"test_deadlines.py::{n}" for _, n in _cases(deadlines_corpus)}
    assert every == (ran | set(WAITING)) & every and not ran & set(WAITING)
    sent_here = {k for k, v in DIST_ELSEWHERE.items() if v == "tests/test_torch_wire.py"}
    assert sent_here == {k for k in ran if not k.startswith("test_deadlines.py")}
    for waiting in (WAITING, DIST_WAITING):
        assert all(v.startswith(("item 12", "item 13")) for v in waiting.values())
        assert not any("11b" in v for v in waiting.values())
    assert len(_DEADLINES) == 17 and len(_cases(deadlines_corpus)) == 19
