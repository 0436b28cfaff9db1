"""The front door of trino_tpu_torch (device="cpu"): the coordinator
server with admission and resource groups, the client, DB-API, CLI,
proxy and verifier.

- The corpora run as written with their names bound to the port's
  (tests/test_torch_distributed.portify), their servers built over port
  runners on the CPU: tests/test_protocol.py, test_services.py,
  test_scheduling_r5.py and test_resource_groups.py whole,
  test_state_machine.py's metrics endpoint, test_tracing.py's query
  endpoints, test_security.py's three server cases and test_serving.py's
  three admission cases. test_the_corpora_are_covered accounts for every
  case, and for every case the other port test files send here.
  test_services.py's distributed transactions run a query over
  in-process workers with mesh_execution on: the mesh plane (item 12),
  over the 8 CPU shards portify gives the runner.
- Against the runner: TPC-H Q1, Q3 and Q18 at tiny give the same rows
  through the port's Client and DB-API as through runner.execute, and
  `python -m trino_tpu_torch.cli --server` prints them.
- The server's serving arms: a batcher given to it, or built from the
  micro-batch properties, coalesces point lookups into the reference's
  rows; GET /v1/fabric answers 200 with the fabric's status (the
  reference's fields), and /v1/metrics shows the replica, scheduler and
  fabric counters from the server's start.
- Every server is stopped, and no server thread outlives a test.
"""

import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import tests.test_protocol as protocol_corpus
import tests.test_resource_groups as rg_corpus
import tests.test_scheduling_r5 as sched_corpus
import tests.test_security as security_corpus
import tests.test_serving as serving_corpus
import tests.test_services as services_corpus
import tests.test_state_machine as sm_corpus
import tests.test_tracing as tracing_corpus
from tests.test_torch_distributed import _ELSEWHERE as DIST_ELSEWHERE
from tests.test_torch_distributed import call_case, portify
from tests.test_torch_statements import ELSEWHERE as STATEMENTS_ELSEWHERE
from tests.test_torch_statements import _cases, _ids
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from tests.tpch_queries import QUERIES
from trino_tpu_torch import dbapi
from trino_tpu_torch.client import Client
from trino_tpu_torch.connectors.tpch import create_tpch_connector
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.runtime.server import CoordinatorServer

_SERVER_THREADS = ("statement-server", "client-reaper", "proxy-server", "worker-http-")


def _threads():
    return [t for t in threading.enumerate() if t.name.startswith(_SERVER_THREADS)]


@pytest.fixture(autouse=True)
def no_server_outlives_the_test():
    before = {t.ident for t in _threads()}
    yield
    deadline = time.monotonic() + 10
    while [t for t in _threads() if t.ident not in before] and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [t.name for t in _threads() if t.ident not in before]


def _server_fixture(corpus):
    """The corpus's module-scoped server fixture, built on the port's
    names (a CoordinatorServer over a port LocalQueryRunner on the CPU)."""
    mp = pytest.MonkeyPatch()
    portify(mp, corpus)
    try:
        gen = corpus.server.__wrapped__()
        srv = next(gen)
    finally:
        mp.undo()
    assert type(srv) is CoordinatorServer
    yield srv
    gen.close()


@pytest.fixture(scope="module")
def protocol_server():
    yield from _server_fixture(protocol_corpus)


@pytest.fixture(scope="module")
def services_server():
    yield from _server_fixture(services_corpus)


# ---- tests/test_protocol.py, test_services.py ---------------------------------

# corpus case -> the ROADMAP §1 item it waits for
WAITING: dict = {}
_PROTOCOL = _cases(protocol_corpus)
_SERVICES = [c for c in _cases(services_corpus) if f"test_services.py::{c[1]}" not in WAITING]


@pytest.mark.parametrize("case", _PROTOCOL, ids=_ids(_PROTOCOL))
def test_protocol_corpus(case, monkeypatch, tmp_path, protocol_server):
    portify(monkeypatch, protocol_corpus)
    call_case(protocol_corpus, case, {"server": lambda: protocol_server, "tmp_path": lambda: tmp_path})


@pytest.mark.parametrize("case", _SERVICES, ids=_ids(_SERVICES))
def test_services_corpus(case, monkeypatch, services_server):
    portify(monkeypatch, services_corpus)
    call_case(services_corpus, case, {"server": lambda: services_server})


# ---- tests/test_scheduling_r5.py, test_resource_groups.py ------------------------

_SCHED = _cases(sched_corpus)
_RG = _cases(rg_corpus)


@pytest.mark.parametrize("case", _SCHED, ids=_ids(_SCHED))
def test_scheduling_r5_corpus(case, monkeypatch):
    portify(monkeypatch, sched_corpus)
    call_case(sched_corpus, case, {})


@pytest.mark.parametrize("case", _RG, ids=_ids(_RG))
def test_resource_groups_corpus(case, monkeypatch):
    portify(monkeypatch, rg_corpus)
    call_case(rg_corpus, case, {})


# ---- the metrics and query endpoints ------------------------------------------------


def test_metrics_endpoint(monkeypatch):
    portify(monkeypatch, sm_corpus)
    sm_corpus.test_metrics_endpoint()


def test_query_endpoints_over_http(monkeypatch):
    portify(monkeypatch, tracing_corpus)
    traced = tracing_corpus.traced.__wrapped__()
    tracing_corpus.test_query_endpoints_over_http(traced)


# ---- test_security.py's server cases, test_serving.py's admission cases -----------

_SECURITY_SERVER = [c for c in _cases(security_corpus)
                    if f"test_security.py::{c[1]}" in STATEMENTS_ELSEWHERE]
_ADMISSION = [c for c in _cases(serving_corpus)
              if STATEMENTS_ELSEWHERE.get(f"test_serving.py::{c[1]}")
              == "tests/test_torch_front_door.py"]


@pytest.mark.parametrize("case", _SECURITY_SERVER, ids=_ids(_SECURITY_SERVER))
def test_security_server_corpus(case, monkeypatch):
    portify(monkeypatch, security_corpus)
    call_case(security_corpus, case, {})


@pytest.mark.parametrize("case", _ADMISSION, ids=_ids(_ADMISSION))
def test_serving_admission_corpus(case, monkeypatch):
    portify(monkeypatch, serving_corpus)
    call_case(serving_corpus, case, {"runner": lambda: serving_corpus.runner.__wrapped__()})


# ---- Client, DB-API and CLI against runner.execute ------------------------------------


@pytest.fixture(scope="module")
def tpch_server():
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    r.register_catalog("tpch", create_tpch_connector())
    srv = CoordinatorServer(r)
    yield r, srv
    srv.stop()


@pytest.mark.parametrize("qid", [1, 3, 18])
def test_client_and_dbapi_rows_equal_the_runner(qid, tpch_server):
    runner, srv = tpch_server
    want = runner.execute(QUERIES[qid])
    got = Client(srv.uri).execute(QUERIES[qid])
    assert got.rows == want.rows and got.column_names == want.column_names
    assert [c["type"] for c in got.columns] == [str(t) for t in want.column_types]
    cur = dbapi.connect(srv.uri, user="tester").cursor()
    cur.execute(QUERIES[qid])
    assert cur.fetchall() == want.rows and cur.rowcount == len(want.rows)


def test_cli_prints_the_runner_rows(tpch_server):
    from trino_tpu_torch.cli import format_table

    runner, srv = tpch_server
    sql = "select n_regionkey, count(*) c from nation group by 1 order by 1"
    want = runner.execute(sql)
    out = subprocess.run(
        [sys.executable, "-m", "trino_tpu_torch.cli", "--server", srv.uri, "--execute", sql],
        capture_output=True, text=True, timeout=120, check=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == format_table(want.column_names, want.rows)


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="checks the no-card path")
def test_the_cli_local_backend_needs_a_card_or_device_cpu():
    from trino_tpu_torch import cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli._LocalBackend("tpch", "tiny")
    backend = cli._LocalBackend("tpch", "tiny", device="cpu")
    assert backend.execute("select count(*) from nation") == (["_col0"], [[25]])


# ---- the serving arms ------------------------------------------------------------------


def test_the_item_13_arms_raise_or_answer_naming_it():
    """The batcher arm (since ported): a MicroBatcher given to
    the server, and one it builds from micro_batch_window_ms, coalesce
    concurrent point lookups and answer the reference's rows; GET
    /v1/fabric (item 13.3, since ported) answers 200 with the reference's
    status fields, and /v1/metrics shows the replica, scheduler and
    fabric counters."""
    import json

    from trino_tpu.runtime.fabric import fabric_status as jfabric_status
    from trino_tpu.connectors import tpch as jtpch
    from trino_tpu.engine import LocalQueryRunner as JRunner
    from trino_tpu.engine import Session as JSession
    from trino_tpu_torch.serving.batcher import MicroBatcher

    ref = JRunner(JSession(catalog="tpch", schema="tiny"))
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    sql = "select o_custkey, o_totalprice from orders where o_orderkey = {}"
    keys = [1, 2, 3, 7, 32, 33]
    want = {k: ref.execute(sql.format(k)).rows for k in keys}
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    r.register_catalog("tpch", create_tpch_connector())
    given = MicroBatcher(r, window_s=0.5, max_batch=len(keys))
    r2 = LocalQueryRunner(Session(catalog="tpch", schema="tiny", micro_batch_window_ms=500.0,
                                  micro_batch_max=len(keys)), device="cpu")
    r2.register_catalog("tpch", create_tpch_connector())
    for srv in (CoordinatorServer(r, batcher=given, max_concurrent=len(keys)),
                CoordinatorServer(r2, max_concurrent=len(keys))):
        try:
            got = {}

            def ask(k, srv=srv, got=got):
                got[k] = Client(srv.uri, timeout=60).execute(sql.format(k)).rows

            ts = [threading.Thread(target=ask, args=(k,)) for k in keys]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            assert got == want
            st = srv.batcher.stats()
            assert st["batched_queries"] == len(keys) and 1 <= st["batches"] < len(keys)
        finally:
            srv.stop()
    srv = CoordinatorServer(r)
    try:
        with urllib.request.urlopen(srv.uri + "/v1/fabric", timeout=10) as resp:
            assert resp.status == 200
            status = json.loads(resp.read())
        assert set(status) == set(jfabric_status()) and status["attached"] is False
        with urllib.request.urlopen(srv.uri + "/v1/metrics", timeout=10) as resp:
            metrics = json.loads(resp.read())
        for name in ("replica.placements", "replica.failovers", "scheduler.parks",
                     "scheduler.steals", "fabric.pulls", "fabric.digest_rejects"):
            assert name in metrics, name
    finally:
        srv.stop()


@pytest.mark.parametrize("ttl", [None, 0.4])
def test_a_running_querys_poll_is_held_until_it_settles(ttl):
    """A poll of a query still running is held, at most
    POLL_MAX_WAIT_S and a quarter of the client TTL, and answered as
    soon as the query settles; a client held this way is not reaped as
    abandoned, and a client polling every 5 ms sends one request a
    hold, not hundreds a second (the reference answers at once)."""
    import json

    release = threading.Event()

    class Blocking:
        session = None

        def execute(self, sql, **kw):
            assert release.wait(30)
            return LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu") \
                .execute("select 1")

    srv = CoordinatorServer(Blocking(), client_timeout_s=ttl)
    hold = min(srv.POLL_MAX_WAIT_S, srv.CLIENT_TTL_S / 4.0)
    try:
        req = urllib.request.Request(srv.uri + "/v1/statement", data=b"select 1",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            out = json.loads(resp.read())
        t0 = time.monotonic()
        with urllib.request.urlopen(out["nextUri"], timeout=10) as resp:
            out = json.loads(resp.read())
        held = time.monotonic() - t0
        assert out["stats"]["state"] in ("QUEUED", "RUNNING") and "nextUri" in out
        assert hold * 0.9 <= held < hold + 0.5, (held, hold)
        threading.Timer(hold / 2, release.set).start()
        t0 = time.monotonic()
        with urllib.request.urlopen(out["nextUri"], timeout=10) as resp:
            out = json.loads(resp.read())
        assert out["stats"]["state"] == "FINISHED" and out["data"] == [[1]]
        assert time.monotonic() - t0 < hold
        # a 5 ms client over a query held for two holds polls a few times
        release.clear()
        polls = []
        real = Client._request

        def counted(self, method, url, body=None):
            polls.append(method)
            return real(self, method, url, body)

        threading.Timer(2 * hold, release.set).start()
        c = Client(srv.uri, timeout=30, poll_interval=0.005)
        c._request = counted.__get__(c)
        assert c.execute("select 1").rows == [[1]]
        assert polls.count("GET") <= 4, polls
    finally:
        release.set()
        srv.stop()


# ---- the corpora's coverage ------------------------------------------------------------


def test_the_corpora_are_covered():
    """Every case of the four whole corpora runs here; so does every case
    that tests/test_torch_distributed.py and test_torch_statements.py
    send to this file. No WAITING map names item 11b."""
    ran = {f"test_protocol.py::{n}" for _, n in _PROTOCOL}
    ran |= {f"test_services.py::{n}" for _, n in _SERVICES}
    ran |= {f"test_scheduling_r5.py::{n}" for _, n in _SCHED}
    ran |= {f"test_resource_groups.py::{n}" for _, n in _RG}
    ran |= {"test_state_machine.py::test_metrics_endpoint",
            "test_tracing.py::test_query_endpoints_over_http"}
    ran |= {f"test_security.py::{n}" for _, n in _SECURITY_SERVER}
    ran |= {f"test_serving.py::{n}" for _, n in _ADMISSION}
    sent = {k for k, v in {**DIST_ELSEWHERE, **STATEMENTS_ELSEWHERE}.items()
            if v == "tests/test_torch_front_door.py"}
    assert sent == {k for k in ran if k.split("::")[0] in (
        "test_state_machine.py", "test_tracing.py", "test_security.py", "test_serving.py")}
    every = {f"test_services.py::{n}" for _, n in _cases(services_corpus)}
    assert every == (ran | set(WAITING)) & every and not ran & set(WAITING)
    assert all(re.match(r"item 13\.[34] ", v) for v in WAITING.values())
    assert (len(_PROTOCOL), len(_SERVICES), len(_SCHED), len(_RG)) == (14, 18, 8, 5)
    assert (len(_SECURITY_SERVER), len(_ADMISSION)) == (3, 3)
