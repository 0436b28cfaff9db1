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
  case, and for every case the other port test files send here. One
  case waits: test_services.py's distributed transactions run a query
  over in-process workers with mesh_execution on (item 12).
- Against the runner: TPC-H Q1, Q3 and Q18 at tiny give the same rows
  through the port's Client and DB-API as through runner.execute, and
  `python -m trino_tpu_torch.cli --server` prints them.
- The arms of item 13 raise or answer naming it: a batcher, the
  micro-batch properties, GET /v1/fabric.
- Every server is stopped, and no server thread outlives a test.
"""

import os
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
WAITING = {
    "test_services.py::test_distributed_runner_transactions":
        "item 12 (a query over in-process workers under the default "
        "mesh_execution = true)",
}
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
              if f"test_serving.py::{c[1]}" in STATEMENTS_ELSEWHERE]


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


# ---- the arms of item 13 -------------------------------------------------------------


def test_the_item_13_arms_raise_or_answer_naming_it():
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        CoordinatorServer(r, batcher=object())
    r.session.micro_batch_window_ms = 5.0
    with pytest.raises(NotImplementedError, match="item 13"):
        CoordinatorServer(r)
    r.session.micro_batch_window_ms = 0.0
    srv = CoordinatorServer(r)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.uri + "/v1/fabric", timeout=10)
        assert e.value.code == 501 and "item 13" in e.value.read().decode()
    finally:
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
    assert all(v.startswith(("item 12", "item 13")) for v in WAITING.values())
    assert (len(_PROTOCOL), len(_SERVICES), len(_SCHED), len(_RG)) == (14, 17, 8, 5)
    assert (len(_SECURITY_SERVER), len(_ADMISSION)) == (3, 3)
