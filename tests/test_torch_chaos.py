"""The chaos harness of trino_tpu_torch (device="cpu") against trino_tpu.

- tests/test_chaos.py's tier-1 cases run on the port's names
  (tests/test_torch_adaptive.adaptive_names: ChaosHarness, its workers
  and runners built on the CPU), against the corpus's sqlite oracle; its
  soak, marked slow there, is marked slow here.
- The same seed gives the reference's fault schedules.
- The replica, preempt and fabric scenarios of runtime/chaos.py
  (park and resume under a later device loss, a drain while parked,
  host loss with a fabric pull, a membership flap, transport
  corruption, a replica killed mid-serve and a replica drained under
  the reference's client population of 6 clients polling every 5 ms
  for 3 s) pass their gates (chaos.mesh_case_failures, the reference's
  chaos_smoke gates) at tiny on 4 CPU shards (2 replicas of 2), in the
  harness's own 256-row chunks.
"""

import inspect

import pytest
import torch

import tests.test_chaos as chaos_corpus
from tests.test_torch_adaptive import adaptive_names, clean_tiers  # noqa: F401
from tests.test_torch_compile import isolated_registries  # noqa: F401
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.runtime import chaos as jchaos
from trino_tpu_torch.connectors.tpch import create_tpch_connector
from trino_tpu_torch.runtime import chaos as tchaos

CPU4 = [torch.device("cpu")] * 4
SLOW = {"test_chaos_soak_tpch"}


@pytest.fixture(scope="module")
def oracle():
    yield from chaos_corpus.oracle.__wrapped__()


@pytest.fixture(scope="module")
def harness():
    """The corpus's two-worker FTE harness, on the port."""
    h = tchaos.ChaosHarness(n_workers=2, device="cpu")
    h.register_catalog("tpch", create_tpch_connector())
    return h


MATRIX = {"test_chaos_matrix"}
CORPUS = [n for _, n in _cases(chaos_corpus) if n not in SLOW | MATRIX]


def _run(name, monkeypatch, args):
    adaptive_names(monkeypatch, chaos_corpus)
    fn = getattr(chaos_corpus, name)
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


@pytest.mark.parametrize("name", CORPUS)
def test_chaos_corpus(name, monkeypatch, oracle, harness):
    _run(name, monkeypatch, {"oracle": oracle, "harness": harness})


@pytest.mark.parametrize("fault_class", chaos_corpus.FAULT_CLASSES)
@pytest.mark.parametrize("sql", [chaos_corpus.Q_AGG, chaos_corpus.Q_JOIN], ids=["agg", "join"])
def test_chaos_matrix(sql, fault_class, monkeypatch, oracle, harness):
    _run("test_chaos_matrix", monkeypatch,
         {"oracle": oracle, "harness": harness, "sql": sql, "fault_class": fault_class})


def test_the_corpus_is_whole():
    assert len(_cases(chaos_corpus)) == 17
    assert set(CORPUS) | SLOW | MATRIX == {n for _, n in _cases(chaos_corpus)}


@pytest.mark.slow
@pytest.mark.parametrize("fault_class", chaos_corpus.FAULT_CLASSES)
@pytest.mark.parametrize("qid", list(range(1, 23)))
def test_chaos_soak_tpch(qid, fault_class, monkeypatch, oracle, harness):
    """The corpus's soak (slow there too): all 22 TPC-H queries under
    every fault class."""
    adaptive_names(monkeypatch, chaos_corpus)
    chaos_corpus.test_chaos_soak_tpch(qid, fault_class, harness, oracle)


@pytest.mark.parametrize("fault_class", jchaos.FAULT_CLASSES)
def test_schedules_are_the_references(fault_class):
    for seed in (0, 1, 42, 1234):
        rules = tchaos.generate_schedule(seed, fault_class)
        assert rules == jchaos.generate_schedule(seed, fault_class)
        assert tchaos.schedule_max_failures(rules) == jchaos.schedule_max_failures(rules)
    assert tchaos.rows_equal([[1, 0.1 + 0.2]], [[1, 0.3]])


# ---- the replica, preempt and fabric scenarios -------------------------------

SQL = ("select o_orderpriority, count(*) c from orders join customer "
       "on o_custkey = c_custkey group by o_orderpriority order by o_orderpriority")


def _gated(scenario):
    """`scenario` as chaos_smoke runs it, at the harness's sizes; its
    report once its gates pass."""
    rows, rep = tchaos.run_mesh_case(scenario, 7, tchaos.CHAOS_QUERIES, SQL, device="cpu",
                                     mesh_devices=CPU4)
    assert tchaos.mesh_case_failures(scenario, rows, rep) == [], rep
    return rep


def test_the_scenarios_are_the_references():
    import bench

    assert tchaos.CHAOS_QUERIES == bench.CHAOS_QUERIES
    assert list(tchaos.MESH_SCENARIOS) == [*jchaos.REPLICA_CLASSES, *jchaos.PREEMPT_CLASSES,
                                           *jchaos.FABRIC_CLASSES]


def test_park_resume_then_device_loss():
    _gated("preempt_park_resume")


def test_a_drain_while_parked_resumes_on_the_sibling():
    _gated("preempt_under_drain")


def test_host_lost_pulls_from_the_peer():
    _gated("host_lost_mid_chunk")


def test_a_membership_flap_refuses_a_double_claim():
    _gated("membership_flap")


def test_transport_corruption_restarts_clean():
    _gated("transport_corruption")


@pytest.mark.parametrize("name", ["replica_down", "replica_drain"])
def test_the_replica_cases_under_a_client_population(name):
    _gated({"replica_down": "replica_down_mid_serve",
            "replica_drain": "replica_drain_under_load"}[name])
