"""EXPLAIN ANALYZE on trino_tpu_torch (device="cpu") against trino_tpu.

- tests/test_observability.py's two EXPLAIN ANALYZE cases and
  tests/test_stats.py::test_explain_analyze_device_inclusive_attribution
  run unedited on the port's runners.
- Over those queries and the memory corpus's (under its pools, so the
  spilled operators too): the plan part equals the reference's
  explain_text, every operator line carries the reference's
  in=/out= rows and batches, operator by operator, and the engine
  counters line carries its counters (the reference's xla_compiles
  aside).
- On a CUDA device each timed section ends with torch.cuda.synchronize
  (checked here with a fake operator and a recording synchronize).
"""

import re

import pytest
import torch

import tests.test_memory as memory_corpus
import tests.test_observability as obs_corpus
import tests.test_stats as stats_corpus
import trino_tpu.connectors.tpch as jtpch_module
import trino_tpu.engine as jengine
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.exec import stats as tstats

OBS_CASES = ["test_explain_analyze_stats", "test_dynamic_filter_prunes_probe"]
QUERIES = {
    "nation_group": ("select n_regionkey, count(*) from nation group by n_regionkey"
                     " order by 1", {}),
    "dynamic_filter": ("select count(*) from lineitem, orders where l_orderkey = o_orderkey"
                       " and o_orderkey < 100", {}),
    "returnflag": ("select l_returnflag, sum(l_quantity) from lineitem"
                   " group by l_returnflag", {}),
    "agg_spilled": (memory_corpus.AGG_Q, dict(batch_rows=8192, memory_pool_bytes=256 * 1024)),
    **{f"{shape}_spilled": (memory_corpus.JOIN_QS[shape],
                            dict(batch_rows=4096, memory_pool_bytes=192 * 1024))
       for shape in ("inner_agg", "semi")},
}
_WALL = re.compile(r"wall=.*$")


@pytest.fixture(scope="module")
def tpch():
    return jtpch.create_tpch_connector(), ttpch.create_tpch_connector()


def _port(tpch, **session):
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny", **session), device="cpu")
    r.register_catalog("tpch", tpch[1])
    return r


@pytest.mark.parametrize("name", OBS_CASES)
def test_observability_case_on_the_port(name, tpch):
    getattr(obs_corpus, name)(_port(tpch))


def test_device_inclusive_attribution_case_on_the_port(tpch, monkeypatch):
    monkeypatch.setattr(jengine, "LocalQueryRunner",
                        lambda session: LocalQueryRunner(session, device="cpu"))
    monkeypatch.setattr(jengine, "Session", Session)
    monkeypatch.setattr(jtpch_module, "create_tpch_connector", lambda: tpch[1])
    stats_corpus.test_explain_analyze_device_inclusive_attribution()


_XLA_COMPILES = re.compile(r" xla_compiles=\d+")


def _split(text):
    """(plan part, operator lines without their walls and the engine
    counters line without the reference's xla_compiles, which counts
    XLA lowerings: ROADMAP §1 item 13)."""
    plan, stats = text.split("\n\n")[:2]
    return plan, [_XLA_COMPILES.sub("", _WALL.sub("", line)) for line in stats.splitlines()]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_plan_and_operator_rows_equal_the_reference(name, tpch):
    sql, session = QUERIES[name]
    ref = JRunner(JSession(catalog="tpch", schema="tiny", **session))
    ref.register_catalog("tpch", tpch[0])
    port = _port(tpch, **session)
    want = ref.execute("explain analyze " + sql).only_value()
    got = port.execute("explain analyze " + sql).only_value()
    assert _split(got) == _split(want)
    assert "Engine counters: rows_scanned=" in got
    assert "xla_compiles" not in got and "census" not in got


class _Echo:
    """A one-batch operator for the barrier check."""

    def __init__(self):
        self._out = None

    def add_input(self, batch):
        self._out = batch

    def get_output(self):
        out, self._out = self._out, None
        return out

    def finish(self):
        pass


def test_every_section_ends_with_a_cuda_barrier(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    (op,), (st,) = tstats.instrument([_Echo()], device_sync=True, device="cuda")
    batch = type("B", (), {"live": None, "capacity": 4})()
    op.add_input(batch)
    assert op.get_output() is batch
    assert op.get_output() is None  # an idle poll launched nothing: no barrier
    op.finish()
    assert synced == ["cuda"] * 3
    assert st.device_synced and st.input_rows == 4 and st.output_rows == 4
    (cpu_op,), _ = tstats.instrument([_Echo()], device_sync=True, device="cpu")
    cpu_op.add_input(batch)
    cpu_op.finish()
    assert len(synced) == 3  # the CPU has nothing to wait for
