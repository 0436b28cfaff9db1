"""tests/test_exec.py's twelve operator-level cases through the port's
Driver: hand-built pipelines of trino_tpu_torch operators (device="cpu")
over the port's tpch connector, held against the same sqlite oracle.

Each corpus function runs unedited with its module's names bound to the
port's. Where the port's constructor differs from the reference's, a
small adapter keeps the corpus's call: the port's operators take an
explicit device, FilterProjectOperator takes the batch function that
make_filter_project_fn builds from the bound filter and projections,
and LookupJoinOperator takes the residual as the function
make_residual_fn builds. The oracle is tests/test_torch_tpch_a.py's
indexed sqlite database (the corpus's unindexed one answers the residual
join's correlated EXISTS over lineitem in minutes).
"""

import pytest

import tests.test_exec as exec_corpus
from tests.test_torch_tpch_a import indexed_oracle
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu_torch import exec as texec
from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.tpch import create_tpch_connector
from trino_tpu_torch.exec import operators as tops
from trino_tpu_torch.expr.compile import ExprBinder
from trino_tpu_torch.expr.ir import Call, InputRef, Literal
from trino_tpu_torch.ops.sort import SortKey

CPU = "cpu"


def _on_cpu(cls):
    return lambda *a, **kw: cls(*a, device=CPU, **kw)


def _filter_project(flt, projections):
    return texec.FilterProjectOperator(tops.make_filter_project_fn(flt, projections))


def _lookup_join(bridge, keys, kind, probe_schema, residual=None):
    fn = tops.make_residual_fn(residual) if residual is not None else None
    return texec.LookupJoinOperator(bridge, keys, kind, probe_schema, residual_fn=fn)


PORT_NAMES = {
    "T": T,
    "create_tpch_connector": create_tpch_connector,
    "AggSpec": texec.AggSpec,
    "CollectorSink": texec.CollectorSink,
    "CrossJoinBuildSink": _on_cpu(texec.CrossJoinBuildSink),
    "CrossJoinOperator": texec.CrossJoinOperator,
    "Driver": texec.Driver,
    "FilterProjectOperator": _filter_project,
    "HashAggregationOperator": _on_cpu(texec.HashAggregationOperator),
    "HashBuildSink": _on_cpu(texec.HashBuildSink),
    "JoinBridge": texec.JoinBridge,
    "LimitOperator": texec.LimitOperator,
    "LookupJoinOperator": _lookup_join,
    "Pipeline": texec.Pipeline,
    "SortOperator": _on_cpu(texec.SortOperator),
    "TableScanOperator": _on_cpu(texec.TableScanOperator),
    "TopNOperator": _on_cpu(texec.TopNOperator),
    "ExprBinder": ExprBinder,
    "Call": Call,
    "InputRef": InputRef,
    "Literal": Literal,
    "SortKey": SortKey,
}

CASES = sorted(n for n in dir(exec_corpus) if n.startswith("test_"))


@pytest.fixture(scope="module")
def oracle():
    conn = indexed_oracle()
    yield conn
    conn.close()


@pytest.fixture(scope="module")
def tpch():
    return create_tpch_connector()


def test_the_corpus_has_twelve_cases():
    assert len(CASES) == 12, CASES


@pytest.mark.parametrize("name", CASES)
def test_exec_corpus_case_on_the_port(name, oracle, tpch, monkeypatch):
    for attr, value in PORT_NAMES.items():
        monkeypatch.setattr(exec_corpus, attr, value)
    fn = getattr(exec_corpus, name)
    if name == "test_limit":
        fn(tpch)
    else:
        fn(oracle, tpch)
