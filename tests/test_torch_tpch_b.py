"""TPC-H at tpch.tiny (Q11-Q22 without Q16 and Q18): trino_tpu_torch
(device="cpu") row-equal to trino_tpu and, within assert_rows_match's
tolerances, to the sqlite oracle. Q1, Q3, Q6 and Q18 are in
test_torch_engine.py and Q16 in test_torch_tpch_a.py. The queries are
split over files because the tier-1 run spreads test files over
workers."""

import pytest

from tests.oracle import assert_rows_match, sqlite_rows
from tests.test_torch_tpch_a import indexed_oracle
from tests.test_tpch import to_sqlite
from tests.tpch_queries import QUERIES
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session


@pytest.fixture(scope="module")
def oracle():
    conn = indexed_oracle()
    yield conn
    conn.close()


@pytest.fixture(scope="module")
def runners():
    ref = JRunner(JSession(catalog="tpch", schema="tiny"))
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    port.register_catalog("tpch", ttpch.create_tpch_connector())
    return ref, port


@pytest.mark.parametrize("qid", [11, 12, 13, 14, 15, 17, 19, 20, 21, 22],
                         ids=lambda q: f"q{q}")
def test_tpch_join_query_matches_reference_and_oracle(qid, runners, oracle):
    ref, port = runners
    sql = QUERIES[qid]
    got = port.execute(sql)
    want = ref.execute(sql)
    assert got.rows == want.rows
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types]
    assert_rows_match(got.rows, sqlite_rows(oracle, to_sqlite(sql)),
                      ordered="order by" in sql, abs_tol=1e-2)
