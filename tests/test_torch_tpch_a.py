"""TPC-H at tpch.tiny (Q2-Q10 without Q3 and Q6, and Q16):
trino_tpu_torch (device="cpu") row-equal to trino_tpu and, within
assert_rows_match's tolerances, to the sqlite oracle. Q1, Q3, Q6 and Q18
are in test_torch_engine.py and the rest, Q22 among them, in
test_torch_tpch_b.py, so all 22 run. The queries are split over files
because the tier-1 run spreads test files over workers."""

import sqlite3

import pytest

from tests.oracle import assert_rows_match, load_tpch_sqlite, sqlite_rows
from tests.test_tpch import to_sqlite
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from tests.tpch_queries import QUERIES
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session


# indexes on the join keys: the oracle's answers are the same, and Q21
# takes milliseconds in sqlite instead of minutes
ORACLE_INDEXES = (
    "lineitem(l_orderkey)", "lineitem(l_suppkey)", "lineitem(l_partkey)",
    "orders(o_orderkey)", "orders(o_custkey)", "customer(c_custkey)",
    "part(p_partkey)", "supplier(s_suppkey)", "partsupp(ps_partkey, ps_suppkey)",
)


def indexed_oracle() -> sqlite3.Connection:
    conn = sqlite3.connect(":memory:")
    load_tpch_sqlite(conn, 0.01)
    for i, target in enumerate(ORACLE_INDEXES):
        conn.execute(f"create index oracle_ix{i} on {target}")
    return conn


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


@pytest.mark.parametrize("qid", [2, 4, 5, 7, 8, 9, 10, 16], ids=lambda q: f"q{q}")
def test_tpch_join_query_matches_reference_and_oracle(qid, runners, oracle):
    ref, port = runners
    sql = QUERIES[qid]
    got = port.execute(sql)
    want = ref.execute(sql)
    assert got.rows == want.rows
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types]
    assert_rows_match(got.rows, sqlite_rows(oracle, to_sqlite(sql)),
                      ordered="order by" in sql, abs_tol=1e-2)
