"""Window functions and set operations through SQL on tpch.tiny:
trino_tpu_torch (device="cpu") row-equal to trino_tpu on every
WINDOW_QUERIES and SET_QUERIES entry of tests/test_window.py (imported,
not copied), and within assert_rows_match's tolerance (abs 1e-2) of the
sqlite oracle; percent_rank and cume_dist against their definitions
within 1e-12."""

import pytest

from tests.oracle import assert_rows_match, sqlite_rows
from tests.test_torch_tpch_a import indexed_oracle
from tests.test_tpch import to_sqlite
from tests.test_window import SET_QUERIES, WINDOW_QUERIES
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
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


def _check(runners, oracle, sql, ordered):
    ref, port = runners
    got = port.execute(sql)
    want = ref.execute(sql)
    assert got.rows == want.rows
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types]
    assert_rows_match(got.rows, sqlite_rows(oracle, to_sqlite(sql)),
                      ordered=ordered, abs_tol=1e-2)


@pytest.mark.parametrize("i", range(len(WINDOW_QUERIES)), ids=lambda i: f"window{i}")
def test_window_query_matches_reference_and_oracle(i, runners, oracle):
    _check(runners, oracle, WINDOW_QUERIES[i], ordered=True)


@pytest.mark.parametrize("i", range(len(SET_QUERIES)), ids=lambda i: f"set{i}")
def test_set_operation_matches_reference_and_oracle(i, runners, oracle):
    sql = SET_QUERIES[i]
    _check(runners, oracle, sql, ordered="order by" in sql)


def test_percent_rank_and_cume_dist(runners):
    ref, port = runners
    sql = ("SELECT n_regionkey, n_nationkey,"
           " percent_rank() OVER (PARTITION BY n_regionkey ORDER BY n_nationkey),"
           " cume_dist() OVER (PARTITION BY n_regionkey ORDER BY n_nationkey)"
           " FROM nation ORDER BY n_regionkey, n_nationkey")
    rows = port.execute(sql).rows
    assert rows == ref.execute(sql).rows
    by_rk = {}
    for rk, nk, pr, cd in rows:
        by_rk.setdefault(rk, []).append((nk, pr, cd))
    for rk, items in by_rk.items():
        n = len(items)
        for i, (nk, pr, cd) in enumerate(items):
            assert abs(pr - (0.0 if n == 1 else i / (n - 1))) < 1e-12, (rk, nk)
            assert abs(cd - (i + 1) / n) < 1e-12, (rk, nk)


def test_cume_dist_and_percent_rank_with_peers(runners):
    _, port = runners
    rows = port.execute(
        "SELECT x, cume_dist() OVER (ORDER BY x) FROM"
        " (VALUES (1), (2), (2), (3)) t(x) ORDER BY x").rows
    assert [r[1] for r in rows] == [0.25, 0.75, 0.75, 1.0]
    rows = port.execute(
        "SELECT x, percent_rank() OVER (ORDER BY x) FROM"
        " (VALUES (1), (2), (2), (3)) t(x) ORDER BY x").rows
    assert [r[1] for r in rows] == [0.0, 1 / 3, 1 / 3, 1.0]


# window shapes the imported lists do not reach: nth_value, the value
# functions over strings, decimal avg and sums, min/max over NULLs and
# ties, a window without PARTITION BY or ORDER BY, descending NULLs first
EXTRA_WINDOW_QUERIES = [
    "select o_custkey, o_orderkey, nth_value(o_orderkey, 2) over"
    " (partition by o_custkey order by o_orderdate) n2,"
    " last_value(o_orderpriority) over (partition by o_custkey order by o_orderkey"
    " rows between unbounded preceding and current row) lp"
    " from orders where o_custkey < 40 order by o_custkey, o_orderkey",
    "select s_nationkey, s_suppkey, avg(s_acctbal) over (partition by s_nationkey) a,"
    " sum(s_acctbal) over (partition by s_nationkey order by s_suppkey) s,"
    " max(s_name) over (partition by s_nationkey) mx"
    " from supplier order by s_suppkey",
    "select n_nationkey, min(case when n_nationkey % 4 = 0 then null else n_regionkey end)"
    " over (partition by n_regionkey order by n_nationkey) m,"
    " count(case when n_nationkey % 4 = 0 then null else 1 end) over () c,"
    " lead(n_name, 1) over (order by n_regionkey desc, n_nationkey) nx"
    " from nation order by n_nationkey",
    "select o_orderpriority, o_orderkey, dense_rank() over"
    " (order by o_orderpriority desc nulls first) dr, ntile(4) over (order by o_orderkey) t"
    " from orders where o_orderkey < 200 order by o_orderkey",
]


@pytest.mark.parametrize("i", range(len(EXTRA_WINDOW_QUERIES)), ids=lambda i: f"extra{i}")
def test_more_window_shapes_match_reference_and_oracle(i, runners, oracle):
    _check(runners, oracle, EXTRA_WINDOW_QUERIES[i], ordered=True)


def test_union_all_keeps_duplicates(runners, oracle):
    _check(runners, oracle,
           "select n_regionkey from nation where n_nationkey < 6 union all"
           " select r_regionkey from region order by 1", ordered=True)


def test_union_of_differing_string_dictionaries_raises(runners):
    ref, port = runners
    sql = "select n_name from nation union all select r_name from region"
    with pytest.raises(NotImplementedError, match="differing dictionaries"):
        port.execute(sql)
    with pytest.raises(NotImplementedError, match="differing dictionaries"):
        ref.execute(sql)


def test_unsupported_frame_rejected(runners):
    from trino_tpu_torch.sql.parser import ParsingError

    _, port = runners
    with pytest.raises(ParsingError):
        port.execute("select sum(n_nationkey) over (order by n_name"
                     " rows between 2 preceding and current row) from nation")


def test_chip_smoke_carries_the_same_queries():
    """chip_smoke.py (which imports no JAX) keeps copies of these query
    lists and of TPC-H Q16/Q22; they must not drift."""
    import chip_smoke
    from tests.tpch_queries import QUERIES

    assert chip_smoke.WINDOW_QUERIES == WINDOW_QUERIES
    assert chip_smoke.SET_QUERIES == SET_QUERIES
    assert chip_smoke.Q16.strip() == QUERIES[16].strip()
    assert chip_smoke.Q22.strip() == QUERIES[22].strip()


def test_string_function_over_nth_value_keeps_its_dictionary(runners):
    """A divergence where the reference is wrong (ROADMAP §3): its
    planner drops nth_value's dictionary, so a string function over the
    result reads NULL; the port's plan keeps it, as for lead/lag."""
    ref, port = runners
    inner = ("select n_nationkey, nth_value(n_name, 2) over"
             " (partition by n_regionkey order by n_name) x from nation")
    plain = port.execute(inner + " order by n_nationkey").rows
    assert plain == ref.execute(inner + " order by n_nationkey").rows
    got = port.execute(f"select n_nationkey, lower(x) from ({inner}) t"
                       " order by n_nationkey").rows
    assert got == [[k, None if v is None else v.lower()] for k, v in plain]
    assert any(v is not None for _, v in got)
