"""The dictionary string functions, abs/round/nullif/greatest/least and
DISTINCT aggregates through SQL on tpch.tiny: trino_tpu_torch
(device="cpu") row-equal to trino_tpu (strings, integers and decimals
bit-equal) and, for the queries sqlite can run, within
assert_rows_match's tolerance (abs 1e-2) of the sqlite oracle."""

import pytest

from tests.oracle import assert_rows_match, sqlite_rows
from tests.test_torch_tpch_a import indexed_oracle
from tests.test_tpch import to_sqlite
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session


@pytest.fixture(scope="module")
def runners():
    ref = JRunner(JSession(catalog="tpch", schema="tiny"))
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    port.register_catalog("tpch", ttpch.create_tpch_connector())
    return ref, port


@pytest.fixture(scope="module")
def oracle():
    conn = indexed_oracle()
    yield conn
    conn.close()


def _same(runners, sql):
    """Row-equal, doubles within assert_rows_match's tolerance (the
    reference's XLA may divide by a constant as a multiply by its
    reciprocal, one ulp off)."""
    ref, port = runners
    got, want = port.execute(sql), ref.execute(sql)
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types]
    exact = [i for i, t in enumerate(got.column_types) if not t.is_floating]
    assert [[r[i] for i in exact] for r in got.rows] == \
        [[r[i] for i in exact] for r in want.rows]
    assert_rows_match(got.rows, want.rows, ordered=True, abs_tol=1e-2)
    return got.rows


# Trino's substr edges: a start of 0 (empty), a negative start (from the
# end), a start before the beginning, a length past the end, a negative
# length (empty)
STRING_QUERIES = {
    "substr_edges": "select n_name, substr(n_name, 0), substr(n_name, 0, 2),"
                    " substr(n_name, -3), substr(n_name, -3, 2), substr(n_name, -30, 2),"
                    " substr(n_name, 3, 100), substr(n_name, 100), substr(n_name, 2, -1),"
                    " substring(n_name, 2, 3), substring(n_name, 4)"
                    " from nation order by n_nationkey",
    "case_and_length": "select upper(r_comment), lower(r_name), length(r_comment),"
                       " length(substr(r_name, 2)) from region order by r_regionkey",
    "trim_reverse_replace": "select trim(concat('  ', n_name, ' ')),"
                            " ltrim(concat('  ', n_name)), rtrim(concat(n_name, '  ')),"
                            " reverse(n_name), replace(n_name, 'A', 'xy'),"
                            " replace(n_name, 'AN') from nation order by n_nationkey",
    "starts_with_concat": "select n_name, starts_with(n_name, 'I'),"
                          " concat(n_name, '-', r_name), concat('<', n_name),"
                          " n_name || r_name from nation join region"
                          " on n_regionkey = r_regionkey order by n_nationkey",
    "null_and_empty_dictionary": "select substr(cast(null as varchar), 1, 2),"
                                 " upper(cast(null as varchar)),"
                                 " length(cast(null as varchar)),"
                                 " concat(n_name, cast(null as varchar))"
                                 " from nation where n_nationkey < 3 order by n_nationkey",
    "nullif_greatest_least": "select nullif(n_regionkey, 1), nullif(n_name, 'CHINA'),"
                             " greatest(n_name, r_name), least(n_name, r_name),"
                             " greatest(n_nationkey, n_regionkey * 6),"
                             " least(n_nationkey, null)"
                             " from nation join region on n_regionkey = r_regionkey"
                             " order by n_nationkey",
    # the doubles divide by 7 so that no value lies halfway between two
    # rounding steps: there the packages may round apart, because the
    # reference turns a decimal into a double by multiplying with the
    # reciprocal of its scale (one ulp from the quotient the port takes)
    "abs_round": "select abs(s_acctbal), round(s_acctbal), round(s_acctbal, 1),"
                 " round(s_acctbal, 5), abs(s_nationkey - 12),"
                 " round(s_acctbal / 7e0), round(s_acctbal / 7e0, 2),"
                 " round(s_acctbal / 7e0, -2)"
                 " from supplier order by s_suppkey limit 40",
    # the string result feeds GROUP BY and ORDER BY, as Q22 uses it
    "group_by_substr": "select substr(c_phone, 1, 2) as cc, count(*), sum(c_acctbal)"
                       " from customer group by substr(c_phone, 1, 2) order by cc",
}


@pytest.mark.parametrize("name", sorted(STRING_QUERIES))
def test_string_and_scalar_functions_match_reference(name, runners):
    rows = _same(runners, STRING_QUERIES[name])
    assert rows


def test_substr_edges_follow_trino():
    from trino_tpu_torch.expr.compile import ExprBinder
    from trino_tpu_torch.expr.ir import Literal
    from trino_tpu_torch import types as T

    def sub(s, start, n=None):
        return ExprBinder._py_substr(
            s, Literal(start, T.BIGINT), None if n is None else Literal(n, T.BIGINT))

    assert sub("hello", 0) == "" and sub("hello", 0, 3) == ""
    assert sub("hello", -3) == "llo" and sub("hello", -3, 2) == "ll"
    assert sub("hello", -9, 2) == "" and sub("hello", 2, 100) == "ello"
    assert sub("hello", 9) == "" and sub("hello", 2, -1) == ""


# sqlite's substr differs from Trino's at a start of 0 and a negative
# length, so the edges hold against the reference and the rules above
@pytest.mark.parametrize("name", ["group_by_substr", "case_and_length"])
def test_string_queries_match_oracle(name, runners, oracle):
    sql = STRING_QUERIES[name]
    _, port = runners
    assert_rows_match(port.execute(sql).rows, sqlite_rows(oracle, to_sqlite(sql)),
                      ordered=True, abs_tol=1e-2)


DISTINCT_QUERIES = {
    "global": "select count(distinct o_custkey) from orders",
    "global_nulls": "select count(distinct nullif(o_orderpriority, '1-URGENT'))"
                    " from orders",
    "grouped": "select o_orderstatus, count(distinct o_custkey) from orders"
               " group by o_orderstatus order by o_orderstatus",
    "grouped_nulls": "select n_regionkey, count(distinct case when n_nationkey % 3 = 0"
                     " then null else n_name end) from nation group by n_regionkey"
                     " order by n_regionkey",
    "sum_distinct": "select l_returnflag, sum(distinct l_quantity) from lineitem"
                    " group by l_returnflag order by l_returnflag",
    "null_group_key": "select case when c_nationkey < 5 then null else c_mktsegment end s,"
                      " count(distinct c_nationkey) from customer group by 1",
}


@pytest.mark.parametrize("name", sorted(DISTINCT_QUERIES))
def test_distinct_aggregates_match_reference_and_oracle(name, runners, oracle):
    sql = DISTINCT_QUERIES[name]
    rows = _same(runners, sql)
    assert_rows_match(rows, sqlite_rows(oracle, to_sqlite(sql)),
                      ordered="order by" in sql, abs_tol=1e-2)


def test_two_distinct_aggregates_raise_in_both(runners):
    ref, port = runners
    sql = "select count(distinct o_custkey), sum(o_totalprice) from orders"
    with pytest.raises(NotImplementedError, match="only aggregate"):
        port.execute(sql)
    with pytest.raises(NotImplementedError, match="only aggregate"):
        ref.execute(sql)
