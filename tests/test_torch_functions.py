"""The scalar function library through SQL: trino_tpu_torch
(device="cpu") against trino_tpu on the same tables.

- (a) Every case of tests/test_functions.py's five lists (imported, not
  copied) through both runners on tpch.tiny, row-equal, and equal to the
  corpus's own expected value. No case is left out.
- (b) The functions of tests/test_functions_r4.py,
  tests/test_function_breadth.py, tests/test_function_breadth_r5.py and
  the entropy, checksum and geometric_mean tests of
  tests/test_aggregates_r4.py. Their SQL is inline in those tests, so it
  is listed here with a comment naming the test it comes from, and the
  port is held against trino_tpu's answer. Tables the reference tests
  make with CREATE TABLE and INSERT are loaded with `load_table` in both
  packages (the port has no write side yet).
- The cases that call a TIMESTAMP WITH TIME ZONE function (ROADMAP §1
  item 6, ported) and the nested-type cases (item 4, ported) are listed
  apart and held to the reference's answer.

Integers, strings, booleans and decimals must be equal; doubles within
tests/oracle.py::assert_rows_match's default tolerance (rel 1e-9, abs
1e-6), NaN equal to NaN and an infinity to itself.
"""

import datetime
import hashlib
import math

import numpy as np
import pytest

import chip_smoke
import tests.test_functions as corpus
from tests.oracle import assert_rows_match
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu import types as JT
from trino_tpu.connectors import memory as jmemory
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.connectors.spi import ColumnMetadata as JColumnMetadata
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu_torch import types as T
from trino_tpu_torch.connectors import memory as tmemory
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.connectors.spi import ColumnMetadata
from trino_tpu_torch.engine import LocalQueryRunner, Session


@pytest.fixture(scope="module")
def tpch():
    ref = JRunner(JSession(catalog="tpch", schema="tiny"))
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    port.register_catalog("tpch", ttpch.create_tpch_connector())
    return ref, port


# the memory tables of the reference tests, by schema: (columns, arrays,
# valids); a column is (name, type name)
TABLES = {
    # tests/test_functions_r4.py's fixture
    "r4": {"t": ([("s", "VARCHAR"), ("n", "BIGINT")],
                 [["hello", "world", "abc", None], np.array([1, 2, 3, 4], np.int64)],
                 [np.array([1, 1, 1, 0], bool), None])},
    # tests/test_aggregates_r4.py's fixture
    "agg": {"t": ([("g", "BIGINT"), ("k", "VARCHAR"), ("v", "BIGINT")],
                  [np.array([1, 1, 1, 2, 2, 3], np.int64), ["a", "b", "a", "c", "c", None],
                   np.array([10, 20, 30, 40, 50, 60], np.int64)],
                  [None, np.array([1, 1, 1, 1, 1, 0], bool), None])},
    # the tables test_function_breadth.py makes with CREATE TABLE/INSERT
    "breadth": {"jdoc": ([("d", "VARCHAR")],
                         [['{"a": [1, 2, {"b": 7}]}', "[1,2,3]", '"x"', "nope"]], [None]),
                "sw": ([("w", "VARCHAR")], [["Robert", "Tymczak"]], [None]),
                # dates as text, one that does not parse
                "ds": ([("d", "VARCHAR")], [["1995-03-15", "2000-02-29", "1969-07-20", "bad",
                                             "12.5"]], [None])},
}


def _memory_runners(schema):
    out = []
    for pkg_types, cm, conn, runner, session in (
            (JT, JColumnMetadata, jmemory.MemoryConnector(), JRunner, JSession),
            (T, ColumnMetadata, tmemory.create_memory_connector(), None, Session)):
        for name, (cols, arrays, valids) in TABLES[schema].items():
            conn.load_table(schema, name,
                            [cm(c, getattr(pkg_types, t)) for c, t in cols],
                            [list(a) if isinstance(a, list) else a.copy() for a in arrays],
                            valids=valids)
        if runner is None:
            r = LocalQueryRunner(session(catalog="memory", schema=schema, user="alice"),
                                 device="cpu")
        else:
            r = runner(session(catalog="memory", schema=schema, user="alice"))
        r.register_catalog("memory", conn)
        out.append(r)
    return tuple(out)


@pytest.fixture(scope="module")
def memory():
    return {schema: _memory_runners(schema) for schema in TABLES}


def _equal_values(x, y):
    if isinstance(x, float) and isinstance(y, float) and (
            x == y or (math.isnan(x) and math.isnan(y))):  # infinities, NaN
        return True
    if isinstance(x, float) or isinstance(y, float):
        if x is None or y is None:
            return False
        assert_rows_match([[x]], [(y,)], ordered=True)
        return True
    return x == y


def _same(runners, sql):
    """Port rows equal to the reference's (types too); returns them."""
    ref, port = runners
    want, got = ref.execute(sql), port.execute(sql)
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types], sql
    assert len(got.rows) == len(want.rows), sql
    for a, b in zip(got.rows, want.rows):
        assert len(a) == len(b) and all(_equal_values(x, y) for x, y in zip(a, b)), \
            (sql, got.rows, want.rows)
    return got.rows


# ---- (a) tests/test_functions.py's five case lists, imported ----------

LISTS = ("CASES", "MATH_CASES", "STRING_CASES", "DATE_CASES", "REGISTRY_CASES")
CORPUS = [(lst, i) for lst in LISTS for i in range(len(getattr(corpus, lst)))]


@pytest.mark.parametrize("lst,i", CORPUS, ids=[f"{lst}-{i}" for lst, i in CORPUS])
def test_function_corpus_matches_reference_and_expected(lst, i, tpch):
    sql, want = getattr(corpus, lst)[i]
    rows = _same(tpch, sql)
    got = rows[0][0]
    # as the corpus checks: doubles within 1e-9, everything else equal
    if isinstance(want, float):
        assert got is not None and abs(got - want) < 1e-9, (sql, got, want)
    else:
        assert got == want, (sql, got, want)


# SQL inline in tests/test_functions.py's column tests
CORPUS_COLUMN_SQL = {
    # test_date_functions_on_columns
    "date_columns": "SELECT o_orderdate, quarter(o_orderdate), week(o_orderdate),"
                    " day_of_week(o_orderdate), day_of_year(o_orderdate),"
                    " date_trunc('month', o_orderdate),"
                    " date_add('month', 2, o_orderdate),"
                    " date_diff('day', o_orderdate, date '1998-01-01')"
                    " FROM orders LIMIT 500",
    # test_review_regressions
    "logical_shift": "SELECT bitwise_right_shift(-8, 2)",
    "dollar_escape": "SELECT regexp_replace(n_name, '^ALGERIA$', '\\$1')"
                     " FROM nation WHERE n_nationkey = 0",
    "empty_codepoint": "SELECT codepoint(ltrim(' ')) FROM nation WHERE n_nationkey = 0",
    # test_registry_functions_over_table
    "md5_column": "SELECT n_name, md5(n_name) FROM nation WHERE n_nationkey < 2"
                  " ORDER BY n_nationkey",
}


@pytest.mark.parametrize("name", sorted(CORPUS_COLUMN_SQL))
def test_function_corpus_column_queries(name, tpch):
    rows = _same(tpch, CORPUS_COLUMN_SQL[name])
    if name == "date_columns":
        assert len(rows) == 500
        for d, q, w, dw, dy, *_ in rows:
            day = datetime.date(1970, 1, 1) + datetime.timedelta(days=d)
            assert (q, w, dw, dy) == ((day.month - 1) // 3 + 1, day.isocalendar()[1],
                                      day.isoweekday(), day.timetuple().tm_yday)
    elif name == "logical_shift":
        assert rows == [[(-8 % (1 << 64)) >> 2]]
    elif name == "dollar_escape":
        assert rows == [["$1"]]
    elif name == "empty_codepoint":
        assert rows == [[None]]
    else:
        assert all(digest == hashlib.md5(n.encode()).hexdigest() for n, digest in rows)


# ---- (b) the other corpora, SQL listed by the test it comes from ------

R4_SQL = [
    # TestDigests
    "select sha512('')", "select xxhash64('')", "select xxhash64('abc')",
    "select murmur3('abc')", "select hmac_sha256('hello', 'key')",
    "select hmac_md5(s, 'k') from t", "select crc32('hello')",
    # TestEncodings
    "select to_base32('hello')", "select from_base32(to_base32(s)) from t",
    "select to_base64url('h?>llo')", "select from_base64url(to_base64url('h?>llo'))",
    "select from_big_endian_64(to_big_endian_64(258))",
    "select from_big_endian_32(to_big_endian_32(77))",
    "select from_big_endian_64('abc')", "select from_ieee754_64(to_ieee754_64(2.5))",
    "select char2hexint('AB')",
    # TestStringRemainder
    "select luhn_check('79927398713')", "select luhn_check('79927398710')",
    "select strrpos('ababab', 'ab')", "select strpos('ababab', 'ab')",
    "select index('ababab', 'ba')", "select position('lo', 'hello')",
    "select word_stem('running')", "select word_stem(s) from t",
    "select from_utf8(to_utf8('héllo'))",
    "select concat_ws('-', 'a', null, 'b', 'c')", "select concat_ws('-', null, 'b')",
    "select concat_ws('-', null, null)", "select concat_ws('-', 'x', '', 'y')",
    "select concat_ws('-', s, 'z') from t",
    # TestDatetimeParse
    "select from_iso8601_timestamp('2020-01-01T12:30:00Z')",
    "select from_iso8601_timestamp('2020-01-01T13:30:00+01:00')",
    "select from_iso8601_timestamp_nanos('2020-01-01T00:00:00.123456789Z')",
    "select parse_datetime('10/05/2020 11:22', 'dd/MM/yyyy HH:mm')",
    "select parse_datetime('01 Jan 2020', 'dd MMM yyyy')",
    "select to_date('2021-03-04', 'yyyy-mm-dd')", "select to_date('bogus', 'yyyy-mm-dd')",
    "select from_unixtime_nanos(1500000000123456789)", "select from_unixtime_nanos(-1)",
    "select date('2021-05-06')",
    "select cast('2021-05-06' as date)", "select cast('bad' as date)",
    "select to_iso8601(date '2020-02-29')",
    # TestMathSession
    "select from_base('1010', 2)", "select from_base('ff', 16)",
    "select to_base(255, 16)", "select to_base(-8, 2)", "select from_base('zz', 8)",
    "select beta_cdf(2.0, 3.0, inverse_beta_cdf(2.0, 3.0, 0.37))",
    "select current_timezone()", "select human_readable_seconds(93784)",
    "select to_milliseconds(parse_duration('3.5m'))", "select parse_data_size('2.3MB')",
    "select format_number(1234567)", "select format_number(531)",
    "select rgb(255, 0, 0)", "select color('#0f0')", "select render('x', color('red'))",
    "select bar(0.5, 10)",
]

BREADTH_SQL = [
    # test_bitwise_family
    "select bitwise_and(19,25), bitwise_or(19,25), bitwise_xor(19,25), bitwise_not(19)",
    "select bitwise_left_shift(1,3), bitwise_right_shift_arithmetic(-8,1)",
    "select bitwise_right_shift(-8,1)",
    "select bit_count(9), bit_count(-7, 64), bit_count(-7, 8)",
    # test_math_remainder
    "select pi(), e(), round(cot(1.0), 6)",
    "select is_nan(nan()), is_infinite(infinity())",
    "select width_bucket(3.14, 0.0, 4.0, 3), width_bucket(-1.0, 0.0, 4.0, 3),"
    " width_bucket(9.9, 0.0, 4.0, 3)",
    "select round(normal_cdf(0.0, 1.0, 1.96), 3),"
    " round(inverse_normal_cdf(0.0, 1.0, 0.975), 2)",
    # test_datetime_breadth
    "select hour(date_parse('2024-03-05 10:30:45', '%Y-%m-%d %H:%i:%s')),"
    " minute(date_parse('2024-03-05 10:30:45', '%Y-%m-%d %H:%i:%s')),"
    " second(date_parse('2024-03-05 10:30:45', '%Y-%m-%d %H:%i:%s')),"
    " year(date_parse('2024-03-05 10:30:45', '%Y-%m-%d %H:%i:%s'))",
    "select hour(from_unixtime(3700)), minute(from_unixtime(3700))",
    "select to_unixtime(from_unixtime(12.5))",
    "select date_parse('nope', '%Y-%m-%d')",
    # test_json_breadth
    "select json_extract(d, '$.a[2]'), is_json_scalar(d), json_array_contains(d, 2),"
    " json_array_get(d, 1), json_parse(d) from jdoc",
    # test_string_remainder
    "select soundex(w), regexp_position(w, 'm'), normalize(w) from sw",
    # no corpus: varchar to date, timestamp and decimal over a column
    "select d, cast(d as date), cast(concat(d, ' 10:11:12') as timestamp),"
    " cast(concat(d, '.5') as decimal(30, 4)), cast(d as decimal(10, 2)),"
    " to_timestamp(d, 'yyyy-mm-dd'), to_date(d, 'yyyy-mm-dd') from ds",
]

R5_SQL = [
    # TestSessionPseudoColumns
    "select current_catalog, current_schema, current_user",
    # TestJodaTokens
    "select parse_datetime('July 4, 2024', 'MMMM d, yyyy')",
]

AGG_SQL = [
    # TestCompositeAggregates: test_entropy, test_entropy_empty_is_zero
    "select entropy(v) from t where g = 1", "select entropy(v) from t where g > 99",
    # test_checksum_order_insensitive, test_checksum_detects_difference,
    # test_checksum_strings_and_empty
    "select checksum(v) from t", "select checksum(v) from (select v from t order by v desc)",
    "select checksum(v + 1) from t", "select checksum(k) from t",
    "select checksum(v) from t where g > 99",
    # test_geometric_mean
    "select geometric_mean(v) from t",
]

BREADTH_CASES = [("r4", q) for q in R4_SQL] + [("breadth", q) for q in BREADTH_SQL] \
    + [("r5", q) for q in R5_SQL] + [("agg", q) for q in AGG_SQL]


@pytest.mark.parametrize("schema,sql", BREADTH_CASES,
                         ids=[f"{s}-{i}" for i, (s, _) in enumerate(BREADTH_CASES)])
def test_breadth_corpora_match_reference(schema, sql, memory, tpch):
    _same(memory[schema] if schema in memory else tpch, sql)


# ---- cases once routed to ROADMAP §1 item 6 (TIMESTAMP WITH TIME ZONE,
# ported): the port answers as the reference does ------------------------

ROUTED = [
    # tests/test_functions_r4.py: test_timezone_offsets_are_utc,
    # test_timestamp_literal, test_session_constants (now())
    ("r4", "select timezone_hour(from_unixtime(0))", 6),
    ("r4", "select timezone_minute(from_unixtime(0))", 6),
    ("r4", "select timestamp '2020-01-01 00:30:00'", 6),
    ("r4", "select now()", 6),
    # tests/test_function_breadth_r5.py: TestJodaTokens, TestSplitToMap
    ("r5", "select format_datetime(timestamp '2024-07-04 15:30:45', 'EEEE, MMMM d yyyy')", 6),
    ("r5", "select format_datetime(timestamp '2024-02-01 13:05:00', 'DDD h a')", 6),
    ("r5", "select format_datetime(timestamp '2024-07-04 15:30:45 America/New_York',"
           " 'yyyy-MM-dd HH:mm')", 6),
]


@pytest.mark.parametrize("schema,sql,item", ROUTED,
                         ids=[f"{s}-{i}" for i, (s, _, _) in enumerate(ROUTED)])
def test_routed_functions_name_their_item(schema, sql, item, memory, tpch):
    runners = memory.get(schema, tpch)
    if "now()" not in sql:
        assert _same(runners, sql)
        return
    # now() reads the clock: the same zone, within a minute of each other
    want, got = (r.execute(sql).rows[0][0] for r in runners)
    assert got.endswith(" UTC") and want.endswith(" UTC")
    gap = datetime.datetime.fromisoformat(got[:23]) - datetime.datetime.fromisoformat(want[:23])
    assert abs(gap) < datetime.timedelta(minutes=1)


# tests/test_function_breadth_r5.py's TestSplitToMap and the array
# functions over test_function_breadth.py's jdoc table (nested values:
# ROADMAP §1 item 4, now ported)
NESTED = [
    ("breadth", "select split_to_map(d, ',', '=') from jdoc"),
    ("breadth", "select split(d, ',') from jdoc"),
    ("breadth", "select regexp_extract_all(d, '[0-9]') from jdoc"),
    ("breadth", "select transform(split(d, ','), x -> length(x)) from jdoc"),
]


@pytest.mark.parametrize("schema,sql", NESTED, ids=[f"{s}-{i}" for i, (s, _) in enumerate(NESTED)])
def test_nested_functions_match_reference(schema, sql, memory, tpch):
    assert _same(memory.get(schema, tpch), sql)


def test_nondeterministic_functions(memory):
    """rand's draws cannot equal the reference's (a torch.Generator, not
    a JAX key): their range holds. uuid and version keep their shape.
    tests/test_functions_r4.py: test_rand_bounds, test_uuid_shape,
    test_session_constants."""
    _, port = memory["r4"]
    rows = port.execute("select rand(), rand(10), random(5, 8) from t").rows
    assert len(rows) == 4
    for u, a, b in rows:
        assert 0.0 <= u < 1.0 and 0 <= a < 10 and 5 <= b < 8
    u = port.execute("select uuid()").rows[0][0]
    assert len(u) == 36 and u.count("-") == 4
    assert "trino_tpu" in port.execute("select version()").rows[0][0]


def test_rand_draws_anew_for_every_batch():
    """Over a scan of many batches each batch draws its own values: no
    two batches repeat a vector, and the mean of 60k draws is 0.5 within
    6 standard errors."""
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny", batch_rows=1024),
                            device="cpu")
    port.register_catalog("tpch", ttpch.create_tpch_connector())
    rows = port.execute("select l_orderkey, l_linenumber, rand() from lineitem").rows
    u = np.array([r[2] for r in rows])
    assert len(u) > 50 * 1024 and ((u >= 0) & (u < 1)).all()
    batches = [tuple(u[i:i + 64]) for i in range(0, len(u) - 1024, 1024)]
    assert len(set(batches)) == len(batches)
    assert abs(u.mean() - 0.5) < 6 * (1 / 12) ** 0.5 / len(u) ** 0.5


# ---- column forms over tpch.tiny (the sf1 identities of chip_smoke.py's
# functions queries, at tiny) --------------------------------------------

COLUMN_SQL = {
    "date_trunc_group": "select date_trunc('month', o_orderdate) m, quarter(o_orderdate),"
                        " count(*), sum(o_totalprice) from orders group by 1, 2 order by 1",
    "date_round_trips": "select count(*) from orders where date_diff('day', o_orderdate,"
                        " date_add('day', 45, o_orderdate)) = 45 and date_add('month', -1,"
                        " date_add('month', 1, date_trunc('month', o_orderdate)))"
                        " = date_trunc('month', o_orderdate)"
                        " and day_of_week(o_orderdate) between 1 and 7",
    "timestamp_parts": "select date_trunc('hour', date_add('minute', 90,"
                       " cast(o_orderdate as timestamp))), hour(date_add('minute', 150,"
                       " cast(o_orderdate as timestamp))), date_diff('hour',"
                       " cast(o_orderdate as timestamp), date_add('day', -3,"
                       " cast(o_orderdate as timestamp))), year_of_week(o_orderdate),"
                       " last_day_of_month(o_orderdate), to_unixtime(o_orderdate)"
                       " from orders order by o_orderkey limit 300",
    "regexp_columns": "select count(*), sum(regexp_count(o_comment, 'e')),"
                      " sum(strpos(o_comment, 'the')), sum(length(regexp_replace("
                      "o_comment, '[aeiou]', ''))), count(regexp_extract(o_comment,"
                      " '(fur|bli)[a-z]+', 1)) from orders where"
                      " regexp_like(o_comment, 'special.*requests')",
    "math_columns": "select sum(ln(o_totalprice)), sum(sqrt(o_totalprice)),"
                    " sum(log10(o_totalprice)), sum(power(o_totalprice, 0.5)),"
                    " sum(sin(o_totalprice)), sum(cbrt(o_totalprice)),"
                    " geometric_mean(o_totalprice), max(truncate(o_totalprice / 7e0, 2))"
                    " from orders",
    "casts_and_split": "select cast(o_shippriority as varchar), cast(o_orderkey as varchar),"
                       " split_part(o_clerk, '#', 2), lpad(cast(o_custkey as varchar), 6,"
                       " '0'), cast(split_part(o_clerk, '#', 2) as decimal(12,2))"
                       " from orders order by o_orderkey limit 200",
    "hash_columns": "select c_name, md5(to_utf8(c_name)), xxhash64(to_utf8(c_name)),"
                    " crc32(to_utf8(c_name)), to_base64(c_name), sha256(c_phone)"
                    " from customer order by c_custkey limit 100",
    "bitwise_join": "select c_mktsegment, bitwise_and(c_custkey, 15) b, count(*),"
                    " sum(o_totalprice) from customer join orders on c_custkey = o_custkey"
                    " where regexp_like(c_phone, '^1[0-9]-') group by 1, 2 order by 1, 2",
    "checksum_entropy": "select checksum(o_comment), checksum(o_totalprice),"
                        " entropy(o_shippriority + 1) from orders",
}


# functions no corpus reaches, over columns and constants
COLUMN_SQL.update({
    "hyperbolic_and_constants": "select sinh(o_totalprice / 1e5), cosh(o_totalprice / 1e5),"
                                " asinh(o_totalprice), acosh(o_totalprice), atanh(1e0 / o_totalprice),"
                                " expm1(1e-3 * o_shippriority), log1p(o_totalprice), e(), pi(),"
                                " is_nan(nan()), infinity() from orders order by o_orderkey limit 50",
    "probability": "select normal_cdf(1.5, 2.0, o_totalprice / 1e5), cauchy_cdf(0.0, 1.0, 0.5),"
                   " chi_squared_cdf(3.0, o_totalprice / 1e5), gamma_cdf(2.0, 1.5, 0.7),"
                   " poisson_cdf(2.5, 3), beta_cdf(2.0, 5.0, 0.3), f_cdf(3.0, 7.0, 1.2),"
                   " binomial_cdf(20, 0.3, 5), laplace_cdf(0.0, 1.0, -0.5),"
                   " logistic_cdf(0.0, 1.0, 0.3), weibull_cdf(1.5, 2.0, 1.0),"
                   " inverse_beta_cdf(2.0, 5.0, 0.4), wilson_interval_lower(30, 100, 1.96),"
                   " wilson_interval_upper(30, 100, 1.96), width_bucket(o_totalprice, 5e5, 0e0, 9)"
                   " from orders order by o_orderkey limit 40",
    "timestamps": "select date_trunc('minute', ts), date_trunc('second', ts), date_trunc('year', ts),"
                  " date_add('month', 5, ts), date_add('second', -7, ts),"
                  " date_diff('month', ts, date_add('day', 400, ts)), millisecond(ts), second(ts),"
                  " minute(ts), to_unixtime(ts), day_of_year(ts), week(ts) from (select"
                  " from_unixtime(o_orderkey * 86399.123e0) ts from orders) t order by ts limit 60",
    "codecs_columns": "select sha512(n_name), hmac_sha1(n_name, 'k'), hmac_sha512(n_comment, 'key'),"
                      " murmur3(n_name), to_base32(n_name), from_base32(to_base32(n_name)),"
                      " to_base64url(n_comment), from_hex(to_hex(n_name)), char2hexint(n_name),"
                      " url_encode(n_comment), levenshtein_distance(n_name, 'CHINA'),"
                      " hamming_distance(n_name, 'CHINA'), soundex(n_name), translate(n_comment,"
                      " 'aeiou', 'AEI'), word_stem(n_comment) from nation order by n_nationkey",
})


@pytest.mark.parametrize("name", sorted(COLUMN_SQL))
def test_column_forms_match_reference(name, tpch):
    assert _same(tpch, COLUMN_SQL[name])


def test_bitwise_join_equals_its_substr_twin(tpch):
    """chip_smoke.py's join identity at tiny: regexp_like and bitwise_and
    against substr and % 16."""
    _, port = tpch
    twin = ("select c_mktsegment, c_custkey % 16 b, count(*), sum(o_totalprice)"
            " from customer join orders on c_custkey = o_custkey"
            " where substr(c_phone, 1, 1) = '1' and substr(c_phone, 3, 1) = '-'"
            " group by 1, 2 order by 1, 2")
    assert port.execute(COLUMN_SQL["bitwise_join"]).rows == port.execute(twin).rows


# ---- where the reference is wrong (ROADMAP §3) or raises ---------------

DEC = ("from (select cast(o_totalprice as decimal(12,2)) x,"
       " cast(o_totalprice * 3 as decimal(15,4)) y, cast(o_totalprice as decimal(38,2)) lx,"
       " cast(-o_totalprice * 3 as decimal(38,4)) ly from orders where o_orderkey < 10) t")


def test_log_and_atan2_descale_decimal_arguments(tpch):
    """log(b, x) and atan2(y, x) read a decimal as its value: the
    reference reads the scaled integer (log(2.0, 8.0) = log(80)/log(20))."""
    ref, port = tpch
    sql = "select log(2.0, 8.0), atan2(1.0, 2.0), log(2, 8)"
    assert ref.execute(sql).rows[0][0] == pytest.approx(math.log(80) / math.log(20))
    got = port.execute(sql).rows[0]
    assert got == pytest.approx([3.0, math.atan2(1.0, 2.0), 3.0], rel=1e-15)


def test_coalesce_of_decimals_takes_the_result_scale(tpch):
    """coalesce(decimal(12,2), decimal(15,4)) is decimal(15,4): the
    reference reads x's scale-2 payload at scale 4 (55732.18 -> 557.3218);
    the port rescales, short and long decimals alike."""
    ref, port = tpch
    sql = f"select x, coalesce(x, y), coalesce(lx, ly) {DEC}"
    want = ref.execute(sql).rows
    got = port.execute(sql).rows
    assert all(w[1] == pytest.approx(w[0] / 100, rel=1e-12) for w in want)
    assert all(g[1] == g[0] and g[2] == g[0] for g in got)


def test_long_decimal_greatest_least_round(tpch):
    """greatest/least over decimal(>18) compare as 128-bit values (equal
    to the reference's answer here); round over decimal(>18) rounds half
    away from zero in 128 bits, where the reference raises."""
    ref, port = tpch
    _same(tpch, f"select greatest(lx, ly), least(lx, ly), greatest(lx, 1e0) {DEC}")
    sql = f"select lx, round(lx, 1), round(lx), round(lx, 5) {DEC}"
    with pytest.raises(ValueError):
        ref.execute(sql)
    from decimal import ROUND_HALF_UP, Decimal
    for lx, r1, r0, r5 in port.execute(sql).rows:
        d = Decimal(str(lx))
        assert Decimal(str(r1)) == d.quantize(Decimal("0.1"), ROUND_HALF_UP)
        assert Decimal(str(r0)) == d.quantize(Decimal("1"), ROUND_HALF_UP)
        assert r5 == lx


BOTH_RAISE = [
    f"select lx in (55732.18, 1.5) {DEC}",
    "select replace(o_comment, o_comment, 'a') from orders",
    "select starts_with(o_comment, o_comment) from orders",
    "select round(o_totalprice, o_shippriority) from orders",
    f"select mod(lx, 2e0) {DEC}",
    f"select sign(lx) {DEC}",
    f"select truncate(lx) {DEC}",
    f"select cast(lx as varchar) {DEC}",
    "select date_diff('hour', o_orderdate, o_orderdate) from orders",
]


@pytest.mark.parametrize("sql", BOTH_RAISE)
def test_inputs_the_reference_refuses_raise_in_the_port(sql, tpch):
    """The port's `_unsupported` sites and plain raises: the reference
    raises on the same input."""
    ref, port = tpch
    with pytest.raises(Exception):
        ref.execute(sql).rows
    with pytest.raises(NotImplementedError):
        port.execute(sql)


@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.FN_QUERIES])
def test_chip_smoke_function_queries_match_reference(name, tpch):
    """chip_smoke.py's functions queries (sf1 on the card) at tiny."""
    assert _same(tpch, dict(chip_smoke.FN_QUERIES)[name])


def test_shared_and_reference_only_faults(tpch):
    """cast(DATE as varchar) renders the epoch-day integer, NULL from
    4,096 days on, in both packages (Trino renders the date): the port
    keeps the reference's static-dictionary cast. ln over decimal(>18)
    crashes the reference's result fetch; the port descales the limbs."""
    ref, port = tpch
    sql = "select cast(o_orderdate as varchar), cast(date '1971-01-01' as varchar) from orders"
    assert port.execute(sql).rows[:3] == ref.execute(sql).rows[:3] == [[None, "365"]] * 3
    sql = "select ln(cast(o_totalprice as decimal(38, 2))), ln(o_totalprice) from orders"
    with pytest.raises(TypeError):
        ref.execute(sql)
    assert all(a == pytest.approx(b, rel=1e-15) for a, b in port.execute(sql).rows)
