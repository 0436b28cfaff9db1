"""MATCH_RECOGNIZE: trino_tpu_torch (device="cpu") against trino_tpu on
the same inputs.

- The automaton: `find_matches` against the reference's over seeded
  masks and every pattern form; the step budget on a pathological
  pattern.
- SQL: every query of tests/test_match_recognize.py (MR_V imported) and
  a few beyond it, over the stock rows loaded with `load_table` in both
  packages (chip_smoke.MR_SQL lists them for the card-against-CPU
  check), equal rows; its error cases raise in both. The formatter round
  trip runs on the port's sql/formatter.py in tests/test_torch_statements.py.
- NULL keys: a NULL ORDER BY key sorts by its data in both. A NULL
  PARTITION BY key whose data equals a real key's merges into that
  partition in the reference and is its own partition in the port, and
  CLASSIFIER() compared with a string reads other codes in the
  reference (ROADMAP §3); those two are held against python.
- The queries of chip_smoke.py's phase zones at tpch.tiny.
"""

import numpy as np
import pytest

import chip_smoke as CS
from tests import test_match_recognize as corpus
from trino_tpu import types as JT
from trino_tpu.connectors.memory import create_memory_connector as jmemory
from trino_tpu.connectors.spi import ColumnMetadata as JColumnMetadata
from trino_tpu.connectors.tpch import create_tpch_connector as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.exec import match_recognize as JMR
from trino_tpu_torch.exec import match_recognize as MR

PATTERNS = [
    ("var", "a"),
    ("seq", [("plus", ("var", "a")), ("plus", ("var", "b"))]),
    ("seq", [("star", ("var", "a")), ("var", "b"), ("opt", ("var", "c"))]),
    ("alt", [("seq", [("var", "a"), ("var", "b")]), ("var", "c")]),
    ("rep", ("var", "a"), 2, 4),
    ("rep", ("alt", [("var", "a"), ("var", "b")]), 0, None),
    ("seq", [("opt", ("var", "a")), ("star", ("var", "c"))]),
]


@pytest.mark.parametrize("after", ["past_last", "next_row"])
@pytest.mark.parametrize("pattern", PATTERNS, ids=[str(i) for i in range(len(PATTERNS))])
def test_find_matches_equals_the_reference(pattern, after):
    rng = np.random.default_rng(len(str(pattern)))
    n = 200
    masks = {v: rng.random(n) < p for v, p in (("a", 0.5), ("b", 0.3), ("c", 0.2))}
    for lo, hi in ((0, n), (17, 90), (50, 50)):
        assert MR.find_matches(pattern, masks, lo, hi, after) == \
            JMR.find_matches(pattern, masks, lo, hi, after)


def test_budget_error_on_a_pathological_pattern(monkeypatch):
    # five stars over rows that all match, then a variable that never
    # does: the backtracking grows as n^5 at the first start position
    pattern = ("seq", [("star", ("var", "a"))] * 5 + [("var", "b")])
    masks = {"a": np.ones(60, bool), "b": np.zeros(60, bool)}
    for mod in (MR, JMR):
        monkeypatch.setattr(mod, "_STEP_CAP", 20_000)
        with pytest.raises(RuntimeError, match="backtracking budget exceeded"):
            mod.find_matches(pattern, masks, 0, 60, "past_last")
    # under the cap both find the same (no) matches
    masks["a"] = masks["a"][:6]
    masks["b"] = masks["b"][:6]
    assert MR.find_matches(pattern, masks, 0, 6, "past_last") == \
        JMR.find_matches(pattern, masks, 0, 6, "past_last") == []


@pytest.fixture(scope="module")
def stock():
    port = CS.mr_runner("cpu")
    conn = jmemory()
    CS.mr_load(conn, JT, JColumnMetadata)
    ref = JRunner(JSession(catalog="memory", schema="default"))
    ref.register_catalog("memory", conn)
    return port, ref


def test_mr_v_is_the_corpus_query():
    assert CS.MR_V == corpus.MR_V


@pytest.mark.parametrize("sql", CS.MR_SQL, ids=[str(i) for i in range(len(CS.MR_SQL))])
def test_corpus_equals_the_reference(stock, sql):
    port, ref = stock
    assert port.execute(sql).rows == ref.execute(sql).rows


def test_v_shape_rows(stock):
    # tests/test_match_recognize.py::test_v_shape's answer
    assert stock[0].execute(CS.MR_V).rows == [
        ["a", 2, 70, 5, 1], ["a", 6, 50, 8, 2], ["b", 2, 10, 4, 1]]


@pytest.mark.parametrize("sql,match", [
    # tests/test_match_recognize.py::test_errors
    ("select * from stock MATCH_RECOGNIZE (ORDER BY day"
     " MEASURES match_number() as m ALL ROWS PER MATCH"
     " PATTERN (x) DEFINE x AS price > 0)", "ONE ROW PER MATCH"),
    ("select * from stock MATCH_RECOGNIZE (ORDER BY day"
     " MEASURES match_number() as m PATTERN (x)"
     " DEFINE y AS price > 0)", "does not appear in PATTERN"),
    ("select * from stock MATCH_RECOGNIZE (ORDER BY day"
     " MEASURES match_number() as m PATTERN (x y)"
     " DEFINE x AS price > 0, y AS price > x.price)", "other"),
])
def test_errors_raise_in_both(stock, sql, match):
    for r in stock:
        with pytest.raises(Exception, match=match):
            r.execute(sql)


def test_null_order_key_sorts_by_its_data(stock):
    port, ref = stock
    sql = CS.MR_NULL_SQL[0]
    # ('b', NULL, 25) sorts first in b (its data is 0): 25 opens a rise
    assert port.execute(sql).rows == ref.execute(sql).rows == [
        ["b", None, None, 25, 1], ["b", 3, 4, 30, 2]]


def test_null_partition_key_is_its_own_partition(stock):
    port, ref = stock
    sql = CS.MR_NULL_SQL[1]
    # the NULL symbol's rows (day 1 price 5, day 2 price 3) fall once
    want = [["a", 2, 80, 1], ["a", 3, 70, 2], ["a", 6, 60, 3], ["a", 7, 50, 4],
            ["b", 1, 20, 1], ["b", 2, 10, 2], [None, 2, 3, 1]]
    assert port.execute(sql).rows == want
    # the reference's fault: the NULL rows hold the code of 'a', sort
    # into a's partition and break its matches
    assert ref.execute(sql).rows == [
        ["a", 6, 60, 3], ["a", 7, 50, 4], ["b", 1, 20, 1], ["b", 2, 10, 2],
        [None, 1, 5, 1], [None, 2, 3, 2]]


def test_classifier_compared_with_a_string(stock):
    port, ref = stock
    sql = """select * from stock MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES classifier() as which, first(up.day) as ud
      ONE ROW PER MATCH
      PATTERN (up | down)
      DEFINE up AS price > PREV(price), down AS price < PREV(price)
    ) where which = 'up' order by symbol, ud"""
    assert port.execute(sql).rows == [
        ["a", "up", 4], ["a", "up", 5], ["a", "up", 8], ["b", "up", 3], ["b", "up", 4]]
    # the reference plans CLASSIFIER() with no dictionary, so 'up' is
    # looked up elsewhere and the filter keeps the 'down' rows
    assert {row[1] for row in ref.execute(sql).rows} == {"down"}


# ---- the phase's pattern queries at tiny --------------------------------------


@pytest.fixture(scope="module")
def tiny():
    port = CS.runner("tiny", "cpu")
    ref = JRunner(JSession(catalog="tpch", schema="tiny"))
    ref.register_catalog("tpch", jtpch())
    return port, ref


@pytest.mark.parametrize("name", ["mr_orders", "mr_all", "mr_all_check", "mr_next"])
def test_phase_queries_equal_the_reference_at_tiny(tiny, name):
    port, ref = tiny
    sql = dict(CS.ZONE_QUERIES)[name]
    got = port.execute(sql).rows
    assert got == ref.execute(sql).rows
    assert got


def test_phase_identities_at_tiny(tiny):
    port, _ = tiny
    with CS.RouteLog(MR.MatchRecognizeOperator, "stats") as ops:
        rows = {n: port.execute(dict(CS.ZONE_QUERIES)[n]).rows for n in ("mr_all", "mr_all_check")}
    CS.check_patterns(rows)
    assert rows["mr_all"] == [[15_000, 26]]
    (st,) = ops.routes
    assert st["rows"] == st["matches"] == 15_000
    assert min(st["device_s"], st["automaton_s"], st["output_s"]) > 0
