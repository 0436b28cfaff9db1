"""Nested ARRAY/MAP/ROW columns, the collect aggregates, the lambda and
array functions and UNNEST: trino_tpu_torch (device="cpu") against
trino_tpu on the same inputs.

- Units: ArrayColumn/MapColumn/RowColumn round trips, gathers and
  `_concat_columns` (NULL, empty and nested values, dead rows), the
  binder's `_seg_counts`, and UNNEST's device expansion against the
  reference's np.repeat construction (empty and NULL arrays, dead rows,
  zip padding, ordinality). Tolerance: equal python values.
- SQL over the memory tables of tests/test_array_columns.py,
  tests/test_nested_types.py, tests/test_aggregates_r4.py (the collect
  aggregates), tests/test_sketches_r4.py (the array and sketch cases)
  and tests/test_function_breadth_r5.py (qdigest readers, split_to_map),
  loaded with `load_table` in both packages; the nested DDL, CTAS and
  INSERT cases run in both over fresh copies (tests/test_torch_write.py
  holds the rest of the write side). Their SQL is inline in those tests, so chip_smoke.py lists it
  (`NEST_MEMORY_SQL`, `nest_tables`, each with a comment naming the
  test) for its card-against-CPU check, and it is imported here. Rows
  equal, types equal; doubles within tests/oracle.py::assert_rows_match's
  default tolerance.
- The nested queries of chip_smoke.py at tpch.tiny. Two reference
  faults are pinned (ROADMAP §3): the port answers right where the
  reference loses split's dictionary across UNNEST and where its filter
  misreads arrays a join has gathered.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from tests.oracle import assert_rows_match
from trino_tpu import block as JB
from trino_tpu import types as JT
from trino_tpu.connectors import memory as jmemory
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.connectors.spi import ColumnMetadata as JColumnMetadata
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.exec.unnest import UnnestOperator as JUnnest
from trino_tpu.expr.compile import ExprBinder as JBinder
from trino_tpu_torch import block as TB
from trino_tpu_torch import types as T
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.exec.unnest import UnnestOperator
from trino_tpu_torch.expr.compile import ExprBinder as TBinder

# ---- units -----------------------------------------------------------------

NESTED_VALUES = [
    ("array(bigint)", [[1, 2], [], None, [3], [None, 5]]),
    ("array(varchar)", [["red", "blue"], None, [], ["green", None, "red"], ["x"]]),
    ("array(array(bigint))", [[[1, 2], [3]], [[4]], None, [], [[], [5, 6]]]),
    ("map(varchar, bigint)", [{"a": 1, "b": 2}, None, {}, {"c": None}, {"a": 9}]),
    ("row(x bigint, y varchar)", [(7, "p"), None, (8, None), (None, "q"), (1, "r")]),
    ("array(map(varchar, bigint))", [[{"a": 1}, {}], None, [{"c": 3}], [], [{"d": 4}]]),
]


def _types(name):
    """(port type, reference type) of a type name."""
    return CS.nest_type(T, name), CS.nest_type(JT, name)


@pytest.mark.parametrize("name,values", NESTED_VALUES, ids=[n for n, _ in NESTED_VALUES])
def test_nested_columns_round_trip_gather_and_concat(name, values):
    tt, jt = _types(name)
    tc = TB.Column.from_pylist(tt, values)
    jc = JB.Column.from_pylist(jt, values)
    assert type(tc).__name__ == type(jc).__name__
    n = len(values)
    assert tc.to_pylist(count=n) == jc.to_pylist(count=n) == values
    # a gather that repeats, reverses and clips rows, with a validity
    pos = np.array([4, 0, 0, 3, 2, 1, 9, 4], np.int32)
    pv = np.array([1, 1, 0, 1, 1, 1, 1, 1], bool)
    tg = tc.gather(torch.from_numpy(pos), torch.from_numpy(pv))
    jg = jc.gather(jnp.asarray(pos), jnp.asarray(pv))
    assert tg.to_pylist(count=8) == jg.to_pylist(count=8)
    # concatenation rebases each part's starts by the flats before it
    tcat = TB._concat_columns([tg, tc, tg])
    jcat = JB._concat_columns([jg, jc, jg])
    assert tcat.to_pylist() == jcat.to_pylist()
    live = np.zeros(tcat.capacity, bool)
    live[::3] = True
    assert tcat.to_pylist(live=live) == jcat.to_pylist(live=live)
    assert TB.null_column(tt, 4).to_pylist() == [None] * 4


def test_seg_counts_equal_the_reference():
    rng = np.random.default_rng(3)
    flags = rng.random(200) < 0.4
    lengths = rng.integers(0, 9, 60).astype(np.int32)
    starts = rng.integers(0, 195, 60).astype(np.int32)
    lengths[::7] = 0
    got = TBinder._seg_counts(torch.from_numpy(flags), torch.from_numpy(starts),
                              torch.from_numpy(lengths))
    want = JBinder._seg_counts(jnp.asarray(flags), jnp.asarray(starts), jnp.asarray(lengths))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # against the definition, slices clipped at the flat's end
    ref = [int(flags[s:s + n].sum()) if n else 0 for s, n in zip(starts, lengths)]
    assert got.tolist() == ref


def _unnest_batches(seed):
    """The same batch for both packages: a key, a string array, a bigint
    array and an array of arrays with empty and NULL arrays, and dead
    rows."""
    rng = np.random.default_rng(seed)
    n = 37
    words = ["a", "b", "c", "d"]

    def arr(fn):
        out = []
        for _ in range(n):
            u = rng.random()
            out.append(None if u < 0.15 else [] if u < 0.3 else
                       [fn() for _ in range(int(rng.integers(1, 5)))])
        return out

    cols = {
        "k": list(range(n)),
        "s": arr(lambda: words[int(rng.integers(0, 4))]),
        "x": arr(lambda: int(rng.integers(-50, 50))),
        "aa": arr(lambda: [int(v) for v in rng.integers(0, 9, int(rng.integers(0, 3)))]),
    }
    live = rng.random(64) < 0.8
    out = []
    for B, mod in ((TB, T), (JB, JT)):
        schema = [("k", mod.BIGINT), ("s", mod.array_of(mod.VARCHAR)),
                  ("x", mod.array_of(mod.BIGINT)),
                  ("aa", mod.array_of(mod.array_of(mod.BIGINT)))]
        b = B.RelBatch.from_pydict(schema, cols, capacity=64)
        lv = torch.from_numpy(live) if B is TB else jnp.asarray(live)
        out.append((B.RelBatch(b.columns, lv), schema))
    return out


@pytest.mark.parametrize("channels,ordinality", [
    ([1], False), ([2], True), ([1, 2], True), ([3], False), ([2, 1, 3], True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_unnest_expansion_equals_the_reference(channels, ordinality, seed):
    (tb, ts), (jb, js) = _unnest_batches(seed)
    op = UnnestOperator(channels, ordinality, [(t, None) for _, t in ts])
    op.add_input(tb)
    jop = JUnnest(channels, ordinality, [(t, None) for _, t in js])
    jop.add_input(jb)
    got, want = op.get_output(), jop.get_output()
    assert got.capacity == want.capacity
    assert got.to_pylists() == want.to_pylists()
    assert got.to_pylists()  # the case expands to some rows


# ---- SQL over memory tables -------------------------------------------------

def _runners(schema):
    conn = jmemory.MemoryConnector()
    CS.nest_load(conn, JT, JColumnMetadata, schema)
    ref = JRunner(JSession(catalog="memory", schema=schema))
    ref.register_catalog("memory", conn)
    return ref, CS.nest_runner(schema, "cpu")


@pytest.fixture(scope="module")
def memory():
    return {schema: _runners(schema) for schema in CS.nest_tables()}


def _close(x, y) -> bool:
    if isinstance(x, float) and isinstance(y, float):
        if x == y or (math.isnan(x) and math.isnan(y)):
            return True
        assert_rows_match([[x]], [(y,)], ordered=True)
        return True
    if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
        return len(x) == len(y) and all(_close(a, b) for a, b in zip(x, y))
    if isinstance(x, dict) and isinstance(y, dict):
        return list(x) == list(y) and all(_close(x[k], y[k]) for k in x)
    return x == y


def _same(runners, sql, sort=False):
    ref, port = runners
    want, got = ref.execute(sql), port.execute(sql)
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types], sql
    g, w = got.rows, want.rows
    if sort:
        key = lambda r: repr(r)  # noqa: E731
        g, w = sorted(g, key=key), sorted(w, key=key)
    assert len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w)), (sql, g, w)
    return got.rows


@pytest.mark.parametrize("schema,sql", CS.NEST_MEMORY_SQL,
                         ids=[f"{s}-{i}" for i, (s, _) in enumerate(CS.NEST_MEMORY_SQL)])
def test_nested_sql_matches_reference(schema, sql, memory):
    assert _same(memory[schema], sql) is not None


def test_full_join_keeps_nested_payload(memory):
    # tests/test_nested_types.py: test_full_join_with_nested_payload
    rows = _same(memory["nest"], "select x, t, y from fa2 full join fb2 on x = y", sort=True)
    assert sorted(rows, key=repr) == sorted([[1, [10], None], [2, [20, 21], 2],
                                             [None, None, 3]], key=repr)


@pytest.mark.parametrize("sql", [
    "select tags, count(*) from orders_tags group by tags",
    "select id from orders_tags order by tags",
    "select a.id from orders_tags a, orders_tags b where a.tags = b.tags",
    "select distinct tags from orders_tags"])
def test_arrays_rejected_as_keys(sql, memory):
    # tests/test_array_columns.py: test_arrays_rejected_as_keys
    for r in memory["tags"]:
        with pytest.raises(Exception, match="ARRAY|array"):
            r.execute(sql)


# ---- the nested queries of chip_smoke.py at tpch.tiny -----------------------

@pytest.fixture(scope="module")
def tpch():
    ref = JRunner(JSession(catalog="tpch", schema="tiny"))
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    port.register_catalog("tpch", ttpch.create_tpch_connector())
    return ref, port


@pytest.mark.parametrize("name", ["NEST_AGG_UNNEST", "NEST_AGG_CHECK", "NEST_LAMBDA",
                                  "NEST_LAMBDA_LIKE", "NEST_MAPS", "NEST_WORDS_TOTAL"])
def test_nested_chip_queries_match_reference(name, tpch):
    assert _same(tpch, getattr(CS, name))


def test_nested_chip_identities_hold_at_tiny(tpch):
    _, port = tpch
    total = port.execute(CS.NEST_WORDS_TOTAL).rows[0][0]
    words = port.execute(CS.NEST_WORDS).rows
    assert total == 90249 and sum(c for _, c in words) == total and len(words) == 47
    cnt, ksum, imax = port.execute(CS.NEST_AGG_UNNEST).rows[0]
    assert [cnt, ksum, imax] == port.execute(CS.NEST_AGG_CHECK).rows[0]
    long_words, n_parts, special = port.execute(CS.NEST_LAMBDA).rows[0]
    assert long_words == sum(c for w, c in words if len(w) > 5) == 63160
    assert n_parts == total
    assert special == port.execute(CS.NEST_LAMBDA_LIKE).rows[0][0]
    for _, hist, agg, n in port.execute(CS.NEST_MAPS).rows:
        assert sum(hist.values()) == n and set(agg) == set(hist)


def test_word_count_keeps_splits_dictionary(tpch):
    """The reference plans UNNEST's element column without split's
    dictionary, so its GROUP BY answers each word's code as a string
    ('36' for 'requests'); the port carries the dictionary and answers
    the words, with the same counts in the same order."""
    ref, port = tpch
    sql = CS.NEST_WORDS + " limit 3"
    want = ref.execute(sql).rows
    assert want == [["36", 2230], ["34", 2127], ["25", 2113]]
    got = port.execute(sql).rows
    words = sorted(w for w, _ in port.execute(CS.NEST_WORDS).rows)
    assert got == [[words[int(code)], c] for code, c in want]
    assert got == [["requests", 2230], ["quickly", 2127], ["instructions", 2113]]


def test_filter_after_a_join_keeps_each_rows_elements(tpch):
    """The reference's filter compacts the whole flat column in flat
    order and gives row i the slice at the running count of the rows
    before it. That is wrong wherever the flat column is not exactly
    the rows' elements in row order: over arrays a join has gathered
    (build rows out of order), and already over split's W-wide rows,
    whose padding slots pass the filter too ('about', the parts'
    dictionary's code 0). The port compacts each row's own elements:
    filtered after the join or before it, and as python filters."""
    ref, port = tpch
    cut = CS.NEST_JOIN_CUT["tiny"]
    got = port.execute(CS.NEST_JOIN.format(cut=cut)).rows
    twin = port.execute(CS.NEST_JOIN_TWIN.format(cut=cut)).rows
    comments = dict(port.execute("select c_custkey, c_comment from customer").rows)
    orders = port.execute(f"select o_orderkey, o_custkey from orders where o_orderkey < {cut}"
                          " order by 1").rows
    want = [[o, k, [w for w in comments[k].split(" ") if len(w) > 4]] for o, k in orders]
    assert got == twin == want and len(got) == 15
    text = port.execute(f"select o_orderkey, o_comment from orders where o_orderkey < {cut}"
                        " order by 1").rows
    sql = (f"select o_orderkey, filter(split(o_comment, ' '), x -> length(x) > 4) from orders"
           f" where o_orderkey < {cut} order by 1")
    assert port.execute(sql).rows == [[o, [w for w in c.split(" ") if len(w) > 4]]
                                      for o, c in text]
    assert ref.execute(sql).rows[1] == [2, ["about", "about", "sleep", "above", "dolphins"]]
    assert port.execute(sql).rows[1] == [2, ["sleep", "above", "dolphins", "ironic", "slyly"]]
    motivation = ("select s.k, filter(s.a, x -> length(x) > 4) from (select o_custkey k,"
                  " split(o_comment,' ') a from orders where o_orderkey < 40) s join customer"
                  " c on s.k = c.c_custkey order by 1 desc limit 3")
    assert ref.execute(motivation).rows[0] == [
        1489, ["unusual", "unusual", "haggle", "packages", "dependencies", "about", "about"]]
    assert port.execute(motivation).rows[0] == [
        1489, ["courts", "carefully", "deposits", "ideas", "sauternes", "sleep", "requests"]]


def test_memory_unnest_group_by_equals_numpy():
    """NEST_MEMORY at 2^12 rows: the port equals numpy's bincount and
    the reference's rows."""
    lists, flat = CS.tagged_arrays(1 << 12)
    port, _ = CS.tagged_runner(1 << 12, "cpu", (lists, flat))
    got = port.execute(CS.NEST_MEMORY).rows
    assert got == CS.tagged_numpy(flat)
    conn = jmemory.MemoryConnector()
    conn.load_table("nest", "tagged", [JColumnMetadata("id", JT.BIGINT),
                                       JColumnMetadata("tags", JT.array_of(JT.BIGINT))],
                    [np.arange(1 << 12, dtype=np.int64), lists])
    ref = JRunner(JSession(catalog="memory", schema="nest"))
    ref.register_catalog("memory", conn)
    assert got == ref.execute(CS.NEST_MEMORY).rows


@pytest.mark.parametrize("sql", [
    # tests/test_nested_types.py: test_nested_type_ddl_parses;
    # tests/test_array_columns.py: test_ctas_and_insert_arrays
    "create table nested_ddl (a array(bigint), m map(varchar, bigint),"
    " r row(x bigint, y varchar))",
    "create table arr_copy as select id, scores from orders_tags where id <= 2",
    "insert into orders_tags select * from orders_tags"])
def test_nested_ddl_and_writes_name_their_item(sql):
    """Once a raise naming ROADMAP §1 item 8: the statement runs in both
    packages over fresh copies of the tags tables, with equal results,
    and every table then reads back equal."""
    ref, port = _runners("tags")
    want, got = ref.execute(sql), port.execute(sql)
    assert got.rows == want.rows
    conn = port.catalogs.get("memory")
    for table in conn.metadata.list_tables("tags"):
        _same((ref, port), f"select * from {table}", sort=True)
