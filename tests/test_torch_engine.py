"""The slices end to end: trino_tpu_torch (device="cpu") against trino_tpu
and the sqlite oracle on tpch.tiny, plus the data the two packages
compute on and the aggregation and join operators on carried batches. Decimals, integers and strings must be row-equal between the
packages; the oracle holds decimals as REAL, so against it values agree
within assert_rows_match's tolerances (abs 1e-2, as tests/test_tpch.py)."""

import dataclasses

import numpy as np
import pytest

from tests.oracle import assert_rows_match, sqlite_rows
from tests.test_torch_tpch_a import indexed_oracle
from tests.test_tpch import to_sqlite
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from tests.tpch_queries import QUERIES
from trino_tpu import types as JT
from trino_tpu.block import RelBatch as JRelBatch
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.exec.operators import AggSpec as JAggSpec
from trino_tpu.exec.operators import HashAggregationOperator as JHashAgg
from trino_tpu_torch import types as T
from trino_tpu_torch.carry import relbatch_from_arrays
from trino_tpu_torch.config import SYSTEM_PROPERTIES, bind_session
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.exec.operators import AggSpec, HashAggregationOperator
from trino_tpu_torch.ops import mxu_groupby as TM
from trino_tpu_torch.sql.optimizer import optimize as T_optimize

Q_MXU = """select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       count(*) as count_order
from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
order by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct"""

SLICE = {"q1": QUERIES[1], "q3": QUERIES[3], "q6": QUERIES[6], "q18": QUERIES[18],
         "q_mxu": Q_MXU}


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


@pytest.mark.parametrize("name", sorted(SLICE))
def test_slice_query_matches_reference_and_oracle(name, runners, oracle, monkeypatch):
    if name == "q_mxu":
        # both packages take the bounded-domain kernel band on the CPU
        monkeypatch.setenv("TRINO_TPU_FORCE_MXU", "1")
    ref, port = runners
    sql = SLICE[name]
    got = port.execute(sql)
    want = ref.execute(sql)
    assert got.rows == want.rows
    assert got.column_names == want.column_names
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types]
    expected = sqlite_rows(oracle, to_sqlite(sql))
    assert_rows_match(got.rows, expected, ordered="order by" in sql, abs_tol=1e-2)


def test_q_mxu_runs_through_the_grouped_sum_wrapper(runners, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_FORCE_MXU", "1")
    calls = []
    plain = TM.grouped_sum_reference

    def spy(gid, values, live, capacity):
        calls.append((int(gid.shape[0]), len(values), capacity))
        return plain(gid, values, live, capacity)

    monkeypatch.setattr(TM, "grouped_sum_reference", spy)
    _, port = runners
    rows = port.execute(Q_MXU).rows
    assert len(rows) == 112
    # one call per scan batch: 13 value columns over the 4*3*8*5 domain
    assert calls == [(65536, 13, 480)]
    # without the switch the CPU takes the sort path
    monkeypatch.setenv("TRINO_TPU_FORCE_MXU", "0")
    calls.clear()
    assert port.execute(Q_MXU).rows == rows
    assert calls == []


@pytest.mark.parametrize("table", ["lineitem", "orders", "part", "supplier"])
def test_tpch_columns_are_array_equal(table):
    names = [n for n, _ in jtpch.TABLES[table]]
    hi = min(jtpch.base_row_count(table, 0.01), 900)
    for name in names:
        want, wd = jtpch.generate_column(table, name, 0.01, hi // 8, hi)
        got, gd = ttpch.generate_column(table, name, 0.01, hi // 8, hi)
        assert np.array_equal(np.asarray(got), np.asarray(want)), name
        assert (gd is None) == (wd is None)
        if gd is not None:
            assert gd.values == wd.values


def test_tpch_batches_match_reference_batches():
    jconn, tconn = jtpch.create_tpch_connector(), ttpch.create_tpch_connector()
    jh = jconn.metadata.get_table_handle("tiny", "lineitem")
    th = tconn.metadata.get_table_handle("tiny", "lineitem")
    jsplit = jconn.split_manager.get_splits(jh, 2)[1]
    tsplit = tconn.split_manager.get_splits(th, 2)[1]
    cols = ["l_orderkey", "l_quantity", "l_returnflag", "l_shipdate"]
    jb = list(jconn.page_source.batches(jsplit, cols, 4096))
    tb = list(tconn.page_source.batches(tsplit, cols, 4096, device="cpu"))
    assert len(jb) == len(tb) > 1
    for a, b in zip(jb, tb):
        assert a.capacity == b.capacity
        assert np.array_equal(np.asarray(a.live_mask()), b.live_mask().numpy())
        for ca, cb in zip(a.columns, b.columns):
            assert cb.data.numpy().dtype == np.asarray(ca.data).dtype
            assert np.array_equal(np.asarray(ca.data), cb.data.numpy())


def _carry(jbatch: JRelBatch):
    """A reference batch through numpy into the port."""
    cols = [
        (str(c.type), np.asarray(c.data),
         None if c.valid is None else np.asarray(c.valid),
         None if c.dictionary is None else c.dictionary.values)
        for c in jbatch.columns
    ]
    live = None if jbatch.live is None else np.asarray(jbatch.live)
    return relbatch_from_arrays(cols, live, "cpu")


def _agg_rows(op, batches):
    for b in batches:
        op.add_input(b)
    op.finish()
    out = op.get_output()
    rows = out.to_pylists()
    return sorted(rows, key=repr)


@pytest.mark.parametrize("route,groups", [
    ("sort", [0]), ("sort", [0, 1]), ("dense", [1]), ("grouped_sum", [1, 2]),
])
def test_aggregation_operator_on_carried_batches(route, groups, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_FORCE_MXU", "1")
    rng = np.random.default_rng(len(groups) + len(route))
    n = 300
    letters = [chr(65 + i) for i in range(26)]
    schema = [("k", JT.BIGINT), ("s", JT.VARCHAR), ("t", JT.VARCHAR),
              ("v", JT.decimal(12, 2))]
    data = {
        "k": [int(x) if x >= 0 else None for x in rng.integers(-1, 20, n)],
        "s": [letters[i] if route != "dense" else letters[i % 4]
              for i in rng.integers(0, 26, n)],
        "t": [letters[i] for i in rng.integers(0, 3, n)],
        "v": [None if x < -900 else x / 100 for x in rng.integers(-1000, 1000, n)],
    }
    jb = JRelBatch.from_pydict(schema, data)
    jschema = [(c.type, c.dictionary) for c in jb.columns]
    kinds = [("sum", 3), ("count", 3), ("count_star", None)]
    if route != "grouped_sum":
        kinds += [("min", 3), ("max", 3)]
    jaggs = [JAggSpec(k, ch, jschema[3][0] if k in ("sum", "min", "max") else JT.BIGINT)
             for k, ch in kinds]
    jop = JHashAgg(groups, jaggs, jschema)
    want = _agg_rows(jop, [jb])

    tb = _carry(jb)
    tschema = [(c.type, c.dictionary) for c in tb.columns]
    taggs = [AggSpec(a.kind, a.arg_channel, tschema[3][0] if a.kind in
                     ("sum", "min", "max") else T.BIGINT) for a in jaggs]
    top = HashAggregationOperator(groups, taggs, tschema, "cpu")
    assert top.route == route
    got = _agg_rows(top, [tb, _carry(jb)])
    # the port saw the batch twice: counts and sums double
    doubled = []
    for row in want:
        r = list(row)
        for i in (len(groups), len(groups) + 1, len(groups) + 2):
            if r[i] is not None:
                r[i] = r[i] * 2  # exact: doubling a decoded decimal is exact
        doubled.append(r)
    assert got == sorted(doubled, key=repr)


# single-table shapes beyond the slice's three queries: ORDER BY, top-n,
# LIMIT/OFFSET, VALUES, LIKE, CASE, IN, BETWEEN, casts, date intervals,
# decimal arithmetic, and the sort, dense and global aggregation routes
SHAPES = [
    "select l_returnflag, count(*) from lineitem group by 1 order by 1",
    "select o_orderkey, o_totalprice from orders order by o_totalprice desc, o_orderkey limit 10",
    "select o_orderkey from orders where o_orderpriority like '1%' order by o_orderkey limit 5 offset 3",
    "select n_name, case when n_regionkey = 0 then 'zero' else 'other' end from nation order by n_name",
    "select count(*), sum(p_size), min(p_retailprice), max(p_retailprice), avg(p_retailprice)"
    " from part where p_type like '%BRASS' and p_size in (1, 5, 15)",
    "select * from (values (1, 'a'), (2, 'b'), (3, null)) as v(x, y) order by x desc",
    "select o_custkey, count(*), sum(o_totalprice) from orders group by o_custkey order by 2 desc, 1 limit 10",
    "select extract(year from o_orderdate) as y, count(*) from orders group by 1 order by 1",
    "select o_orderstatus, o_orderpriority, count(*), max(o_totalprice) from orders group by 1, 2 order by 1, 2",
    "select c_mktsegment, avg(c_acctbal), min(c_name), max(c_phone) from customer group by 1 order by 1",
    "select s_name, s_acctbal * 2, s_acctbal / 3, -s_acctbal from supplier where s_acctbal > 9000 order by s_name",
    "select l_shipmode, sum(case when l_shipinstruct = 'NONE' then 1 else 0 end) from lineitem group by 1 order by 1",
    "select p_brand, count(*) from part where p_container in ('SM CASE', 'SM BOX')"
    " and p_size between 1 and 5 group by p_brand order by 2 desc, 1 limit 5",
    "select cast(l_quantity as bigint) + 1, cast(l_discount as double), l_shipdate + interval '3' day"
    " from lineitem order by l_orderkey, l_linenumber limit 5",
    "select coalesce(null, o_comment), o_orderkey % 7, o_orderkey / 3 from orders order by o_orderkey limit 3",
]


@pytest.mark.parametrize("sql", SHAPES, ids=[f"shape{i}" for i in range(len(SHAPES))])
def test_single_table_query_matches_reference(sql, runners):
    ref, port = runners
    assert port.execute(sql).rows == ref.execute(sql).rows


# every join kind through SQL: (plan join kinds it must use, query)
JOIN_SHAPES = {
    "left": ({"left"}, "select n_name, r_name from nation left join region"
             " on n_regionkey = r_regionkey and r_name <> 'ASIA' order by n_name"),
    "left_sparse": ({"left"}, "select c_name, o_orderstatus from customer left join orders"
                    " on c_custkey = o_custkey and o_totalprice > 400000"
                    " where c_custkey < 30 order by 1, 2"),
    "full": ({"full"}, "select n_name, r_name from nation full join region"
             " on n_regionkey = r_regionkey and r_regionkey < 2 order by n_name, r_name"),
    "right": ({"left"}, "select r_name, n_name from region right join nation"
              " on n_regionkey = r_regionkey and r_name like 'A%' order by n_name"),
    "anti": ({"anti"}, "select c_custkey from customer where not exists"
             " (select * from orders where o_custkey = c_custkey) and c_nationkey = 3"
             " order by 1"),
    "mark": ({"mark"}, "select n_name, n_regionkey in (select r_regionkey from region"
             " where r_name like 'A%') from nation order by n_name"),
    "mark_under_or": ({"mark"}, "select n_name from nation where n_regionkey in"
                      " (select r_regionkey from region where r_name like 'A%')"
                      " or n_nationkey = 1 order by n_name"),
    "mark_exists": ({"mark_exists"}, "select n_name, exists (select * from region where"
                    " r_regionkey = n_regionkey and r_name = 'ASIA') from nation order by 1"),
    "self_join_residual": ({"inner"}, "select count(*) from orders o1 join orders o2"
                           " on o1.o_custkey = o2.o_custkey and o1.o_orderkey < o2.o_orderkey"),
    "cross_scalar": ({"cross"}, "select n_name, (select count(*) from region) from nation"
                     " order by 1 limit 3"),
}


def _join_kinds(node, out):
    from trino_tpu_torch.sql import plan as P

    if isinstance(node, P.JoinNode):
        out.add(node.kind)
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if isinstance(c, P.PlanNode):
            _join_kinds(c, out)
    return out


@pytest.mark.parametrize("name", sorted(JOIN_SHAPES))
def test_join_kinds_through_sql_match_reference(name, runners):
    from trino_tpu_torch.sql.parser import parse

    ref, port = runners
    kinds, sql = JOIN_SHAPES[name]
    assert kinds <= _join_kinds(port._analyze(parse(sql)), set())
    assert port.execute(sql).rows == ref.execute(sql).rows


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti", "full"])
def test_lookup_join_operator_on_carried_batches(kind):
    # the reference builds the lookup source; its build batch and
    # LookupSource carry into the port, whose LookupJoinOperator probes
    # them with carried probe batches
    from trino_tpu.exec.operators import HashBuildSink as JBuildSink
    from trino_tpu.exec.operators import JoinBridge as JBridge
    from trino_tpu.exec.operators import LookupJoinOperator as JLookupJoin
    from trino_tpu_torch.carry import lookup_source_from_arrays
    from trino_tpu_torch.exec.operators import JoinBridge, LookupJoinOperator

    rng = np.random.default_rng(len(kind))
    letters = [chr(65 + i) for i in range(8)]

    def batch(n, dom):
        return JRelBatch.from_pydict(
            [("k", JT.BIGINT), ("s", JT.VARCHAR), ("v", JT.decimal(12, 2))],
            {"k": [int(x) if x >= 0 else None for x in rng.integers(-1, dom, n)],
             "s": [letters[i] for i in rng.integers(0, 8, n)],
             "v": [x / 100 for x in rng.integers(-1000, 1000, n)]})

    build, probes = batch(200, 60), [batch(300, 80), batch(100, 80)]
    schema = [(c.type, c.dictionary) for c in build.columns]
    jbridge = JBridge()
    sink = JBuildSink(jbridge, [0], schema)
    sink.add_input(build)
    sink.finish()
    want = []
    jop = JLookupJoin(jbridge, [0], kind, schema)
    for p in probes:
        jop.add_input(p)
        while (out := jop.get_output()) is not None:
            want.extend(out.to_pylists())
    jop.finish()
    while (out := jop.get_output()) is not None:
        want.extend(out.to_pylists())

    bridge = JoinBridge()
    jls = jbridge.lookup_source
    bridge.lookup_source = lookup_source_from_arrays(
        np.asarray(jls.sorted_hash), np.asarray(jls.perm),
        [np.asarray(k) for k in jls.key_cols], [np.asarray(v) for v in jls.key_valids],
        np.asarray(jls.build_live), "cpu")
    bridge.build_batch = _carry(jbridge.build_batch)
    bridge.key_dicts = [bridge.build_batch.columns[0].dictionary]
    bridge.build_key_channels = [0]
    tschema = [(c.type, c.dictionary) for c in bridge.build_batch.columns]
    top = LookupJoinOperator(bridge, [0], kind, tschema)
    got = []
    for p in probes:
        top.add_input(_carry(p))
        while (out := top.get_output()) is not None:
            got.extend(out.to_pylists())
    top.finish()
    while (out := top.get_output()) is not None:
        got.extend(out.to_pylists())
    assert got == want
    assert len(got) > 0


def test_session_properties_match_session_fields():
    # every registered property is a Session field with the same default
    # (memory_pool_bytes: None on the Session, 0 in the registry, both
    # unlimited, as in the reference), and bind_session validates before
    # it sets
    fields = {f.name: f.default for f in dataclasses.fields(Session)}
    for meta in SYSTEM_PROPERTIES.all():
        want = None if meta.name == "memory_pool_bytes" else meta.default
        assert fields[meta.name] == want, meta.name
    s = Session()
    bind_session(s, {"batch_rows": "4096", "enable_pushdown": "off"})
    assert (s.batch_rows, s.enable_pushdown) == (4096, False)
    with pytest.raises(ValueError):
        bind_session(s, {"join_reordering_strategy": "greedy"})
    with pytest.raises(ValueError):
        bind_session(s, {"plan_validation": "everything"})
    with pytest.raises(ValueError):
        bind_session(s, {"no_such_property": 1})


@pytest.mark.parametrize("overrides", [
    {"enable_optimizer": False}, {"enable_pushdown": False},
    {"join_reordering_strategy": "none"}, None,
], ids=["no_optimizer", "no_pushdown", "no_reordering", "no_session"])
def test_optimizer_settings_keep_answers(overrides, runners, monkeypatch):
    ref, port = runners
    if overrides is None:
        # optimize() without a session takes every default
        plain = T_optimize
        monkeypatch.setattr(
            "trino_tpu_torch.engine.optimize",
            lambda root, catalogs, session=None: plain(root, catalogs),
        )
        runner = port
    else:
        runner = LocalQueryRunner(Session(catalog="tpch", schema="tiny", **overrides),
                                  device="cpu")
        runner.register_catalog("tpch", ttpch.create_tpch_connector())
    sql = QUERIES[6]
    assert runner.execute(sql).rows == ref.execute(sql).rows


@pytest.mark.parametrize("name", ["q3", "q18"])
def test_joins_run_through_the_rank_and_gather_wrappers(name, runners, monkeypatch):
    # on the CPU the wrappers take their plain versions; the join path
    # must reach them (on the card the same calls launch the kernels)
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import window_rank as W

    calls = {"rank": 0, "take_flat": 0}
    rank_plain, flat_plain = W.rank_reference, GK.take_flat_reference

    def rank_spy(*args, **kwargs):
        calls["rank"] += 1
        return rank_plain(*args, **kwargs)

    def flat_spy(*args, **kwargs):
        calls["take_flat"] += 1
        return flat_plain(*args, **kwargs)

    monkeypatch.setattr(W, "rank_reference", rank_spy)
    monkeypatch.setattr(GK, "take_flat_reference", flat_spy)
    _, port = runners
    port.execute(SLICE[name])
    assert calls["rank"] > 0 and calls["take_flat"] > 0
    calls.update(rank=0, take_flat=0)
    port.execute(SLICE["q1"])
    assert calls == {"rank": 0, "take_flat": 0}


def test_dynamic_filter_domains_match_reference():
    from trino_tpu.exec.operators import HashBuildSink as JBuildSink
    from trino_tpu.exec.operators import JoinBridge as JBridge
    from trino_tpu.exec.operators import dynamic_filter_constraints as jdfc
    from trino_tpu_torch.exec.operators import (
        DynamicFilterOperator,
        HashBuildSink,
        JoinBridge,
        dynamic_filter_constraints,
    )

    rng = np.random.default_rng(9)
    schema = [("k", JT.BIGINT), ("d", JT.DATE), ("s", JT.VARCHAR)]
    few = {"k": [int(x) for x in rng.integers(100, 140, 50)],
           "d": [int(x) for x in rng.integers(9000, 9100, 50)],
           "s": ["x"] * 50}
    many = {"k": [int(x) if x % 7 else None for x in rng.integers(0, 10_000, 500)],
            "d": [int(x) for x in rng.integers(9000, 9003, 500)],
            "s": ["y"] * 500}
    for data in (few, many):
        jb = JRelBatch.from_pydict(schema, data)
        jschema = [(c.type, c.dictionary) for c in jb.columns]
        jbridge = JBridge()
        sink = JBuildSink(jbridge, [0, 1], jschema)
        sink.add_input(jb)
        sink.finish()
        tb = _carry(jb)
        bridge = JoinBridge()
        tsink = HashBuildSink(bridge, [0, 1], [(c.type, c.dictionary) for c in tb.columns], "cpu")
        tsink.add_input(tb)
        tsink.finish()
        types = [T.BIGINT, T.DATE]
        want = jdfc(jbridge, [JT.BIGINT, JT.DATE], ["k", "d"])
        got = dynamic_filter_constraints(bridge, types, ["k", "d"])
        assert [(c.column, c.op, c.value) for c in got] == \
            [(c.column, c.op, c.value) for c in want]
        # the operator drops probe rows outside every key's [min, max]
        probe = _carry(JRelBatch.from_pydict(schema[:2], {
            "k": [99, 120, 139, None, 20_000], "d": [9050, 9050, 9001, 9001, 9001]}))
        op = DynamicFilterOperator(bridge, [0, 1])
        op.add_input(probe)
        kept = op.get_output().to_pylists()
        lo_k = min(v for v in data["k"] if v is not None)
        hi_k = max(v for v in data["k"] if v is not None)
        assert kept == [[k, d] for k, d in [(99, 9050), (120, 9050), (139, 9001), (20_000, 9001)]
                        if lo_k <= k <= hi_k and min(data["d"]) <= d <= max(data["d"])]
