"""The holistic and sketch aggregates: trino_tpu_torch against trino_tpu on
the same seeded numpy inputs.

- The seven sorted-segment reducers of ops/groupby (key_order,
  grouped_argbest, grouped_weighted_percentile, grouped_percentile,
  grouped_count_distinct, grouped_rows_order, grouped_rows_sorted), with
  NULL keys and values, dead rows, groups whose values are all NULL,
  ties, several keys and Int128 keys, `by` and `x`. Tolerance: every
  output array bit-equal, including the slots a result marks invalid.
- The six sketch expressions the optimizer's approx rewrites emit
  (hll_bucket, hll_rho, hll_weight, hll_weight_rho, hll_estimate,
  pctl_bucket): buckets, ranks and estimates bit-equal. The weights
  2^-rho within 1e-14 relative: the port computes exact powers of two,
  the reference's exp2 lowers to exp(x ln 2), a few of whose values sit
  up to 20 ulp off.
- SQL: the scalar-result cases of tests/test_aggregates.py,
  tests/test_aggregates_r4.py and tests/test_approx_aggs.py through both
  runners on the same tables (integers, decimals and strings equal,
  doubles within assert_rows_match's tolerance), and the reference's
  answer for a lone approx_distinct (its HLL plan, not exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import assert_rows_match
from trino_tpu import types as JT
from trino_tpu.block import Dictionary as JDictionary
from trino_tpu.connectors import memory as jmemory
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.connectors.spi import ColumnMetadata as JColumnMetadata
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.expr import ir as JIR
from trino_tpu.expr.compile import ExprBinder as JBinder
from trino_tpu.ops import groupby as JG
from trino_tpu_torch import types as T
from trino_tpu_torch.block import Dictionary
from trino_tpu_torch.connectors import memory as tmemory
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.connectors.spi import ColumnMetadata
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.expr import ir as TIR
from trino_tpu_torch.expr.compile import ExprBinder as TBinder
from trino_tpu_torch.ops import groupby as TG

N = 400
CAP = 64


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.array(x))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind == "f":
        assert np.array_equal(got.view(np.uint8), want.astype(got.dtype).view(np.uint8))
    else:
        assert np.array_equal(got.astype(want.dtype), want)


def _keys(kind, rng):
    """(keys, valids) of one grouping shape."""
    if kind == "none":
        return [], []
    k1 = rng.integers(0, 9, N).astype(np.int64)
    v1 = rng.random(N) < 0.9
    if kind == "one":
        return [k1], [v1]
    if kind == "double":
        f = rng.integers(-3, 4, N).astype(np.float64) * 0.5
        f[f == 0] = -0.0
        f[rng.random(N) < 0.05] = np.nan
        return [f], [v1]
    if kind == "two":
        k2 = rng.integers(0, 4, N).astype(np.int32)
        return [k1, k2], [v1, rng.random(N) < 0.95]
    # Int128 limb-pair key next to an int key
    k2 = np.stack([rng.integers(-2, 2, N), rng.integers(-3, 3, N)], axis=1).astype(np.int64)
    return [k1, k2], [v1, rng.random(N) < 0.95]


def _case(kind, seed):
    rng = np.random.default_rng(seed)
    keys, valids = _keys(kind, rng)
    mask = rng.random(N) < 0.9
    mask[-30:] = False  # a dead tail
    return rng, keys, valids, mask


def _both(keys, valids, mask):
    return ((tuple(_j(k) for k in keys), tuple(_j(v) for v in valids), _j(mask)),
            (tuple(_t(k) for k in keys), tuple(_t(v) for v in valids), _t(mask)))


KINDS = ("none", "one", "double", "two", "int128_key")


@pytest.mark.parametrize("kind", KINDS)
def test_key_order_matches_reference(kind):
    _, keys, valids, mask = _case(kind, 1)
    (jk, jv, jm), (tk, tv, tm) = _both(keys, valids, mask)
    _eq(TG.key_order(tk, tv, tm, CAP), JG.key_order(jk, jv, jm, CAP))


def _by_values(by_kind, rng):
    if by_kind == "int64":
        by = rng.integers(0, 6, N).astype(np.int64)  # many ties
    elif by_kind == "float64":
        by = rng.integers(-4, 5, N).astype(np.float64) * 0.25
    elif by_kind == "int32":
        by = rng.integers(-5, 5, N).astype(np.int32)
    elif by_kind == "bool":
        by = rng.random(N) < 0.5
    else:  # Int128: equal high limbs differ in the unsigned low limb
        hi = rng.integers(-1, 2, N)
        lo = rng.choice(np.array([-5, -1, 0, 3, 2 ** 62], dtype=np.int64), N)
        by = np.stack([hi, lo], axis=1).astype(np.int64)
    return by


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("by_kind", ["int64", "float64", "int32", "bool", "int128"])
@pytest.mark.parametrize("agg", ["min_by", "max_by"])
def test_grouped_argbest_matches_reference(kind, by_kind, agg):
    rng, keys, valids, mask = _case(kind, 2)
    by = _by_values(by_kind, rng)
    by_valid = rng.random(N) < 0.8
    # group 3 of the first key has no valid `by` at all
    if keys:
        by_valid[keys[0] == 3] = False
    x = rng.integers(-1000, 1000, N).astype(np.int64)
    x_valid = rng.random(N) < 0.85
    (jk, jv, jm), (tk, tv, tm) = _both(keys, valids, mask)
    want = JG.grouped_argbest(jk, jv, jm, _j(by), _j(by_valid), _j(x), _j(x_valid),
                              agg, CAP)
    got = TG.grouped_argbest(tk, tv, tm, _t(by), _t(by_valid), _t(x), _t(x_valid),
                             agg, CAP)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("kind", ["one", "two"])
def test_grouped_argbest_gathers_int128_x_and_shares_an_order(kind):
    rng, keys, valids, mask = _case(kind, 3)
    by = rng.normal(0, 1, N)
    x = np.stack([rng.integers(-3, 3, N), rng.integers(-(2 ** 62), 2 ** 62, N)],
                 axis=1).astype(np.int64)
    (jk, jv, jm), (tk, tv, tm) = _both(keys, valids, mask)
    order_t = TG.key_order(tk, tv, tm, CAP)
    want = JG.grouped_argbest(jk, jv, jm, _j(by), None, _j(x), None, "max_by", CAP)
    got = TG.grouped_argbest(tk, tv, tm, _t(by), None, _t(x), None, "max_by", CAP,
                             order=order_t)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("fraction", [0.0, 0.5, 0.9, 1.0])
def test_grouped_percentile_matches_reference(kind, dtype, fraction):
    rng, keys, valids, mask = _case(kind, 4)
    x = (rng.integers(-50, 50, N) if dtype == "int64" else rng.normal(0, 10, N)).astype(dtype)
    x_valid = rng.random(N) < 0.8
    if keys:
        x_valid[keys[0] == 5] = False  # a group whose values are all NULL
    (jk, jv, jm), (tk, tv, tm) = _both(keys, valids, mask)
    want = JG.grouped_percentile(jk, jv, jm, _j(x), _j(x_valid), fraction, CAP)
    got = TG.grouped_percentile(tk, tv, tm, _t(x), _t(x_valid), fraction, CAP)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("fraction", [0.1, 0.5, 0.99])
def test_grouped_weighted_percentile_matches_reference(kind, dtype, fraction):
    rng, keys, valids, mask = _case(kind, 5)
    lo = rng.integers(-40, 40, N)
    mn = lo.astype(dtype)
    mx = (lo + rng.integers(0, 3, N)).astype(dtype)
    cnt = rng.integers(1, 6, N).astype(np.int64)
    cnt[mn == mx] = 1  # a bucket of one value holds one element
    mn_valid = rng.random(N) < 0.9
    (jk, jv, jm), (tk, tv, tm) = _both(keys, valids, mask)
    want = JG.grouped_weighted_percentile(jk, jv, jm, _j(mn), _j(mn_valid), _j(cnt),
                                          _j(mx), fraction, CAP)
    got = TG.grouped_weighted_percentile(tk, tv, tm, _t(mn), _t(mn_valid), _t(cnt),
                                         _t(mx), fraction, CAP)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["int64", "float64", "int32", "bool"])
def test_grouped_count_distinct_matches_reference(kind, dtype):
    rng, keys, valids, mask = _case(kind, 6)
    if dtype == "bool":
        x = rng.random(N) < 0.3
    elif dtype == "float64":
        x = rng.integers(-5, 5, N).astype(np.float64)
        x[x == 0] = -0.0
        x[rng.random(N) < 0.05] = np.nan
    else:
        x = rng.integers(0, 12, N).astype(dtype)
    x_valid = rng.random(N) < 0.85
    (jk, jv, jm), (tk, tv, tm) = _both(keys, valids, mask)
    want = JG.grouped_count_distinct(jk, jv, jm, _j(x), _j(x_valid), CAP)
    got = TG.grouped_count_distinct(tk, tv, tm, _t(x), _t(x_valid), CAP)
    _eq(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_grouped_rows_order_and_sorted_match_reference(kind):
    rng, keys, valids, mask = _case(kind, 7)
    x = rng.integers(0, 20, N).astype(np.int32)  # dictionary codes
    x_valid = rng.random(N) < 0.85
    (jk, jv, jm), (tk, tv, tm) = _both(keys, valids, mask)
    for want, got in (
        (JG.grouped_rows_order(jk, jv, jm, _j(x), _j(x_valid), CAP),
         TG.grouped_rows_order(tk, tv, tm, _t(x), _t(x_valid), CAP)),
        (JG.grouped_rows_sorted(jk, jv, jm, _j(x), _j(x_valid), CAP),
         TG.grouped_rows_sorted(tk, tv, tm, _t(x), _t(x_valid), CAP)),
    ):
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("kind", ["one", "two", "int128_key"])
def test_reducer_slots_align_with_sort_group_reduce(kind):
    # the order statistics land in the slot sort_group_reduce gives
    # their group
    rng, keys, valids, mask = _case(kind, 8)
    x = rng.integers(0, 100, N).astype(np.int64)
    _, (tk, tv, tm) = _both(keys, valids, mask)
    gk, gv, used, (mx,), _, _, _ = TG.sort_group_reduce(
        tk, tv, tm, (_t(x),), (None,), ("max",), 512)
    best, ok = TG.grouped_percentile(tk, tv, tm, _t(x), None, 1.0, 512)
    assert torch.equal(ok, used)
    assert torch.equal(best[used], mx[used])


# ---------------------------------------------------------------------------
# the sketch expressions
# ---------------------------------------------------------------------------


_WORDS = [f"w{i:03d}-{'x' * (i % 7)}" for i in range(40)]


def _sketch_inputs(seed):
    """Columns: bigint, double (with -0.0, NaN, inf), dictionary
    varchar, and a decimal(12,2); each with NULLs."""
    rng = np.random.default_rng(seed)
    n = 500
    f = rng.normal(0, 1e3, n)
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.03] = np.nan
    f[rng.random(n) < 0.02] = np.inf
    cols = [
        rng.integers(-(2 ** 62), 2 ** 62, n).astype(np.int64),
        f,
        rng.integers(0, len(_WORDS), n).astype(np.int32),
        rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int64),
    ]
    valids = [rng.random(n) < 0.9 for _ in cols]
    return cols, valids


def _bind_both(name, arg_channels, out_type_name):
    jt = [JT.BIGINT, JT.DOUBLE, JT.VARCHAR, JT.decimal(12, 2)]
    tt = [T.BIGINT, T.DOUBLE, T.VARCHAR, T.decimal(12, 2)]
    jd = [None, None, JDictionary(_WORDS), None]
    td = [None, None, Dictionary(_WORDS), None]
    jout, tout = getattr(JT, out_type_name), getattr(T, out_type_name)
    je = JIR.Call(name, tuple(JIR.InputRef(c, jt[c]) for c in arg_channels), jout)
    te = TIR.Call(name, tuple(TIR.InputRef(c, tt[c]) for c in arg_channels), tout)
    return JBinder(jt, jd).bind(je), TBinder(tt, td).bind(te)


def _eval_both(jb, tb, cols, valids, rtol=None):
    jd, jv = jb.fn([_j(c) for c in cols], [_j(v) for v in valids])
    td, tv = tb.fn([_t(c) for c in cols], [_t(v) for v in valids])
    if rtol is None:
        _eq(td, jd)
    else:
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=rtol, atol=0)
    if jv is None:
        assert tv is None
    else:
        _eq(tv, jv)


@pytest.mark.parametrize("name,out", [("hll_bucket", "BIGINT"), ("hll_rho", "BIGINT"),
                                      ("hll_weight", "DOUBLE")])
@pytest.mark.parametrize("channel", [0, 1, 2, 3], ids=["bigint", "double", "varchar",
                                                         "decimal"])
def test_hll_primitives_match_reference(name, out, channel):
    cols, valids = _sketch_inputs(11)
    jb, tb = _bind_both(name, (channel,), out)
    _eval_both(jb, tb, cols, valids, rtol=1e-14 if name == "hll_weight" else None)


@pytest.mark.parametrize("channel", [0, 1, 3], ids=["bigint", "double", "decimal"])
def test_pctl_bucket_matches_reference(channel):
    cols, valids = _sketch_inputs(12)
    jb, tb = _bind_both("pctl_bucket", (channel,), "BIGINT")
    _eval_both(jb, tb, cols, valids)


def test_hll_weight_rho_matches_reference():
    rng = np.random.default_rng(13)
    cols, valids = _sketch_inputs(13)
    cols[0] = rng.integers(1, 53, 500).astype(np.int64)  # merged max-rho
    cols[3] = rng.integers(0, 2048, 500).astype(np.int64)  # bucket
    jb, tb = _bind_both("hll_weight_rho", (0, 3), "DOUBLE")
    _eval_both(jb, tb, cols, valids, rtol=1e-14)


def test_hll_estimate_matches_reference():
    rng = np.random.default_rng(14)
    cols, valids = _sketch_inputs(14)
    regs = rng.integers(1, 2049, 500)
    # summed register weights: small (linear counting) to saturated
    cols[1] = regs * np.exp2(-rng.integers(1, 30, 500).astype(np.float64))
    cols[0] = regs.astype(np.int64)  # non-empty register count
    jb, tb = _bind_both("hll_estimate", (1, 0), "BIGINT")
    _eval_both(jb, tb, cols, valids)


# ---------------------------------------------------------------------------
# SQL: both runners on the same tables
# ---------------------------------------------------------------------------


# the scalar-result cases of tests/test_aggregates.py (approx_distinct,
# TestApproxDistinct, TestHolisticAggregates, listagg) over tpch.tiny
TPCH_CASES = [
    "SELECT approx_distinct(l_suppkey) FROM lineitem",
    "SELECT approx_distinct(o_custkey) FROM orders",
    "SELECT l_returnflag, approx_distinct(l_suppkey), count(*), sum(l_quantity),"
    " approx_distinct(l_shipmode) FROM lineitem GROUP BY l_returnflag"
    " ORDER BY l_returnflag",
    "SELECT approx_distinct(nullif(l_linenumber, 1)) FROM lineitem",
    "SELECT l_returnflag, approx_percentile(l_quantity, 0.5) FROM lineitem"
    " GROUP BY l_returnflag ORDER BY l_returnflag",
    "SELECT max_by(n_name, n_nationkey), min_by(n_name, n_nationkey) FROM nation",
    "SELECT l_returnflag, max_by(l_orderkey, l_extendedprice),"
    " min_by(l_orderkey, l_extendedprice) FROM lineitem GROUP BY l_returnflag"
    " ORDER BY l_returnflag",
    "SELECT max_by(x, y) FROM (VALUES (1, 10), (2, NULL), (3, 5)) t(x, y)",
    "SELECT max_by(x, y) FROM (VALUES (1, NULL)) t(x, y)",
    "SELECT approx_percentile(l_quantity, 0.0) FROM lineitem",
    "SELECT approx_percentile(l_quantity, 0.25) FROM lineitem",
    "SELECT approx_percentile(l_quantity, 0.9) FROM lineitem",
    "SELECT approx_percentile(l_quantity, 1.0) FROM lineitem",
    "SELECT l_linestatus, approx_percentile(l_extendedprice, 0.5) FROM lineitem"
    " GROUP BY l_linestatus ORDER BY l_linestatus",
    "SELECT n_regionkey, count(*), max_by(n_name, n_nationkey), sum(n_nationkey)"
    " FROM nation GROUP BY n_regionkey ORDER BY n_regionkey",
    "SELECT min(n_name), max(n_name) FROM nation",
    "SELECT max_by(n_name, n_nationkey), approx_percentile(n_nationkey, 0.5),"
    " count(*) FROM nation WHERE n_nationkey < 0",
    "SELECT max_by(x, y), approx_percentile(y, 0.5), count(*) FROM"
    " (SELECT n_nationkey x, n_regionkey y FROM nation LIMIT 0) t",
    "SELECT listagg(r_name, ', ') FROM region",
    "SELECT n_regionkey, string_agg(n_name, '|') FROM nation"
    " WHERE n_nationkey < 6 GROUP BY n_regionkey ORDER BY n_regionkey",
    "SELECT listagg(r_name, '-') FROM region WHERE r_regionkey < 0",
    # listagg's runtime dictionary through a projection and an ORDER BY
    "SELECT k, s FROM (SELECT n_regionkey k, string_agg(n_name, '|') s FROM nation"
    " GROUP BY n_regionkey) t ORDER BY s DESC",
    # the holistic path with its identities at tiny
    "SELECT approx_distinct(o_custkey), min_by(o_orderkey, o_totalprice),"
    " max_by(o_orderkey, o_totalprice) FROM orders",
    "SELECT o_orderpriority, approx_percentile(o_totalprice, 0.5) FROM orders"
    " GROUP BY o_orderpriority ORDER BY o_orderpriority",
]

# plan-time string operations over listagg's output raise in both
LISTAGG_DOWNSTREAM = [
    "SELECT k, s FROM (SELECT n_regionkey k, string_agg(n_name,'|') s"
    " FROM nation GROUP BY n_regionkey) t WHERE s = 'EGYPT'",
    "SELECT upper(s) FROM (SELECT listagg(r_name, '-') s FROM region) t",
]

# tests/test_aggregates_r4.py's table and tests/test_approx_aggs.py's,
# through the memory connector. (entropy, checksum and geometric_mean
# there need ln and checksum_hash, which come with the expression
# breadth of ROADMAP §1 item 3; the collect kinds are in
# tests/test_torch_nested.py.)
MEMORY_CASES = [
    ("select regr_count(v, g), regr_avgx(v, g), regr_avgy(v, g), regr_sxx(v, g),"
     " regr_sxy(v, g), regr_syy(v, g), regr_r2(v, g) from t", True),
    ("select g, min_by(k, v), max_by(k, v), listagg(k, ',') from t group by g order by g",
     False),
    ("select k, approx_distinct(x) from d group by k order by k", False),
    ("select k, approx_distinct(x), count(x), sum(x), min(x), avg(y) from d"
     " group by k order by k", True),
    ("select approx_distinct(x) from d", False),
    ("select approx_distinct(x) from d where k > 9", False),
    ("select k, approx_percentile(y, 0.5), approx_percentile(y, 0.9), count(*)"
     " from d group by k order by k", False),
    ("select k, approx_distinct(x), approx_distinct(y), count(*) from d"
     " group by k order by k", False),
    ("select k, approx_distinct(x), approx_percentile(y, 0.5), avg(y), sum(x)"
     " from d group by k order by k", True),
    ("select approx_percentile(x, 0.3), approx_percentile(y, 0.7) from d", False),
    ("select k, approx_percentile(x, 0.5), min_by(y, x) from d group by k order by k",
     False),
    ("select k, approx_distinct(x) from nulls group by k order by k", False),
    ("select approx_distinct(w) from s", False),
]


@pytest.fixture(scope="module")
def tpch_runners():
    ref = JRunner(JSession(catalog="tpch", schema="tiny"))
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    port.register_catalog("tpch", ttpch.create_tpch_connector())
    return ref, port


def _load_memory(conn, types, cm):
    """The tables of test_aggregates_r4 (t), test_approx_aggs (d, nulls,
    s), loaded into one memory connector of either package."""
    g = np.array([1, 1, 1, 2, 2, 3], dtype=np.int64)
    conn.load_table(
        "default", "t", [cm("g", types.BIGINT), cm("k", types.VARCHAR),
                         cm("v", types.BIGINT)],
        [g, ["a", "b", "a", "c", "c", None], np.arange(10, 70, 10, dtype=np.int64)],
        valids=[None, np.array([1, 1, 1, 1, 1, 0], bool), None],
    )
    rng = np.random.default_rng(11)
    n = 40000
    k = rng.integers(0, 4, n).astype(np.int64)
    x = rng.integers(0, 2500, n).astype(np.int64)
    y = rng.normal(50.0, 10.0, n)
    conn.load_table(
        "default", "d", [cm("k", types.BIGINT), cm("x", types.BIGINT),
                         cm("y", types.DOUBLE)],
        [k, x, y], [None, rng.random(n) >= 0.03, None], [None, None, None],
    )
    conn.load_table(
        "default", "nulls", [cm("k", types.BIGINT), cm("x", types.BIGINT)],
        [np.asarray([1, 1, 2], dtype=np.int64), np.asarray([5, 6, 0], dtype=np.int64)],
        [None, np.asarray([True, True, False])], [None, None],
    )
    conn.load_table("default", "s", [cm("w", types.VARCHAR)],
                    [[f"w{i % 700}" for i in range(5000)]], None, [None])


@pytest.fixture(scope="module")
def memory_runners():
    jm = jmemory.create_memory_connector()
    _load_memory(jm, JT, JColumnMetadata)
    ref = JRunner(JSession(catalog="memory", schema="default"))
    ref.register_catalog("memory", jm)
    tm = tmemory.create_memory_connector()
    _load_memory(tm, T, ColumnMetadata)
    port = LocalQueryRunner(Session(catalog="memory", schema="default"), device="cpu")
    port.register_catalog("memory", tm)
    return ref, port


@pytest.mark.parametrize("sql", TPCH_CASES)
def test_tpch_aggregates_match_reference(sql, tpch_runners):
    # integers, decimals and strings equal; every double here is an
    # order statistic taken from the data, so equal as well
    ref, port = tpch_runners
    assert port.execute(sql).rows == ref.execute(sql).rows


@pytest.mark.parametrize("sql", LISTAGG_DOWNSTREAM)
def test_listagg_downstream_string_ops_raise(sql, tpch_runners):
    ref, port = tpch_runners
    for r in (ref, port):
        with pytest.raises(NotImplementedError):
            r.execute(sql)


@pytest.mark.parametrize("sql,float_sums", MEMORY_CASES)
def test_memory_aggregates_match_reference(sql, float_sums, memory_runners):
    # float_sums: avg/regr over doubles add in another order, so those
    # doubles agree within assert_rows_match's 1e-9 relative
    ref, port = memory_runners
    got, want = port.execute(sql).rows, ref.execute(sql).rows
    if float_sums:
        assert_rows_match(got, want, ordered=True)
    else:
        assert got == want


def test_lone_approx_distinct_is_the_references_hll_estimate(tpch_runners):
    # the optimizer rewrites a lone approx_distinct into the HLL plan:
    # both packages answer 1008 where the exact count is 1000; mixed
    # with min_by it takes the holistic path, which is exact
    ref, port = tpch_runners
    for r in (ref, port):
        assert r.execute("SELECT approx_distinct(o_custkey) FROM orders").rows == [[1008]]
        assert r.execute("SELECT count(DISTINCT o_custkey) FROM orders").rows == [[1000]]
        assert r.execute("SELECT approx_distinct(o_custkey), min_by(o_orderkey,"
                         " o_totalprice) FROM orders").rows[0][0] == 1000


def test_collect_aggregates_raise_naming_their_roadmap_item(tpch_runners):
    # the collect aggregates (ROADMAP §1 item 4) are ported: the port's
    # array_agg equals the reference's, element order included
    ref, port = tpch_runners
    sql = "SELECT n_regionkey, array_agg(n_name) FROM nation GROUP BY n_regionkey ORDER BY 1"
    rows = port.execute(sql).rows
    assert rows == ref.execute(sql).rows
    assert len(rows) == 5 and sum(len(names) for _, names in rows) == 25
