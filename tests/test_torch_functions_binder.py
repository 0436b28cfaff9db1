"""trino_tpu_torch's scalar functions below SQL, against trino_tpu's on
the same numpy inputs made from a seed.

- (c) Every date helper of expr/functions.py against the reference's on
  100,000 days drawn over 1900-2100, for every unit: bit-equal.
- (d) Both ExprBinders on random doubles, int64s and NULL masks for the
  math, probability and bitwise functions. Integers, booleans and the
  NULL masks are bit-equal (the shifts' and bit_count's 64-bit patterns
  included); each double family states its tolerance.
- (e) Routing: no `_not_ported` call is left in trino_tpu_torch/expr/
  (items 4 and 6 are ported), and every TIMESTAMP WITH TIME ZONE
  function binds bit-equal to the reference's on seeded packed values.
"""

import datetime
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import types as JT
from trino_tpu.expr import functions as JF
from trino_tpu.expr import ir as jir
from trino_tpu.expr.compile import ExprBinder as JBinder
from trino_tpu_torch import types as T
from trino_tpu_torch.expr import compile as TC
from trino_tpu_torch.expr import functions as TF
from trino_tpu_torch.expr import ir as tir
from trino_tpu_torch.expr.compile import ExprBinder as TBinder

N_DAYS = 100_000
LO_DAY = (datetime.date(1900, 1, 1) - datetime.date(1970, 1, 1)).days
HI_DAY = (datetime.date(2100, 12, 31) - datetime.date(1970, 1, 1)).days


@pytest.fixture(scope="module")
def days():
    rng = np.random.default_rng(20260801)
    a = rng.integers(LO_DAY, HI_DAY + 1, N_DAYS).astype(np.int32)
    b = rng.integers(LO_DAY, HI_DAY + 1, N_DAYS).astype(np.int32)
    n = rng.integers(-2400, 2401, N_DAYS).astype(np.int32)
    return a, b, n


def _bit_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- (c) the date helpers ----------------------------------------------

UNARY_DAY_HELPERS = ["civil_from_days", "day_of_week", "day_of_year", "week_of_year",
                     "year_of_week", "last_day_of_month_days"]


@pytest.mark.parametrize("name", UNARY_DAY_HELPERS)
def test_day_helpers_bit_equal(name, days):
    a, _, _ = days
    got, want = getattr(TF, name)(_t(a)), getattr(JF, name)(jnp.asarray(a))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _bit_equal(g, w)


def test_days_from_civil_and_month_lengths(days):
    a, _, _ = days
    y, m, d = (np.asarray(x) for x in JF.civil_from_days(jnp.asarray(a)))
    _bit_equal(TF.days_from_civil(_t(y), _t(m), _t(d)), JF.days_from_civil(y, m, d))
    _bit_equal(TF.days_from_civil(_t(y), _t(m), _t(d)), a)
    _bit_equal(TF.days_in_month(_t(y), _t(m)), JF.days_in_month(jnp.asarray(y), jnp.asarray(m)))


@pytest.mark.parametrize("unit", ["day", "week", "month", "quarter", "year"])
def test_unit_helpers_bit_equal(unit, days):
    a, b, n = days
    ja, jb, jn = jnp.asarray(a), jnp.asarray(b), jnp.asarray(n)
    _bit_equal(TF.date_trunc_days(unit, _t(a)), JF.date_trunc_days(unit, ja))
    _bit_equal(TF.date_add_days(unit, _t(n), _t(a)), JF.date_add_days(unit, jn, ja))
    _bit_equal(TF.date_diff_days(unit, _t(a), _t(b)), JF.date_diff_days(unit, ja, jb))


def test_add_months_vec_bit_equal(days):
    a, _, n = days
    _bit_equal(TF.add_months_vec(_t(a), _t(n)), JF.add_months_vec(jnp.asarray(a),
                                                                   jnp.asarray(n)))


def test_host_date_helpers(days):
    a, _, n = days
    for day, months in zip(a[:3000].tolist(), n[:3000].tolist()):
        d = TF.days_to_date(day)
        assert d == JF.days_to_date(day) and TF.date_to_days(d) == JF.date_to_days(d) == day
        assert TF.add_months_scalar(d, months) == JF.add_months_scalar(d, months)


def test_sqrt_exact():
    """Exact integer roots bit-equal; elsewhere within one ulp (torch's
    sqrt is correctly rounded, XLA's CPU sqrt may be one ulp off)."""
    rng = np.random.default_rng(7)
    squares = np.arange(0, 2000, dtype=np.float64) ** 2
    _bit_equal(TF.sqrt_exact(_t(squares)), JF.sqrt_exact(jnp.asarray(squares)))
    _bit_equal(TF.sqrt_exact(_t(squares)), np.arange(0, 2000, dtype=np.float64))
    x = np.concatenate([rng.uniform(0, 1e6, 5000), [0.0, -1.0, np.inf, np.nan]])
    np.testing.assert_allclose(TF.sqrt_exact(_t(x)).numpy(), JF.sqrt_exact(jnp.asarray(x)),
                               rtol=2.3e-16, equal_nan=True)


# ---- (d) the binders on random columns ---------------------------------

N = 2000


@pytest.fixture(scope="module")
def columns():
    """(numpy arrays, valids) by column name, and each column's type."""
    rng = np.random.default_rng(11)
    cols = {
        "x": rng.normal(0, 50, N),                       # any double
        "p": rng.uniform(0.001, 0.999, N),               # in (0, 1)
        "u": rng.uniform(-0.999, 0.999, N),              # in (-1, 1)
        "pos": rng.uniform(0.01, 40, N),                 # positive
        "big": rng.uniform(1.0, 500, N),                 # >= 1
        "i": rng.integers(-(2 ** 63), 2 ** 63 - 1, N, dtype=np.int64, endpoint=True),
        "j": rng.integers(-(2 ** 40), 2 ** 40, N).astype(np.int64),
        "s": rng.integers(-3, 70, N).astype(np.int64),  # shift counts, some out of range
        "k": rng.integers(0, 60, N).astype(np.int64),
        "n": rng.integers(1, 80, N).astype(np.int64),
    }
    cols["x"][:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e300]
    valids = {name: rng.random(N) < 0.85 for name in cols}
    return cols, valids


KIND = {"x": "DOUBLE", "p": "DOUBLE", "u": "DOUBLE", "pos": "DOUBLE", "big": "DOUBLE",
        "i": "BIGINT", "j": "BIGINT", "s": "BIGINT", "k": "BIGINT", "n": "BIGINT"}


def _eval(name, argcols, out_type, columns, consts=()):
    """Bind Call(name, args) in both packages over the named columns
    (then constant literals); returns ((port data, valid), (ref data,
    valid)) as numpy."""
    cols, valids = columns
    out = []
    for pkg_t, ir_mod, binder, conv in ((T, tir, TBinder, _t), (JT, jir, JBinder, jnp.asarray)):
        types = [getattr(pkg_t, KIND[c]) for c in argcols]
        args = [ir_mod.InputRef(k, t) for k, t in enumerate(types)]
        args += [ir_mod.Literal(v, getattr(pkg_t, t)) for v, t in consts]
        b = binder(types, [None] * len(types)).bind(
            ir_mod.Call(name, tuple(args), getattr(pkg_t, out_type)))
        d, v = b.fn([conv(cols[c]) for c in argcols], [conv(valids[c]) for c in argcols])
        out.append((np.asarray(d), None if v is None else np.asarray(v)))
    return out


def _check(name, got, want, rtol=None, atol=0.0):
    (gd, gv), (wd, wv) = got, want
    assert (gv is None) == (wv is None), name
    if gv is not None:
        np.testing.assert_array_equal(gv, wv, err_msg=name)
    live = np.ones(gd.shape[0], bool) if gv is None else gv
    if rtol is None:
        assert gd.dtype == wd.dtype, (name, gd.dtype, wd.dtype)
        np.testing.assert_array_equal(gd[live], wd[live], err_msg=name)
    else:
        np.testing.assert_allclose(gd[live], wd[live], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=name)


# Elementary doubles: XLA's and torch's libm may differ in the last ulps,
# so rel 1e-13 (plus abs 1e-300 for results that underflow to zero).
ELEMENTARY = [
    ("sin", "x"), ("cos", "x"), ("tan", "x"), ("asin", "u"), ("acos", "u"),
    ("atan", "x"), ("sinh", "p"), ("cosh", "p"), ("tanh", "x"), ("asinh", "x"),
    ("acosh", "big"), ("atanh", "u"), ("cbrt", "x"), ("degrees", "x"),
    ("radians", "x"), ("expm1", "p"), ("log1p", "pos"), ("sqrt", "pos"), ("ln", "pos"),
    ("exp", "p"), ("log2", "pos"), ("log10", "pos"), ("cot", "pos"),
]


@pytest.mark.parametrize("name,col", ELEMENTARY)
def test_elementary_double_functions(name, col, columns):
    got, want = _eval(name, [col], "DOUBLE", columns)
    _check(name, got, want, rtol=1e-13, atol=1e-300)


@pytest.mark.parametrize("name,cols", [("power", ["pos", "u"]), ("atan2", ["x", "pos"]),
                                       ("log", ["big", "pos"])])
def test_binary_double_functions(name, cols, columns):
    got, want = _eval(name, cols, "DOUBLE", columns)
    _check(name, got, want, rtol=1e-13, atol=1e-300)


@pytest.mark.parametrize("name,out", [("floor", "DOUBLE"), ("ceil", "DOUBLE"),
                                      ("is_nan", "BOOLEAN"), ("is_infinite", "BOOLEAN"),
                                      ("is_finite", "BOOLEAN"), ("sign", "DOUBLE")])
def test_exact_double_functions(name, out, columns):
    got, want = _eval(name, ["x"], out, columns)
    _check(name, got, want)


def test_truncate(columns):
    for consts in ((), ((2, "BIGINT"),), ((-1, "BIGINT"),)):
        got, want = _eval("truncate", ["x"], "DOUBLE", columns, consts)
        _check("truncate", got, want, rtol=1e-15)


# Probability family. The normal, Cauchy, logistic, Laplace and Weibull
# cdfs and the Wilson bounds are closed forms: rel 1e-12, abs 1e-15 (a
# cdf near 0 computed as 1 - exp(...) keeps only its absolute error).
# chi-squared and gamma come from torch.special.gammainc against
# jax.scipy's: rel 1e-10. poisson_cdf is torch.special.gammaincc, which
# is less accurate than jax.scipy's in this range: rel 5e-9. The
# beta-based ones (beta, F, binomial) are a continued fraction in torch
# against jax.scipy.special.betainc: abs 1e-11 on values in [0, 1];
# inverse_beta_cdf bisects both sides to 2^-64: abs 1e-10.
PROB = [
    ("normal_cdf", ["x", "pos", "x"], dict(rtol=1e-12, atol=1e-15)),
    ("inverse_normal_cdf", ["x", "pos", "p"], dict(rtol=1e-12, atol=1e-12)),
    ("cauchy_cdf", ["x", "pos", "x"], dict(rtol=1e-12, atol=1e-15)),
    ("logistic_cdf", ["x", "pos", "x"], dict(rtol=1e-12, atol=1e-15)),
    ("laplace_cdf", ["x", "pos", "x"], dict(rtol=1e-12, atol=1e-15)),
    ("weibull_cdf", ["pos", "pos", "x"], dict(rtol=1e-12, atol=1e-15)),
    ("wilson_interval_lower", ["k", "n", "pos"], dict(rtol=1e-12, atol=1e-14)),
    ("wilson_interval_upper", ["k", "n", "pos"], dict(rtol=1e-12, atol=1e-14)),
    ("chi_squared_cdf", ["pos", "pos"], dict(rtol=1e-10, atol=1e-300)),
    ("gamma_cdf", ["pos", "pos", "pos"], dict(rtol=1e-10, atol=1e-300)),
    ("poisson_cdf", ["pos", "k"], dict(rtol=5e-9, atol=1e-300)),
    ("beta_cdf", ["pos", "pos", "p"], dict(rtol=0, atol=1e-11)),
    ("f_cdf", ["pos", "pos", "pos"], dict(rtol=0, atol=1e-11)),
    ("binomial_cdf", ["n", "p", "k"], dict(rtol=0, atol=1e-11)),
    ("inverse_beta_cdf", ["pos", "pos", "p"], dict(rtol=0, atol=1e-10)),
]


@pytest.mark.parametrize("name,cols,tol", PROB, ids=[p[0] for p in PROB])
def test_probability_functions(name, cols, tol, columns):
    got, want = _eval(name, cols, "DOUBLE", columns)
    _check(name, got, want, **tol)


def test_width_bucket(columns):
    got, want = _eval("width_bucket", ["x"], "BIGINT", columns,
                      ((-40.0, "DOUBLE"), (60.0, "DOUBLE"), (7, "BIGINT")))
    _check("width_bucket", got, want)


BITWISE = [("bitwise_and", ["i", "j"]), ("bitwise_or", ["i", "j"]),
           ("bitwise_xor", ["i", "j"]), ("bitwise_left_shift", ["i", "s"]),
           ("bitwise_right_shift", ["i", "s"]),
           ("bitwise_right_shift_arithmetic", ["i", "s"]), ("bitwise_not", ["i"]),
           ("bit_count", ["i"]), ("bit_count", ["j"])]


@pytest.mark.parametrize("name,cols", BITWISE, ids=[f"{n}-{c[0]}" for n, c in BITWISE])
def test_bitwise_patterns_exact(name, cols, columns):
    got, want = _eval(name, cols, "BIGINT", columns)
    _check(name, got, want)


@pytest.mark.parametrize("bits", [8, 32, 63])
def test_bit_count_width(bits, columns):
    got, want = _eval("bit_count", ["i"], "BIGINT", columns, ((bits, "BIGINT"),))
    _check("bit_count", got, want)


def test_shifts_follow_trino_on_the_64_bit_pattern():
    x = torch.tensor([-8, -1, 1, 2 ** 62, -(2 ** 63)], dtype=torch.int64)
    for s in range(-2, 70):
        k = torch.full_like(x, s)
        for v, got_l, got_a in zip(x.tolist(), TC._shift_right_logical(x, k).tolist(),
                                   TC._shift_right_arithmetic(x, k).tolist()):
            ok = 0 <= s <= 63
            assert got_l == (((v % 2 ** 64) >> s) if ok else 0) - (
                2 ** 64 if ok and ((v % 2 ** 64) >> s) >= 2 ** 63 else 0)
            assert got_a == (v >> s if ok else (-1 if v < 0 else 0))
    assert TC._popcount64(x).tolist() == [bin(v % 2 ** 64).count("1") for v in x.tolist()]


# ---- (e) routing -------------------------------------------------------

EXPR_DIR = pathlib.Path(TC.__file__).parent


def test_every_not_ported_site_names_item_4_or_6():
    """Items 4 (nested types) and 6 (TIMESTAMP WITH TIME ZONE) are
    ported: no `_not_ported` site is left in trino_tpu_torch/expr/."""
    calls = []
    for path in sorted(EXPR_DIR.glob("*.py")):
        calls += [(path.name, m.group(0)) for m in re.finditer(r"_not_ported\(", path.read_text())]
    assert calls == []
    assert not hasattr(TC, "_not_ported")


def _tstz_inputs(n: int):
    """Seeded packed values over every zone of the registry, timestamps
    (micros), millisecond shifts and a validity, 1900-2100."""
    from trino_tpu_torch.ops import tz as TZ

    rng = np.random.default_rng(13)
    ids = np.array(list(range(0, 1682)) + list(range(TZ._NAMED_BASE, TZ._NAMED_BASE
                                                      + len(TZ._named_zones()))))
    ms = rng.integers(-2_208_988_800_000, 4_102_444_800_000, n)
    return {"tstz": (ms << 12) | rng.choice(ids, n),
            "timestamp": rng.integers(-2_208_988_800_000, 4_102_444_800_000, n) * 1000
            + rng.integers(0, 1000, n),
            "bigint": rng.integers(-10 ** 10, 10 ** 10, n)}, rng.random(n) < 0.9


def test_routed_functions_raise_naming_their_item():
    """Item 6 is ported: every function the port routed there binds as
    the reference's, bit-equal (data and NULL mask) on seeded packed
    values over every zone id, and none raises. The nested-type
    functions (item 4) are ported: the port binds the reference's lambda
    and array function sets, and routes none."""
    from trino_tpu.block import Dictionary as JDictionary
    from trino_tpu_torch.block import Dictionary as TDictionary
    from trino_tpu_torch.ops import tz as TZ

    n = 4096
    data, valid = _tstz_inputs(n)
    ny, tokyo = TZ.zone_id("America/New_York"), TZ.zone_id("Asia/Tokyo")
    cases = [
        ("at_timezone_id", ["tstz"], [tokyo], "TIMESTAMP_TZ"),
        ("tstz_shift", ["tstz", "bigint"], [], "TIMESTAMP_TZ"),
        ("tstz_to_instant_ts", ["tstz"], [], "TIMESTAMP"),
        ("tstz_rewall", ["timestamp", "tstz"], [], "TIMESTAMP_TZ"),
        ("ts_to_tstz", ["timestamp"], [ny], "TIMESTAMP_TZ"),
        ("tstz_to_ts", ["tstz"], [], "TIMESTAMP"),
        ("tstz_timezone_hour", ["tstz"], [], "BIGINT"),
        ("tstz_timezone_minute", ["tstz"], [], "BIGINT"),
        ("timezone_hour", ["timestamp"], [], "BIGINT"),
        ("timezone_minute", ["timestamp"], [], "BIGINT"),
    ]
    kinds = {"tstz": "TIMESTAMP_TZ", "timestamp": "TIMESTAMP", "bigint": "BIGINT"}
    assert {c[0] for c in cases} >= set(TC._TSTZ_FNS) - {"parse_tstz"}
    for name, argcols, consts, out_type in cases:
        got, want = [], []
        for pkg_t, ir_mod, binder, conv, out in ((T, tir, TBinder, _t, got),
                                                 (JT, jir, JBinder, jnp.asarray, want)):
            types = [getattr(pkg_t, kinds[c]) for c in argcols]
            args = [ir_mod.InputRef(k, t) for k, t in enumerate(types)]
            args += [ir_mod.Literal(v, pkg_t.INTEGER) for v in consts]
            b = binder(types, [None] * len(types)).bind(
                ir_mod.Call(name, tuple(args), getattr(pkg_t, out_type)))
            d, v = b.fn([conv(data[c]) for c in argcols], [conv(valid)] * len(argcols))
            out.extend([np.asarray(d), None if v is None else np.asarray(v)])
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
        np.testing.assert_array_equal(got[1], want[1], err_msg=name)
    # parse_tstz maps the dictionary's strings on the host at bind time
    texts = ["2024-03-10 02:30:00", "2024-11-03 01:30:00 America/New_York", "1969-12-31",
             "2024-07-04T12:00:00+05:30", "nonsense", "1900-01-01 00:00:00 Europe/London"]
    codes = np.random.default_rng(14).integers(0, len(texts), 64).astype(np.int32)
    got, want = [], []
    for pkg_t, ir_mod, binder, dct, conv, out in (
            (T, tir, TBinder, TDictionary, _t, got),
            (JT, jir, JBinder, JDictionary, jnp.asarray, want)):
        b = binder([pkg_t.VARCHAR], [dct(texts)]).bind(ir_mod.Call(
            "parse_tstz", (ir_mod.InputRef(0, pkg_t.VARCHAR), ir_mod.Literal(ny, pkg_t.INTEGER)),
            pkg_t.TIMESTAMP_TZ))
        d, v = b.fn([conv(codes)], [None])
        out.extend([np.asarray(d), np.asarray(v)])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not got[1].all()
    assert not hasattr(TC, "_NESTED_FNS")
    assert TBinder._LAMBDA_FNS == JBinder._LAMBDA_FNS
    assert TBinder._ARRAY_FNS == JBinder._ARRAY_FNS


def test_lookup_tables_cross_to_a_device_once():
    """A Bound's host-built table is copied to a device on first use and
    reused for every later batch there (one copy per device, not per
    batch); the lookup itself is unchanged."""
    from trino_tpu_torch.block import Dictionary

    b = TBinder([T.VARCHAR], [Dictionary(["b", "a", "c"])]).bind(
        tir.Call("upper", (tir.InputRef(0, T.VARCHAR),), T.VARCHAR))
    tables = [c.cell_contents for c in b.fn.__closure__
              if isinstance(c.cell_contents, TC._Table)]
    assert len(tables) == 1 and not tables[0]._placed
    codes = torch.tensor([2, 0, 1, 1], dtype=torch.int32)
    first, _ = b.fn([codes], [None])
    placed = dict(tables[0]._placed)
    second, _ = b.fn([codes.flip(0)], [None])
    assert list(tables[0]._placed) == [torch.device("cpu")]
    assert tables[0]._placed[torch.device("cpu")] is placed[torch.device("cpu")]
    assert [b.dictionary.values[i] for i in first.tolist()] == ["C", "A", "B", "B"]
    assert torch.equal(second, first.flip(0))
