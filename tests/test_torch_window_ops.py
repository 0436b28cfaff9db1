"""trino_tpu_torch.ops.window against trino_tpu.ops.window on the same
seeded numpy inputs: sorted partitions with ties, NULLs, a dead tail in
a segment of its own, NaN and -0.0. Tolerance: integer, boolean and
gathered outputs bit-equal (min/max, first/last/nth_value and lead/lag
gather, so -0.0 and NaN must come back as the reference returns them);
float64 sums and averages within 1e-12 relative; percent_rank and
cume_dist within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.ops import window as JW
from trino_tpu_torch.ops import window as TW

N = 300
FRAMES = ("partition", "rows", "range")


def _case(seed):
    """A sorted batch: partition ids and order keys ascending (with
    ties), the last 20 rows dead and in their own segment."""
    rng = np.random.default_rng(seed)
    part = np.sort(rng.integers(0, 12, N))
    order = np.concatenate([np.sort(rng.integers(0, 6, (part == p).sum()))
                            for p in np.unique(part)])
    live = np.ones(N, dtype=bool)
    live[-20:] = False
    part_start = JW.segment_starts(
        [jnp.asarray(part), jnp.asarray(live)], [None, None], N)
    peer_start = part_start | JW.segment_starts([jnp.asarray(order)], [None], N)
    f = rng.normal(0, 100, N).round(1)
    f[rng.random(N) < 0.08] = np.nan
    f[rng.random(N) < 0.1] = 0.0
    f[rng.random(N) < 0.1] = -0.0
    f[rng.random(N) < 0.05] = np.inf
    vals = {
        "float64": f,
        "int64": rng.integers(-(2 ** 62), 2 ** 62, N).astype(np.int64),
        "int32": rng.integers(-50, 50, N).astype(np.int32),
        "bool": rng.random(N) < 0.5,
        "float32": rng.normal(0, 10, N).astype(np.float32),
    }
    valid = rng.random(N) < 0.85
    return part, live, np.asarray(part_start), np.asarray(peer_start), vals, valid


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    """Bit-equal, NaN == NaN and -0.0 distinct from +0.0."""
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        assert np.array_equal(got.view(np.uint8), want.astype(got.dtype).view(np.uint8))
    else:
        assert np.array_equal(got, want.astype(got.dtype))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_starts_and_indices(seed):
    part, live, ps, pe, vals, valid = _case(seed)
    pv = np.random.default_rng(seed).random(N) < 0.9
    for cols, valids in (([part, live], [None, None]), ([part], [pv]),
                         ([vals["float64"]], [valid])):
        want = JW.segment_starts([jnp.asarray(c) for c in cols],
                                 [None if v is None else jnp.asarray(v) for v in valids], N)
        got = TW.segment_starts([_t(c) for c in cols],
                                [None if v is None else _t(v) for v in valids], N)
        _eq(got, want)
    _eq(TW._seg_start_index(_t(ps)), JW._seg_start_index(jnp.asarray(ps)))
    _eq(TW._seg_end_index(_t(ps)), JW._seg_end_index(jnp.asarray(ps)))
    _eq(TW._peer_end_index(_t(ps), _t(pe)),
        JW._peer_end_index(jnp.asarray(ps), jnp.asarray(pe)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranking_family(seed):
    _, _, ps, pe, _, _ = _case(seed)
    jps, jpe, tps, tpe = jnp.asarray(ps), jnp.asarray(pe), _t(ps), _t(pe)
    _eq(TW.row_number(tps), JW.row_number(jps))
    _eq(TW.rank(tps, tpe), JW.rank(jps, jpe))
    _eq(TW.dense_rank(tps, tpe), JW.dense_rank(jps, jpe))
    _close(TW.percent_rank(tps, tpe), JW.percent_rank(jps, jpe))
    _close(TW.cume_dist(tps, tpe), JW.cume_dist(jps, jpe))
    for n in (1, 2, 3, 7, 400):
        _eq(TW.ntile(n, tps), JW.ntile(n, jps))


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("kind", ["count", "count_star", "sum", "avg"])
@pytest.mark.parametrize("dtype", ["float64", "int64", "int32"])
def test_windowed_sum_count(kind, dtype, frame):
    _, live, ps, pe, vals, valid = _case(3)
    v = vals[dtype]
    if dtype == "float64":
        v = np.where(np.isfinite(v), v, 1.5)  # sums of NaN/inf are NaN alike
    acc = np.float64 if dtype == "float64" else np.int64
    v = v.astype(acc)
    vv = None if kind == "count_star" else valid
    want_v, want_c = JW.windowed_agg(
        kind, jnp.asarray(v), None if vv is None else jnp.asarray(vv),
        jnp.asarray(live), jnp.asarray(ps), jnp.asarray(pe), frame, 0)
    got_v, got_c = TW.windowed_agg(
        kind, _t(v), None if vv is None else _t(vv), _t(live), _t(ps), _t(pe),
        frame, 0)
    _eq(got_c, want_c)
    if dtype == "float64" and kind in ("sum", "avg"):
        _close(got_v, want_v)
    else:
        _eq(got_v, want_v)


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("dtype", ["float64", "int64", "int32", "bool", "float32"])
def test_windowed_min_max(kind, dtype, frame):
    """NaN (largest), -0.0 against +0.0 (equal; the latest attaining row
    wins) and NULLs behave as in the reference: gathered bit-equal."""
    from trino_tpu.exec.operators import minmax_neutral

    _, live, ps, pe, vals, valid = _case(4)
    v = vals[dtype]
    neutral = minmax_neutral(v.dtype, kind)
    want_v, want_c = JW.windowed_agg(
        kind, jnp.asarray(v), jnp.asarray(valid), jnp.asarray(live),
        jnp.asarray(ps), jnp.asarray(pe), frame, neutral)
    got_v, got_c = TW.windowed_agg(
        kind, _t(v), _t(valid), _t(live), _t(ps), _t(pe), frame, neutral)
    _eq(got_c, want_c)
    _eq(got_v, want_v)


def test_min_max_pin_nan_negative_zero_and_null():
    """One partition each: [-0.0, 0.0], [0.0, -0.0], [NaN, 1.0],
    [NULL, 2.0], [NaN, NaN] — the running values the reference gives."""
    v = np.array([-0.0, 0.0, 0.0, -0.0, np.nan, 1.0, 5.0, 2.0, np.nan, np.nan])
    valid = np.array([True] * 6 + [False] + [True] * 3)
    ps = np.array([True, False] * 5)
    live = np.ones(10, dtype=bool)
    for kind in ("min", "max"):
        neutral = np.inf if kind == "min" else -np.inf
        want, _ = JW.windowed_agg(kind, jnp.asarray(v), jnp.asarray(valid),
                                  jnp.asarray(live), jnp.asarray(ps), None, "rows",
                                  neutral)
        got, _ = TW.windowed_agg(kind, _t(v), _t(valid), _t(live), _t(ps), None,
                                 "rows", neutral)
        _eq(got, want)
    got, _ = TW.windowed_agg("max", _t(v), _t(valid), _t(live), _t(ps), None,
                             "rows", -np.inf)
    g = got.numpy()
    assert np.signbit(g[0]) and not np.signbit(g[1])  # latest attaining row
    assert not np.signbit(g[2]) and np.signbit(g[3])
    assert np.isnan(g[5]) and g[7] == 2.0 and np.isnan(g[9])


@pytest.mark.parametrize("offset", [1, 2, -1, -3, 0])
@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_shift_in_partition(offset, dtype):
    _, _, ps, _, vals, valid = _case(5)
    v = vals[dtype]
    for vv in (valid, None):
        want = JW.shift_in_partition(jnp.asarray(v), None if vv is None else jnp.asarray(vv),
                                     jnp.asarray(ps), offset)
        got = TW.shift_in_partition(_t(v), None if vv is None else _t(vv), _t(ps), offset)
        _eq(got[0], want[0])
        _eq(got[1], want[1])


def test_shift_long_decimal_pairs():
    _, _, ps, _, vals, valid = _case(6)
    pairs = np.stack([vals["int64"] >> 40, vals["int64"]], axis=-1)
    want = JW.shift_in_partition(jnp.asarray(pairs), jnp.asarray(valid), jnp.asarray(ps), 1)
    got = TW.shift_in_partition(_t(pairs), _t(valid), _t(ps), 1)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("frame", FRAMES)
def test_value_functions(frame):
    _, _, ps, pe, vals, valid = _case(7)
    jps, jpe, tps, tpe = jnp.asarray(ps), jnp.asarray(pe), _t(ps), _t(pe)
    for dtype in ("float64", "int32"):
        v = vals[dtype]
        for vv in (valid, None):
            jv = None if vv is None else jnp.asarray(vv)
            tv = None if vv is None else _t(vv)
            pairs = [
                (TW.first_value(_t(v), tv, tps), JW.first_value(jnp.asarray(v), jv, jps)),
                (TW.last_value(_t(v), tv, tps, tpe, frame),
                 JW.last_value(jnp.asarray(v), jv, jps, jpe, frame)),
            ] + [
                (TW.nth_value(_t(v), tv, tps, tpe, frame, n),
                 JW.nth_value(jnp.asarray(v), jv, jps, jpe, frame, n))
                for n in (1, 2, 5)
            ]
            for got, want in pairs:
                _eq(got[0], want[0])
                assert (got[1] is None) == (want[1] is None)
                if want[1] is not None:
                    _eq(got[1], want[1])
    idx = np.random.default_rng(7).integers(0, N, N)
    got = TW.value_at(_t(vals["int64"]), _t(valid), _t(idx))
    want = JW.value_at(jnp.asarray(vals["int64"]), jnp.asarray(valid), jnp.asarray(idx))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_running_sum_int64_wraps_like_the_reference():
    v = np.array([2 ** 62, 2 ** 62, 2 ** 62, -5, 7], dtype=np.int64)
    ps = np.array([True, False, False, True, False])
    _eq(TW._running_sum(_t(v), _t(ps)), JW._running_sum(jnp.asarray(v), jnp.asarray(ps)))


def test_single_row_and_empty():
    ps = np.array([True])
    _eq(TW.row_number(_t(ps)), JW.row_number(jnp.asarray(ps)))
    _close(TW.percent_rank(_t(ps), _t(ps)), JW.percent_rank(jnp.asarray(ps), jnp.asarray(ps)))
    e = torch.zeros(0, dtype=torch.bool)
    assert TW.row_number(e).shape == (0,)
    assert TW.rank(e, e).shape == (0,)
    assert TW._peer_end_index(e, e).shape == (0,)
