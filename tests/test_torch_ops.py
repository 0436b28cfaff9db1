"""trino_tpu_torch's main-path kernels against the reference, on the same
numpy inputs. Integer, boolean and key outputs: bit-equal. Float
min/max/keys: bit-equal too (no arithmetic on them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.ops import groupby as JG
from trino_tpu.ops import hashing as JH
from trino_tpu.ops import int128 as JI
from trino_tpu.ops import sort as JS
from trino_tpu_torch.ops import groupby as TG
from trino_tpu_torch.ops import hashing as TH
from trino_tpu_torch.ops import int128 as TI
from trino_tpu_torch.ops import sort as TS

N = 512


def _cols(seed):
    """Key columns of every lane kind the hash reads, with NULLs."""
    rng = np.random.default_rng(seed)
    f64 = rng.normal(0, 1e6, N)
    f64[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e300, -1e-300, 1e-200]
    cols = {
        "int64": rng.integers(-(2 ** 62), 2 ** 62, N).astype(np.int64),
        "int32": rng.integers(-(2 ** 31), 2 ** 31 - 1, N).astype(np.int32),
        "codes": rng.integers(0, 50, N).astype(np.int32),
        "bool": rng.random(N) < 0.5,
        "float32": rng.normal(0, 10, N).astype(np.float32),
        "float64": f64,
        "decimal128": rng.integers(-(2 ** 62), 2 ** 62, (N, 2)).astype(np.int64),
    }
    valids = {k: rng.random(N) < 0.9 for k in cols}
    return cols, valids


HASH_SETS = [("int64",), ("int32", "codes"), ("bool", "float32"),
             ("float64",), ("decimal128", "int64"), ("codes", "float64", "bool")]


@pytest.mark.parametrize("names", HASH_SETS, ids=lambda s: "+".join(s))
@pytest.mark.parametrize("seed", [0, 0x9E37])
def test_hash32_hash64_bit_equal(names, seed):
    cols, valids = _cols(len(names))
    jc = [jnp.asarray(cols[n]) for n in names]
    jv = [jnp.asarray(valids[n]) for n in names]
    tc = [torch.from_numpy(cols[n]) for n in names]
    tv = [torch.from_numpy(valids[n]) for n in names]
    want32 = np.asarray(JH.hash32(jc, jv, seed=seed)).astype(np.int64)
    got32 = TH.hash32(tc, tv, seed=seed).numpy()
    assert np.array_equal(got32, want32)
    want64 = np.asarray(JH.hash64(jc, jv, seed=seed))
    assert np.array_equal(TH.hash64(tc, tv, seed=seed).numpy(), want64)
    # no validity masks at all
    assert np.array_equal(
        TH.hash32(tc, None, seed=seed).numpy(),
        np.asarray(JH.hash32(jc, None, seed=seed)).astype(np.int64),
    )


@pytest.mark.parametrize("seed", [0, 7])
def test_hash32_np_bit_equal(seed):
    cols, valids = _cols(3)
    keys = [cols["int64"], JH.dictionary_code_hashes([f"v{i}" for i in range(N)]),
            cols["decimal128"]]
    vs = [valids["int64"], None, valids["decimal128"]]
    want = JH.hash32_np(keys, vs, seed=seed)
    got = TH.hash32_np(keys, vs, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # and the host replica agrees with the port's device hash
    dev = TH.hash32([torch.from_numpy(cols["int64"])],
                    [torch.from_numpy(valids["int64"])], seed=seed).numpy()
    host = TH.hash32_np([cols["int64"]], [valids["int64"]], seed=seed)
    assert np.array_equal(dev, host.astype(np.int64))


def _limbs(seed, n=N):
    rng = np.random.default_rng(seed)
    h = rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64)
    lo = rng.integers(-(2 ** 63), 2 ** 63 - 1, n, dtype=np.int64)
    h[:4] = [0, -1, 2 ** 62, -(2 ** 62)]
    lo[:4] = [-1, 0, -(2 ** 63), 2 ** 63 - 1]
    return h, lo


INT128_OPS = {
    "add": lambda M, a, b: M.add(a[0], a[1], b[0], b[1]),
    "sub": lambda M, a, b: M.sub(a[0], a[1], b[0], b[1]),
    "mul_128": lambda M, a, b: M.mul_128(a[0], a[1], b[0], b[1]),
    "mul_i64": lambda M, a, b: M.mul_i64(a[1], b[1]),
    "mul_128_64": lambda M, a, b: M.mul_128_64(a[0], a[1], b[1] >> 2),
    "lt_eq": lambda M, a, b: (M.lt(a[0], a[1], b[0], b[1]), M.eq(a[0], a[1], a[0], a[1])),
    "rescale_up": lambda M, a, b: M.rescale_up(a[0] >> 30, a[1], 20),
    "rescale_down_round": lambda M, a, b: M.rescale_down_round(a[0], a[1], 22),
    "div_round_i64": lambda M, a, b: M.div_round_i64(a[0], a[1], (b[1] >> 20) | 1),
    "overflows_38": lambda M, a, b: (M.overflows_38(a[0] << 22, a[1]),),
}


@pytest.mark.parametrize("op", sorted(INT128_OPS))
def test_int128_bit_equal(op):
    a, b = _limbs(1), _limbs(2)
    want = INT128_OPS[op](JI, tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    got = INT128_OPS[op](TI, tuple(map(torch.from_numpy, a)), tuple(map(torch.from_numpy, b)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), op


SORT_CASES = {
    "int_asc_desc": (("int64", False, False), ("codes", True, True)),
    "float_nulls_first": (("float64", False, True),),
    "float_desc": (("float64", True, False), ("int32", False, False)),
    "bool_and_decimal": (("bool", True, False), ("decimal128", False, False)),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sort_order_bit_equal(case):
    cols, valids = _cols(5)
    rng = np.random.default_rng(6)
    cols = dict(cols, codes=rng.integers(0, 5, N).astype(np.int32),
                int64=rng.integers(0, 20, N).astype(np.int64))
    live = rng.random(N) < 0.85
    spec = SORT_CASES[case]
    want = JS.sort_order(
        [jnp.asarray(cols[n]) for n, _, _ in spec],
        [jnp.asarray(valids[n]) for n, _, _ in spec],
        [d for _, d, _ in spec], [nf for _, _, nf in spec], jnp.asarray(live),
    )
    got = TS.sort_order(
        [torch.from_numpy(cols[n]) for n, _, _ in spec],
        [torch.from_numpy(valids[n]) for n, _, _ in spec],
        [d for _, d, _ in spec], [nf for _, _, nf in spec], torch.from_numpy(live),
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


def _group_inputs(seed, key_names, n=N):
    cols, valids = _cols(seed)
    rng = np.random.default_rng(seed + 100)
    cols = dict(cols, codes=rng.integers(0, 6, n).astype(np.int32),
                int64=rng.integers(-3, 3, n).astype(np.int64),
                float64=rng.choice([0.0, -0.0, 1.5, np.nan, 2.5], n),
                decimal128=rng.integers(-2, 2, (n, 2)).astype(np.int64))
    keys = [cols[k] for k in key_names]
    kv = [valids[k] for k in key_names]
    mask = rng.random(n) < 0.8
    values = [rng.integers(-1000, 1000, n).astype(np.int64),
              rng.integers(-1000, 1000, n).astype(np.int32),
              rng.normal(0, 1, n),
              np.ones(n, dtype=np.int64)]
    vvalids = [rng.random(n) < 0.9, None, rng.random(n) < 0.9, None]
    return keys, kv, mask, values, vvalids


SORT_GROUP_CASES = {
    "single_int": (("int64",), ("sum", "min", "max", "count")),
    "single_float": (("float64",), ("sum", "max", "min", "count")),
    "multi_key": (("codes", "int64", "bool"), ("sum", "max", "min", "count")),
    "limb_key": (("decimal128", "codes"), ("sum", "min", "max", "count")),
}


@pytest.mark.parametrize("case", sorted(SORT_GROUP_CASES))
def test_sort_group_reduce_bit_equal(case):
    key_names, reds = SORT_GROUP_CASES[case]
    keys, kv, mask, values, vvalids = _group_inputs(3, key_names)
    cap = 256
    want = JG.sort_group_reduce(
        tuple(map(jnp.asarray, keys)), tuple(map(jnp.asarray, kv)),
        jnp.asarray(mask), tuple(map(jnp.asarray, values)),
        tuple(None if v is None else jnp.asarray(v) for v in vvalids), reds, cap,
    )
    got = TG.sort_group_reduce(
        tuple(map(torch.from_numpy, keys)), tuple(map(torch.from_numpy, kv)),
        torch.from_numpy(mask), tuple(map(torch.from_numpy, values)),
        tuple(None if v is None else torch.from_numpy(v) for v in vvalids), reds, cap,
    )
    gk, gv, used, res, cnts, ng, ovf = got
    wk, wv, wused, wres, wcnts, wng, wovf = want
    assert int(ng) == int(wng) and bool(ovf) == bool(wovf) is False
    assert np.array_equal(used.numpy(), np.asarray(wused))
    for a, b in zip(list(gv) + list(cnts), list(wv) + list(wcnts)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b, v in zip(gk, wk, gv):
        # the payload under a NULL key is whichever row the sort put
        # first (unspecified); compare the keys SQL can see
        v = v.numpy() if a.dim() == 1 else v.numpy()[:, None]
        a, b = np.where(v, a.numpy(), 0), np.where(v, np.asarray(b), 0)
        assert np.array_equal(a, b, equal_nan=True)
    for i, (a, b) in enumerate(zip(res, wres)):
        a, b = a.numpy(), np.asarray(b)
        if i == 2 and reds[i] == "sum":
            # float sums: another summation order; doubles agree to 1e-9
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
        else:
            assert np.array_equal(a, b, equal_nan=True), (i, reds[i])


@pytest.mark.parametrize("reds", [("sum", "min", "max", "count"),
                                  ("count", "sum", "sum", "count")])
def test_dense_group_reduce_bit_equal(reds):
    keys, kv, mask, values, vvalids = _group_inputs(9, ("codes", "bool"))
    dims, cap = (6, 2), 32
    values[2] = np.round(values[2] * 8) / 8  # exactly summable doubles
    want = JG.dense_group_reduce(
        list(map(jnp.asarray, keys)), list(map(jnp.asarray, kv)), jnp.asarray(mask),
        list(map(jnp.asarray, values)),
        tuple(None if v is None else jnp.asarray(v) for v in vvalids), reds, dims, cap,
    )
    got = TG.dense_group_reduce(
        list(map(torch.from_numpy, keys)), list(map(torch.from_numpy, kv)),
        torch.from_numpy(mask), list(map(torch.from_numpy, values)),
        tuple(None if v is None else torch.from_numpy(v) for v in vvalids), reds, dims, cap,
    )
    for g, w in zip(got[:5], want[:5]):
        gl = g if isinstance(g, (list, tuple)) else [g]
        wl = w if isinstance(w, (list, tuple)) else [w]
        for a, b in zip(gl, wl):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert int(got[5]) == int(want[5]) and bool(got[6]) == bool(want[6])


@pytest.mark.parametrize("fn", ["seg_sum", "seg_count", "seg_min", "seg_max", "seg_any"])
def test_seg_accumulators_bit_equal(fn):
    rng = np.random.default_rng(12)
    n, cap = 400, 24
    gid = rng.integers(0, cap + 1, n).astype(np.int32)  # cap = the drop slot
    w = rng.random(n) < 0.7
    vals = rng.integers(-500, 500, n).astype(np.int64)
    flags = rng.random(n) < 0.5
    j, t = getattr(JG, fn), getattr(TG, fn)
    if fn == "seg_count":
        want = j(jnp.asarray(gid), jnp.asarray(w), cap)
        got = t(torch.from_numpy(gid), torch.from_numpy(w), cap)
    else:
        x = flags if fn == "seg_any" else vals
        want = j(jnp.asarray(gid), jnp.asarray(x), jnp.asarray(w), cap)
        got = t(torch.from_numpy(gid), torch.from_numpy(x), torch.from_numpy(w), cap)
    assert np.array_equal(got.numpy(), np.asarray(want))
