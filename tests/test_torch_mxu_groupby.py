"""The grouped-sum kernel's plain version and `mxu_group_reduce` in
trino_tpu_torch against the reference's Pallas kernel (interpret mode on
the CPU) and its scatter oracle. Integer sums: bit-equal, no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.ops import groupby as JG
from trino_tpu.ops.mxu_groupby import grouped_sum_mxu, grouped_sum_reference
from trino_tpu_torch.ops import groupby as TG
from trino_tpu_torch.ops import mxu_groupby as TM


def _inputs(n, c, n_vals, seed, live_frac=1.0, extreme=False, ids="even", dead_tail=0):
    """ids: "even" over the c slots, "one_slot" (every row in slot 0) or
    "sorted" (long runs of one slot); the last `dead_tail` rows dead."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, c, n, dtype=np.int32)
    if ids == "one_slot":
        gid[:] = 0
    elif ids == "sorted":
        gid.sort()
    live = rng.random(n) < live_frac
    if dead_tail:
        live[n - dead_tail:] = False
    if extreme:
        big = np.int64(2 ** 63 - 1)
        vals = [
            np.where(rng.random(n) < 0.5, big - rng.integers(0, 100, n),
                     -big - 1 + rng.integers(0, 100, n)).astype(np.int64)
            for _ in range(n_vals)
        ]
    else:
        vals = [
            rng.integers(-(10 ** 12), 10 ** 12, n).astype(np.int64)
            for _ in range(n_vals)
        ]
    return gid, vals, live


# the reference's own kernel cases (tests/test_ops.py TestMxuGroupby),
# int64-extreme values whose sums wrap mod 2^64, and the shapes the card
# kernel's per-tile sort finds hard: one hot slot, long runs of one slot,
# a ragged length with a dead tail, and 13 value columns at capacity 2048
CASES = {
    "exact_int64_sums": dict(n=3000, c=300, n_vals=2, seed=1),
    "masked_rows_and_row_padding": dict(n=1001, c=17, n_vals=1, seed=2, live_frac=0.7),
    "many_values_multi_sublane_tile": dict(n=2048, c=100, n_vals=9, seed=3),
    "int64_extreme_wraparound": dict(n=1500, c=40, n_vals=3, seed=4, extreme=True),
    "all_rows_one_slot": dict(n=3000, c=300, n_vals=2, seed=5, ids="one_slot"),
    "sorted_long_runs": dict(n=5000, c=40, n_vals=3, seed=6, ids="sorted", extreme=True),
    "ragged_length_dead_tail": dict(n=1301, c=50, n_vals=2, seed=7, dead_tail=213),
    "thirteen_columns_capacity_2048": dict(n=4100, c=2048, n_vals=13, seed=8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_grouped_sum_matches_reference_kernel(case):
    kw = CASES[case]
    gid, vals, live = _inputs(kw["n"], kw["c"], kw["n_vals"], kw["seed"],
                              kw.get("live_frac", 1.0), kw.get("extreme", False),
                              kw.get("ids", "even"), kw.get("dead_tail", 0))
    c = kw["c"]
    want_kernel = grouped_sum_mxu(
        jnp.asarray(gid), tuple(jnp.asarray(v) for v in vals),
        jnp.asarray(live), c, interpret=jax.default_backend() != "tpu",
    )
    want_oracle = grouped_sum_reference(
        jnp.asarray(gid), tuple(jnp.asarray(v) for v in vals), jnp.asarray(live), c
    )
    got = TM.grouped_sum(
        torch.from_numpy(gid), torch.from_numpy(np.stack(vals)),
        torch.from_numpy(live), c,
    )
    assert len(got) == len(want_kernel) == len(vals) + 1
    for g, wk, wo in zip(got, want_kernel, want_oracle):
        assert np.array_equal(g.numpy(), np.asarray(wk))
        assert np.array_equal(g.numpy(), np.asarray(wo))


def test_out_of_range_group_ids_drop():
    gid = torch.tensor([0, 1, -1, 8, 2, 7], dtype=torch.int32)
    vals = torch.tensor([[1, 2, 4, 8, 16, 32]], dtype=torch.int64)
    live = torch.tensor([True, True, True, True, False, True])
    sums, count = TM.grouped_sum(gid, vals, live, 8)
    assert sums.tolist() == [1, 2, 0, 0, 0, 0, 0, 32]
    assert count.tolist() == [1, 1, 0, 0, 0, 0, 0, 1]


@pytest.mark.parametrize("values", [
    [torch.zeros(4, dtype=torch.int64)],       # a list, not one (k, n) tensor
    torch.zeros((1, 4), dtype=torch.int32),    # not int64
    torch.zeros((1, 5), dtype=torch.int64),    # length differs from gid
])
def test_grouped_sum_rejects_malformed_values(values):
    gid = torch.zeros(4, dtype=torch.int32)
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        TM.grouped_sum(gid, values, live, 8)


def test_column_split_covers_every_column():
    # the card splits (k+1) columns over gridDim.y once the (column, slot)
    # accumulators exceed the per-block budget
    assert TM.columns_per_block(14, 480) == 14
    assert TM.columns_per_block(14, 2048) == TM.SMEM_BUDGET // (2048 * 8)
    assert TM.columns_per_block(1, 2048) == 1


def _reduce_args(seed, n=5000, d0=5, d1=7):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, d0, n).astype(np.int64),
            rng.integers(0, d1, n).astype(np.int64)]
    valids = [rng.random(n) < 0.9, np.ones(n, dtype=bool)]
    mask = rng.random(n) < 0.8
    values = [rng.integers(-1000, 1000, n).astype(np.int64),
              np.ones(n, dtype=np.int64)]
    vvalids = [rng.random(n) < 0.95, None]
    return keys, valids, mask, values, vvalids, ("sum", "count"), (d0, d1), 64


def _as_jax(args):
    keys, valids, mask, values, vvalids, reds, dims, cap = args
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    return ([j(k) for k in keys], [j(v) for v in valids], j(mask),
            [j(v) for v in values], tuple(j(v) for v in vvalids), reds, dims, cap)


def _as_torch(args):
    keys, valids, mask, values, vvalids, reds, dims, cap = args
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    return ([t(k) for k in keys], [t(v) for v in valids], t(mask),
            [t(v) for v in values], tuple(t(v) for v in vvalids), reds, dims, cap)


def _assert_same_reduce(got, want):
    for g, w in zip(got[:5], want[:5]):
        gl = g if isinstance(g, (list, tuple)) else [g]
        wl = w if isinstance(w, (list, tuple)) else [w]
        assert len(gl) == len(wl)
        for ga, wa in zip(gl, wl):
            assert np.array_equal(np.asarray(ga), np.asarray(wa))
    assert int(got[5]) == int(want[5])
    assert bool(got[6]) == bool(want[6])


@pytest.mark.parametrize("seed", [4, 11])
def test_mxu_group_reduce_matches_reference(seed):
    args = _reduce_args(seed)
    want = JG.mxu_group_reduce(*_as_jax(args))
    got = TG.mxu_group_reduce(*_as_torch(args))
    _assert_same_reduce([_np(x) for x in got], want)


def test_mxu_group_reduce_matches_dense_group_reduce():
    args = _as_torch(_reduce_args(5))
    _assert_same_reduce(
        [_np(x) for x in TG.mxu_group_reduce(*args)],
        [_np(x) for x in TG.dense_group_reduce(*args)],
    )


def test_mxu_group_reduce_routes_through_grouped_sum(monkeypatch):
    calls = []
    plain = TM.grouped_sum_reference

    def spy(*a, **k):
        calls.append(a[3])
        return plain(*a, **k)

    monkeypatch.setattr(TM, "grouped_sum_reference", spy)
    TG.mxu_group_reduce(*_as_torch(_reduce_args(6)))
    assert calls == [6 * 8]  # (d0 + 1) * (d1 + 1) slots


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4_194_304, 13, 480), (1 << 18, 13, 2048),
                                   (1001, 1, 17)])
def test_kernel_matches_plain_on_the_card(shape, cuda_device):
    n, k, cap = shape
    gid, vals, live = _inputs(n, cap, k, seed=n % 97, live_frac=0.7)
    dev = cuda_device
    g = torch.from_numpy(gid).to(dev)
    v = torch.from_numpy(np.stack(vals)).to(dev)
    lv = torch.from_numpy(live).to(dev)
    before = TM.grouped_sum.launches
    got = TM.grouped_sum(g, v, lv, cap)
    want = TM.grouped_sum_reference(g, v, lv, cap)
    torch.cuda.synchronize()
    assert TM.grouped_sum.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,ids", [(1 << 20, "one_slot"), (4_194_304, "sorted"),
                                   (4097, "even"), (3, "even")])
def test_kernel_matches_plain_at_hard_shapes_on_the_card(n, ids, cuda_device):
    # one hot slot, long runs, one row past a tile, a tile of three rows
    gid, vals, live = _inputs(n, 480, 13, seed=n % 89, live_frac=0.9, ids=ids)
    dev = cuda_device
    g, v, lv = (torch.from_numpy(x).to(dev) for x in (gid, np.stack(vals), live))
    got = TM.grouped_sum(g, v, lv, 480)
    want = TM.grouped_sum_reference(g, v, lv, 480)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")
