"""The join's ops and the rank and gather kernels' plain versions.

trino_tpu_torch.ops.join against trino_tpu.ops.join on the same numpy
inputs: lo, counts, the permutation and the expanded (probe, build, ok)
triples are bit-equal. The windowed-rank and gather wrappers (on the
CPU, their plain versions) are held against numpy transcriptions of the
explorers' TPU kernels, and against copies of those Pallas bodies run in
interpret mode. Tests marked `cuda` hold each kernel against its plain
version on the card and skip without one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from trino_tpu.ops import join as JJ
from trino_tpu_torch.ops import gather_kernels as GK
from trino_tpu_torch.ops import join as TJ
from trino_tpu_torch.ops import window_rank as W


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a))
                                              for a in arrays]


def _join_case(name):
    """(build keys, build valids, build live, probe keys, probe valids,
    probe live) as numpy arrays."""
    rng = np.random.default_rng(sum(map(ord, name)))
    nb, npr = 300, 700
    if name == "duplicates":
        bk = [rng.integers(0, 40, nb)]
        pk = [rng.integers(0, 50, npr)]
    elif name == "nulls_and_dead":
        bk = [rng.integers(0, 100, nb)]
        pk = [rng.integers(0, 100, npr)]
    elif name == "all_dead_build":
        bk = [rng.integers(0, 10, 16)]
        pk = [rng.integers(0, 10, npr)]
        nb = 16
    elif name == "all_dead_probe":
        bk = [rng.integers(0, 10, nb)]
        pk = [rng.integers(0, 10, 16)]
        npr = 16
    elif name == "unique_wide":
        bk = [rng.integers(-(1 << 62), 1 << 62, nb)]
        pk = [np.concatenate([bk[0][:200], rng.integers(0, 1 << 62, npr - 200)])]
    elif name == "limb_pairs":
        # long-decimal keys as their two int64 limbs
        base = rng.integers(-(1 << 40), 1 << 40, (30, 2))
        bk = [base[rng.integers(0, 30, nb), 0], base[rng.integers(0, 30, nb), 1]]
        pi = rng.integers(0, 30, npr)
        pk = [base[pi, 0], base[pi, 1]]
    elif name == "multi_key":
        bk = [rng.integers(0, 6, nb).astype(np.int32), rng.integers(0, 5, nb),
              rng.integers(9000, 9004, nb).astype(np.int32)]
        pk = [rng.integers(0, 6, npr).astype(np.int32), rng.integers(0, 5, npr),
              rng.integers(9000, 9004, npr).astype(np.int32)]
    else:
        raise KeyError(name)
    null_frac = 0.1 if name in ("nulls_and_dead", "multi_key") else 0.0
    bv = [rng.random(nb) >= null_frac for _ in bk]
    pv = [rng.random(npr) >= null_frac for _ in pk]
    bl = rng.random(nb) >= (0.2 if name == "nulls_and_dead" else 0.0)
    pl_ = rng.random(npr) >= (0.2 if name == "nulls_and_dead" else 0.0)
    if name == "all_dead_build":
        bl[:] = False
    if name == "all_dead_probe":
        pl_[:] = False
    return bk, bv, bl, pk, pv, pl_


JOIN_CASES = ["duplicates", "nulls_and_dead", "all_dead_build", "all_dead_probe",
              "unique_wide", "limb_pairs", "multi_key"]


@pytest.mark.parametrize("name", JOIN_CASES)
def test_build_probe_expand_are_bit_equal(name):
    bk, bv, bl, pk, pv, pl_ = _join_case(name)
    jb, tb = _both(*bk, *bv, bl)
    jp, tp = _both(*pk, *pv, pl_)
    k = len(bk)
    jls = JJ.build_lookup(jb[:k], jb[k:2 * k], jb[-1])
    tls = TJ.build_lookup(tb[:k], tb[k:2 * k], tb[-1])
    assert np.array_equal(np.asarray(jls.sorted_hash).astype(np.int64),
                          tls.sorted_hash.numpy())
    assert np.array_equal(np.asarray(jls.perm), tls.perm.numpy())
    assert np.array_equal(np.asarray(jls.build_live), tls.build_live.numpy())
    jlo, jc, jt = JJ.probe_counts(jls, jp[:k], jp[k:2 * k], jp[-1])
    tlo, tc, tt = TJ.probe_counts(tls, tp[:k], tp[k:2 * k], tp[-1])
    assert np.array_equal(np.asarray(jlo), tlo.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert int(jt) == int(tt)
    cap = 16
    while cap < max(int(tt), 1):
        cap *= 2
    for verify in (True, False):
        want = JJ.expand_matches(jls, jp[:k], jp[k:2 * k], jlo, jc, cap, verify=verify)
        got = TJ.expand_matches(tls, tp[:k], tp[k:2 * k], tlo, tc, cap, verify=verify)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())
        pi, bi, ok = got
        assert bool(torch.all(pi[1:] >= pi[:-1]))  # _segment_any relies on it
    flags = TJ.probe_matched_flags(len(pl_), pi, ok)
    assert np.array_equal(
        np.asarray(JJ.probe_matched_flags(len(pl_), *[jnp.asarray(x.numpy()) for x in (pi, ok)])),
        flags.numpy())
    bflags = TJ.build_matched_flags(len(bl), bi, ok)
    assert np.array_equal(
        np.asarray(JJ.build_matched_flags(len(bl), *[jnp.asarray(x.numpy()) for x in (bi, ok)])),
        bflags.numpy())


def test_two_dimensional_limb_keys_verify_whole_pairs():
    # a (n, 2) limb-pair key column straight into the ops (the operators
    # split limbs; this holds the 2-D verify path): the verified pairs are
    # exactly the pairs whose both limbs agree
    rng = np.random.default_rng(5)
    base = rng.integers(-(1 << 40), 1 << 40, (20, 2))
    bkey, pkey = base[rng.integers(0, 20, 200)], base[rng.integers(0, 20, 500)]
    pkey[::7, 1] += 1  # same high limb, different low limb: never equal
    ones_b, ones_p = torch.ones(200, dtype=torch.bool), torch.ones(500, dtype=torch.bool)
    tbk, tpk = torch.from_numpy(bkey), torch.from_numpy(pkey)
    ls = TJ.build_lookup([tbk], [ones_b], ones_b)
    lo, counts, total = TJ.probe_counts(ls, [tpk], [ones_p], ones_p)
    cap = 1 << max(int(total) - 1, 1).bit_length()
    pi, bi, ok = TJ.expand_matches(ls, [tpk], [ones_p], lo, counts, cap)
    got = sorted(zip(pi[ok].tolist(), bi[ok].tolist()))
    eq = (pkey[:, None, :] == bkey[None, :, :]).all(-1)
    assert got == sorted(zip(*np.nonzero(eq)))


@pytest.mark.parametrize("n_sorted,n_q", [(1000, 3000), (129, 5)])
def test_sorted_run_bounds_with_sentinels_matches_reference(n_sorted, n_q):
    rng = np.random.default_rng(n_sorted + n_q)
    vals = rng.integers(0, 0xFFFFFFFE, n_sorted)
    vals[: n_sorted // 10] = 0xFFFFFFFF  # dead build rows
    vals[n_sorted // 10: n_sorted // 5] = 0xFFFFFFFD
    s = np.sort(vals).astype(np.uint32)
    q = np.concatenate([rng.choice(s, n_q), [0xFFFFFFFE, 0xFFFFFFFD, 0, 1]]).astype(np.uint32)
    jlo, jhi = JJ.sorted_run_bounds(jnp.asarray(s), jnp.asarray(q))
    tlo, thi = TJ.sorted_run_bounds(torch.from_numpy(s.astype(np.int64)),
                                    torch.from_numpy(q.astype(np.int64)))
    assert np.array_equal(np.asarray(jlo), tlo.numpy())
    assert np.array_equal(np.asarray(jhi), thi.numpy())


def test_sorted_run_bounds_of_empty_inputs():
    lo, hi = TJ.sorted_run_bounds(torch.zeros(0, dtype=torch.int64),
                                  torch.arange(5, dtype=torch.int64))
    assert lo.tolist() == hi.tolist() == [0] * 5
    lo, hi = TJ.sorted_run_bounds(torch.arange(5, dtype=torch.int64),
                                  torch.zeros(0, dtype=torch.int64))
    assert lo.numel() == hi.numel() == 0


def _bounds_case(name, dtype):
    """(sorted b, queries) as numpy arrays of `dtype`, values in the u32
    domain the reference's sorted_run_bounds takes."""
    rng = np.random.default_rng(sum(map(ord, name)))
    top = 0xFFFFFFFD if dtype == np.int64 else (1 << 31) - 2
    if name == "long_runs":  # runs of 300 and 1000 across window boundaries
        b = np.concatenate([rng.integers(0, top, 2000), np.full(300, 77),
                            np.full(1000, top // 2)])
    elif name == "sentinels":  # dead builds, queries that must find nothing
        b = np.concatenate([rng.integers(0, top, 900), np.full(150, 0xFFFFFFFF)])
    elif name == "n_b_lt_128":
        b = rng.integers(0, 50, 77)
    elif name == "n_b_ragged":
        b = rng.integers(0, top, 1000)
    elif name == "empty_b":
        b = np.zeros(0, np.int64)
    else:
        raise KeyError(name)
    b = np.sort(b)
    q = np.concatenate([rng.integers(0, top, 500), rng.choice(b, 300) if len(b) else [],
                        [0, top]])
    if name == "sentinels":
        q = np.concatenate([q, np.full(40, 0xFFFFFFFE)])
    return b.astype(dtype), q.astype(dtype)


@pytest.mark.parametrize("name,dtype", [
    (name, dtype)
    for dtype in (np.int32, np.int64)
    for name in ("long_runs", "sentinels", "n_b_lt_128", "n_b_ragged", "empty_b")
    if not (name == "sentinels" and dtype == np.int32)  # sentinels exceed int32
], ids=lambda v: v if isinstance(v, str) else np.dtype(v).name)
def test_bounds_plain_matches_sorted_run_bounds(name, dtype):
    b, q = _bounds_case(name, dtype)
    jlo, jhi = JJ.sorted_run_bounds(jnp.asarray(b.astype(np.uint32)),
                                    jnp.asarray(q.astype(np.uint32)))
    lo, hi = W.bounds(torch.from_numpy(q), torch.from_numpy(b))
    assert lo.dtype == hi.dtype == torch.int32
    assert np.array_equal(np.asarray(jlo), lo.numpy())
    assert np.array_equal(np.asarray(jhi), hi.numpy())
    assert np.array_equal(hi.numpy(), np.searchsorted(b, q, "right"))


def _run_owner_case(name):
    """(int32 counts, n_out)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "plateaus":  # zero-count rows between short runs
        counts = rng.integers(0, 3, 3000) * (rng.random(3000) < 0.4)
        return counts.astype(np.int32), int(counts.sum())
    if name == "n_out_past_total":
        counts = rng.integers(0, 4, 500)
        return counts.astype(np.int32), int(counts.sum()) + 333
    if name == "one_run_10000":
        counts = np.zeros(64, np.int64)
        counts[17] = 10_000
        counts[40:43] = 1
        return counts.astype(np.int32), 16_384
    raise KeyError(name)


@pytest.mark.parametrize("name", ["plateaus", "n_out_past_total", "one_run_10000"])
def test_run_owner_plain_matches_expand_matches(name):
    counts, n_out = _run_owner_case(name)
    n = len(counts)
    off = torch.cumsum(torch.from_numpy(counts), 0, dtype=torch.int32)
    got = W.run_owner(off, n_out)
    assert got.dtype == torch.int32 and got.shape == (n_out,)
    j = torch.arange(n_out, dtype=torch.int32)
    assert torch.equal(got, torch.searchsorted(off, j, right=True).to(torch.int32))
    # the reference's expansion clips its row index to the probe rows
    ls = JJ.LookupSource(jnp.zeros(16, jnp.uint32), jnp.arange(16, dtype=jnp.int32),
                         [], [], jnp.ones(16, bool))
    pi, _, _ = JJ.expand_matches(ls, [], [], jnp.zeros(n, jnp.int32),
                                 jnp.asarray(counts), n_out, verify=False)
    assert np.array_equal(np.asarray(pi), np.clip(got.numpy(), 0, n - 1))


def test_run_owner_of_no_rows_and_no_outputs():
    empty = torch.zeros(0, dtype=torch.int32)
    assert W.run_owner(empty, 5).tolist() == [0] * 5
    assert W.run_owner(torch.tensor([0, 2, 2], dtype=torch.int32), 0).numel() == 0


def test_bounds_and_run_owner_refuse_bad_arguments():
    a = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        W.bounds(a, a.to(torch.int32))
    with pytest.raises(ValueError):
        W.bounds(a, a.view(2, 2))
    with pytest.raises(ValueError):
        W.run_owner(a, 4)  # offsets are int32
    with pytest.raises(ValueError):
        W.run_owner(a.to(torch.int32), -1)


# ---------------------------------------------------------------------------
# windowed rank: the explorer's k0..k4 and the searched mode
# ---------------------------------------------------------------------------


def _np_window_rank(at, b2, nwin, edge):
    """numpy transcription of explore_kernel_costs.py's k0..k4 bodies."""
    acc = np.zeros(at.shape, np.int64)
    t = 0
    for w in range(nwin):
        acc += (b2[w][None, None, :] < at[:, :, None]).sum(-1)
        if edge:
            t += int(b2[w, 0]) + int(b2[w, 127])
    return ((acc + t + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


@pytest.mark.parametrize("nwin,edge", [(2, False), (2, True), (8, False)],
                         ids=["k0_k1_k2", "k3", "k4"])
def test_fixed_rank_matches_the_explorer_bodies(nwin, edge):
    rng = np.random.default_rng(0)
    at = rng.integers(0, 1 << 30, (1024, 8)).astype(np.int32)
    b2 = rng.integers(0, 1 << 30, (1024, 128)).astype(np.int32)
    got = W.rank(torch.from_numpy(at), torch.from_numpy(b2.reshape(-1)), False, 0, nwin, edge)
    assert np.array_equal(got.numpy(), _np_window_rank(at, b2, nwin, edge))


def _pallas_rank(body, at, b2):
    """A copy of the explorer's pallas_call wrapper, in interpret mode."""
    grid = at.shape[0] // 128
    with jax.enable_x64(False):
        return np.asarray(pl.pallas_call(
            body, grid=(grid,),
            in_specs=[pl.BlockSpec((128, 8), lambda i: (i, 0), memory_space=pltpu.VMEM),
                      pl.BlockSpec(b2.shape, lambda i: (0, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((128, 8), lambda i: (i, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(at.shape, jnp.int32),
            scratch_shapes=[pltpu.SMEM((2,), jnp.int32)], interpret=True,
        )(jnp.asarray(at), jnp.asarray(b2)))


def _window_body(nwin, edge, smem_start=False):
    """The k0/k2/k3/k4 body of explore_kernel_costs.py (k2 reads its
    window start from SMEM, set to 0 at program 0)."""

    def body(a_ref, b_ref, o_ref, cur):
        if smem_start:
            @pl.when(pl.program_id(0) == 0)
            def _():
                cur[0] = jnp.int32(0)
        acc = jnp.zeros((128, 8), jnp.int32)
        t = jnp.int32(0)
        for w in range(nwin):
            if edge:
                t = t + b_ref[w, 0] + b_ref[w, 127]
            b_win = b_ref[w: w + 1, :]
            cols = []
            for c in range(8):
                a_col = a_ref[:, c: c + 1]
                cols.append(acc[:, c: c + 1] + jnp.sum(
                    (b_win < a_col).astype(jnp.int32), axis=1, keepdims=True,
                    dtype=jnp.int32))
            acc = jnp.concatenate(cols, axis=1)
        o_ref[:, :] = acc + t

    return body


@pytest.mark.parametrize("nwin,edge,smem", [(2, False, False), (2, False, True),
                                            (2, True, False), (8, False, False)],
                         ids=["k0", "k2", "k3", "k4"])
def test_fixed_rank_matches_pallas_bodies_in_interpret_mode(nwin, edge, smem):
    rng = np.random.default_rng(1)
    at = rng.integers(0, 1 << 30, (256, 8)).astype(np.int32)
    b2 = rng.integers(0, 1 << 30, (1024, 128)).astype(np.int32)
    want = _pallas_rank(_window_body(nwin, edge, smem), at, b2)
    got = W.rank(torch.from_numpy(at), torch.from_numpy(b2.reshape(-1)), False, 0, nwin, edge)
    assert np.array_equal(got.numpy(), want)


def test_fixed_rank_counts_only_positions_inside_b():
    rng = np.random.default_rng(2)
    a = rng.integers(-1000, 1000, 77).astype(np.int64)
    b = rng.integers(-1000, 1000, 1000).astype(np.int64)
    got = W.rank(torch.from_numpy(a), torch.from_numpy(b), False, 7, 2)
    tail = b[7 * 128:]  # windows 7 and 8 hold only 104 positions
    want = 7 * 128 + (tail[None, :] < a[:, None]).sum(1)
    assert np.array_equal(got.numpy(), want)
    for searched in (False, True):
        empty = W.rank(torch.from_numpy(a), torch.zeros(0, dtype=torch.int64), searched)
        assert empty.tolist() == [0] * 77
    assert W.rank(torch.from_numpy(a[:0]), torch.from_numpy(b), True).numel() == 0


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_searched_rank_is_the_lower_bound(dtype):
    rng = np.random.default_rng(3)
    hi = (1 << 31) - 2 if dtype == np.int32 else 1 << 40
    b = np.sort(rng.integers(-hi, hi, 10_001)).astype(dtype)
    b[100:400] = b[100]  # a run across window boundaries
    a = np.concatenate([rng.integers(-hi, hi, 3000), b[::5], [b[0], b[-1]]]).astype(dtype)
    got = W.rank(torch.from_numpy(a), torch.from_numpy(b), True)
    assert np.array_equal(got.numpy(), np.searchsorted(b, a, "left"))


def test_rank_wrapper_refuses_bad_arguments():
    a = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        W.rank(a, a.to(torch.int32), True)
    with pytest.raises(ValueError):
        W.rank(a, a, True, nwin=2)
    with pytest.raises(ValueError):
        W.rank(a, a, False, 0, 2, edge=True)  # edge sums are int32 only
    with pytest.raises(ValueError, match="unsupported device"):
        W.rank(a.to("meta"), a.to("meta"), True)


# ---------------------------------------------------------------------------
# gathers: the explorer's v1, v2, v3
# ---------------------------------------------------------------------------


def _pallas_gather(body, tab, ix, block_in, block_out, out_shape, grid):
    with jax.enable_x64(False):
        return np.asarray(pl.pallas_call(
            body, grid=(grid,),
            in_specs=[pl.BlockSpec(tab.shape, lambda i: (0, 0), memory_space=pltpu.VMEM),
                      pl.BlockSpec(block_in, lambda i: (i, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(block_out, lambda i: (i, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32), interpret=True,
        )(jnp.asarray(tab), jnp.asarray(ix)))


def test_take_flat_matches_v1():
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 30, 1 << 12).astype(np.int32)
    idx = rng.integers(0, 1 << 12, (4, 256)).astype(np.int32)
    got = GK.take_flat(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    assert np.array_equal(got, table[idx])  # the explorer's own check

    def k1(tab_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take(tab_ref[:].reshape(-1), idx_ref[:].reshape(-1),
                              axis=0).reshape(out_ref.shape)

    want = _pallas_gather(k1, table.reshape(-1, 128), idx, (1, 256), (1, 256), idx.shape, 4)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tdtype,idtype", [(np.int32, np.int32), (np.int64, np.int64),
                                           (np.int64, np.int32), (np.float32, np.int64)])
def test_take_flat_clips_like_the_reference(tdtype, idtype):
    rng = np.random.default_rng(1)
    table = rng.integers(-(1 << 30), 1 << 30, 1001).astype(tdtype)
    idx = rng.integers(-20, 1030, 3001).astype(idtype)
    got = GK.take_flat(torch.from_numpy(table), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), table[np.clip(idx, 0, 1000)])
    assert GK.take_flat(torch.from_numpy(table), torch.zeros(0, dtype=torch.int32)).numel() == 0


def _flat_edge(case, dev="cpu"):
    """(table, idx) on `dev` at an edge of take_flat's layout (a warp takes
    chunks of 128 outputs): `case` is (table kind, index dtype, offset of
    the index view, its length)."""
    tkind, idtype, off, n = case
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, 1001)).to(dev)
    if tkind == "int32":
        table = table.to(torch.int32)
    elif tkind == "view":
        table = table[1:]
    idx = torch.from_numpy(rng.integers(-3, 1004, 300)).to(idtype).to(dev)
    return table, idx[off:off + n]


FLAT_EDGES = [(tkind, idtype, off, n)
              for tkind, idtype in (("int32", torch.int32), ("int64", torch.int64),
                                    ("view", torch.int32))
              for off in (0, 1) for n in (0, 1, 4, 5, 127, 129)]


@pytest.mark.parametrize("case", FLAT_EDGES, ids=str)
def test_take_flat_edges_match_numpy(case):
    table, idx = _flat_edge(case)
    want = table.numpy()[np.clip(idx.numpy(), 0, table.shape[0] - 1)]
    got = GK.take_flat(table, idx)
    assert got.dtype == table.dtype and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,sms,ilp", [
    (0, 132, 1), (1024, 132, 1), (262_143, 256, 1),
    (135_167, 132, 1), (135_168, 132, 4),       # a block's chunk (1,024) for every SM
    (262_144, 132, 4), (1 << 25, 132, 4), (1024, 1, 4),
])
def test_flat_ilp_gathers_four_a_thread_once_every_sm_has_a_block(n, sms, ilp):
    assert GK.flat_ilp(n, sms) == ilp


def test_take_rows_sum_matches_v2_mod_2_32():
    rng = np.random.default_rng(0)
    table2d = rng.integers(0, 1 << 30, (64, 128)).astype(np.int32)
    ridx = rng.integers(0, 64, (4, 512)).astype(np.int32)
    got = GK.take_rows_sum(torch.from_numpy(table2d), torch.from_numpy(ridx)).numpy()
    # the explorer's own check sums in int64; the kernel's int32 sum wraps
    wide = table2d[ridx].sum(axis=-1)
    assert np.array_equal(got, wide.astype(np.uint32).view(np.int32))

    def k2(tab_ref, idx_ref, out_ref):
        rows = jnp.take(tab_ref[:], idx_ref[0, :], axis=0)
        out_ref[0, :] = jnp.sum(rows, axis=1)

    want = _pallas_gather(k2, table2d, ridx, (1, 512), (1, 512), ridx.shape, 4)
    assert np.array_equal(got, want)


def test_take_rows_sum_clips_rows():
    table2d = torch.arange(6 * 100, dtype=torch.int32).reshape(6, 100)
    got = GK.take_rows_sum(table2d, torch.tensor([-3, 0, 5, 9], dtype=torch.int64))
    sums = table2d.to(torch.int64).sum(1)
    assert got.tolist() == [sums[0], sums[0], sums[5], sums[5]]


def _k2(tab_ref, idx_ref, out_ref):
    rows = jnp.take(tab_ref[:], idx_ref[0, :], axis=0)
    out_ref[0, :] = jnp.sum(rows, axis=1)


@pytest.mark.parametrize("case", ["more_rows_than_indices", "single_row_table",
                                  "int64_indices_clip_both_ends"])
def test_take_rows_sum_shapes_match_v2(case):
    # the card kernel picks its path by shape (a row's sum once per row,
    # or once per output); every shape keeps v2's function. v2 itself
    # takes in-range rows, so it gets the indices clipped.
    rng = np.random.default_rng(len(case))
    big = (1 << 31) - 1
    if case == "more_rows_than_indices":
        table2d = rng.integers(-big - 1, big, (3000, 128)).astype(np.int32)
        ridx = rng.integers(0, 3000, (1, 512)).astype(np.int32)
    elif case == "single_row_table":
        table2d = rng.integers(-big - 1, big, (1, 128)).astype(np.int32)
        ridx = rng.integers(-2, 3, (2, 512)).astype(np.int32)
    else:
        table2d = rng.integers(-big - 1, big, (64, 128)).astype(np.int32)
        ridx = rng.integers(-(1 << 40), 1 << 40, (2, 512))
        ridx[0, :6] = [-(1 << 62), -1, 0, 63, 64, 1 << 62]
    got = GK.take_rows_sum(torch.from_numpy(table2d), torch.from_numpy(ridx)).numpy()
    assert got.shape == ridx.shape and got.dtype == np.int32
    clipped = np.clip(ridx, 0, table2d.shape[0] - 1).astype(np.int32)
    wide = table2d.astype(np.int64)[clipped].sum(axis=-1)
    assert np.array_equal(got, wide.astype(np.uint32).view(np.int32))
    want = _pallas_gather(_k2, table2d, clipped, (1, 512), (1, 512), ridx.shape,
                          ridx.shape[0])
    assert np.array_equal(got, want)


def test_rows_sum_path_reads_fewer_bytes():
    # sum every row once while the table has no more rows than indices
    assert GK.rows_sum_path(1024, 1 << 20) == "row_sums"
    assert GK.rows_sum_path(1, 1) == "row_sums"
    assert GK.rows_sum_path(1_000_000, 1000) == "per_output"
    assert GK.rows_sum_path(5, 0) == "per_output"


def test_take_along_lanes_matches_v3():
    rng = np.random.default_rng(0)
    sel = rng.integers(0, 128, (128, 128)).astype(np.int32)
    src = rng.integers(0, 1 << 30, (128, 128)).astype(np.int32)
    got = GK.take_along_lanes(torch.from_numpy(src), torch.from_numpy(sel)).numpy()
    assert np.array_equal(got, np.take_along_axis(src, sel, axis=1))

    def k3(src_ref, sel_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(src_ref[:], sel_ref[:], axis=1)

    with jax.enable_x64(False):
        want = np.asarray(pl.pallas_call(
            k3, grid=(2,),
            in_specs=[pl.BlockSpec((64, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
                      pl.BlockSpec((64, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((64, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(src.shape, jnp.int32), interpret=True,
        )(jnp.asarray(src), jnp.asarray(sel)))
    assert np.array_equal(got, want)
    clipped = GK.take_along_lanes(torch.from_numpy(src),
                                  torch.from_numpy(np.full_like(sel, 200)))
    assert np.array_equal(clipped.numpy(), np.repeat(src[:, 127:], 128, axis=1))


@pytest.mark.parametrize("width", [128, 100])
def test_take_along_lanes_widths_match_numpy(width):
    rng = np.random.default_rng(width)
    src = rng.integers(-(1 << 31), (1 << 31) - 1, (300, width)).astype(np.int32)
    sel = rng.integers(-5, width + 5, (300, width)).astype(np.int32)
    got = GK.take_along_lanes(torch.from_numpy(src), torch.from_numpy(sel)).numpy()
    assert np.array_equal(got, np.take_along_axis(src, np.clip(sel, 0, width - 1), axis=1))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with `pytest -m cuda` on one)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("searched,nwin,edge,dtype", [
    (False, 2, False, torch.int32), (False, 2, True, torch.int32),
    (False, 8, False, torch.int32), (True, 1, False, torch.int64),
    (True, 1, False, torch.int32),
])
def test_rank_kernel_matches_plain_on_the_card(searched, nwin, edge, dtype, cuda_device):
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(0, 1 << 30, 100_003)).to(dtype).to(cuda_device)
    b = torch.from_numpy(rng.integers(0, 1 << 30, 70_001)).to(dtype).to(cuda_device)
    if searched:
        b, _ = torch.sort(b)
    got = W.rank(a, b, searched, 0, nwin, edge)
    assert torch.equal(got, W.rank_reference(a, b, searched, 0, nwin, edge))


@pytest.mark.cuda
def test_gather_kernels_match_plain_on_the_card(cuda_device):
    rng = np.random.default_rng(5)
    dev = cuda_device
    table = torch.from_numpy(rng.integers(0, 1 << 40, 9999)).to(dev)
    idx = torch.from_numpy(rng.integers(-9, 10_010, 50_001)).to(dev)
    assert torch.equal(GK.take_flat(table, idx), GK.take_flat_reference(table, idx))
    t2 = torch.from_numpy(rng.integers(0, 1 << 30, (99, 128)).astype(np.int32)).to(dev)
    r = torch.from_numpy(rng.integers(-3, 103, 7777).astype(np.int32)).to(dev)
    assert torch.equal(GK.take_rows_sum(t2, r), GK.take_rows_sum_reference(t2, r))
    src = torch.from_numpy(rng.integers(0, 1 << 30, (1001, 128)).astype(np.int32)).to(dev)
    sel = torch.from_numpy(rng.integers(-5, 133, (1001, 128)).astype(np.int32)).to(dev)
    assert torch.equal(GK.take_along_lanes(src, sel), GK.take_along_lanes_reference(src, sel))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLAT_EDGES, ids=str)
def test_take_flat_edges_match_plain_on_the_card(case, cuda_device):
    table, idx = _flat_edge(case, cuda_device)
    assert torch.equal(GK.take_flat(table, idx), GK.take_flat_reference(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [-1, 0, 1, 129])
def test_take_flat_four_a_thread_matches_plain_on_the_card(extra, cuda_device):
    from trino_tpu_torch.ops import cuda_build

    full = GK.FLAT_THREADS * GK.FLAT_ILP * cuda_build.sm_count(cuda_device)
    rng = np.random.default_rng(extra + 2)
    table = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, 5000)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-3, 5003, full + extra)).to(cuda_device)
    assert GK.flat_ilp(idx.numel(), cuda_build.sm_count(cuda_device)) == (4 if extra >= 0 else 1)
    assert torch.equal(GK.take_flat(table, idx), GK.take_flat_reference(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1024, 1 << 20), (20_000, 777), (1, 5000)])
def test_take_rows_sum_paths_match_plain_on_the_card(rows, n, cuda_device):
    rng = np.random.default_rng(rows)
    t2 = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, (rows, 128)).astype(
        np.int32)).to(cuda_device)
    r = torch.from_numpy(rng.integers(-3, rows + 3, n)).to(cuda_device)
    assert torch.equal(GK.take_rows_sum(t2, r), GK.take_rows_sum_reference(t2, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_bounds_kernel_matches_plain_on_the_card(dtype, cuda_device):
    for name in ("long_runs", "sentinels", "n_b_lt_128", "n_b_ragged", "empty_b"):
        if name == "sentinels" and dtype == torch.int32:
            continue  # sentinels exceed int32
        b, q = _bounds_case(name, np.int64 if dtype == torch.int64 else np.int32)
        tb, tq = torch.from_numpy(b).to(cuda_device), torch.from_numpy(q).to(cuda_device)
        got, want = W.bounds(tq, tb), W.bounds_reference(tq, tb)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


@pytest.mark.cuda
def test_run_owner_kernel_matches_plain_on_the_card(cuda_device):
    for name in ("plateaus", "n_out_past_total", "one_run_10000"):
        counts, n_out = _run_owner_case(name)
        off = torch.cumsum(torch.from_numpy(counts), 0, dtype=torch.int32).to(cuda_device)
        assert torch.equal(W.run_owner(off, n_out), W.run_owner_reference(off, n_out)), name


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 100])
def test_take_along_lanes_kernel_matches_plain_on_the_card(width, cuda_device):
    rng = np.random.default_rng(width)
    src = torch.from_numpy(rng.integers(0, 1 << 30, (1001, width)).astype(np.int32))
    sel = torch.from_numpy(rng.integers(-5, width + 5, (1001, width)).astype(np.int32))
    src, sel = src.to(cuda_device), sel.to(cuda_device)
    assert torch.equal(GK.take_along_lanes(src, sel), GK.take_along_lanes_reference(src, sel))
