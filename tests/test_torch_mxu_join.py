"""The join-project route (trino_tpu_torch.ops.mxu_join and the planner's
selection of it) against trino_tpu. Ops level: the same seeded numpy
build and probe sides go through both packages (the reference's sums
through its Pallas kernel in interpret mode), with NULL keys and values,
dead rows, an empty build side and a forced 32-bit hash collision
between distinct build keys. Engine level: on tpch.tiny, the route on
equals the route off equals trino_tpu, and the route is selected exactly
when trino_tpu selects it. Tolerance: every output is an integer or a
string and must be bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.ops import join as JJ
from trino_tpu.ops import mxu_join as JMJ
from trino_tpu.runtime.metrics import METRICS
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.ops import join as TJ
from trino_tpu_torch.ops import mxu_groupby as TM
from trino_tpu_torch.ops import mxu_join as TMJ
from trino_tpu_torch.ops.hashing import hash32
from trino_tpu_torch.sql import local_planner as LP

KINDS = ("sum", "count", "count_star", "sum")
# two distinct keys whose 32-bit join hashes are equal
COLLIDING = (20568, 173077)


def _t(x):
    return torch.from_numpy(np.array(x))


def _sides(seed, n_build=48, n_probe=700, collide=False, empty_build=False):
    rng = np.random.default_rng(seed)
    bkey = rng.integers(0, 20, n_build).astype(np.int64) * 1000
    if collide:
        bkey[:3] = [COLLIDING[0], COLLIDING[1], COLLIDING[0]]
    bvalid = rng.random(n_build) >= 0.1
    blive = rng.random(n_build) >= 0.1
    if empty_build:
        blive[:] = False
    pool = np.concatenate([bkey, rng.integers(0, 40, 30) * 1000 + 7])
    pkey = rng.choice(pool, n_probe)
    pvalid = rng.random(n_probe) >= 0.1
    plive = rng.random(n_probe) >= 0.15
    args = [
        (rng.integers(-(2 ** 40), 2 ** 40, n_probe).astype(np.int64),
         rng.random(n_probe) >= 0.2),
        (rng.integers(-5, 5, n_probe).astype(np.int32), rng.random(n_probe) >= 0.3),
        (pkey, pvalid),  # count_star placeholder
        (rng.integers(0, 9, n_probe).astype(np.int32), np.zeros(n_probe, bool)),
    ]
    return (bkey, bvalid, blive), (pkey, pvalid, plive), args


def _reference(build, probe, args, hash_path=None):
    bkey, bvalid, blive = (jnp.asarray(x) for x in build)
    ls = JJ.build_lookup([bkey], [bvalid], blive)
    kid, kid_by_pos, distinct, n_distinct, pure = JMJ.build_key_analysis(
        bkey, bvalid, blive, ls.sorted_hash, ls.perm)
    hp = bool(pure) if hash_path is None else hash_path
    sums = JMJ.probe_page_sums(
        ls, kid_by_pos, distinct, n_distinct, *(jnp.asarray(x) for x in probe),
        tuple(jnp.asarray(d) for d, _ in args), tuple(jnp.asarray(v) for _, v in args),
        KINDS, int(bkey.shape[0]), True, True, hp)
    live, outs = JMJ.finalize_partials(kid, blive, sums, KINDS)
    return (kid, kid_by_pos, distinct, n_distinct, pure), sums, (live, outs)


def _port(build, probe, args, use_kernel=True, hash_path=None):
    bkey, bvalid, blive = (_t(x) for x in build)
    ls = TJ.build_lookup([bkey], [bvalid], blive)
    analysis = TMJ.build_key_analysis(bkey, bvalid, blive, ls.sorted_hash, ls.perm)
    kid, kid_by_pos, distinct, n_distinct, pure = analysis
    hp = bool(pure) if hash_path is None else hash_path
    sums = TMJ.probe_page_sums(
        ls, kid_by_pos, distinct, n_distinct, *(_t(x) for x in probe),
        [_t(d) for d, _ in args], [_t(v) for _, v in args], KINDS,
        int(bkey.shape[0]), use_kernel, hp)
    return analysis, sums, TMJ.finalize_partials(kid, blive, sums, KINDS)


def _same(got, want):
    assert np.array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))


def _assert_parity(ref, port):
    (rkid, rpos, rdist, rn, rpure), rsums, (rlive, routs) = ref
    (kid, pos, dist, n, pure), sums, (live, outs) = port
    _same(kid, rkid)
    _same(pos, rpos)
    _same(dist, rdist)
    assert int(n) == int(rn) and bool(pure) == bool(rpure)
    assert len(sums) == len(rsums)
    for g, w in zip(sums, rsums):
        _same(g, w)
    _same(live, rlive)
    for (gd, gv), (wd, wv) in zip(outs, routs):
        _same(gd, wd)
        _same(gv, wv)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_mxu_join_matches_reference(seed, use_kernel):
    build, probe, args = _sides(seed)
    ref = _reference(build, probe, args)
    assert bool(ref[0][4])  # no collision: the hash path
    _assert_parity(ref, _port(build, probe, args, use_kernel))


def test_mxu_join_searchsorted_path_on_a_hash_collision():
    bkey = torch.tensor(COLLIDING, dtype=torch.int64)
    ones = torch.ones(2, dtype=torch.bool)
    assert int(hash32([bkey[:1]], [ones[:1]])) == int(hash32([bkey[1:]], [ones[:1]]))
    build, probe, args = _sides(2, collide=True)
    build[1][:3] = True
    build[2][:3] = True
    ref = _reference(build, probe, args)
    assert not bool(ref[0][4])  # runs are no longer key-pure
    port = _port(build, probe, args)
    assert not bool(port[0][4])
    _assert_parity(ref, port)
    # both colliding keys still find their own build rows
    assert int(port[1][-1].sum()) == int(np.asarray(ref[1][-1]).sum()) > 0


def test_mxu_join_forced_paths_agree():
    """Either lookup is exact where the runs are key-pure."""
    build, probe, args = _sides(3)
    _assert_parity(_reference(build, probe, args, hash_path=False),
                   _port(build, probe, args, hash_path=False))
    a = _port(build, probe, args, hash_path=True)[1]
    b = _port(build, probe, args, hash_path=False)[1]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_mxu_join_empty_build():
    build, probe, args = _sides(4, empty_build=True)
    ref = _reference(build, probe, args)
    port = _port(build, probe, args)
    _assert_parity(ref, port)
    assert not bool(port[2][0].any())


def test_mxu_join_routes_by_shape_alone(monkeypatch):
    assert TMJ.uses_kernel(TM.MAX_CAPACITY, TM.MAX_ROWS)
    assert not TMJ.uses_kernel(TM.MAX_CAPACITY + 1, 16)
    assert not TMJ.uses_kernel(16, TM.MAX_ROWS + 1)
    calls = []

    def plain(gid, values, live, capacity):
        calls.append(capacity)
        return [torch.zeros(capacity, dtype=torch.int64)] * (values.shape[0] + 1)

    monkeypatch.setattr(TM, "grouped_sum_reference", plain)
    build, probe, args = _sides(5)
    _port(build, probe, args, use_kernel=True)
    _port(build, probe, args, use_kernel=False)
    assert calls == [48, 48]  # the kernel's wrapper on the CPU takes the plain sums


# ---------------------------------------------------------------------------
# engine level, tpch.tiny
# ---------------------------------------------------------------------------

Q_MXJ = """select p_brand, count(*), count(l_suppkey), sum(l_linenumber)
from lineitem join part on l_partkey = p_partkey
where p_size = 15 and p_type like '%BRASS'
group by p_brand order by p_brand"""

# NULL probe keys and values, NULL build keys and group keys, a SUM over
# only NULLs, and dead probe rows (the filter)
Q_NULLS = """select g, count(*), count(v), sum(v), sum(w)
from (select case when l_linenumber = 2 then null else l_partkey end as k,
             nullif(l_suppkey % 7, 3) as v,
             case when l_linenumber > 100 then l_linenumber end as w
      from lineitem where l_quantity < 30) l
join (select case when p_partkey % 11 = 0 then null else p_partkey end as pk,
             case when p_size > 40 then null else p_brand end as g
      from part where p_size < 45) p
on k = pk
group by g order by g"""

Q_EMPTY = """select p_brand, count(*), sum(l_linenumber)
from lineitem join part on l_partkey = p_partkey
where p_size = 1000 group by p_brand"""


def _runners(**session):
    ref = JRunner(JSession(catalog="tpch", schema="tiny", **session))
    ref.register_catalog("tpch", jtpch.create_tpch_connector())
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny", **session),
                            device="cpu")
    port.register_catalog("tpch", ttpch.create_tpch_connector())
    return ref, port


def _selected(runner_kind, run):
    if runner_kind == "ref":
        before = METRICS.snapshot().get("skew.mxu_join_selected", 0.0)
        rows = run()
        return rows, METRICS.snapshot().get("skew.mxu_join_selected", 0.0) - before
    before = LP.mxu_join_selected
    rows = run()
    return rows, LP.mxu_join_selected - before


ENGINE_QUERIES = {"q_mxj": Q_MXJ, "nulls": Q_NULLS, "empty_build": Q_EMPTY}


@pytest.mark.parametrize("name", sorted(ENGINE_QUERIES))
def test_route_on_equals_route_off_equals_reference(name, monkeypatch):
    sql = ENGINE_QUERIES[name]
    ref_on, port_on = _runners(mxu_join_enabled=True, mxu_join_min_work=0.0)
    _, port_off = _runners()
    calls = []
    plain = TM.grouped_sum_reference

    def spy(gid, values, live, capacity):
        calls.append(capacity)
        return plain(gid, values, live, capacity)

    monkeypatch.setattr(TM, "grouped_sum_reference", spy)
    want, ref_sel = _selected("ref", lambda: ref_on.execute(sql).rows)
    got, port_sel = _selected("port", lambda: port_on.execute(sql).rows)
    assert ref_sel == 1 and port_sel == 1
    assert got == want
    assert calls  # the sums went through the grouped_sum wrapper
    calls.clear()
    off, off_sel = _selected("port", lambda: port_off.execute(sql).rows)
    assert off_sel == 0 and not calls
    assert off == got
    if name == "empty_build":
        assert got == []
    else:
        assert got
    if name == "nulls":
        assert any(r[0] is None for r in got)  # the NULL group key
        assert all(r[4] is None for r in got)  # SUM over only NULLs


def test_route_not_selected_above_min_work():
    ref, port = _runners(mxu_join_enabled=True, mxu_join_min_work=1e12)
    want, ref_sel = _selected("ref", lambda: ref.execute(Q_MXJ).rows)
    got, port_sel = _selected("port", lambda: port.execute(Q_MXJ).rows)
    assert ref_sel == 0 and port_sel == 0
    assert got == want
