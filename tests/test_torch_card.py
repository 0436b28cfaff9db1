"""The port's kernels on the card, against their plain versions.

Runs on a machine with an NVIDIA card and no jax: it imports neither jax
nor trino_tpu nor tests/conftest.py. Run it there with

    python -m pytest --noconftest tests/test_torch_card.py

(chip_smoke.py's phase serve does, and fails its run if pytest fails;
phase adaptive runs the checkpoint and salted-exchange cases). Without a
card every case skips.

Each kernel (grouped_sum, bounds, run_owner, take_flat, take_rows_sum,
take_along_lanes and the searched and fixed rank) is held bit for bit
against its plain version on the same CUDA tensors, at ordinary shapes
and on the all-dead batches the warmers feed: rows that are all dead, a
probe into a build whose rows are all dead, zero counts, zero indices.
A wrapper given an empty result launches nothing and returns what its
plain version returns; the next non-empty call launches again. In a
fresh process whose first use of the kernels is a mesh program's warm,
the launches after it still match their plain versions.

The recovery and skew tiers on the card: a join carry and a group carry
of four shards of the card, snapshot to the host and restored, equal the
carries before, each shard with its own storage; the salted exchange of
a skew-annotated join on four shards of the card equals the same
exchange over CPU shards (the plain ops).

The replica plane on the card: a parked GROUP BY carry on two shards of
the card frees at least half its bytes while parked (memory_allocated,
not the caching allocator's reserve) and comes back equal, each shard
with its own storage; a work-stealing merge on two shards of the card
equals the same merge over CPU shards (chip_smoke.py's phase replicas
runs these two).
"""

import numpy as np
import pytest
import torch

# imported by its own name, from this directory (pytest puts it on sys.path):
# a machine may install another package named `tests`
from torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu_torch.ops import gather_kernels as GK
from trino_tpu_torch.ops import mxu_groupby as MG
from trino_tpu_torch.ops import window_rank as W

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _equal(got, want):
    torch.cuda.synchronize()
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


# ---- grouped_sum ----------------------------------------------------------------


@pytest.mark.parametrize("n,k,cap,live_frac", [(4096, 3, 480, 0.7), (1 << 20, 13, 2048, 0.5),
                                               (65536, 9, 16, 0.0), (1 << 20, 13, 480, 0.0)])
def test_grouped_sum(dev, n, k, cap, live_frac):
    rng = np.random.default_rng(n + k)
    gid = _t(rng.integers(0, cap, n).astype(np.int32), dev)
    vals = _t(rng.integers(-1 << 40, 1 << 40, (k, n)).astype(np.int64), dev)
    live = _t(rng.random(n) < live_frac, dev)
    before = MG.grouped_sum.launches
    _equal(MG.grouped_sum(gid, vals, live, cap), MG.grouped_sum_reference(gid, vals, live, cap))
    assert MG.grouped_sum.launches == before + 1


def test_grouped_sum_on_a_dead_zero_batch(dev):
    """The aggregation warmer's input: zero data, every row dead."""
    n, k, cap = 1 << 16, 7, 2048
    gid = torch.zeros(n, dtype=torch.int32, device=dev)
    vals = torch.zeros((k, n), dtype=torch.int64, device=dev)
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    got = MG.grouped_sum(gid, vals, live, cap)
    _equal(got, MG.grouped_sum_reference(gid, vals, live, cap))
    assert all(not bool(g.any()) for g in got)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    before = MG.grouped_sum.launches
    _equal(MG.grouped_sum(empty, torch.zeros((k, 0), dtype=torch.int64, device=dev),
                          torch.zeros(0, dtype=torch.bool, device=dev), cap),
           [torch.zeros(cap, dtype=torch.int64, device=dev)] * (k + 1))
    assert MG.grouped_sum.launches == before  # no zero-block grid


# ---- the join probe: bounds, run_owner, take_flat ----------------------------------


@pytest.mark.parametrize("n_q,n_b,dtype", [(4096, 65536, torch.int64),
                                           (1 << 20, 1 << 22, torch.int64),
                                           (100_000, 4096, torch.int32)])
def test_bounds(dev, n_q, n_b, dtype):
    rng = np.random.default_rng(n_q)
    info = np.iinfo(np.int64 if dtype == torch.int64 else np.int32)
    b = np.sort(rng.integers(-1000, 1000, n_b)).astype(info.dtype)
    q = rng.integers(-1100, 1100, n_q).astype(info.dtype)
    q[:3] = [info.max, info.min, b[0]]
    b_t, q_t = _t(b, dev), _t(q, dev)
    _equal(W.bounds(q_t, b_t), W.bounds_reference(q_t, b_t))


def test_bounds_into_a_dead_build(dev):
    """The join warmer's probe: the hashes of dead probe rows searched in
    the sorted hashes of a build whose rows are all dead, and in an
    empty build."""
    from trino_tpu_torch.ops import join as J

    dead = torch.zeros(4096, dtype=torch.bool, device=dev)
    key = torch.zeros(4096, dtype=torch.int64, device=dev)
    ls = J.build_lookup([key], [torch.ones_like(dead)], dead)
    ls_cpu = J.build_lookup([key.cpu()], [torch.ones_like(dead).cpu()], dead.cpu())
    q = torch.zeros(65536, dtype=torch.int64, device=dev)
    qd = torch.zeros(65536, dtype=torch.bool, device=dev)
    lo, counts, total = J.probe_counts(ls, [q], [torch.ones_like(qd)], qd)
    lo_c, counts_c, total_c = J.probe_counts(ls_cpu, [q.cpu()], [torch.ones_like(qd).cpu()],
                                             qd.cpu())
    torch.cuda.synchronize()
    assert torch.equal(lo.cpu(), lo_c) and torch.equal(counts.cpu(), counts_c)
    assert int(total) == int(total_c) == 0
    hashes = ls.sorted_hash
    _equal(W.bounds(hashes[:100], hashes), W.bounds_reference(hashes[:100], hashes))
    nothing = hashes[:0]
    before = W.bounds.launches
    _equal(W.bounds(hashes[:100], nothing), W.bounds_reference(hashes[:100], nothing))
    assert W.bounds.launches == before + 1


@pytest.mark.parametrize("n,n_out", [(4096, 65536), (1000, 16), (1 << 20, 1 << 21)])
def test_run_owner(dev, n, n_out):
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 4, n).astype(np.int32)
    off = _t(np.cumsum(counts).astype(np.int32), dev)
    _equal(W.run_owner(off, n_out), W.run_owner_reference(off, n_out))


def test_run_owner_over_zero_counts(dev):
    """A dead probe's expansion: every count zero."""
    off = torch.zeros(65536, dtype=torch.int32, device=dev)
    before = W.run_owner.launches
    _equal(W.run_owner(off, 16), W.run_owner_reference(off, 16))
    assert W.run_owner.launches == before + 1
    _equal(W.run_owner(off, 0), W.run_owner_reference(off, 0))
    assert W.run_owner.launches == before + 1  # an empty result launches nothing
    _equal(W.run_owner(off, 16), W.run_owner_reference(off, 16))
    assert W.run_owner.launches == before + 2  # and the next call launches again


def test_a_mesh_program_warm_before_the_first_launch_leaves_the_kernels_bound(dev):
    """A fresh process whose first use of the kernels is a mesh program's
    warm (a server's or a joining replica's warm-up) still hands each
    kernel its pointers whole: run_owner and take_flat then equal their
    plain versions."""
    import os
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from trino_tpu_torch.ops import gather_kernels as GK\n"
        "from trino_tpu_torch.ops import window_rank as W\n"
        "from trino_tpu_torch.parallel.mesh_chunk import _ProgramWarmer\n"
        "_ProgramWarmer(['cuda:0', 'cuda:0'])()\n"
        "off = torch.cumsum(torch.arange(4096, dtype=torch.int32) % 3, 0).to(torch.int32).cuda()\n"
        "got = W.run_owner(off, 4096).cpu()\n"
        "assert torch.equal(got, W.run_owner_reference(off.cpu(), 4096)), 'run_owner'\n"
        "table = torch.arange(1 << 20, dtype=torch.int64).cuda()\n"
        "idx = torch.arange(0, 1 << 20, 7, dtype=torch.int32).cuda()\n"
        "got = GK.take_flat(table, idx).cpu()\n"
        "assert torch.equal(got, GK.take_flat_reference(table.cpu(), idx.cpu())), 'take_flat'\n"
        "assert W.run_owner.launches == 1 and GK.take_flat.launches == 1\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]


@pytest.mark.parametrize("n_table,n,elem", [(65536, 4096, torch.int64), (1 << 22, 1 << 20, torch.int32),
                                            (17, 3, torch.int64)])
def test_take_flat(dev, n_table, n, elem):
    rng = np.random.default_rng(n_table)
    table = _t(rng.integers(-1 << 30, 1 << 30, n_table).astype(
        np.int64 if elem == torch.int64 else np.int32), dev)
    for idx_type in (np.int32, np.int64):
        idx = _t(rng.integers(-5, n_table + 5, n).astype(idx_type), dev)
        _equal(GK.take_flat(table, idx), GK.take_flat_reference(table, idx))


def test_take_flat_with_zero_and_no_indices(dev):
    table = torch.zeros(4096, dtype=torch.int64, device=dev)
    zero = torch.zeros(16, dtype=torch.int32, device=dev)
    before = GK.take_flat.launches
    _equal(GK.take_flat(table, zero), GK.take_flat_reference(table, zero))
    none = zero[:0]
    _equal(GK.take_flat(table, none), GK.take_flat_reference(table, none))
    assert GK.take_flat.launches == before + 1


# ---- the explorers' kernels and the rank ---------------------------------------------


def test_take_rows_sum(dev):
    rng = np.random.default_rng(3)
    table = _t(rng.integers(-1000, 1000, (4096, 128)).astype(np.int32), dev)
    ridx = _t(rng.integers(0, 4096, 2048).astype(np.int32), dev)
    _equal(GK.take_rows_sum(table, ridx), GK.take_rows_sum_reference(table, ridx))


def test_take_along_lanes(dev):
    rng = np.random.default_rng(4)
    src = _t(rng.integers(-1000, 1000, (2048, 128)).astype(np.int32), dev)
    sel = _t(rng.integers(0, 128, (2048, 128)).astype(np.int32), dev)
    _equal(GK.take_along_lanes(src, sel), GK.take_along_lanes_reference(src, sel))


@pytest.mark.parametrize("searched", [True, False])
def test_rank(dev, searched):
    rng = np.random.default_rng(5)
    a = _t(rng.integers(-1000, 1000, 8192).astype(np.int32), dev)
    b = _t(np.sort(rng.integers(-1000, 1000, 16384)).astype(np.int32), dev)
    _equal(W.rank(a, b, searched), W.rank_reference(a, b, searched))


# ---- the recovery and skew tiers on the card ------------------------------------


def _carry_shards(dev, n_shards, cap, seed, group):
    """One carry of `n_shards` shards of `cap` rows on `dev`: a join
    carry (bigint key, varchar, double) or a group carry (bigint key,
    sums and a count), the first rows of each shard live."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.block import Column, Dictionary, RelBatch

    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_shards):
        n_live = int(rng.integers(1, cap))
        live = _t(np.arange(cap) < n_live, dev)
        key = Column(T.BIGINT, _t(rng.integers(0, 1 << 40, cap), dev), live.clone())
        if group:
            cols = [key] + [Column(T.BIGINT, _t(rng.integers(-1 << 50, 1 << 50, cap), dev),
                                   live.clone()) for _ in range(3)]
        else:
            d = Dictionary([f"v{i}" for i in range(7)])
            cols = [key,
                    Column(T.VARCHAR, _t(rng.integers(0, 7, cap).astype(np.int32), dev),
                           _t(rng.random(cap) < 0.9, dev), d),
                    Column(T.DOUBLE, _t(rng.standard_normal(cap), dev), live.clone())]
        out.append(RelBatch(cols, live))
    return out


@pytest.mark.parametrize("grown", [False, True])
def test_checkpoint_restores_join_and_group_carries_onto_four_shards(dev, grown):
    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.parallel.mesh import ShardMesh
    from trino_tpu_torch.recovery import MeshCheckpoint

    devices = [torch.device("cuda", 0)] * 4
    cap = 4096
    carries = [_carry_shards(dev, 4, cap, 1, group=False),
               _carry_shards(dev, 4, cap, 2, group=True)]
    ck = MeshCheckpoint(next_chunk=3, n_chunks=6, chunk_cap=1024,
                        resolved_caps={"carry:f1": cap, "carry:f2": cap},
                        carries_host=tuple(mesh_chunk._carry_to_host(c) for c in carries),
                        tables=(), generations=())
    ck = MeshCheckpoint.from_bytes(ck.to_bytes())
    runner = mesh_chunk.ChunkedMeshRunner.__new__(mesh_chunk.ChunkedMeshRunner)
    runner.ex = type("Ex", (), {"mesh": ShardMesh(devices), "n": 4})()
    new_cap = 2 * cap if grown else cap
    record = mesh_chunk.MeshProgramRecord(
        n_chunks=6, chunk_cap=1024, resolved_caps={"carry:f1": new_cap, "carry:f2": new_cap},
        pctx_fids=(), carry_meta=(("out", 1), ("ctx", 2)), prelude_sps=[], stream_sps=[],
        flush_sps=[])
    restored = runner._restore_carries(ck, record)
    torch.cuda.synchronize()
    assert len(restored) == 2
    ptrs = set()
    for before, after in zip(carries, restored):
        assert len(after) == 4
        for old, new in zip(before, after):
            assert new.device.type == "cuda" and new.capacity == new_cap
            _equal(new.live[:cap], old.live)
            assert not bool(new.live[cap:].any())
            for a, b in zip(old.columns, new.columns):
                _equal(b.data[:cap], a.data)
                _equal(b.valid[:cap], a.valid_mask())
                assert b.dictionary == a.dictionary
                ptrs.add(b.data.data_ptr())
    assert len(ptrs) == sum(len(b.columns) for c in restored for b in c)


@pytest.mark.parametrize("role", ["build", "probe"])
def test_salted_exchange_on_the_card_equals_the_plain_ops(dev, role):
    from trino_tpu_torch import types as T
    from trino_tpu_torch.block import Column, RelBatch
    from trino_tpu_torch.parallel.mesh import ShardMesh
    from trino_tpu_torch.parallel.mesh_plan import _salted_exchange_hash

    rng = np.random.default_rng(11)
    cap, hot = 8192, (0, 3)
    shards = []
    for s in range(4):
        p = 1.0 / np.arange(1, 65) ** 1.4
        keys = rng.choice(64, size=cap, p=p / p.sum()).astype(np.int64)
        live = rng.random(cap) < 0.8
        vals = rng.integers(0, 100, cap)
        shards.append((keys, live, vals))

    def run(device):
        batches = [RelBatch([Column(T.BIGINT, _t(k, device), None),
                             Column(T.BIGINT, _t(v, device), None)], _t(lv, device))
                   for k, lv, v in shards]
        out = _salted_exchange_hash(ShardMesh([device] * 4), batches, [0], hot, role)
        return [(b.columns[0].data.cpu(), b.columns[1].data.cpu(), b.live_mask().cpu())
                for b in out]

    got, want = run(torch.device("cuda", 0)), run(torch.device("cpu"))
    assert len(got) == len(want) == 4
    for (gk, gv, gl), (wk, wv, wl) in zip(got, want):
        assert torch.equal(gl, wl)
        assert torch.equal(gk[gl], wk[wl]) and torch.equal(gv[gl], wv[wl])
    if role == "build":
        for key in hot:
            counts = {int((k[lv] == key).sum()) for k, _v, lv in got}
            assert len(counts) == 1 and counts.pop() > 0


# ---- the replica plane on the card ----------------------------------------------


class _Seat:
    """A scheduler seat that grants at once: park_wait reads what the
    card holds while the run is parked."""

    def __init__(self):
        self.parked_allocated = None

    def park_wait(self, done, total):
        torch.cuda.synchronize()
        self.parked_allocated = torch.cuda.memory_allocated()

    def park_refused(self):
        raise AssertionError("the park budget refused the snapshot")


def _runner_on(devices):
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.parallel.mesh import ShardMesh

    runner = mesh_chunk.ChunkedMeshRunner.__new__(mesh_chunk.ChunkedMeshRunner)
    runner.ex = type("Ex", (), {"mesh": ShardMesh(devices), "n": len(devices)})()
    runner.session = Session()
    runner.feed_tables = ()
    runner._run_stats = {"parks": 0, "unparks": 0}
    return runner


def _record(cap, kind, n_chunks=8):
    from trino_tpu_torch.parallel import mesh_chunk

    return mesh_chunk.MeshProgramRecord(
        n_chunks=n_chunks, chunk_cap=1024, resolved_caps={"carry:f1": cap},
        pctx_fids=(), carry_meta=((kind, 1),), prelude_sps=[], stream_sps=[], flush_sps=[])


def test_park_frees_the_carries_and_restores_them_each_shard_its_own(dev):
    """A chunked GROUP BY's carries on [cuda:0] * 2 parked: while the
    run waits, memory_allocated is down by at least half the carries'
    bytes; after the grant every shard's tensors are back, equal to
    before, each with storage of its own."""
    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.recovery import CHECKPOINTS
    from trino_tpu_torch.runtime.memory import batch_bytes

    cap = 1 << 20
    runner = _runner_on([torch.device("cuda", 0)] * 2)
    carries = [_carry_shards(dev, 2, cap, 5, group=True)]
    carry_bytes = sum(batch_bytes(b) for b in carries[0])
    want = mesh_chunk._carry_to_host(carries[0])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    seat = _Seat()
    key = ("card-park", 1)
    try:
        runner._park(key, _record(cap, "ctx"), carries, 3, 8, None, seat)
        torch.cuda.synchronize()
        assert before - seat.parked_allocated >= carry_bytes // 2, (
            before, seat.parked_allocated, carry_bytes)
        got = mesh_chunk._carry_to_host(carries[0])
        assert np.array_equal(got.live, want.live)
        for (_t1, d1, v1, _x), (_t2, d2, v2, _y) in zip(got.columns, want.columns):
            assert np.array_equal(d1, d2) and np.array_equal(v1, v2)
        ptrs = [t.data_ptr() for b in carries[0] for c in b.columns for t in (c.data, c.valid)]
        assert all(b.columns[0].data.device.type == "cuda" for b in carries[0])
        assert len(set(ptrs)) == len(ptrs)
        assert runner._run_stats == {"parks": 1, "unparks": 1}
    finally:
        CHECKPOINTS.discard(key)


def _append_carry(device, n_shards, cap, seed):
    """An append accumulator of `n_shards` shards: under half of each
    shard's rows live, packed at its front."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.block import Column, RelBatch

    rng = np.random.default_rng(seed)
    out = []
    for _s in range(n_shards):
        live = np.arange(cap) < int(rng.integers(0, cap // 2))
        out.append(RelBatch([Column(T.BIGINT, _t(rng.integers(0, 1 << 40, cap), device),
                                    _t(live, device)),
                             Column(T.DOUBLE, _t(rng.standard_normal(cap), device),
                                    _t(rng.random(cap) < 0.9, device))], _t(live, device)))
    return out


def test_a_steal_merge_on_the_card_equals_the_merge_on_cpu_shards(dev):
    """The primary's carries on 2 shards of the card merged with a
    helper's published carries equal the same merge over CPU shards."""
    import threading

    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.recovery import CHECKPOINTS, MeshCheckpoint

    cap = 1 << 16
    theirs = mesh_chunk._carry_to_host(_append_carry(torch.device("cpu"), 2, cap, 8))
    results = []
    for device in (torch.device("cuda", 0), torch.device("cpu")):
        runner = _runner_on([device] * 2)
        record = _record(cap, "out")
        steal = mesh_chunk.StealContext("merge", 4, ("steal", "card"), {"carry:f1": cap},
                                        done=threading.Event())
        CHECKPOINTS.put(steal.key, MeshCheckpoint(
            next_chunk=8, n_chunks=8, chunk_cap=1024, resolved_caps={"carry:f1": cap},
            carries_host=(theirs,), tables=(), generations=()))
        steal.done.set()
        merged = runner._steal_merge(record, [_append_carry(device, 2, cap, 7)], steal)
        assert merged is not None and merged[0][0].live.device.type == device.type
        results.append(mesh_chunk._carry_to_host(merged[0]))
    got, want = results
    assert np.array_equal(got.live, want.live)
    for (_a, d1, v1, _b), (_c, d2, v2, _d) in zip(got.columns, want.columns):
        assert np.array_equal(d1, d2) and np.array_equal(v1, v2)
