"""The mesh plane's exchange and carry functions and the streaming group
table of trino_tpu_torch against trino_tpu, at 8 shards.

The same numpy inputs (seeded) go through the reference under
`shard_map` over the 8 CPU devices tests/conftest.py provides and
through the port over `ShardMesh([cpu] * 8)`. Every batch has a BIGINT
key with NULLs, a decimal(38,2) `(cap, 2)` column with NULLs, a
dictionary (varchar) column with NULLs and a boolean, and dead rows.
Integers, booleans, codes and limb pairs are compared bit-equal:

- per-row outputs (`_partition_ids`, `_scatter_to_blocks`,
  `_local_partition`, `_salted_local_partition`, `_slice_chunk`,
  `_accumulate`, `_pad_shards`, `_merge_out_carry`) array for array;
- the collectives (`_exchange_hash`, `_replicate`, both roles of
  `_salted_exchange_hash`) shard for shard, as the live rows in order:
  the port trims each received batch to the rung of its live rows,
  where the reference keeps the n * block rows of its static shape.

GroupTable is held to the reference's contract (tests/test_ops.py):
same key, same id; distinct keys, distinct ids; the group count; the
overflow flag; the set of slot keys (which row of a colliding set wins
a slot is backend-defined). distributed_groupby_step's groups equal the
reference's after sorting; its float32 sums within assert_rows_match's
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from tests.oracle import assert_rows_match
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu import types as JT
from trino_tpu.block import Column as JColumn, Dictionary as JDictionary, RelBatch as JRelBatch
from trino_tpu.jaxcfg import get_shard_map
from trino_tpu.ops import groupby as JG
from trino_tpu.parallel import exchange as jexchange
from trino_tpu.parallel import mesh_chunk as jchunk
from trino_tpu.parallel import mesh_plan as jplan
from trino_tpu_torch import types as T
from trino_tpu_torch.block import Column, Dictionary, RelBatch
from trino_tpu_torch.ops import groupby as G
from trino_tpu_torch.parallel import exchange as texchange
from trino_tpu_torch.parallel import mesh as tmesh
from trino_tpu_torch.parallel import mesh_chunk as tchunk
from trino_tpu_torch.parallel import mesh_plan as tplan

N_SHARDS = 8
AXIS = "shard"
WORDS = [f"w{i:02d}" for i in range(13)]
HOT = (3, 7)
shard_map = get_shard_map()


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:N_SHARDS]), (AXIS,))


@pytest.fixture(scope="module")
def tmesh8():
    return tmesh.ShardMesh([torch.device("cpu")] * N_SHARDS)


def columns_np(cap: int, seed: int):
    """Global (8 * cap,) columns: k BIGINT, amt decimal(38,2) limb
    pairs, s varchar codes, b boolean; each with validity; and live."""
    rng = np.random.default_rng(seed)
    n = N_SHARDS * cap
    k = rng.integers(0, 40, n).astype(np.int64)
    amt = np.stack([rng.integers(-3, 3, n), rng.integers(0, 1 << 62, n)], -1).astype(np.int64)
    s = rng.integers(0, len(WORDS), n).astype(np.int32)
    b = rng.random(n) > 0.5
    valids = [rng.random(n) > 0.15 for _ in range(4)]
    live = rng.random(n) > 0.2
    return [k, amt, s, b], valids, live


def _types(mod):
    return [mod.BIGINT, mod.DataType(mod.TypeKind.DECIMAL, 38, 2), mod.VARCHAR, mod.BOOLEAN]


def ref_batch(datas, valids, live):
    types = _types(JT)
    cols = [JColumn(t, jnp.asarray(d), jnp.asarray(v), JDictionary(WORDS) if t.is_string else None)
            for t, d, v in zip(types, datas, valids)]
    return JRelBatch(cols, jnp.asarray(live))


def port_shards(datas, valids, live, n=N_SHARDS):
    types = _types(T)
    cap = len(live) // n
    out = []
    for s in range(n):
        sl = slice(s * cap, (s + 1) * cap)
        cols = [Column(t, torch.from_numpy(np.ascontiguousarray(d[sl])),
                       torch.from_numpy(v[sl].copy()),
                       Dictionary(WORDS) if t.is_string else None)
                for t, d, v in zip(types, datas, valids)]
        out.append(RelBatch(cols, torch.from_numpy(live[sl].copy())))
    return out


def run_ref(jmesh, body, *args):
    """body per shard under shard_map over the 8 devices; the global
    outputs, on the host."""
    f = shard_map(body, mesh=jmesh, in_specs=tuple(PSpec(AXIS) for _ in args),
                  out_specs=PSpec(AXIS), check_vma=False)
    return jax.device_get(jax.jit(f)(*args))


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ref_shard_rows(batch, n=N_SHARDS):
    """Per shard, the live rows (each column's data and valid) in order
    of a reference global batch."""
    live = np_of(batch.live).astype(bool)
    cap = len(live) // n
    out = []
    for s in range(n):
        keep = live[s * cap:(s + 1) * cap]
        out.append([(np_of(c.data)[s * cap:(s + 1) * cap][keep],
                     np_of(c.valid_mask())[s * cap:(s + 1) * cap][keep]) for c in batch.columns])
    return out


def port_shard_rows(batches):
    out = []
    for b in batches:
        keep = np_of(b.live_mask()).astype(bool)
        out.append([(np_of(c.data)[keep], np_of(c.valid_mask())[keep]) for c in b.columns])
    return out


def assert_rows_equal(ref_rows, port_rows):
    """Bit-equal live rows shard for shard; data under a NULL is not
    compared."""
    assert len(ref_rows) == len(port_rows)
    for s, (rs, ps) in enumerate(zip(ref_rows, port_rows)):
        for i, ((rd, rv), (pd, pv)) in enumerate(zip(rs, ps)):
            assert np.array_equal(rv, pv), (s, i)
            assert np.array_equal(rd[rv], pd[pv]), (s, i)


def assert_batch_equal(ref, port_batches):
    """A reference global batch equal, array for array, to the port's
    shards concatenated (data under dead or NULL rows included)."""
    assert np.array_equal(np_of(ref.live_mask()),
                          np.concatenate([np_of(b.live_mask()) for b in port_batches]))
    for i, c in enumerate(ref.columns):
        assert np.array_equal(np_of(c.data),
                              np.concatenate([np_of(b.columns[i].data) for b in port_batches])), i
        assert np.array_equal(np_of(c.valid_mask()), np.concatenate(
            [np_of(b.columns[i].valid_mask()) for b in port_batches])), i
        assert (c.dictionary is None) == (port_batches[0].columns[i].dictionary is None)


CHANNELS = [[0], [1], [2], [0, 2, 3], [1, 2]]
LOCAL_CHANNELS = [[0], [2], [1, 2]]
ROLES = ["build", "probe"]
SALT_LOCAL = [(role, ch) for ch in ([0], [2]) for role in ROLES]
HOT_CHANNELS = [[0], [1], [2]]
SLICES = [0, 1, 3]
CARRIES = [(64, 10), (32, 20)]


@pytest.fixture(scope="module")
def data():
    return columns_np(64, 1)


def _ref_body(b):
    """Every per-shard and collective function of the reference over one
    shard's batch, in one program (one compile for the module)."""
    out = {}
    for i, ch in enumerate(CHANNELS):
        out[f"pid{i}"] = jplan._partition_ids(b, ch, N_SHARDS)
        out[f"ex{i}"] = jplan._exchange_hash(b, ch, N_SHARDS)
    pid = jplan._partition_ids(b, [0, 2], N_SHARDS)
    arrays = [a for c in b.columns for a in (c.data, c.valid_mask())]
    out["scatter"] = jplan._scatter_to_blocks(arrays, b.live_mask(), pid, N_SHARDS, b.capacity)
    out["rep"] = jplan._replicate(b)
    for i, ch in enumerate(LOCAL_CHANNELS):
        out[f"local{i}"] = jplan._local_partition(b, ch, N_SHARDS)
    for role in ROLES:
        out[f"salt_{role}"] = jplan._salted_exchange_hash(b, [0], N_SHARDS, HOT, role)
    for i, (role, ch) in enumerate(SALT_LOCAL):
        out[f"salt_local{i}"] = jplan._salted_local_partition(b, ch, N_SHARDS, HOT, role)
    for i, ch in enumerate(HOT_CHANNELS):
        out[f"hot{i}"] = jplan._hot_mask(b, ch, HOT)
    for k in SLICES:
        out[f"slice{k}"] = jchunk._slice_chunk(b, k, 16)
    return out


@pytest.fixture(scope="module")
def ref(jmesh, data):
    return run_ref(jmesh, _ref_body, ref_batch(*data))


@pytest.mark.parametrize("i", range(len(CHANNELS)), ids=[str(c) for c in CHANNELS])
def test_partition_ids(i, data, ref):
    got = np.concatenate([tplan._partition_ids(b, CHANNELS[i], N_SHARDS).numpy()
                          for b in port_shards(*data)])
    assert np.array_equal(np.asarray(ref[f"pid{i}"]), got)


def test_scatter_to_blocks(data, ref):
    want_blocks, want_live = ref["scatter"]
    got_blocks, got_live = [], []
    for b in port_shards(*data):
        pid = tplan._partition_ids(b, [0, 2], N_SHARDS)
        arrays = [a for c in b.columns for a in (c.data, c.valid_mask())]
        blocks, lb = tplan._scatter_to_blocks(arrays, b.live_mask(), pid, N_SHARDS, b.capacity)
        got_blocks.append(blocks)
        got_live.append(lb)
    assert np.array_equal(np.asarray(want_live), np.concatenate([x.numpy() for x in got_live]))
    for i, w in enumerate(want_blocks):
        assert np.array_equal(np.asarray(w), np.concatenate([g[i].numpy() for g in got_blocks]))


@pytest.mark.parametrize("i", range(len(CHANNELS)), ids=[str(c) for c in CHANNELS])
def test_exchange_hash(i, data, ref, tmesh8):
    got = tplan._exchange_hash(tmesh8, port_shards(*data), CHANNELS[i])
    assert_rows_equal(ref_shard_rows(ref[f"ex{i}"]), port_shard_rows(got))
    assert [c.dictionary for c in got[0].columns][2] == Dictionary(WORDS)


def test_replicate(data, ref, tmesh8):
    got = tplan._replicate(tmesh8, port_shards(*data))
    assert_rows_equal(ref_shard_rows(ref["rep"]), port_shard_rows(got))


@pytest.mark.parametrize("i", range(len(LOCAL_CHANNELS)), ids=[str(c) for c in LOCAL_CHANNELS])
def test_local_partition(i, data, ref):
    got = [tplan._local_partition(b, LOCAL_CHANNELS[i], N_SHARDS, s)
           for s, b in enumerate(port_shards(*data))]
    assert_batch_equal(ref[f"local{i}"], got)


@pytest.mark.parametrize("role", ROLES)
def test_salted_exchange_hash(role, data, ref, tmesh8):
    got = tplan._salted_exchange_hash(tmesh8, port_shards(*data), [0], HOT, role)
    assert_rows_equal(ref_shard_rows(ref[f"salt_{role}"]), port_shard_rows(got))


@pytest.mark.parametrize("i", range(len(SALT_LOCAL)),
                         ids=[f"{r}-{c}" for r, c in SALT_LOCAL])
def test_salted_local_partition(i, data, ref):
    """A dictionary key degrades to plain placement in both packages."""
    role, ch = SALT_LOCAL[i]
    got = [tplan._salted_local_partition(b, ch, N_SHARDS, HOT, role, s)
           for s, b in enumerate(port_shards(*data))]
    assert_batch_equal(ref[f"salt_local{i}"], got)


def test_hot_mask(data, ref):
    for i, ch in enumerate(HOT_CHANNELS):
        got = np.concatenate([tplan._hot_mask(b, ch, HOT).numpy() for b in port_shards(*data)])
        assert np.array_equal(np.asarray(ref[f"hot{i}"]), got), ch


@pytest.mark.parametrize("k", SLICES)
def test_slice_chunk(k, data, ref):
    got = [tchunk._slice_chunk(b, k, 16) for b in port_shards(*data)]
    assert_batch_equal(ref[f"slice{k}"], got)


def _carry_pair(seed: int, carry_cap: int, carry_live: int):
    """A carry of `carry_cap` rows a shard, its first `carry_live` rows
    live (packed at the front, as _accumulate keeps them), and a
    contribution of 32 rows a shard."""
    datas, valids, live = columns_np(carry_cap, seed)
    live = np.zeros_like(live)
    for s in range(N_SHARDS):
        live[s * carry_cap:s * carry_cap + carry_live] = True
    cdatas, cvalids, clive = columns_np(32, seed + 1)
    return (datas, valids, live), (cdatas, cvalids, clive)


@pytest.fixture(scope="module")
def ref_accumulate(jmesh):
    """The reference's _accumulate over both CARRIES cases, one program."""
    pairs = [_carry_pair(10, cap, n_live) for cap, n_live in CARRIES]

    def body(*batches):
        out = []
        for c, x in zip(batches[0::2], batches[1::2]):
            carry, flag = jchunk._accumulate(c, x)
            out.append((carry, flag[None]))
        return tuple(out)

    args = [ref_batch(*b) for pair in pairs for b in pair]
    return pairs, run_ref(jmesh, body, *args)


@pytest.mark.parametrize("i", range(len(CARRIES)), ids=[f"{c}-{n}" for c, n in CARRIES])
def test_accumulate(i, ref_accumulate):
    """(32, 20): 20 live rows plus about 26 more overflow 32; the flag
    carries the needed capacity in both packages."""
    pairs, outs = ref_accumulate
    carry, contrib = pairs[i]
    want, want_flag = outs[i]
    got, got_flag = [], []
    for c, x in zip(port_shards(*carry), port_shards(*contrib)):
        out, flag = tchunk._accumulate(c, x)
        got.append(out)
        got_flag.append(int(flag))
    assert list(np.asarray(want_flag)) == got_flag
    assert_batch_equal(want, got)


def _host(batch_np, mod_types, mod_col, mod_dict, mod_batch, as_tensor):
    datas, valids, live = batch_np
    conv = torch.from_numpy if as_tensor else np.asarray
    cols = [mod_col(t, conv(np.ascontiguousarray(d)), conv(v.copy()),
                    mod_dict(WORDS) if t.is_string else None)
            for t, d, v in zip(mod_types, datas, valids)]
    return mod_batch(cols, conv(live.copy()))


@pytest.mark.parametrize("new_cap", [64, 96, 128])
def test_pad_shards(new_cap):
    b = columns_np(64, 11)
    want = jchunk._pad_shards(_host(b, _types(JT), JColumn, JDictionary, JRelBatch, False),
                              N_SHARDS, 64, new_cap)
    got = tchunk._pad_shards(_host(b, _types(T), Column, Dictionary, RelBatch, True),
                             N_SHARDS, 64, new_cap)
    assert_batch_equal(want, [got])


@pytest.mark.parametrize("mine_live,theirs_live", [(10, 12), (30, 10), (0, 5), (7, 0)])
def test_merge_out_carry(mine_live, theirs_live):
    """Packed carries merge shard by shard; 30 + 10 overflows 32 rows
    (None in both packages), as does a carry whose rows are not packed."""
    def packed(seed, n_live):
        datas, valids, live = columns_np(32, seed)
        live = np.zeros_like(live)
        for s in range(N_SHARDS):
            live[s * 32:s * 32 + n_live] = True
        return datas, valids, live

    mine, theirs = packed(12, mine_live), packed(13, theirs_live)
    want = jchunk._merge_out_carry(
        _host(mine, _types(JT), JColumn, JDictionary, JRelBatch, False),
        _host(theirs, _types(JT), JColumn, JDictionary, JRelBatch, False), N_SHARDS)
    got = tchunk._merge_out_carry(
        _host(mine, _types(T), Column, Dictionary, RelBatch, True),
        _host(theirs, _types(T), Column, Dictionary, RelBatch, True), N_SHARDS)
    assert (want is None) == (got is None)
    if want is not None:
        assert_batch_equal(want, [got])
    if mine_live:
        unpacked = (mine[0], mine[1], np.roll(mine[2], 1))
        assert tchunk._merge_out_carry(
            _host(unpacked, _types(T), Column, Dictionary, RelBatch, True),
            _host(theirs, _types(T), Column, Dictionary, RelBatch, True), N_SHARDS) is None


# ---- the collectives ---------------------------------------------------------


def test_collectives_in_shard_order(tmesh8):
    xs = [torch.arange(16, dtype=torch.int64) + 100 * s for s in range(N_SHARDS)]
    a2a = tmesh.all_to_all(tmesh8, xs)
    for d in range(N_SHARDS):
        assert a2a[d].tolist() == [100 * s + 2 * d + j for s in range(N_SHARDS) for j in (0, 1)]
    ag = tmesh.all_gather(tmesh8, xs)
    assert all(torch.equal(g, torch.cat(xs)) for g in ag)
    ps = tmesh.psum(tmesh8, [torch.tensor(s) for s in range(N_SHARDS)])
    assert [int(p) for p in ps] == [sum(range(N_SHARDS))] * N_SHARDS


def test_shard_mesh_resolve():
    cpu = torch.device("cpu")
    assert tmesh.ShardMesh.resolve(None, cpu).devices == [cpu]
    assert tmesh.ShardMesh.resolve([cpu] * 8, cpu).n == 8
    assert tplan.MeshExecutor(None, None, devices=None, device="cpu").n == 1


# ---- GroupTable --------------------------------------------------------------


def _group_inputs(n_rows: int, n_keys: int, seed: int):
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, n_keys, n_rows).astype(np.int64)
    k2 = rng.integers(0, 3, n_rows).astype(np.int32)
    v1 = rng.random(n_rows) > 0.1
    v2 = rng.random(n_rows) > 0.1
    mask = rng.random(n_rows) > 0.1
    return [k1, k2], [v1, v2], mask


def _row_keys(keys, valids, mask):
    return [tuple(int(k[i]) if v[i] else None for k, v in zip(keys, valids)) if mask[i] else None
            for i in range(len(mask))]


def _slot_keys(table):
    used = np_of(table.slot_used).astype(bool)
    ks = [np_of(k) for k in table.slot_keys]
    vs = [np_of(v).astype(bool) for v in table.slot_valids]
    return sorted((tuple(int(k[i]) if v[i] else None for k, v in zip(ks, vs))
                   for i in np.nonzero(used)[0]), key=repr)


def _check_contract(gid, table, overflowed, keys, valids, mask, C, ref):
    """The table's contract and the reference's group count, overflow
    flag and slot keys."""
    gid = np_of(gid)
    rows = _row_keys(keys, valids, mask)
    by_key = {}
    for i, key in enumerate(rows):
        if key is None:
            assert gid[i] == C
        elif gid[i] < C:
            assert by_key.setdefault(key, gid[i]) == gid[i]  # same key, same id
    assert len(set(by_key.values())) == len(by_key)  # distinct keys, distinct ids
    rgid, rtable, rovf = ref
    assert bool(overflowed) == bool(rovf)
    assert int(table.num_groups()) == int(rtable.num_groups())
    assert _slot_keys(table) == _slot_keys(rtable)
    if not bool(overflowed):
        assert (gid < C).sum() == sum(k is not None for k in rows)
        # rows grouped together by the port are grouped together by the reference
        rg = np_of(rgid)
        pairs = {(int(g), int(r)) for g, r, k in zip(gid, rg, rows) if k is not None}
        assert len({g for g, _ in pairs}) == len(pairs) == len({r for _, r in pairs})


@pytest.mark.parametrize("n_rows,n_keys,capacity", [(64, 20, 64), (512, 60, 256),
                                                    (512, 200, 128)])
def test_group_table(n_rows, n_keys, capacity):
    """(512, 200, 128): more groups than slots, the overflow flag."""
    keys, valids, mask = _group_inputs(n_rows, n_keys, n_rows + n_keys)
    ref = JG.assign_group_ids([jnp.asarray(k) for k in keys], [jnp.asarray(v) for v in valids],
                              jnp.asarray(mask), capacity)
    gid, table, ovf = G.assign_group_ids([torch.from_numpy(k) for k in keys],
                                         [torch.from_numpy(v) for v in valids],
                                         torch.from_numpy(mask), capacity)
    _check_contract(gid, table, ovf, keys, valids, mask, capacity, ref)


def test_group_table_grows_and_streams():
    """A 64-slot table takes a first batch, grows to 256 (the remap
    moves every group) and takes a second batch with new keys, in both
    packages."""
    keys1, valids1, mask1 = _group_inputs(128, 30, 1)
    keys2, valids2, mask2 = _group_inputs(256, 90, 2)
    j = [lambda xs: [jnp.asarray(x) for x in xs], jnp.asarray]
    t = [lambda xs: [torch.from_numpy(x) for x in xs], torch.from_numpy]
    rg, rt, rovf = JG.assign_group_ids(j[0](keys1), j[0](valids1), j[1](mask1), 64)
    pg, pt, povf = G.assign_group_ids(t[0](keys1), t[0](valids1), t[1](mask1), 64)
    _check_contract(pg, pt, povf, keys1, valids1, mask1, 64, (rg, rt, rovf))
    rt2, rremap = JG.grow_table(rt, 256)
    pt2, premap = G.grow_table(pt, 256)
    assert _slot_keys(pt2) == _slot_keys(rt2) == _slot_keys(pt)
    used = np_of(pt.slot_used).astype(bool)
    assert (np_of(premap)[used] < 256).all() and (np_of(premap)[~used] == 256).all()
    ref = JG.insert_group_ids(rt2, j[0](keys2), j[0](valids2), j[1](mask2))
    gid, table, ovf = G.insert_group_ids(pt2, t[0](keys2), t[0](valids2), t[1](mask2))
    _check_contract(gid, table, ovf, keys2, valids2, mask2, 256, ref)


# ---- distributed_groupby_step ------------------------------------------------


def _groups(ks, vs, used, sums, counts):
    out = {}
    for k, v, u, s, c in zip(np_of(ks[0]), np_of(vs[0]), np_of(used), np_of(sums[0]),
                             np_of(counts)):
        if u:
            key = (int(k) if v else None, bool(v))
            assert key not in out  # every group on exactly one shard
            out[key] = (s.item(), int(c))
    return out


@pytest.mark.parametrize("floating", [False, True])
def test_distributed_groupby_step(floating, jmesh, tmesh8):
    rows, capacity = N_SHARDS * 256, 128
    rng = np.random.default_rng(11)
    keys_np = rng.integers(0, 40, rows).astype(np.int64)
    vals_np = (rng.random(rows) * 100 if floating
               else rng.integers(-50, 1000, rows)).astype(np.float64 if floating else np.int64)
    valid_np = rng.random(rows) > 0.1
    live_np = rng.random(rows) > 0.05
    sharding = NamedSharding(jmesh, PSpec(AXIS))
    put = lambda x: jax.device_put(jnp.asarray(x), sharding)  # noqa: E731
    want = jexchange.distributed_groupby_step(jmesh, AXIS, capacity, 1)(
        [put(keys_np)], [put(valid_np)], put(live_np), [put(vals_np)])
    got = texchange.distributed_groupby_step(tmesh8, capacity, 1)(
        [torch.from_numpy(keys_np)], [torch.from_numpy(valid_np)], torch.from_numpy(live_np),
        [torch.from_numpy(vals_np)])
    assert int(np.asarray(want[5]).max()) == int(got[5].max()) == 0
    assert got[3][0].dtype == (torch.float32 if floating else torch.int64)
    w, g = _groups(*want[:5]), _groups(*got[:5])
    assert sorted(w, key=repr) == sorted(g, key=repr)
    want_rows = sorted([[k[0], k[1], s, c] for k, (s, c) in w.items()], key=repr)
    got_rows = sorted([[k[0], k[1], s, c] for k, (s, c) in g.items()], key=repr)
    if floating:
        assert_rows_match(got_rows, want_rows, ordered=True)
    else:
        assert got_rows == want_rows
