"""The mesh data plane of trino_tpu_torch (device="cpu", 8 CPU shards)
against trino_tpu: the slice as a whole, tests/test_mesh.py and
tests/test_parallel.py.

- The slice: one reference DistributedQueryRunner with the mesh on over
  its 8 CPU devices and the port's twin over `ShardMesh([cpu] * 8)` run
  TPC-H Q3 (a partitioned join, partial/final aggregation, a TopN at the
  root), a broadcast join with a GROUP BY (all_gather) and the mark
  join's IN under OR (psum of the build flags), plus a mark join over
  memory tables with NULL keys on both sides. Both report
  data_plane == "mesh"; integer, decimal and boolean columns are
  bit-equal, doubles within assert_rows_match's tolerance.
- tests/test_mesh.py runs as written on the port's names
  (tests/test_torch_distributed.portify, whose runners get 8 CPU
  shards), its TPC-H sweep marked as the corpus marks it; its jaxpr
  case becomes a port-side copy that counts the all_to_all.
  tests/test_parallel.py builds a jax Mesh itself: its three cases run
  here as port-side copies over the shard mesh.
- test_the_corpora_are_covered accounts for every case of the five mesh
  corpora (these two, and test_mesh_chunking.py, test_mesh_decimal.py
  and test_bucketed.py in tests/test_torch_mesh_chunking.py): each
  runs here, in a port-side copy (COPIES), or waits in WAITING for the
  item it names.
"""

import re

import numpy as np
import pytest
import torch

import tests.test_bucketed as bucketed_corpus
import tests.test_mesh as mesh_corpus
import tests.test_mesh_chunking as chunk_corpus
import tests.test_mesh_decimal as decimal_corpus
import tests.test_parallel as parallel_corpus
from tests.oracle import assert_rows_match
from tests.test_torch_distributed import MESH_DEVICES, _run, portify
from tests.test_torch_statements import _cases
from tests.test_torch_tpch_a import indexed_oracle
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from tests.tpch_queries import QUERIES
from trino_tpu import types as JT
from trino_tpu.connectors import memory as jmemory
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.connectors.spi import ColumnMetadata as JColumnMetadata
from trino_tpu.engine import Session as JSession
from trino_tpu.parallel import mesh_plan as jplan
from trino_tpu.runtime.coordinator import DistributedQueryRunner as JDistributed
from trino_tpu_torch import types as T
from trino_tpu_torch.block import Column, RelBatch
from trino_tpu_torch.connectors import memory as tmemory
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.connectors.spi import ColumnMetadata
from trino_tpu_torch.engine import Session
from trino_tpu_torch.ops.hashing import hash32, partition_of
from trino_tpu_torch.parallel import exchange as texchange
from trino_tpu_torch.parallel import mesh_plan
from trino_tpu_torch.parallel.mesh import ShardMesh
from trino_tpu_torch.runtime import DistributedQueryRunner

MESH = ShardMesh(MESH_DEVICES)


def port_mesh_runner(catalog="tpch", schema="tiny", connector=None, **session):
    r = DistributedQueryRunner(Session(catalog=catalog, schema=schema, **session),
                               n_workers=2, hash_partitions=2, device="cpu",
                               mesh_devices=MESH_DEVICES)
    r.register_catalog(catalog, connector or ttpch.create_tpch_connector())
    return r


@pytest.fixture(scope="module")
def runner():
    """The port's counterpart of tests/conftest.py's tpch_cluster."""
    return port_mesh_runner()


@pytest.fixture(scope="module")
def oracle():
    """The corpus's sqlite oracle (tpch at 0.01) with
    tests/test_torch_tpch_a.py's indexes: the same rows, and Q19 without
    a scan of lineitem per part."""
    conn = indexed_oracle()
    yield conn
    conn.close()


# ---- the slice against the reference ------------------------------------------

NULL_ROWS = 64


def _mark_tables():
    """Two memory tables whose keys hold NULLs: t1(k, v), t2(k2)."""
    rng = np.random.default_rng(17)
    k1 = rng.integers(0, 12, NULL_ROWS).astype(np.int64)
    v1 = np.arange(NULL_ROWS, dtype=np.int64)
    k2 = rng.integers(0, 12, 20).astype(np.int64)
    kv1 = rng.random(NULL_ROWS) > 0.2
    kv2 = rng.random(20) > 0.2
    return (k1, kv1, v1), (k2, kv2)


def _load_mark(conn, types, column_metadata):
    (k1, kv1, v1), (k2, kv2) = _mark_tables()
    conn.load_table("s", "t1", [column_metadata("k", types.BIGINT),
                                column_metadata("v", types.BIGINT)],
                    [k1, v1], [kv1, None])
    conn.load_table("s", "t2", [column_metadata("k2", types.BIGINT)], [k2], [kv2])
    return conn


SLICE = {
    "q3": QUERIES[3],
    "broadcast_group": (
        "select n_name, count(*), sum(s_acctbal), min(s_suppkey) from supplier, nation "
        "where s_nationkey = n_nationkey group by n_name order by n_name"),
    "mark": ("select count(*) from orders where o_custkey < 10 or o_orderkey in "
             "(select l_orderkey from lineitem where l_quantity > 48)"),
}
MARK_NULLS = "select v, k, k in (select k2 from t2) from t1 order by v"


@pytest.fixture(scope="module")
def ref_runners():
    r = JDistributed(JSession(catalog="tpch", schema="tiny"), n_workers=2, hash_partitions=2)
    r.register_catalog("tpch", jtpch.create_tpch_connector())
    m = JDistributed(JSession(catalog="memory", schema="s"), n_workers=2, hash_partitions=2)
    m.register_catalog("memory", _load_mark(jmemory.create_memory_connector(), JT,
                                            JColumnMetadata))
    return r, m


@pytest.fixture(scope="module")
def port_runners(runner):
    m = port_mesh_runner("memory", "s", _load_mark(tmemory.create_memory_connector(), T,
                                                   ColumnMetadata))
    return runner, m


def _same_rows(got, want):
    assert got.column_names == want.column_names
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types]
    exact = [i for i, t in enumerate(want.column_types) if not t.is_floating]
    assert [[r[i] for i in exact] for r in got.rows] == [[r[i] for i in exact]
                                                         for r in want.rows]
    assert_rows_match(got.rows, want.rows, ordered=True, abs_tol=1e-2)


@pytest.mark.parametrize("name", list(SLICE) + ["mark_nulls"])
def test_slice_rows_equal_the_reference_mesh(name, ref_runners, port_runners):
    sql = SLICE.get(name, MARK_NULLS)
    ref, port = (ref_runners[1], port_runners[1]) if name == "mark_nulls" else (
        ref_runners[0], port_runners[0])
    j0, t0 = dict(jplan.MESH_COUNTERS), mesh_plan.mesh_counters_snapshot()
    want = ref.execute(sql)
    got = port.execute(sql)
    assert want.data_plane == got.data_plane == "mesh"
    assert ref.last_mesh_fallback is None and port.last_mesh_fallback is None
    _same_rows(got, want)
    t1 = mesh_plan.mesh_counters_snapshot()
    assert t1["queries"] == t0["queries"] + 1
    if name == "broadcast_group":
        assert t1["all_gather"] > t0["all_gather"] and \
            jplan.MESH_COUNTERS["all_gather"] > j0["all_gather"]
    if name == "q3":
        assert t1["all_to_all"] > t0["all_to_all"]
    if name == "mark_nulls":
        assert any(r[2] is None for r in got.rows), "no three-valued IN row"


@pytest.mark.parametrize("sql", [SLICE["broadcast_group"], "select 1"],
                         ids=["broadcast_group", "single_fragment"])
def test_explain_analyze_names_the_data_plane_as_the_reference(sql, ref_runners, port_runners):
    """EXPLAIN ANALYZE's data-plane line (mesh_eligibility: the static
    collective census, or the fallback's reason) equals the reference's."""
    def line(r):
        text = r.execute("explain analyze " + sql).only_value()
        return [x for x in text.splitlines() if x.startswith("data_plane=")]

    assert line(port_runners[0]) == line(ref_runners[0])
    assert len(line(port_runners[0])) == 1


# ---- tests/test_mesh.py ------------------------------------------------------

_MESH_PLAIN = [n for _, n in _cases(mesh_corpus)
               if n not in ("test_mesh_tpch", "test_mesh_program_contains_collective")]


@pytest.mark.parametrize("qid", mesh_corpus.MESH_QUERIES)
def test_mesh_tpch(qid, runner, oracle, monkeypatch):
    portify(monkeypatch, mesh_corpus)
    mesh_corpus.test_mesh_tpch(qid, runner, oracle)


@pytest.mark.parametrize("name", _MESH_PLAIN)
def test_mesh_corpus(name, runner, oracle, monkeypatch):
    _run(mesh_corpus, name, monkeypatch, {"runner": lambda: runner, "oracle": lambda: oracle})


def test_mesh_program_contains_collective():
    """tests/test_mesh.py::test_mesh_program_contains_collective on the
    port: the FIXED_HASH exchange is one all_to_all over the shards (the
    port has no jaxpr; the counter moves once), every live row lands on
    the shard its key hashes to, and none is lost."""
    n = MESH.n
    data = torch.arange(16 * n, dtype=torch.int64)
    shards = [RelBatch([Column(T.BIGINT, data[s * 16:(s + 1) * 16],
                               torch.ones(16, dtype=torch.bool))],
                       torch.ones(16, dtype=torch.bool)) for s in range(n)]
    before = mesh_plan.mesh_counter("all_to_all")
    out = mesh_plan._exchange_hash(MESH, shards, [0])
    assert mesh_plan.mesh_counter("all_to_all") == before + 1
    got = []
    for d, b in enumerate(out):
        rows = b.columns[0].data[b.live_mask()]
        assert (partition_of(hash32([rows], [None]), n) == d).all()
        got.extend(rows.tolist())
    assert sorted(got) == data.tolist()


# ---- tests/test_parallel.py, on the shard mesh ---------------------------------


def _run_step(rows, n_groups, capacity, with_nulls=False):
    """tests/test_parallel.py::_run_step over ShardMesh([cpu] * 8)."""
    rng = np.random.default_rng(11)
    keys_np = rng.integers(0, n_groups, rows).astype(np.int64)
    vals_np = rng.integers(-50, 1000, rows).astype(np.int64)
    valid_np = rng.random(rows) > 0.1 if with_nulls else np.ones(rows, dtype=bool)
    live_np = rng.random(rows) > 0.05
    step = texchange.distributed_groupby_step(MESH, capacity, 1)
    ks, vs, used, sums, counts, overflowed = step(
        [torch.from_numpy(keys_np)], [torch.from_numpy(valid_np)], torch.from_numpy(live_np),
        [torch.from_numpy(vals_np)])
    assert int(overflowed.max()) == 0
    got = {}
    for k, kv, u, s, c in zip(ks[0].tolist(), vs[0].tolist(), used.tolist(),
                              sums[0].tolist(), counts.tolist()):
        if u:
            got[(int(k) if kv else 0, bool(kv))] = (int(s), int(c))
    want = {}
    for k, v, ok, lv in zip(keys_np, vals_np, valid_np, live_np):
        if not lv:
            continue
        kk = (int(k), True) if ok else (0, False)
        s, c = want.get(kk, (0, 0))
        want[kk] = (s + int(v), c + 1)
    return got, want


def test_distributed_groupby_matches_oracle():
    got, want = _run_step(rows=8 * 512, n_groups=100, capacity=256)
    assert got == want


def test_distributed_groupby_null_keys():
    """NULL is one group cluster-wide (validity is part of the key and
    the exchange hash), never one group per shard."""
    got, want = _run_step(rows=8 * 256, n_groups=40, capacity=128, with_nulls=True)
    got_null = [v for (k, ok), v in got.items() if not ok]
    want_null = [v for (k, ok), v in want.items() if not ok]
    assert len(got_null) == len(want_null) == 1
    assert got_null[0] == want_null[0]
    assert {k: v for k, v in got.items() if k[1]} == {k: v for k, v in want.items() if k[1]}


def test_groups_land_on_unique_shards():
    """Each group exists on exactly one shard after the exchange."""
    got, want = _run_step(rows=8 * 512, n_groups=64, capacity=256)
    assert sum(c for _, c in got.values()) == sum(c for _, c in want.values())


# ---- the corpora's coverage -------------------------------------------------

# corpus case -> the ROADMAP §1 item it waits for
WAITING: dict = {}
# corpus case -> the port-side copy that runs in its place (the case
# builds a jax Mesh or calls the reference's jnp hashing itself)
COPIES = {
    "test_mesh.py::test_mesh_program_contains_collective": "test_mesh_program_contains_collective",
    "test_parallel.py::test_distributed_groupby_matches_oracle":
        "test_distributed_groupby_matches_oracle",
    "test_parallel.py::test_distributed_groupby_null_keys": "test_distributed_groupby_null_keys",
    "test_parallel.py::test_groups_land_on_unique_shards": "test_groups_land_on_unique_shards",
    "test_bucketed.py::test_np_hash_is_lockstep_with_device_hash":
        "tests/test_torch_mesh_chunking.py::test_np_hash_is_lockstep_with_device_hash",
    # the compile regime's two cases (the first reads the port's counter)
    "test_mesh_chunking.py::test_second_execution_zero_relowerings":
        "tests/test_torch_compile.py::test_second_mesh_execution_builds_nothing",
    "test_mesh_chunking.py::test_warmup_registration":
        "tests/test_torch_compile.py::test_mesh_warmup_registration",
}


def test_the_corpora_are_covered():
    from tests.test_torch_mesh_chunking import BUCKETED, CHUNKING, DECIMAL

    ran = {"test_mesh.py::test_mesh_tpch"}
    ran |= {f"test_mesh.py::{n}" for n in _MESH_PLAIN}
    ran |= {f"test_mesh_chunking.py::{n}" for n in CHUNKING}
    ran |= {f"test_mesh_decimal.py::{n}" for n in DECIMAL}
    ran |= {f"test_bucketed.py::{n}" for n in BUCKETED}
    every = set()
    for f, module in (("test_mesh.py", mesh_corpus), ("test_parallel.py", parallel_corpus),
                      ("test_mesh_chunking.py", chunk_corpus),
                      ("test_mesh_decimal.py", decimal_corpus),
                      ("test_bucketed.py", bucketed_corpus)):
        every |= {f"{f}::{n}" for _, n in _cases(module)}
    assert every == ran | set(WAITING) | set(COPIES)
    assert not ran & set(WAITING) and not ran & set(COPIES) and not set(WAITING) & set(COPIES)
    assert all(re.match(r"item 13\.[34] ", v) for v in WAITING.values())
    assert len(mesh_corpus.FAST_MESH_QUERIES) == 10 and len(_MESH_PLAIN) == 8
    assert (len(CHUNKING), len(DECIMAL), len(BUCKETED)) == (7, 5, 8)


# ---- chip_smoke.py phase mesh ------------------------------------------------


def test_phase_mesh_statements_at_tiny():
    """chip_smoke.py phase mesh's statements at tiny on 4 CPU shards
    (the card runs them at sf1 on 4 shards of one card), its chunked
    reruns in 1,024-row chunks; its FAST query list is test_mesh.py's."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as CS

    assert CS.MESH_FAST_QUERIES == mesh_corpus.FAST_MESH_QUERIES
    steps = CS.mesh_identities("tiny", "cpu", [torch.device("cpu")] * CS.MESH_SHARDS,
                               lambda msg: None, chunk_rows=1024)
    assert set(steps) == {n for n, *_ in CS.MESH_STATEMENTS} | {
        f"{n}_chunked" for n in CS.MESH_CHUNKED}
    assert steps["supplier_nation"]["collectives"]["all_gather"] >= 1
    assert steps["custkey_group_chunked"]["chunks"] >= 2
    assert all(rec["attempts"] == 1 for rec in steps.values())
