"""The mesh data plane's chunked runner, long decimals and bucketed tables
on trino_tpu_torch (device="cpu", 8 CPU shards): tests/test_mesh_chunking.py,
test_mesh_decimal.py and test_bucketed.py run as written on the port's
names (tests/test_torch_distributed.portify, whose runners get 8 CPU
shards). The page-plane answers the chunking corpus holds every chunk
setting to come from a port runner with mesh_execution off.
test_bucketed.py's hash-lockstep case calls the reference's jnp hashing:
its port-side copy holds the port's hash32/partition_of to their numpy
replicas. tests/test_torch_mesh.py::test_the_corpora_are_covered
accounts for every case; the compile regime's two run in
tests/test_torch_compile.py.
"""

import numpy as np
import pytest
import torch

import tests.test_bucketed as bucketed_corpus
import tests.test_mesh_chunking as chunk_corpus
import tests.test_mesh_decimal as decimal_corpus
from tests.test_torch_distributed import _run, portify
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401

# the compile regime's two cases run in tests/test_torch_compile.py
_COMPILE_CASES = ("test_second_execution_zero_relowerings", "test_warmup_registration")
CHUNKING = [n for _, n in _cases(chunk_corpus) if n not in _COMPILE_CASES]
DECIMAL = [n for _, n in _cases(decimal_corpus)]
BUCKETED = [n for _, n in _cases(bucketed_corpus)
            if n != "test_np_hash_is_lockstep_with_device_hash"]


def _portify(mp, corpus) -> None:
    """portify, plus the decimal corpus's module-level decimal(38,2)
    type, built from the reference's types at import."""
    portify(mp, corpus)
    if corpus is decimal_corpus:
        from trino_tpu_torch import types as T

        mp.setattr(corpus, "DEC38", T.DataType(T.TypeKind.DECIMAL, 38, 2))


def _built(corpus, fixture, *args):
    """A corpus fixture's value, built on the port's names."""
    mp = pytest.MonkeyPatch()
    _portify(mp, corpus)
    try:
        return fixture.__wrapped__(*args)
    finally:
        mp.undo()


# ---- tests/test_mesh_chunking.py ---------------------------------------------


@pytest.fixture(scope="module")
def baseline_rows():
    """The page plane's answers, on the port (tests/conftest.py's
    tpch_cluster_mesh_off is the reference's)."""
    mp = pytest.MonkeyPatch()
    portify(mp, chunk_corpus)
    try:
        r = chunk_corpus.mk_runner(mesh_execution=False)
        return {"group": r.execute(chunk_corpus.Q_GROUP).rows,
                "join": r.execute(chunk_corpus.Q_JOIN).rows}
    finally:
        mp.undo()


@pytest.mark.parametrize("chunk_rows", [0, 8192, 4096, 512])
def test_chunked_results_identical(chunk_rows, baseline_rows, monkeypatch):
    portify(monkeypatch, chunk_corpus)
    chunk_corpus.test_chunked_results_identical(chunk_rows, baseline_rows)


@pytest.mark.parametrize("name", [n for n in CHUNKING if n != "test_chunked_results_identical"])
def test_mesh_chunking_corpus(name, baseline_rows, monkeypatch):
    _run(chunk_corpus, name, monkeypatch,
         {"baseline_rows": lambda: baseline_rows, "monkeypatch": lambda: monkeypatch})


# ---- tests/test_mesh_decimal.py ----------------------------------------------


@pytest.fixture(scope="module")
def decimal_data():
    return decimal_corpus.data.__wrapped__()


@pytest.fixture(scope="module")
def decimal_runners(decimal_data):
    return {"mesh_runner": _built(decimal_corpus, decimal_corpus.mesh_runner, decimal_data),
            "http_runner": _built(decimal_corpus, decimal_corpus.http_runner, decimal_data)}


@pytest.mark.parametrize("name", DECIMAL)
def test_mesh_decimal_corpus(name, decimal_data, decimal_runners, monkeypatch):
    _portify(monkeypatch, decimal_corpus)
    _run(decimal_corpus, name, monkeypatch,
         {"data": lambda: decimal_data, "mesh_runner": lambda: decimal_runners["mesh_runner"],
          "http_runner": lambda: decimal_runners["http_runner"]})


# ---- tests/test_bucketed.py --------------------------------------------------


@pytest.fixture(scope="module")
def bucketed_clusters():
    return {"bucketed_cluster": _built(bucketed_corpus, bucketed_corpus.bucketed_cluster),
            "unbucketed_cluster": _built(bucketed_corpus, bucketed_corpus.unbucketed_cluster)}


@pytest.mark.parametrize("name", BUCKETED)
def test_bucketed_corpus(name, bucketed_clusters, monkeypatch):
    _run(bucketed_corpus, name, monkeypatch,
         {k: (lambda v=v: v) for k, v in bucketed_clusters.items()})


def test_np_hash_is_lockstep_with_device_hash():
    """tests/test_bucketed.py's case on the port: hash32_np and
    partition_of_np match hash32 and partition_of bit for bit."""
    from trino_tpu_torch.ops.hashing import (
        dictionary_code_hashes, hash32, hash32_np, partition_of, partition_of_np,
    )

    rng = np.random.default_rng(0)
    a = rng.integers(-2**62, 2**62, 4096, dtype=np.int64)
    b = rng.integers(0, 50, 4096, dtype=np.int64)
    v = rng.random(4096) < 0.9
    ht = hash32([torch.from_numpy(a), torch.from_numpy(b)], [torch.from_numpy(v), None])
    hn = hash32_np([a, b], [v, None])
    assert np.array_equal(ht.numpy(), hn.astype(np.int64))
    lut = dictionary_code_hashes(["x", "y", "zebra", "w"])
    codes = rng.integers(0, 4, 512, dtype=np.int32)
    lane = torch.from_numpy(lut.astype(np.int64))[torch.from_numpy(codes).long()].to(torch.int32)
    assert np.array_equal(hash32([lane]).numpy(), hash32_np([lut[codes]]).astype(np.int64))
    for n in (8, 7, 16, 3):
        assert np.array_equal(partition_of(ht, n).numpy(), partition_of_np(hn, n))


# ---- the port's own arms -----------------------------------------------------


def _mesh_runner(**session):
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.runtime import DistributedQueryRunner
    from tests.test_torch_distributed import MESH_DEVICES

    r = DistributedQueryRunner(Session(catalog="tpch", schema="tiny", **session), n_workers=2,
                               hash_partitions=2, device="cpu", mesh_devices=MESH_DEVICES)
    r.register_catalog("tpch", create_tpch_connector())
    return r


@pytest.mark.parametrize("session,item", [
    ({"mesh_replicas": 2}, "13.3"),
    ({"mesh_chunk_rows": 512, "mesh_checkpoint_interval_chunks": 1}, "13.2"),
])
def test_mesh_arms_of_item_13_raise_naming_it(session, item, baseline_rows):
    """Both arms of item 13 run. The replica plane (item 13.3): over 2
    replicas of the 8 CPU shards Q_GROUP answers the page plane's rows
    on the mesh, placed on a replica. Mesh checkpoints (item 13.2): a
    run with checkpoints on resumes from a fault mid-run at tiny with
    the page plane's rows, every chunk executed once."""
    from trino_tpu_torch.parallel import mesh_chunk

    r = _mesh_runner(**session)
    if item == "13.3":
        assert r.execute(chunk_corpus.Q_GROUP).rows == baseline_rows["group"]
        assert r._last_data_plane == "mesh" and r.last_mesh_fallback is None
        assert r._replicas.n_replicas == 2 and r._replicas.placements == 1
        return
    assert r.execute(chunk_corpus.Q_GROUP).rows == baseline_rows["group"]
    K = mesh_chunk.last_run_info()["chunks"]
    fired = []

    def fault(k, _K):
        if not fired and k == K // 2:
            fired.append(k)
            raise mesh_chunk.MeshDeviceLost(f"injected at chunk {k}")

    mesh_chunk.MESH_FAULT_HOOK = fault
    try:
        assert r.execute(chunk_corpus.Q_GROUP).rows == baseline_rows["group"]
    finally:
        mesh_chunk.MESH_FAULT_HOOK = None
    info = mesh_chunk.last_run_info()
    assert fired and r.last_mesh_fallback is None
    assert (info["resumes"], info["resumed_from_chunk"], info["executed_chunk_steps"]) == (
        1, K // 2, K)


def test_an_unexpected_mesh_error_propagates(monkeypatch):
    """The reference reruns any failed mesh query on the page plane; the
    port falls back only on MeshUnsupported, MeshStuck and MeshDeviceLost
    (ROADMAP §3): anything else propagates, with no fallback recorded."""
    from trino_tpu_torch.parallel import mesh_chunk, mesh_plan

    def boom(self, preempt=None, query_span=None):
        raise RuntimeError("a kernel failed")

    monkeypatch.setattr(mesh_chunk.ChunkedMeshRunner, "run", boom)
    r = _mesh_runner()
    before = mesh_plan.mesh_counters_snapshot()
    with pytest.raises(RuntimeError, match="a kernel failed"):
        r.execute(chunk_corpus.Q_GROUP)
    assert r.last_mesh_fallback is None
    assert mesh_plan.mesh_counters_snapshot() == before
