"""The compile regime on trino_tpu_torch (device="cpu") against trino_tpu:
the capacity ladder, the shape census, census-driven warmup on dead
batches, the program cache and the kernel-library directory.

- tests/test_compile_regime.py's 20 cases run on the port's names
  (`port_names`). Four read jax's compile counter (`xla_compiles`, or
  EXPLAIN ANALYZE's `xla_compiles_this_query=`) or the reference's jax
  salt, and run here as port-side copies that read the port's counter,
  `programs_built` (compile/cache.py: the programs the ProgramCache
  built plus the kernel libraries nvcc built), and its torch salt.
- tests/test_plan_validate.py's five census cases and
  tests/test_mesh_chunking.py's two compile-regime cases run here too
  (the zero-relowering case as a port-side copy).
- EXPLAIN ANALYZE's census block equals the reference's class for
  class; each of the compile properties set away from its default gives
  the reference's rows; the planner's dead-batch warmers reach the
  kernels' wrappers; a program bound for one device is never served to
  another.
- WARM_CLASSES and MESH_WARMUP_ENTRIES are process-wide: every case here
  runs with both saved and restored (`isolated_registries`), so no
  outcome depends on test order.
"""

import importlib
import inspect
import os
import threading

import pytest
import torch

import tests.test_compile_regime as regime_corpus
import tests.test_mesh_chunking as chunk_corpus
import tests.test_plan_validate as validate_corpus
from tests.test_torch_distributed import portify
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from tests.tpch_queries import QUERIES
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu_torch.compile import cache as tcache
from trino_tpu_torch.compile import warmup as twarmup
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.parallel import mesh_chunk as tmesh_chunk
from trino_tpu_torch.runtime.metrics import METRICS

# modules of the serving tier the corpora name, beyond portify's
_EXTRA = ["compile.shapes", "compile.warmup", "compile.cache", "resident.manager",
          "resident.table", "resident.fastlane", "serving.batcher", "serving.harness",
          "runtime.memory", "exec.spill"]
_EXTRA_ORIGINAL = {name: dict(vars(importlib.import_module("trino_tpu." + name)))
                   for name in _EXTRA}


def port_names(mp, *corpora) -> None:
    """portify, plus the serving tier's modules: every public name of
    those reference modules that the port's module also has is bound to
    the port's, in the reference module and in each corpus."""
    portify(mp, *corpora)
    swap = {}
    for name in _EXTRA:
        j = importlib.import_module("trino_tpu." + name)
        t = importlib.import_module("trino_tpu_torch." + name)
        parent, _, leaf = ("trino_tpu." + name).rpartition(".")
        mp.setattr(importlib.import_module(parent), leaf, t)
        for attr, obj in _EXTRA_ORIGINAL[name].items():
            if attr.startswith("_") or inspect.ismodule(obj) or not hasattr(t, attr):
                continue
            mp.setattr(j, attr, getattr(t, attr))
            swap.setdefault(id(obj), getattr(t, attr))
    for corpus in corpora:
        for attr, obj in list(vars(corpus).items()):
            if id(obj) in swap:
                mp.setattr(corpus, attr, swap[id(obj)])


@pytest.fixture(autouse=True)
def isolated_registries():
    """The warm-class registry and the mesh warmup entries as they were
    before the case, afterwards."""
    warm = set(twarmup.WARM_CLASSES)
    mesh = list(tmesh_chunk.MESH_WARMUP_ENTRIES)
    yield
    with twarmup._warm_lock:
        twarmup.WARM_CLASSES.clear()
        twarmup.WARM_CLASSES.update(warm)
    with tmesh_chunk._warmup_entries_lock:
        tmesh_chunk.MESH_WARMUP_ENTRIES[:] = mesh


@pytest.fixture(scope="module")
def tpch():
    return jtpch.create_tpch_connector(), ttpch.create_tpch_connector()


def _port_runner(tpch, **session):
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny", **session), device="cpu")
    r.register_catalog("tpch", tpch[1])
    return r


def _ref_runner(tpch, **session):
    r = JRunner(JSession(catalog="tpch", schema="tiny", **session))
    r.register_catalog("tpch", tpch[0])
    return r


@pytest.fixture(scope="module")
def port_runner(tpch):
    return _port_runner(tpch)


# ---- tests/test_compile_regime.py ----------------------------------------------

# cases that read jax's compile counter or salt: port-side copies below
COPIES = {
    "test_persistent_cache_scrub_and_evict": "test_persistent_cache_scrub_and_evict",
    "test_second_execution_compiles_nothing": "test_second_execution_builds_nothing",
    "test_restarted_runner_replays_warm": "test_restarted_runner_replays_warm",
    "test_fte_reattempt_compiles_nothing": "test_fte_reattempt_builds_nothing",
}
REGIME = [n for _, n in _cases(regime_corpus) if n not in COPIES]


@pytest.mark.parametrize("name", REGIME)
def test_compile_regime_corpus(name, port_runner, monkeypatch, tmp_path):
    port_names(monkeypatch, regime_corpus)
    fn = getattr(regime_corpus, name)
    args = {"runner": lambda: port_runner, "tmp_path": lambda: tmp_path}
    fn(**{p: args[p]() for p in inspect.signature(fn).parameters})


def test_persistent_cache_scrub_and_evict(tmp_path):
    """tests/test_compile_regime.py's case on the kernel-library cache:
    the same scrub and eviction, and a salt that names torch, CUDA and
    the schema rev."""
    cache = tcache.PersistentCompileCache(root=str(tmp_path), max_bytes=250)
    os.makedirs(cache.dir, exist_ok=True)

    def put(name, size, mtime):
        p = os.path.join(cache.dir, name)
        with open(p, "wb") as f:
            f.write(b"x" * size)
        os.utime(p, (mtime, mtime))
        return p

    put("dead", 0, 100)
    put("libgather.so.12.tmp", 50, 100)
    put("tmp_orphan", 50, 100)
    oldest = put("libgrouped_sum.so", 100, 100)
    put("libwindow_rank.so", 100, 200)
    put("libgather.so", 100, 300)
    cache.prepare()
    assert cache.scrubbed == 3 and cache.evicted == 1
    assert not os.path.exists(oldest)
    assert cache.entry_count() == 2 and cache.total_bytes() == 200
    assert cache.stats()["scrubbed"] == 3 and cache.stats()["evicted"] == 1
    assert cache.salt == f"torch{torch.__version__}-cuda{torch.version.cuda or 'none'}-schema1"
    assert cache.dir.endswith(cache.salt)


def test_the_kernel_build_writes_through_the_salted_cache(tmp_path, monkeypatch):
    """ops/cuda_build.py builds into the cache's salt dir through a
    temporary file and a rename, counts one build, and a failed build
    raises (the cache never makes a kernel optional). nvcc is faked."""
    from trino_tpu_torch.ops import cuda_build

    cache = tcache.PersistentCompileCache(root=str(tmp_path))
    monkeypatch.setattr(tcache, "ACTIVE_PERSISTENT_CACHE", cache)

    class _Nvcc:
        def __init__(self, cmd, fail):
            self.returncode = 1 if fail else 0
            if not fail:
                with open(cmd[cmd.index("-o") + 1], "wb") as f:
                    f.write(b"\x7fELF")

        def communicate(self):
            return "", "ptxas info"

    fail = []
    monkeypatch.setattr(cuda_build.subprocess, "Popen",
                        lambda cmd, **kw: _Nvcc(cmd, bool(fail)))
    before = METRICS.counter("programs_built")
    path = cuda_build.build("gather")
    assert path == os.path.join(cache.dir, "libgather.so") and os.path.exists(path)
    assert not [n for n in os.listdir(cache.dir) if n.endswith(".tmp")]
    assert METRICS.counter("programs_built") == before + 1
    assert cuda_build.build("gather") == path  # fresh: nothing rebuilt
    assert METRICS.counter("programs_built") == before + 1
    fail.append(1)
    with pytest.raises(RuntimeError, match="nvcc failed on window_rank.cu"):
        cuda_build.build("window_rank")


def _built_this_query(runner, sql):
    text = runner.execute("explain analyze " + sql).rows[0][0]
    assert "programs_built_this_query=" in text, text
    return int(text.split("programs_built_this_query=")[1].split()[0])


def test_second_execution_builds_nothing(port_runner):
    """tests/test_compile_regime.py::test_second_execution_compiles_nothing
    on the port's counter: once a query shape has run, running it again
    (a dynamic-filtered re-scan included) builds nothing."""
    for q in regime_corpus.REPLAY_QUERIES:
        first = _built_this_query(port_runner, q)
        second = _built_this_query(port_runner, q)
        assert second == 0, f"{q!r}: first={first} second={second}"


def test_restarted_runner_replays_warm(tpch, port_runner):
    """::test_restarted_runner_replays_warm: a fresh runner in the same
    process (fresh plan cache) replays with 0 builds: the program cache
    is process-wide."""
    baseline = {q: port_runner.execute(q).rows for q in regime_corpus.REPLAY_QUERIES}
    fresh = _port_runner(tpch)
    for q in regime_corpus.REPLAY_QUERIES:
        assert _built_this_query(fresh, q) == 0, q
        assert fresh.execute(q).rows == baseline[q]


def test_fte_reattempt_builds_nothing(monkeypatch):
    """::test_fte_reattempt_compiles_nothing on METRICS programs_built:
    a retried task re-lands on programs already built."""
    port_names(monkeypatch, regime_corpus)
    from trino_tpu_torch.connectors.spi import CatalogManager
    from trino_tpu_torch.runtime import DistributedQueryRunner
    from trino_tpu_torch.runtime.failure import FailureInjector
    from trino_tpu_torch.runtime.worker import Worker

    inj = FailureInjector()
    cats = CatalogManager()
    cats.register("tpch", ttpch.create_tpch_connector())
    workers = [Worker(f"w{i}", cats, failure_injector=inj, device="cpu") for i in range(2)]
    r = DistributedQueryRunner(
        Session(catalog="tpch", schema="tiny", retry_policy="task"),
        worker_handles=workers, hash_partitions=2, device="cpu")
    r.register_catalog("tpch", ttpch.create_tpch_connector())
    baseline = r.execute(regime_corpus.FTE_Q).rows
    before = METRICS.counter("programs_built")
    inj.inject(fragment_id=0, partition=0, attempts=(0,), where="start")
    assert r.execute(regime_corpus.FTE_Q).rows == baseline
    assert METRICS.counter("programs_built") - before == 0


# ---- the census: tests/test_plan_validate.py's five cases ----------------------

CENSUS = ["test_shape_census_simple_aggregation", "test_shape_census_join_marks_retry_variant",
          "test_explain_analyze_census_matches_observed",
          "test_explain_analyze_census_tail_classes", "test_census_warns_above_threshold"]


@pytest.mark.parametrize("name", CENSUS)
def test_census_corpus(name, tpch, monkeypatch):
    port_names(monkeypatch, validate_corpus)
    from trino_tpu_torch.sql import validate as tvalidate

    for attr in ("Lowering", "shape_census"):
        monkeypatch.setattr(validate_corpus, attr, getattr(tvalidate, attr))
    from trino_tpu_torch.sql.parser import parse

    monkeypatch.setattr(validate_corpus, "parse", parse)
    fn = getattr(validate_corpus, name)
    if "tpch_runner" in inspect.signature(fn).parameters:
        fn(_port_runner(tpch))
    else:
        fn()


CENSUS_QUERIES = {
    "fp": (regime_corpus.FP_Q, {}),
    "agg": (regime_corpus.AGG_Q, {}),
    "join": (regime_corpus.JOIN_Q, {}),
    "tail": (regime_corpus.AGG_Q, {"batch_rows": 49152}),
    "ladder4": (regime_corpus.JOIN_Q, {"capacity_ladder_base": 4}),
    "unstabilized": (regime_corpus.JOIN_Q, {"shape_stabilization": False}),
    "q3": (QUERIES[3], {}),
}


def _census_block(text):
    """EXPLAIN ANALYZE's census block: its summary and class lines (the
    compile counter, warmup and cache lines follow it)."""
    block = text.split("\n\n")[-1].splitlines()
    return [line for line in block
            if line.startswith("Compile-churn census:") or line.startswith("  ")]


@pytest.mark.parametrize("name", sorted(CENSUS_QUERIES))
def test_explain_analyze_census_equals_the_reference(name, tpch):
    """The census block, class for class (operator, capacity, dtypes,
    markers) and its expected/observed counts, equals the reference's."""
    sql, session = CENSUS_QUERIES[name]
    want = _census_block(_ref_runner(tpch, **session).execute("explain analyze " + sql)
                         .rows[0][0])
    got = _census_block(_port_runner(tpch, **session).execute("explain analyze " + sql)
                        .rows[0][0])
    assert got == want


# ---- the compile properties away from their defaults ---------------------------

PROPERTIES = {
    "shape_stabilization": {"shape_stabilization": False},
    "capacity_ladder_base": {"capacity_ladder_base": 4},
    "warmup_mode_block": {"warmup_mode": "block"},
    "warmup_mode_background": {"warmup_mode": "background"},
    "compile_churn_warn_threshold": {"compile_churn_warn_threshold": 1},
    "resident_tables": {"resident_tables": "orders"},
    "micro_batch": {"micro_batch_window_ms": 5.0, "micro_batch_max": 4},
}
PROPERTY_QUERIES = list(regime_corpus.REPLAY_QUERIES) + [
    "select o_custkey, o_totalprice from orders where o_orderkey = 7"]


@pytest.mark.parametrize("name", sorted(PROPERTIES))
def test_a_ported_property_gives_the_references_rows(name, tpch):
    ref = _ref_runner(tpch, **PROPERTIES[name])
    port = _port_runner(tpch, **PROPERTIES[name])
    for sql in PROPERTY_QUERIES:
        assert port.execute(sql).rows == ref.execute(sql).rows, sql
    text = port.execute("explain analyze " + regime_corpus.JOIN_Q).rows[0][0]
    if name == "compile_churn_warn_threshold":
        assert "WARNING: exceeds compile_churn_warn_threshold=1" in text
    if name.startswith("warmup_mode"):
        assert f"warmup: mode={PROPERTIES[name]['warmup_mode']}" in text
        assert port._last_warmup.failures() == []


# ---- warmup on dead batches ------------------------------------------------------


def test_the_warmers_reach_the_kernel_wrappers(tpch, monkeypatch):
    """warmup_mode = block over TPC-H Q3 and Q-MXU: every entry
    compiles, and the dead batches reach grouped_sum, bounds, run_owner
    and take_flat through their wrappers (on the CPU their plain
    versions; on the card their kernels, held against the plain
    versions by tests/test_torch_card.py). Rows equal the cold run's."""
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import mxu_groupby as MG
    from trino_tpu_torch.ops import window_rank as W

    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapper)

    import chip_smoke as CS

    # the grouped-sum band runs on the CPU under the reference's switch
    monkeypatch.setenv("TRINO_TPU_FORCE_MXU", "1")
    queries = (("q3", QUERIES[3]), ("q_mxu", CS.Q_MXU))
    cold = _port_runner(tpch)
    want = {q: cold.execute(sql).rows for q, sql in queries}
    from trino_tpu_torch.sql.parser import parse

    r = _port_runner(tpch, warmup_mode="block")
    for mod, name in ((W, "bounds"), (W, "run_owner"), (GK, "take_flat"), (MG, "grouped_sum")):
        counted(mod, name)
    seen = {}
    for q, sql in queries:
        physical = r._plan(parse(sql), None)[1]
        calls.clear()
        svc = r._start_warmup(physical)
        assert svc is not None and svc.failures() == [] and svc.status_counts()["compiled"]
        seen[q] = dict(calls)
        assert r.execute(sql).rows == want[q]
    assert {"bounds", "run_owner", "take_flat"} <= set(seen["q3"]), seen
    assert seen["q_mxu"].get("grouped_sum"), seen


def test_a_failed_warmup_entry_keeps_its_error_and_never_fails_the_query(tpch):
    from trino_tpu_torch.sql.parser import parse

    r = _port_runner(tpch, warmup_mode="block")
    physical = r._plan(parse(regime_corpus.FP_Q), None)[1]
    entry = physical.warmup_entries[0]
    good = entry.fn

    def boom(batch):
        raise RuntimeError("no kernel image for this device")

    entry.fn = boom
    before = METRICS.counter("warmup_failures")
    try:
        svc = r._start_warmup(physical)
    finally:
        entry.fn = good
    assert svc.failures() == [("FilterProjectOperator",
                               f"cap={entry.capacities[0]}: RuntimeError: "
                               "no kernel image for this device")]
    assert METRICS.counter("warmup_failures") == before + 1
    assert "failed=1" in svc.report_line()
    assert r.execute(regime_corpus.FP_Q).rows == _port_runner(tpch).execute(
        regime_corpus.FP_Q).rows


# ---- the program cache -----------------------------------------------------------


def test_a_program_is_never_served_to_another_device(tpch):
    """The same stage planned for two devices binds two closures; the
    same device gets the cached one back."""
    from trino_tpu_torch.sql.local_planner import LocalPlanner
    from trino_tpu_torch.sql.parser import parse

    r = _port_runner(tpch)
    out = r._analyze(parse(regime_corpus.FP_Q))

    def fp_fn(device):
        plan = LocalPlanner(r.catalogs, device, stabilizer=r._make_stabilizer()).plan(out)
        return [f for f in plan.chain_factories if hasattr(f, "fused_fn")][0].fused_fn

    a, b, c = fp_fn("cpu"), fp_fn("meta"), fp_fn("cpu")
    assert a is c and a is not b
    assert tcache.PROGRAM_CACHE.key_of(a)[-1] == "cpu"
    assert tcache.PROGRAM_CACHE.key_of(b)[-1] == "meta"


def test_concurrent_builders_share_one_program():
    """More threads than cores race on a few keys under a short switch
    interval: each key ends with one program, every caller got it, and
    hits plus misses count every call."""
    import sys

    cache = tcache.ProgramCache()
    n, keys = 4 * (os.cpu_count() or 4), 3
    got = [[] for _ in range(keys)]
    gate = threading.Barrier(n)

    def worker(i):
        gate.wait()
        for _ in range(50):
            k = i % keys
            got[k].append(cache.get_or_create(("k", k), object))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    for k in range(keys):
        assert len({id(g) for g in got[k]}) == 1
        assert cache.key_of(got[k][0]) == ("k", k)
    st = cache.stats()
    assert st["misses"] == keys and st["hits"] + st["misses"] == n * 50


def test_the_lru_bound_and_the_composition_keys():
    cache = tcache.ProgramCache(max_entries=2)
    a = cache.get_or_create(("a",), lambda: lambda b: b)
    bfn = cache.get_or_create(("b",), lambda: lambda b: b)
    comp = cache.get_or_create(("compose", cache.key_of(a), cache.key_of(bfn)),
                               lambda: lambda x: x)
    assert cache.key_of(comp) == ("compose", ("a",), ("b",))
    assert cache.key_of(a) is None and len(cache) == 2
    assert cache.stats()["evictions"] == 1
    assert tcache.expr_fingerprint(object()) is None


# ---- tests/test_mesh_chunking.py's compile-regime cases --------------------------


def test_mesh_warmup_registration(monkeypatch):
    """tests/test_mesh_chunking.py::test_warmup_registration on the
    port's names."""
    portify(monkeypatch, chunk_corpus)
    port_names(monkeypatch, chunk_corpus)
    chunk_corpus.test_warmup_registration()


def test_a_mesh_program_warm_builds_the_kernels_and_loads_no_library(monkeypatch):
    """On a CUDA shard list the mesh program's warmer builds the kernel
    sources and leaves their loading to the wrappers' first launches,
    which bind each function's argument types."""
    from trino_tpu_torch.ops import cuda_build
    from trino_tpu_torch.parallel.mesh_chunk import _ProgramWarmer

    built = []
    monkeypatch.setattr(cuda_build, "build_all", lambda names=cuda_build.SOURCES:
                        built.append(tuple(names)) or {})
    monkeypatch.setattr(cuda_build, "build", lambda name: built.append(name) or "")
    libs = dict(cuda_build._libs)
    _ProgramWarmer(["cuda:0", "cuda:0"])()
    assert built == [cuda_build.SOURCES] and cuda_build._libs == libs
    _ProgramWarmer(["cpu", "cpu"])()
    assert built == [cuda_build.SOURCES]


def test_second_mesh_execution_builds_nothing(monkeypatch):
    """::test_second_execution_zero_relowerings on the port's counter: a
    repeated chunked query replays its program records from the cache."""
    portify(monkeypatch, chunk_corpus)
    r = chunk_corpus.mk_runner(mesh_chunk_rows=512)
    want = chunk_corpus.mk_runner(mesh_execution=False).execute(chunk_corpus.Q_JOIN).rows
    assert r.execute(chunk_corpus.Q_JOIN).rows == want
    before = METRICS.counter("programs_built")
    assert r.execute(chunk_corpus.Q_JOIN).rows == want
    assert METRICS.counter("programs_built") - before == 0
