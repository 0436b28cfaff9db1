"""The concurrency soundness plane of trino_tpu_torch (analysis/) against
trino_tpu's.

- tests/test_concurrency_analysis.py's cases run on the port's names:
  the module's analyzer, witness and registry names are swapped for the
  port's (`port_names`).
  - The static cases analyze the corpus's broken fixtures. Their sources
    reach the port with only the package name changed. The reference's
    analyzer runs on the original source beside it, and the two reports
    must hold the same findings: kinds, files, lines and messages (which
    name the locks).
  - The witness and registry cases run their acquisition script twice,
    once through each package. So both raise LockOrderError naming the
    same lock_a and lock_b.
  - test_full_package_is_clean runs on the port's tree, at the corpus's
    thresholds (more than 100 files, 40 locks and 200 sites).
- The two regression races the reference pinned have counterparts on
  the port's parallel/mesh_chunk.py and parallel/mesh_plan.py. The
  third, `_global_update_fn`'s cache, has none: the port has no such
  function (NO_COUNTERPART).
- The two trees' static lock graphs name the same locks and order
  edges, apart from PORT_ONLY and REFERENCE_ONLY, each with its reason.
- The port names every lock and starts every thread through analysis/.
  Its EXPLAIN ANALYZE prints the reference's concurrency= line, and the
  coordinator registers the analysis.* gauges. The chaos witness gate
  fails a case that records a violation.
- `import trino_tpu_torch.analysis` imports neither jax nor trino_tpu.
"""

import ast
import functools
import os
import re
import subprocess
import sys
import threading

import pytest

import tests.test_concurrency_analysis as corpus
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu import analysis as janalysis
from trino_tpu.analysis import witness as jwitness
from trino_tpu_torch import analysis as tanalysis
from trino_tpu_torch.analysis import threadreg as tthreadreg
from trino_tpu_torch.analysis import witness as twitness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "trino_tpu_torch")

STATIC = [
    "test_static_lock_order_cycle_reported_with_both_paths",
    "test_static_cycle_through_call_edge",
    "test_static_bare_guarded_write_flagged_at_line",
    "test_static_unlocked_mutable_global_write_flagged",
    "test_static_raw_thread_spawn_flagged",
    "test_static_nonreentrant_reentry_flagged",
    "test_static_wait_while_holding_flagged",
]
WITNESS = [
    "test_witness_order_violation_raises_typed_error",
    "test_witness_transitive_violation_detected",
    "test_witness_same_thread_reentry_raises",
    "test_witness_rlock_reentry_allowed",
    "test_witness_condition_wait_releases_recursion",
    "test_witness_seed_order_preloads_static_edges",
    "test_witness_distinct_instances_same_name_no_false_positive",
    "test_threadreg_spawn_tracks_name_and_owner",
    "test_threadreg_non_daemon_leak_reported_then_cleared",
    "test_threadreg_join_all_by_owner",
]
COUNTERPARTS = {
    "test_full_package_is_clean": "test_full_package_is_clean",
    "test_last_run_info_publish_is_atomic": "test_last_run_info_publish_is_atomic",
    "test_mesh_counters_concurrent_bumps_all_land":
        "test_mesh_counters_concurrent_bumps_all_land",
}
NO_COUNTERPART = {
    "test_global_fn_cache_returns_one_identity":
        "the port has no _global_update_fn or _GLOBAL_FN_CACHE: its global "
        "aggregation runs eagerly, with no jitted callable to share",
}

# Lock ids of the two static graphs that only one tree has.
PORT_ONLY = {
    "cuda_build._lock": "ops/cuda_build.py: loads a kernel library once per process",
    "cuda_build._build_lock": "ops/cuda_build.py: serializes nvcc builds and guards "
                              "PTXAS_LOG; taken after cuda_build._lock",
    "cuda_build._count_lock": "ops/cuda_build.py: each wrapper's launch count and shapes",
    "PersistentCompileCache._lock": "compile/cache.py: the kernel libraries' build "
                                    "directory (the reference leaves that to XLA)",
    "cache._active_lock": "compile/cache.py: the process's active kernel cache",
    "fastlane._compaction_lock": "resident/fastlane.py: one compaction at a time, where "
                                 "the reference runs a one-worker pool",
    "serde._DICT_CACHE_LOCK": "exec/serde.py: the decoded-dictionary cache",
    "spill._stats_lock": "exec/spill.py: the spill byte counters",
    "DistributedQueryRunner._carve_lock": "runtime/coordinator.py: one replica plane and "
                                          "one run queue per runner",
}
REFERENCE_ONLY = {
    "operators._global_fn_lock": "guards _GLOBAL_FN_CACHE of _global_update_fn, which "
                                 "the port does not have (NO_COUNTERPART)",
}
PORT_ONLY_EDGES = {
    ("cuda_build._lock", "cuda_build._build_lock"): "load builds a stale library while "
                                                    "it holds cuda_build._lock",
    ("fastlane._compaction_lock", "ResidentStateManager._lock"): "a compaction notes "
                                                                 "itself in RESIDENT",
    ("PlanCache._lock", "MetricsRegistry._lock"): "both packages count hits under the "
                                                  "lock; the reference imports METRICS "
                                                  "inside the method, where the static "
                                                  "resolver does not follow it",
}
REFERENCE_ONLY_EDGES: dict = {}


@pytest.fixture(autouse=True)
def _fresh_witnesses():
    """The cases trip both witnesses on purpose: clear both order graphs
    and violation counters around each, so both packages' module
    sanitizers see a clean slate."""
    jwitness.reset_witness_for_tests()
    twitness.reset_witness_for_tests()
    yield
    jwitness.reset_witness_for_tests()
    twitness.reset_witness_for_tests()


@functools.lru_cache(maxsize=None)
def _port_report():
    return tanalysis.analyze_package()


@functools.lru_cache(maxsize=None)
def _reference_report():
    return janalysis.analyze_package()


def _findings(rep):
    return [(f.kind, f.file, f.line, f.message) for f in rep.findings]


def _both_analyzers(sources):
    """The port's analyzer on the fixture with the package name changed,
    held to the reference's analyzer on the original."""
    port = tanalysis.analyze_sources({
        k: (path, text.replace("trino_tpu.", "trino_tpu_torch."))
        for k, (path, text) in sources.items()})
    ref = janalysis.analyze_sources(sources)
    assert _findings(port) == _findings(ref)
    assert sorted(port.graph.locks) == sorted(ref.graph.locks)
    return port


def port_names(monkeypatch):
    monkeypatch.setattr(corpus, "analyze_sources", _both_analyzers)
    monkeypatch.setattr(corpus, "analyze_package", _port_report)
    for name in ("LockOrderError", "named_condition", "named_lock", "named_rlock",
                 "reset_witness_for_tests", "seed_order", "violation_count"):
        monkeypatch.setattr(corpus, name, getattr(twitness, name))
    monkeypatch.setattr(corpus, "threadreg", tthreadreg)


@pytest.mark.parametrize("name", STATIC)
def test_static_corpus_case(name, monkeypatch):
    port_names(monkeypatch)
    getattr(corpus, name)()


@pytest.mark.parametrize("name", WITNESS)
def test_witness_and_registry_corpus_case(name, monkeypatch):
    """The same script through the reference, then through the port."""
    getattr(corpus, name)()
    jwitness.reset_witness_for_tests()
    with monkeypatch.context() as m:
        port_names(m)
        getattr(corpus, name)()


def test_full_package_is_clean(monkeypatch):
    port_names(monkeypatch)
    corpus.test_full_package_is_clean()
    assert tanalysis.PACKAGE_ROOT == PORT
    assert _port_report().summary()["violations"] == 0


def test_the_corpus_is_covered():
    """Every case of tests/test_concurrency_analysis.py runs here or has
    no counterpart, with its reason."""
    every = {n for _, n in _cases(corpus)}
    ran = set(STATIC) | set(WITNESS) | set(COUNTERPARTS)
    assert every == ran | set(NO_COUNTERPART) and not ran & set(NO_COUNTERPART)
    assert len(every) == 21
    here = {n for n in globals() if n.startswith("test_")}
    assert set(COUNTERPARTS.values()) <= here


def test_the_two_lock_graphs_name_the_same_locks_and_edges():
    port, ref = _port_report().graph, _reference_report().graph
    assert set(port.locks) - set(ref.locks) == set(PORT_ONLY)
    assert set(ref.locks) - set(port.locks) == set(REFERENCE_ONLY)
    assert set(port.edges) - set(ref.edges) == set(PORT_ONLY_EDGES)
    assert set(ref.edges) - set(port.edges) == set(REFERENCE_ONLY_EDGES)
    assert all(PORT_ONLY.values()) and all(REFERENCE_ONLY.values())
    assert all(PORT_ONLY_EDGES.values())


def _port_sources():
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build", "analysis")]
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                with open(path) as fh:
                    yield os.path.relpath(path, REPO), fh.read()


def _unregistered_pools(path, text):
    """ThreadPoolExecutor constructions whose workers do not adopt
    themselves into the registry (no `initializer=`)."""
    out = []
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if name == "ThreadPoolExecutor" and not any(
                    k.arg == "initializer" for k in node.keywords):
                out.append(f"{path}:{node.lineno}: ThreadPoolExecutor without initializer")
    return out


def test_every_lock_and_thread_goes_through_analysis():
    """Outside analysis/, the port constructs no bare lock and starts no
    thread of its own (a ThreadPoolExecutor's workers register themselves
    through its initializer); its named locks carry the reference's name
    at the same site or one of PORT_ONLY's."""
    bare = re.compile(r"threading\.(Lock|RLock|Condition)\(\)|\bThread\(")
    named = re.compile(r"named_(?:lock|rlock|condition)\(\"([^\"]+)\"")
    ref_locks = set(_reference_report().graph.locks)
    offenders, names = [], set()
    for path, text in _port_sources():
        offenders += [f"{path}: {m.group(0)}" for m in bare.finditer(text)]
        offenders += _unregistered_pools(path, text)
        names |= set(named.findall(text))
    assert not offenders, offenders
    # the function-local locks of the chaos and serving harnesses are not
    # in either static graph; the reference leaves them bare
    local = {"ChaosHarness.stats_lock", "harness.load_stats_lock"}
    assert names - local <= ref_locks | set(PORT_ONLY), sorted(names - local - ref_locks)
    outside = {n for n, ld in _port_report().graph.locks.items()
               if f"{os.sep}analysis{os.sep}" not in ld.file}
    assert outside <= names


def test_the_thread_pools_workers_register_with_their_owners(monkeypatch):
    """The two thread pools of the port, the mesh scan's and the
    coordinator server's, adopt each worker into the registry under its
    owner as the worker starts."""
    from tests.test_torch_mesh import port_mesh_runner
    from trino_tpu_torch.client import Client
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import LocalQueryRunner, Session
    from trino_tpu_torch.runtime.server import CoordinatorServer

    seen = []
    register = tthreadreg.THREADS.register

    def recording(thread, **kw):
        seen.append((kw.get("name") or thread.name, kw.get("owner")))
        return register(thread, **kw)

    monkeypatch.setattr(tthreadreg.THREADS, "register", recording)
    assert port_mesh_runner().execute("select count(*) from nation").rows == [[25]]
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    r.register_catalog("tpch", create_tpch_connector())
    srv = CoordinatorServer(r)
    try:
        assert Client(srv.uri).execute("select count(*) from region").rows == [[5]]
    finally:
        srv.stop()
    owners = {owner for name, owner in seen
              if name.startswith(("mesh-scan", "coordinator-query"))}
    assert owners == {"MeshExecutor", "CoordinatorServer"}, seen


def test_a_loaded_kernel_library_is_read_without_the_lock(monkeypatch):
    """Every kernel launch asks cuda_build.load for its library; once it
    is loaded the call takes no lock (under the witness, taking the
    non-reentrant cuda_build._lock while holding it would raise)."""
    from trino_tpu_torch.ops import cuda_build

    lib = object()
    monkeypatch.setitem(cuda_build._libs, "window_rank", lib)
    with cuda_build._lock:
        assert cuda_build.load("window_rank", {}) is lib


def test_last_run_info_publish_is_atomic():
    """The port's publish/read pair of LAST_RUN_INFO never shows a reader
    a half-published snapshot (parallel/mesh_chunk.py)."""
    from trino_tpu_torch.parallel import mesh_chunk

    payload = {"chunks": 4, "resumes": 0, "chunked": True}
    mesh_chunk.publish_run_info(dict(payload))
    stop = threading.Event()
    bad = []

    def reader():
        while not stop.is_set():
            snap = mesh_chunk.last_run_info()
            if snap and set(snap) != set(payload):
                bad.append(snap)

    for i in range(2):
        tthreadreg.spawn(f"port-lri-{i}", reader, daemon=False, owner="port-lri")
    for _ in range(300):
        mesh_chunk.publish_run_info(dict(payload))
    stop.set()
    assert not tthreadreg.THREADS.join_all(timeout=5.0, owner="port-lri")
    assert not bad, f"reader saw a torn snapshot: {bad[:3]}"


def test_mesh_counters_concurrent_bumps_all_land():
    """Concurrent bumps of the port's mesh counters all land
    (parallel/mesh_plan.py)."""
    from trino_tpu_torch.parallel.mesh_plan import bump_mesh_counter, mesh_counter

    before = mesh_counter("queries")
    n, per = 4, 500

    def bump():
        for _ in range(per):
            bump_mesh_counter("queries")

    for i in range(n):
        tthreadreg.spawn(f"port-mc-{i}", bump, daemon=False, owner="port-mc")
    assert not tthreadreg.THREADS.join_all(timeout=10.0, owner="port-mc")
    assert mesh_counter("queries") == before + n * per


def test_the_witness_is_on_under_pytest_and_its_switch_is_the_ports_own():
    assert twitness.witness_enabled()
    code = ("import trino_tpu_torch.analysis.witness as w, sys; "
            "sys.stdout.write(str(int(w.witness_enabled())))")
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
    got = []
    for value in (None, "1", "0"):
        e = dict(env)
        e.pop("TRINO_TPU_TORCH_LOCK_WITNESS", None)
        if value is not None:
            e["TRINO_TPU_TORCH_LOCK_WITNESS"] = value
        got.append(subprocess.run([sys.executable, "-c", code], env=e, cwd=REPO,
                                  capture_output=True, text=True, check=True).stdout)
    assert got == ["0", "1", "0"]


def test_importing_the_analysis_imports_no_jax():
    code = ("import sys, trino_tpu_torch.analysis; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'trino_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_lock_order_inside_the_port_raises_and_counts():
    """Two of the port's own module locks taken in both orders: the
    second order raises LockOrderError naming both."""
    from trino_tpu_torch.parallel import mesh_chunk, mesh_plan

    with mesh_plan._counters_lock:
        with mesh_chunk._run_info_lock:
            pass
    with mesh_chunk._run_info_lock:
        with pytest.raises(twitness.LockOrderError) as ei:
            mesh_plan._counters_lock.acquire()
    assert (ei.value.lock_a, ei.value.lock_b) == (
        "mesh_chunk._run_info_lock", "mesh_plan._counters_lock")
    assert twitness.violation_count() == 1 and not twitness.held_locks()


def test_the_chaos_witness_gate_turns_the_witness_on_and_fails_a_violation(monkeypatch):
    """run_mesh_case runs preempt_park_resume with the witness on, puts
    the old setting back, and mesh_case_failures fails it on any
    violation recorded meanwhile."""
    from trino_tpu_torch.runtime import chaos

    seen = []

    def fake_case(sql, seed, **kw):
        seen.append(twitness.witness_enabled())
        a, b = twitness.named_lock("gate.a"), twitness.named_lock("gate.b")
        with a:
            with b:
                pass
        with b:
            try:
                a.acquire()
            except twitness.LockOrderError:
                pass  # swallowed: only the counter tells
        return [[1]], {"mesh_clean_plane": True, "expected": [[1]], "parked": True,
                       "faulted": True, "mesh_fault_plane": "mesh", "parks": 1,
                       "unparks": 1, "resumes": 1, "executed_chunk_steps": 4,
                       "chunks": 4, "point_ok": True}

    monkeypatch.setattr(chaos, "run_preempt_park_resume_case", fake_case)
    twitness.enable_witness(False)
    try:
        rows, rep = chaos.run_mesh_case("preempt_park_resume", 7, {}, "select 1",
                                        device="cpu")
        assert not twitness.witness_enabled()
    finally:
        twitness.enable_witness(True)
    assert seen == [True] and rep["witness_violations"] == 1
    failures = chaos.mesh_case_failures("preempt_park_resume", rows, rep)
    assert failures == ["preempt/preempt_park_resume: 1 lock-witness violation(s) "
                        "recorded during the park/resume run"]
    rep["witness_violations"] = 0
    assert chaos.mesh_case_failures("preempt_park_resume", rows, rep) == []


def test_explain_analyze_prints_the_concurrency_line_and_the_gauges_are_registered():
    """Distributed EXPLAIN ANALYZE ends its replica lines with the
    reference's concurrency= line (the same fields, violations=0 and the
    witness on), and the coordinator registered analysis.locks,
    analysis.threads_live and analysis.witness_violations."""
    from trino_tpu.runtime.coordinator import DistributedQueryRunner as JRunner
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.runtime import DistributedQueryRunner
    from trino_tpu_torch.runtime.metrics import METRICS

    r = DistributedQueryRunner(Session(catalog="tpch", schema="tiny", mesh_execution=False),
                               n_workers=2, hash_partitions=2, device="cpu")
    r.register_catalog("tpch", create_tpch_connector())
    text = r.execute("EXPLAIN ANALYZE select count(*) from nation").rows[0][0]
    lines = [ln for ln in text.splitlines() if ln.startswith("concurrency=")]
    assert len(lines) == 1 and text.splitlines()[-1] == lines[0]
    fields = dict(kv.split("=") for kv in lines[0].split()[1:])
    ref_fields = dict(kv.split("=") for kv in JRunner._concurrency_line(None).split()[1:])
    assert list(fields) == list(ref_fields)
    assert fields["witness"] == "on" and fields["violations"] == "0"
    assert int(fields["locks"]) > 0 and int(fields["threads_spawned"]) > 0
    snap = METRICS.snapshot()
    for gauge in ("analysis.locks", "analysis.threads_live", "analysis.witness_violations"):
        assert gauge in snap
    assert snap["analysis.witness_violations"] == 0 and snap["analysis.locks"] > 0


def test_phase_replicas_chaos_runs_the_witness_gate_at_tiny(monkeypatch):
    """chip_smoke.py's chaos process (replica_chaos) at tiny on 4 CPU
    shards, cut to park and resume: the case ran with the witness on and
    recorded no violation, and its gate line carries the count."""
    import chip_smoke as CS
    import torch
    from trino_tpu_torch.runtime import chaos

    monkeypatch.setenv("TRINO_TPU_INTERNAL_SECRET", "chip-smoke-fabric")
    monkeypatch.setattr(chaos, "MESH_SCENARIOS", {"preempt_park_resume": "preempt"})
    logged = []
    out = CS.replica_chaos("cpu", [torch.device("cpu")] * 4, logged.append)
    assert out["preempt_park_resume"]["witness_violations"] == 0
    assert any("witness_violations=0" in line for line in logged)


def test_the_sanitizer_leaves_the_references_threads_to_the_references_sanitizer():
    """A non-daemon thread the reference's registry holds (its fast lane's
    long-lived compaction worker) is not the port's leak; one that neither
    registry holds is."""
    from tests.torch_sanitizer import _port_leaks
    from trino_tpu.analysis import threadreg as jthreadreg

    stop = threading.Event()
    theirs = threading.Thread(target=stop.wait, args=(10.0,), name="ref-owned")
    jthreadreg.THREADS.register(theirs, owner="t", long_lived=True)
    stray = threading.Thread(target=stop.wait, args=(10.0,), name="nobodys")
    ours = tthreadreg.spawn("port-owned", stop.wait, args=(10.0,), daemon=False, owner="t")
    theirs.start()
    stray.start()
    try:
        leaks = _port_leaks()
        assert "port-owned (owner=t)" in leaks and "nobodys (UNREGISTERED)" in leaks
        assert not any(leak.startswith("ref-owned ") for leak in leaks)
    finally:
        stop.set()
        for t in (theirs, stray, ours):
            t.join(5.0)
