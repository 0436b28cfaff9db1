"""trino_tpu_torch stands alone: no jax, nothing of trino_tpu, and no
silent CPU fallback for the runner."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "trino_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, name) for name in ("chip_smoke.py", "kernel_ab.py", "lock_ab.py")]
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _module_names():
    names = []
    for path in _port_sources():
        if not path.startswith(PKG):
            continue
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        names.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return names


_BAD = "('jax', 'jaxlib', 'trino_tpu')"
_BAD_FILES = "('jax', 'jaxlib', 'trino_tpu', 'pyarrow', 'zstandard')"


def _imports_clean(module: str, bad: str = _BAD) -> str:
    """Check code: import `module`, then find nothing of `bad` loaded."""
    return (
        "import importlib, sys, threading, os\n"
        f"importlib.import_module({module!r})\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {bad})\n"
        "assert not bad, bad\n"
    )


ZONE_MODULES = ["trino_tpu_torch.ops.tz", "trino_tpu_torch.exec.match_recognize"]
WRITE_MODULES = ["trino_tpu_torch.transaction", "trino_tpu_torch.engine",
                 "trino_tpu_torch.connectors.memory"]
STATEMENT_MODULES = ["trino_tpu_torch.security", "trino_tpu_torch.config",
                     "trino_tpu_torch.serving.plan_cache", "trino_tpu_torch.serving.params",
                     "trino_tpu_torch.sql.formatter", "trino_tpu_torch.sql.validate"]
FILE_MODULES = ["trino_tpu_torch.connectors.file", "trino_tpu_torch.connectors.parquet_format",
                "trino_tpu_torch.connectors.blackhole", "trino_tpu_torch.utils.snappy"]
MEMORY_MODULES = ["trino_tpu_torch.runtime", "trino_tpu_torch.runtime.memory",
                  "trino_tpu_torch.native", "trino_tpu_torch.exec.serde",
                  "trino_tpu_torch.exec.exchange_ops", "trino_tpu_torch.exec.spill",
                  "trino_tpu_torch.exec.stats", "trino_tpu_torch.exec.local_exchange",
                  "trino_tpu_torch.exec.driver"]
WIRE_MODULES = ["trino_tpu_torch.runtime.http", "trino_tpu_torch.runtime.fte",
                "trino_tpu_torch.runtime.server", "trino_tpu_torch.runtime.spool",
                "trino_tpu_torch.runtime.codec", "trino_tpu_torch.runtime.resource_groups",
                "trino_tpu_torch.serving.admission", "trino_tpu_torch.client",
                "trino_tpu_torch.dbapi", "trino_tpu_torch.cli",
                "trino_tpu_torch.service.proxy", "trino_tpu_torch.service.verifier"]
MESH_PACKAGES = [("trino_tpu_torch.parallel", ("mesh", "exchange", "mesh_plan", "mesh_chunk")),
                 ("trino_tpu_torch.compile", ("shapes",))]
SERVING_MODULES = ["trino_tpu_torch.compile.cache", "trino_tpu_torch.compile.warmup",
                   "trino_tpu_torch.resident", "trino_tpu_torch.resident.manager",
                   "trino_tpu_torch.resident.table", "trino_tpu_torch.resident.fastlane",
                   "trino_tpu_torch.serving.batcher", "trino_tpu_torch.serving.harness"]
TIER_MODULES = ["trino_tpu_torch.adaptive", "trino_tpu_torch.adaptive.spool",
                "trino_tpu_torch.adaptive.observer", "trino_tpu_torch.adaptive.controller",
                "trino_tpu_torch.recovery", "trino_tpu_torch.recovery.checkpoint",
                "trino_tpu_torch.recovery.stage_spool"]
REPLICA_MODULES = ["trino_tpu_torch.runtime.scheduler", "trino_tpu_torch.runtime.replicas",
                   "trino_tpu_torch.runtime.fabric", "trino_tpu_torch.runtime.chaos"]

# check name -> code run first and alone in a child process (see `alone`)
ALONE = {
    "all": (
        "import importlib, sys\n"
        f"for m in {_module_names()!r}:\n"
        "    importlib.import_module(m)\n"
        "import trino_tpu_torch.engine\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m.startswith('jaxlib.')"
        " or m == 'trino_tpu' or m.startswith('trino_tpu.'))\n"
        "assert not bad, bad\n"
    ),
    **{f"zone:{m}": _imports_clean(m) + (
        # and the zone module builds no table until a device function runs
        "tz = sys.modules.get('trino_tpu_torch.ops.tz')\n"
        "assert tz is None or tz._zone_flat.cache_info().currsize == 0\n") for m in ZONE_MODULES},
    **{f"write:{m}": _imports_clean(m) + (
        "from trino_tpu_torch.transaction import TransactionManager\n"
        "from trino_tpu_torch.connectors.spi import CatalogManager\n"
        "tm = TransactionManager(CatalogManager())\n"
        "tx = tm.begin(read_only=True)\n"
        "assert tm.is_read_only(tx) and tm.is_active(tx)\n"
        "tm.rollback(tx)\n"
        "assert not tm.is_active(tx)\n") for m in WRITE_MODULES},
    **{f"statement:{m}": _imports_clean(m) for m in STATEMENT_MODULES},
    **{f"file:{m}": _imports_clean(m, _BAD_FILES) for m in FILE_MODULES},
    **{f"memory:{m}": _imports_clean(m) + (
        # and the native library is not built by an import
        "native = sys.modules.get('trino_tpu_torch.native')\n"
        "assert native is None or native._lib is None\n") for m in MEMORY_MODULES},
    **{f"wire:{m}": _imports_clean(m) + (
        # and no server thread is started (nor a socket opened)
        "assert threading.active_count() == 1, threading.enumerate()\n") for m in WIRE_MODULES},
    **{f"mesh:{p}": _imports_clean(p) + "".join(
        f"importlib.import_module({p + '.' + m!r})\n" for m in ms) + (
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {_BAD})\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n")
       for p, ms in MESH_PACKAGES},
    **{f"serving:{m}": _imports_clean(m) + (
        # and no thread is started, no kernel-library directory prepared
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "cache = sys.modules.get('trino_tpu_torch.compile.cache')\n"
        "assert cache is None or cache.ACTIVE_PERSISTENT_CACHE is None\n") for m in SERVING_MODULES},
    **{f"tiers:{m}": _imports_clean(m) + (
        # and no thread is started, and the process-wide stores start empty
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "for name, attr in (('trino_tpu_torch.adaptive.spool', 'SPOOL'),\n"
        "                   ('trino_tpu_torch.recovery.checkpoint', 'CHECKPOINTS')):\n"
        "    mod = sys.modules.get(name)\n"
        "    assert mod is None or len(getattr(mod, attr)._entries) == 0\n") for m in TIER_MODULES},
    **{f"replicas:{m}": _imports_clean(m) + (
        # and no thread is started, no fabric attached, no push hook set
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "fabric = sys.modules.get('trino_tpu_torch.runtime.fabric')\n"
        "assert fabric is None or fabric.ACTIVE_FABRIC is None\n"
        "chunk = sys.modules.get('trino_tpu_torch.parallel.mesh_chunk')\n"
        "assert chunk is None or chunk.CHECKPOINT_PUSH_HOOK is None\n") for m in REPLICA_MODULES},
}

_ALONE_HELPER = r"""
import io, json, os, sys, traceback
import torch  # what every port module imports first
assert not [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'trino_tpu')]
results = {}
for name, code in json.load(sys.stdin).items():
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        out, err, rc = io.StringIO(), "", 0
        sys.stdout = out
        try:
            exec(compile(code, name, "exec"), {"__name__": "__main__"})
        except BaseException:
            rc, err = 1, traceback.format_exc()
        with os.fdopen(w, "w") as fh:
            json.dump({"rc": rc, "stdout": out.getvalue(), "stderr": err}, fh)
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as fh:
        results[name] = json.loads(fh.read() or '{"rc": 1, "stderr": "no report"}')
    os.waitpid(pid, 0)
print(json.dumps(results))
"""


@pytest.fixture(scope="module")
def alone():
    """Each check of ALONE in a process of its own whose only earlier
    import is torch: one helper process imports torch (and asserts that
    this pulled in nothing of jax or trino_tpu), then forks one child a
    check, so every module is still imported first and alone, without
    paying torch's import once a check."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _ALONE_HELPER], input=json.dumps(ALONE),
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def _check_alone(alone, name):
    res = alone[name]
    assert res["rc"] == 0, res["stderr"]
    assert res["stdout"] == ""


def test_import_pulls_in_no_jax_and_no_reference_package(alone):
    _check_alone(alone, "all")


@pytest.mark.parametrize("module", ZONE_MODULES)
def test_zone_and_pattern_modules_import_alone(module, alone):
    # each imported first and alone: neither pulls in jax nor anything of
    # trino_tpu, and the zone module builds no table until a device
    # function runs
    _check_alone(alone, f"zone:{module}")


@pytest.mark.parametrize("module", WRITE_MODULES)
def test_write_side_modules_import_alone(module, alone):
    # the write side keeps its own transaction manager: imported first and
    # alone, none of these pulls in jax or trino_tpu
    # (trino_tpu/transaction.py itself imports trino_tpu.analysis)
    _check_alone(alone, f"write:{module}")


@pytest.mark.parametrize("module", STATEMENT_MODULES)
def test_statement_surface_modules_import_alone(module, alone):
    # the port keeps its own copy of each (trino_tpu/security.py and
    # sql/formatter.py import no jax, but are the reference's): imported
    # first and alone, none pulls in jax or trino_tpu
    _check_alone(alone, f"statement:{module}")


@pytest.mark.parametrize("module", FILE_MODULES)
def test_file_connector_modules_import_alone(module, alone):
    # the port keeps its own codec and snappy (trino_tpu's import no jax,
    # but are the reference's), and the card machine has neither pyarrow
    # nor, maybe, zstandard: imported first and alone, none of these
    # pulls in jax, trino_tpu, pyarrow or zstandard
    _check_alone(alone, f"file:{module}")


@pytest.mark.parametrize("module", MEMORY_MODULES)
def test_memory_spill_and_page_modules_import_alone(module, alone):
    # imported first and alone, none of the memory, spill, serde,
    # exchange or statistics modules pulls in jax or trino_tpu, and the
    # native library is not built by an import
    _check_alone(alone, f"memory:{module}")


@pytest.mark.parametrize("module", WIRE_MODULES)
def test_wire_and_front_door_modules_import_alone(module, alone):
    # imported first and alone, none of the wire or front-door modules
    # pulls in jax or trino_tpu, and none starts a server thread or opens
    # a socket
    _check_alone(alone, f"wire:{module}")


@pytest.mark.parametrize("package", [p for p, _ in MESH_PACKAGES])
def test_mesh_plane_packages_import_alone(package, alone):
    # the mesh plane's packages, imported first and alone, pull in
    # neither jax nor trino_tpu and start no thread
    _check_alone(alone, f"mesh:{package}")


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_tier_modules_import_alone(module, alone):
    # the program cache, warmup, resident and serving modules, imported
    # first and alone, pull in neither jax nor trino_tpu, start no thread
    # and prepare no kernel-library directory
    _check_alone(alone, f"serving:{module}")


@pytest.mark.parametrize("module", TIER_MODULES)
def test_adaptive_and_recovery_modules_import_alone(module, alone):
    # the adaptive and recovery tiers, imported first and alone, pull in
    # neither jax nor trino_tpu, start no thread and hold no entry
    _check_alone(alone, f"tiers:{module}")


@pytest.mark.parametrize("module", REPLICA_MODULES)
def test_replica_plane_modules_import_alone(module, alone):
    # the run queue, the replica plane, the fabric and the chaos harness,
    # imported first and alone, pull in neither jax nor trino_tpu, start
    # no thread, attach no fabric and set no push hook
    _check_alone(alone, f"replicas:{module}")


def test_phase_files_statements_at_tiny():
    """chip_smoke.py phase files' statements and identities at tiny on
    the port's CPU runner (the card runs them at sf1), its temporary
    directory removed after."""
    import tempfile

    sys.path.insert(0, REPO)
    import chip_smoke as CS

    before = set(os.listdir(tempfile.gettempdir()))
    steps = CS.file_identities("tiny", "cpu", lambda msg: None)
    assert all(rec["error"] is None for rec in steps.values())
    assert steps["ctas_orders"]["rows"] == [[15000]]
    assert steps["insert"]["rows"][0][0] > 0
    assert steps["blackhole_select"]["rows"] == []
    assert steps["first_parse"]["bytes_scanned"] > 0 and steps["group"]["bytes_scanned"] == 0
    assert {k for k in set(os.listdir(tempfile.gettempdir())) - before
            if k.startswith("chip_smoke_files_")} == set()


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_sources_import_no_jax_or_reference(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]] if node.level == 0 else []
        else:
            continue
        for r in roots:
            assert r not in ("jax", "jaxlib", "trino_tpu"), (
                f"{path}:{node.lineno} imports {r}"
            )


def test_runner_defaults_to_the_card():
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    if torch.cuda.is_available():
        assert LocalQueryRunner(Session()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LocalQueryRunner(Session())
    assert LocalQueryRunner(Session(), device="cpu").device.type == "cpu"


def _catalog(name):
    import numpy as np

    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.memory import create_memory_connector
    from trino_tpu_torch.connectors.spi import ColumnMetadata
    from trino_tpu_torch.connectors.tpcds import create_tpcds_connector

    if name == "tpcds":
        return "tiny", "store_sales", create_tpcds_connector()
    conn = create_memory_connector()
    conn.load_table("default", "t", [ColumnMetadata("x", T.BIGINT)],
                    [np.arange(5, dtype=np.int64)])
    return "default", "t", conn


@pytest.mark.parametrize("catalog", ["memory", "tpcds"])
def test_memory_and_tpcds_runners_default_to_the_card(catalog):
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    schema, table, conn = _catalog(catalog)
    session = Session(catalog=catalog, schema=schema)
    if torch.cuda.is_available():
        assert LocalQueryRunner(session).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LocalQueryRunner(session)
    r = LocalQueryRunner(session, device="cpu")
    r.register_catalog(catalog, conn)
    assert r.execute(f"select count(*) from {table}").rows[0][0] > 0


def test_kernel_wrapper_refuses_other_devices():
    from trino_tpu_torch.ops.mxu_groupby import grouped_sum

    gid = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        grouped_sum(gid, gid.to(torch.int64).view(1, 4), gid.to(torch.bool), 8)


@pytest.mark.parametrize("name", ["rank", "take_flat", "take_rows_sum", "take_along_lanes",
                                  "bounds", "run_owner"])
def test_join_kernel_wrappers_refuse_other_devices(name):
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import window_rank as W

    i32 = torch.zeros((4, 128), dtype=torch.int32, device="meta")
    calls = {
        "rank": lambda: W.rank(i32.reshape(-1), i32.reshape(-1), True),
        "take_flat": lambda: GK.take_flat(i32.reshape(-1), i32.reshape(-1)),
        "take_rows_sum": lambda: GK.take_rows_sum(i32, i32[0]),
        "take_along_lanes": lambda: GK.take_along_lanes(i32, i32),
        "bounds": lambda: W.bounds(i32.reshape(-1), i32.reshape(-1)),
        "run_owner": lambda: W.run_owner(i32.reshape(-1), 8),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[name]()


@pytest.mark.parametrize("module", ["pallas_gather", "kernel_costs"])
def test_explorers_exit_nonzero_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the explorer would run")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", f"trino_tpu_torch.explore.{module}"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_kernel_ab_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the comparison would run")
    proc = subprocess.run(
        [sys.executable, "kernel_ab.py", REPO, REPO], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_lock_ab_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the comparison would run")
    proc = subprocess.run(
        [sys.executable, "lock_ab.py", REPO, REPO], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_lock_ab_times_every_round_trip_and_leaves_the_witness_as_it_was(monkeypatch):
    import lock_ab
    from trino_tpu_torch.analysis import witness

    monkeypatch.setattr(lock_ab, "CALLS", 10)
    was = witness.witness_enabled()
    out = lock_ab.lock_costs()
    assert witness.witness_enabled() == was
    assert sorted(out) == ["bare_lock_us", "count_launch_us", "named_lock_witness_off_us",
                           "named_lock_witness_on_us"]
    assert all(len(v) == lock_ab.REPEATS and min(v) > 0 for v in out.values())


def test_device_timing_refuses_an_unknown_mode():
    from trino_tpu_torch.explore import device_ms

    with pytest.raises(ValueError, match="mode"):
        device_ms(lambda: None, 1, "hot")


def test_chip_smoke_alone_prints_no_result(tmp_path):
    # without the package beside it (or without a card) the script fails
    # and prints no result line
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
