"""trino_tpu_torch stands alone: no jax, nothing of trino_tpu, and no
silent CPU fallback for the runner."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "trino_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "kernel_ab.py")]
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


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_module_names()!r}:\n"
        "    importlib.import_module(m)\n"
        "import trino_tpu_torch.engine\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m.startswith('jaxlib.')"
        " or m == 'trino_tpu' or m.startswith('trino_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["trino_tpu_torch.ops.tz",
                                    "trino_tpu_torch.exec.match_recognize"])
def test_zone_and_pattern_modules_import_alone(module):
    # each imported first and alone in a fresh process: neither pulls in
    # jax nor anything of trino_tpu, and the zone module builds no table
    # until a device function runs
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'trino_tpu'))\n"
        "assert not bad, bad\n"
        "tz = sys.modules.get('trino_tpu_torch.ops.tz')\n"
        "assert tz is None or tz._zone_flat.cache_info().currsize == 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["trino_tpu_torch.transaction",
                                    "trino_tpu_torch.engine",
                                    "trino_tpu_torch.connectors.memory"])
def test_write_side_modules_import_alone(module):
    # the write side keeps its own transaction manager: imported first and
    # alone in a fresh process, none of these pulls in jax or trino_tpu
    # (trino_tpu/transaction.py itself imports trino_tpu.analysis)
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'trino_tpu'))\n"
        "assert not bad, bad\n"
        "from trino_tpu_torch.transaction import TransactionManager\n"
        "from trino_tpu_torch.connectors.spi import CatalogManager\n"
        "tm = TransactionManager(CatalogManager())\n"
        "tx = tm.begin(read_only=True)\n"
        "assert tm.is_read_only(tx) and tm.is_active(tx)\n"
        "tm.rollback(tx)\n"
        "assert not tm.is_active(tx)\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["trino_tpu_torch.security", "trino_tpu_torch.config",
                                    "trino_tpu_torch.serving.plan_cache",
                                    "trino_tpu_torch.serving.params",
                                    "trino_tpu_torch.sql.formatter",
                                    "trino_tpu_torch.sql.validate"])
def test_statement_surface_modules_import_alone(module):
    # the port keeps its own copy of each (trino_tpu/security.py and
    # sql/formatter.py import no jax, but are the reference's): imported
    # first and alone in a fresh process, none pulls in jax or trino_tpu
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'trino_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["trino_tpu_torch.connectors.file",
                                    "trino_tpu_torch.connectors.parquet_format",
                                    "trino_tpu_torch.connectors.blackhole",
                                    "trino_tpu_torch.utils.snappy"])
def test_file_connector_modules_import_alone(module):
    # the port keeps its own codec and snappy (trino_tpu's import no jax,
    # but are the reference's), and the card machine has neither pyarrow
    # nor, maybe, zstandard: imported first and alone in a fresh process,
    # none of these pulls in jax, trino_tpu, pyarrow or zstandard
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'trino_tpu', 'pyarrow', 'zstandard'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["trino_tpu_torch.runtime",
                                    "trino_tpu_torch.runtime.memory",
                                    "trino_tpu_torch.native",
                                    "trino_tpu_torch.exec.serde",
                                    "trino_tpu_torch.exec.exchange_ops",
                                    "trino_tpu_torch.exec.spill",
                                    "trino_tpu_torch.exec.stats",
                                    "trino_tpu_torch.exec.local_exchange",
                                    "trino_tpu_torch.exec.driver"])
def test_memory_spill_and_page_modules_import_alone(module):
    # imported first and alone in a fresh process, none of the memory,
    # spill, serde, exchange or statistics modules pulls in jax or
    # trino_tpu, and the native library is not built by an import
    code = (
        "import importlib, sys, os\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'trino_tpu'))\n"
        "assert not bad, bad\n"
        "native = sys.modules.get('trino_tpu_torch.native')\n"
        "assert native is None or native._lib is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["trino_tpu_torch.runtime.http",
                                    "trino_tpu_torch.runtime.fte",
                                    "trino_tpu_torch.runtime.server",
                                    "trino_tpu_torch.runtime.spool",
                                    "trino_tpu_torch.runtime.codec",
                                    "trino_tpu_torch.runtime.resource_groups",
                                    "trino_tpu_torch.serving.admission",
                                    "trino_tpu_torch.client",
                                    "trino_tpu_torch.dbapi",
                                    "trino_tpu_torch.cli",
                                    "trino_tpu_torch.service.proxy",
                                    "trino_tpu_torch.service.verifier"])
def test_wire_and_front_door_modules_import_alone(module):
    # imported first and alone in a fresh process, none of the wire or
    # front-door modules pulls in jax or trino_tpu, and none starts a
    # server thread or opens a socket
    code = (
        "import importlib, sys, threading\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'trino_tpu'))\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


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
