"""A benchmark run loads no JAX and no JAX package, and the plain
references import nothing of the port."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "trino_tpu"}

_PROBE = """
import json, sys
from portbench.run import run_cell
r = run_cell("tpch_sf10.streams_scan", 9, 2.0, False, device="cpu", scale_factor=0.01)
print(json.dumps({"correct": r["result"]["correct"],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "trino_tpu_torch" in got["top"]
    assert not FORBIDDEN & set(got["top"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_yardstick_imports_nothing_of_the_port():
    """The references, the comparison, the generators, the traffic and the
    metric arithmetic: only sut.py, run.py and streams.py reach the port."""
    base = os.path.join(ROOT, "portbench")
    allowed = {"sut.py", "run.py", "streams.py"}
    for d, _, files in os.walk(base):
        if "tests" in d.split(os.sep) or "_cache" in d:
            continue
        for f in files:
            if f.endswith(".py") and not (d == base and f in allowed):
                for name in _imports(os.path.join(d, f)):
                    assert name.split(".")[0] not in FORBIDDEN | {"trino_tpu_torch"}, (f, name)
