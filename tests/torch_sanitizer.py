"""The port's module-teardown concurrency sanitizer.

Counterpart of tests/conftest.py's `_concurrency_sanitizer`, over the
port's own analysis/ (trino_tpu_torch.analysis): after each module, no
non-daemon thread may still run, no witness lock may still be held, and
the module may not have recorded a lock-witness violation. The witness
is on under pytest, so every named lock the module took was
order-checked.

Every tests/test_torch_*.py module imports the fixture into its
namespace (pytest then runs it for that module only), so it also runs
under `--noconftest` on the card:

    from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401

tests/test_torch_card.py imports it as `torch_sanitizer` (pytest puts
this directory on sys.path), since the card's machine may install
another package named `tests`.
"""

import sys
import time

import pytest

from trino_tpu_torch.analysis import threadreg, witness


def _port_leaks():
    """Non-daemon threads still alive, less those the reference's own
    registry holds: a parity test runs trino_tpu beside the port (its
    resident fast lane keeps a long-lived compaction worker), and
    tests/conftest.py's sanitizer watches the reference's threads."""
    leaks = threadreg.THREADS.non_daemon_leaks()
    reference = sys.modules.get("trino_tpu.analysis.threadreg")
    if reference is None:
        return leaks
    theirs = {f"{name} (UNREGISTERED)" for name, _owner, _daemon in reference.THREADS.live()}
    return [leak for leak in leaks if leak not in theirs]


@pytest.fixture(autouse=True, scope="module")
def port_concurrency_sanitizer():
    assert witness.witness_enabled(), "the port's lock witness is off under pytest"
    violations_before = witness.violation_count()
    yield
    leaks = _port_leaks()
    deadline = time.monotonic() + 2.0
    # grace for threads mid-exit (target returned, join pending)
    while leaks and time.monotonic() < deadline:
        time.sleep(0.02)
        leaks = _port_leaks()
    assert not leaks, "non-daemon threads leaked by this module: " + ", ".join(leaks)

    held = witness.held_locks()
    deadline = time.monotonic() + 1.0
    # a background daemon may hold a lock for a moment
    while held and time.monotonic() < deadline:
        time.sleep(0.01)
        held = witness.held_locks()
    assert not held, f"port locks still held after module: {held}"
    recorded = witness.violation_count() - violations_before
    assert recorded == 0, (
        f"{recorded} port lock-witness violations recorded by this module "
        "(a LockOrderError was raised and swallowed somewhere)")
