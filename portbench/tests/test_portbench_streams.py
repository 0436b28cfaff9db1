"""One tiny run of every cell on the CPU: generation, loading,
the warm-up, the streams through a CoordinatorServer in their own
process, and every answer held against the plain reference."""

import pytest

from portbench.run import read_benchmark, run_cell
from portbench.tests.sizes import tiny

CELLS = [w["name"] for w in read_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell):
    out = run_cell(cell, 2**31 + 17, 3.0, False, device="cpu", scale_factor=tiny(cell))
    r = out["result"]
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["mismatched_cells"]["value"] == 0
    assert "qps" in r["metrics"] and "setup_s" in r["metrics"]
    assert list(r)[-1] == "checks"


def test_traced_tiny_run_reports_per_layer_metrics():
    r = run_cell("tpch_sf10.streams_scan", 5, 3.0, True, device="cpu",
                 scale_factor=0.01)["result"]
    assert r["correct"]
    for name in ("protocol_ms", "engine_ms", "kernel_launches_per_query"):
        assert name in r["metrics"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.card
def test_short_run_on_the_card(card):
    out = run_cell("tpch_sf10.streams_scan", 3, 3.0, False, device=card, scale_factor=0.1)
    assert out["result"]["correct"], out["result"]["checks"]
    assert out["result"]["device"]["memory_peak_bytes"] > 0
