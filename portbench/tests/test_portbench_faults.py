"""`correct` has to come out false when the timed path is broken
underneath, and for the control (the reference in float64 in the
program's place). The harness's look for a card is skipped: these runs
are tiny and on the CPU."""

import pytest

from portbench.control import control_cells
from portbench.run import read_benchmark, run_cell
from portbench.tests.sizes import tiny

CELLS = [w["name"] for w in read_benchmark()["workloads"]]


def _alter_one_answer(monkeypatch):
    """The runner returns one numeric cell of one statement off by one unit
    in its last place, as a wrong kernel would leave it."""
    import math

    from trino_tpu_torch.engine import LocalQueryRunner

    real = LocalQueryRunner.execute
    state = {"n": 0}

    def execute(self, sql, *a, **kw):
        res = real(self, sql, *a, **kw)
        state["n"] += 1
        if state["n"] % 7 == 0:
            for row in res.rows:
                for k, v in enumerate(row):
                    if isinstance(v, float) and v:
                        row[k] = math.nextafter(v, math.inf)
                        return res
                    if isinstance(v, int) and not isinstance(v, bool):
                        row[k] = v + 1
                        return res
        return res

    monkeypatch.setattr(LocalQueryRunner, "execute", execute)


def _drop_half_the_batches(monkeypatch):
    """The scan cuts each table into batches of 2,048 rows and yields every
    other one: half of each table left out."""
    from trino_tpu_torch.connectors.memory import MemoryPageSource

    real = MemoryPageSource.batches

    def batches(self, split, columns, batch_rows, *a, **kw):
        for k, b in enumerate(real(self, split, columns, 2048, *a, **kw)):
            if k % 2 == 0:
                yield b

    monkeypatch.setattr(MemoryPageSource, "batches", batches)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_alter_one_answer, _drop_half_the_batches])
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_cell(cell, 23, 3.0, False, device="cpu", scale_factor=tiny(cell))["result"]
    assert not r["correct"]
    assert r["checks"]["mismatched_cells"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_float64_control_is_not_correct(cell, seed):
    assert control_cells(cell, seed, "cpu", tiny(cell))["mismatched_cells"] > 0
