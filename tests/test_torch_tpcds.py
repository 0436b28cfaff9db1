"""TPC-DS through trino_tpu_torch (device="cpu") against trino_tpu and the
sqlite oracle.

- The generator: every column of every table, and each table's
  row_count, equal to the reference generator's at tiny (arrays and
  dictionaries bit-equal).
- The ten templates of tests/test_tpcds.py (imported, parameters
  substituted by its own `_sql_for`) at SF 0.01: rows equal to
  trino_tpu's (integers, decimals and strings exactly; the decimals of
  both packages decode to the same doubles), and to the sqlite oracle
  within assert_rows_match's tolerance (abs 1e-2, as
  tests/test_tpcds.py). Each template runs once per engine for the
  module; q72 runs in tests/test_torch_tpcds_q72.py.
"""

import sqlite3

import numpy as np
import pytest

from tests.oracle import assert_rows_match, load_tpcds_sqlite, sqlite_rows
from tests.test_tpcds import _NONEMPTY, QUERIES, _sql_for
from tests.test_tpch import to_sqlite
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.connectors import tpcds as jtpcds
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu_torch.connectors import tpcds as ttpcds
from trino_tpu_torch.engine import LocalQueryRunner, Session

SF = 0.01


@pytest.fixture(scope="module")
def oracle():
    conn = sqlite3.connect(":memory:")
    load_tpcds_sqlite(conn, SF)
    yield conn
    conn.close()


@pytest.fixture(scope="module")
def results(oracle):
    """Per template: (port rows, reference rows, oracle rows), each
    computed once for the module."""
    ref = JRunner(JSession(catalog="tpcds", schema="tiny"))
    ref.register_catalog("tpcds", jtpcds.create_tpcds_connector())
    port = LocalQueryRunner(Session(catalog="tpcds", schema="tiny"), device="cpu")
    port.register_catalog("tpcds", ttpcds.create_tpcds_connector())
    cache = {}

    def get(name):
        if name not in cache:
            sql = _sql_for(name, oracle)
            cache[name] = (port.execute(sql).rows, ref.execute(sql).rows,
                           sqlite_rows(oracle, to_sqlite(sql)), "order by" in sql)
        return cache[name]

    return get


@pytest.mark.parametrize("table", sorted(jtpcds.TABLES))
def test_generator_columns_equal_the_reference(table):
    n = jtpcds.row_count(table, SF)
    assert ttpcds.row_count(table, SF) == n
    assert ttpcds.row_count(table, 1.0) == jtpcds.row_count(table, 1.0)
    assert [c for c, _ in ttpcds.TABLES[table]] == [c for c, _ in jtpcds.TABLES[table]]
    assert [str(t) for _, t in ttpcds.TABLES[table]] == \
        [str(t) for _, t in jtpcds.TABLES[table]]
    for col, _ in jtpcds.TABLES[table]:
        want, wd = jtpcds.generate_column(table, col, SF, 0, n)
        got, gd = ttpcds.generate_column(table, col, SF, 0, n)
        want, got = np.asarray(want), np.asarray(got)
        assert got.dtype == want.dtype and np.array_equal(got, want), col
        assert (gd is None) == (wd is None)
        if wd is not None:
            assert gd.values == wd.values, col


# q72 (most of this file's time) runs in tests/test_torch_tpcds_q72.py, so
# that --dist loadfile gives it a worker of its own
TEMPLATES = sorted(n for n in QUERIES if n != "q72")


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_matches_reference_and_oracle(name, results):
    got, want, oracle_rows, ordered = results(name)
    if name in _NONEMPTY:
        assert want, f"{name}: the reference selected no rows at tiny scale"
    assert got == want
    assert_rows_match(got, oracle_rows, ordered=ordered, abs_tol=1e-2)


def test_fact_table_counts():
    port = LocalQueryRunner(Session(catalog="tpcds", schema="tiny"), device="cpu")
    port.register_catalog("tpcds", ttpcds.create_tpcds_connector())
    for table in ("store_sales", "catalog_sales", "inventory"):
        assert port.execute(f"select count(*) from {table}").rows == \
            [[jtpcds.row_count(table, SF)]]


def test_chip_smoke_carries_the_same_templates():
    """chip_smoke.py (which imports no JAX) keeps copies of the template
    texts and of the set that must select rows; they must not drift."""
    import chip_smoke

    assert chip_smoke.TPCDS_QUERIES == QUERIES
    assert chip_smoke.TPCDS_NONEMPTY == _NONEMPTY


def test_count_star_counts_every_chunk():
    """A divergence where the reference is wrong (ROADMAP §3): count(*)
    projects the scan to no columns, and the reference's batch without
    columns and without a live mask has capacity 0, so a chunk whose row
    count is exactly its power-of-two capacity counts 0 rows. With
    chunks of 1024 rows, every chunk of tiny's store_sales (28 x 1024 +
    128) is full; at sf1 the same loses two chunks of 2^20."""
    sql = "select count(*) from store_sales"
    ref = JRunner(JSession(catalog="tpcds", schema="tiny", batch_rows=1024))
    ref.register_catalog("tpcds", jtpcds.create_tpcds_connector())
    port = LocalQueryRunner(Session(catalog="tpcds", schema="tiny", batch_rows=1024),
                            device="cpu")
    port.register_catalog("tpcds", ttpcds.create_tpcds_connector())
    assert port.execute(sql).rows == [[28800]]
    assert ref.execute(sql).rows == [[0]]


def test_chip_smoke_capture_keeps_only_the_largest_arguments():
    """chip_smoke.py times each join kernel on the largest arguments the
    main path gave it while it measures q72's peak memory: its captures
    must keep those arguments and drop the rest."""
    import types

    import chip_smoke

    mod = types.SimpleNamespace(f=lambda *args: len(args))
    cap = chip_smoke.Capture(mod, "f", lambda a, b: (a, b),
                             keep=(lambda k: k, lambda k: (k[1], k[0])))
    with cap:
        for a, b in ((1, 9), (3, 2), (2, 5), (3, 1)):
            assert mod.f(a, b) == 2
    assert cap.calls == 4 and cap.keys == {(1, 9), (3, 2), (2, 5), (3, 1)}
    assert set(cap.args) == {(3, 2), (1, 9)}
    assert cap.largest() == (3, 2) and cap.largest(lambda k: (k[1], k[0])) == (1, 9)
    none = chip_smoke.Capture(mod, "f", lambda a, b: (a, b), keep=())
    with none:
        # a capture made inside another wraps it
        every = chip_smoke.Capture(mod, "f", lambda a, b: (a, b), keep=None)
        with every:
            mod.f(1, 2), mod.f(2, 1)
    assert none.args == {} and none.calls == 2 and len(every.args) == 2


@pytest.mark.parametrize("n,n_b,steps,want", [
    (2048, 33_554_432, 29, 2048 * 29 * 32),   # few searches: the sectors touched
    (4_194_304, 1_500_000, 22, 1_500_000 * 8),  # many: all of b, read once
])
def test_chip_smoke_search_bound_counts_what_a_search_reads(n, n_b, steps, want):
    import chip_smoke

    assert chip_smoke.search_bytes(n, n_b, 8, steps) == want


@pytest.mark.parametrize("case,sectors", [
    ("distinct", 128),    # 128 indices, 8 apart: one int32 sector each
    ("clipped", 1),       # every index past the table: its last element
    ("expansion", 5),     # runs [0, 4), [2, 6), [100, 108), then the tail
])
def test_chip_smoke_flat_bound_counts_the_sectors_a_gather_reads(case, sectors):
    import chip_smoke
    import torch

    if case == "distinct":
        table = torch.zeros(8192, dtype=torch.int32)
        idx = torch.arange(0, 1024, 8, dtype=torch.int32)
    elif case == "clipped":
        table = torch.zeros(1000, dtype=torch.int64)
        idx = torch.full((300,), 5000, dtype=torch.int64)
    else:  # int64: four elements a sector; sectors 0, 1, 25, 26 and 249
        table = torch.zeros(1000, dtype=torch.int64)
        idx = torch.cat([torch.arange(0, 4), torch.arange(2, 6), torch.arange(100, 108),
                         torch.full((16,), 1 << 20)]).to(torch.int32)
    got = chip_smoke.flat_sectors(table, idx)
    assert got == sectors
    n, ib, n_table, elem = idx.numel(), idx.element_size(), table.shape[0], table.element_size()
    assert chip_smoke.flat_bytes(n, ib, n_table, elem, got) == n * (ib + elem) + 32 * sectors
    # never more than the whole table
    assert chip_smoke.flat_bytes(n, ib, 3, elem, got) == n * (ib + elem) + 3 * elem
