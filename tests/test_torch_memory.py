"""The memory connector's read side (trino_tpu_torch.connectors.memory)
against trino_tpu's on the same numpy columns.

- load_table with dictionary strings (codes plus a dictionary, and raw
  python strings), NULLs, a decimal(>18) column and `bucketed_by`: the
  splits, the bucket ids of every row (`_bucket_ids`, through
  ops/hashing's dictionary_lut, hash32_np and partition_of_np), each
  split's rows, the statistics and pushed-down filters equal the
  reference's exactly.
- The host hashing helpers bit-equal to the reference's.
- bench.py's wide-string GROUP BY (BASELINE config 5) at 2^14 rows:
  rows equal to numpy's own group-by of the same arrays and to
  trino_tpu's, on the sort route and on the grouped-sum route.
"""

import numpy as np
import pytest

import chip_smoke

from trino_tpu import types as JT
from trino_tpu.block import Dictionary as JDictionary
from trino_tpu.connectors import memory as jmemory
from trino_tpu.connectors.spi import ColumnMetadata as JColumnMetadata
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.ops import hashing as JH
from trino_tpu_torch import types as T
from trino_tpu_torch.block import Dictionary
from trino_tpu_torch.connectors import memory as tmemory
from trino_tpu_torch.connectors.spi import ColumnMetadata
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.ops import hashing as TH
from trino_tpu_torch.ops import mxu_groupby as TM

N = 3000
WORDS = [f"word-{i:02d}" for i in range(37)]


def _columns(seed=5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, len(WORDS), N).astype(np.int32)
    ints = rng.integers(-(2 ** 40), 2 ** 40, N).astype(np.int64)
    small = rng.integers(0, 50, N).astype(np.int32)
    dec = np.stack([rng.integers(-3, 3, N), rng.integers(-(2 ** 62), 2 ** 62, N)],
                   axis=1).astype(np.int64)
    raw = [None if i % 11 == 0 else f"s{i % 23}" for i in range(N)]
    valids = [rng.random(N) < 0.9, None, rng.random(N) < 0.95, None, None]
    return [codes, ints, small, dec, raw], valids


def _load(pkg_types, cm, conn, dictionary_cls, bucketed_by=("w", "i")):
    arrays, valids = _columns()
    conn.load_table(
        "default", "t",
        [cm("w", pkg_types.VARCHAR), cm("i", pkg_types.BIGINT),
         cm("n", pkg_types.INTEGER), cm("d", pkg_types.decimal(30, 2)),
         cm("r", pkg_types.VARCHAR)],
        arrays, valids, [dictionary_cls(WORDS), None, None, None, None],
        bucketed_by=bucketed_by,
    )
    return conn


@pytest.fixture(scope="module")
def connectors():
    return (_load(JT, JColumnMetadata, jmemory.create_memory_connector(), JDictionary),
            _load(T, ColumnMetadata, tmemory.create_memory_connector(), Dictionary))


def _rows(batches):
    out = []
    for b in batches:
        out.extend(b.to_pylists())
    return out


@pytest.mark.parametrize("n_splits", [1, 3, 4])
def test_splits_and_rows_equal_the_reference(connectors, n_splits):
    jc, tc = connectors
    jh = jc.metadata.get_table_handle("default", "t")
    th = tc.metadata.get_table_handle("default", "t")
    js = jc.split_manager.get_splits(jh, n_splits)
    ts = tc.split_manager.get_splits(th, n_splits)
    assert [(s.seq, s.row_range, s.payload) for s in ts] == \
        [(s.seq, s.row_range, s.payload) for s in js]
    cols = ["w", "i", "n", "d", "r"]
    for a, b in zip(js, ts):
        want = _rows(jc.page_source.batches(a, cols, 1000))
        got = _rows(tc.page_source.batches(b, cols, 1000))
        assert got == want
        # a second scan yields the batches the first one built
        assert _rows(tc.page_source.batches(b, cols, 1000)) == got


@pytest.mark.parametrize("nb", [2, 3, 8])
def test_bucket_ids_equal_the_reference(connectors, nb):
    jc, tc = connectors
    jt = jc.store.tables[("default", "t")]
    tt = tc.store.tables[("default", "t")]
    want = jc.page_source._bucket_ids(jt, nb)
    got = tc.page_source._bucket_ids(tt, nb)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert set(np.unique(got)) == set(range(nb))


def test_metadata_equals_the_reference(connectors):
    jc, tc = connectors
    jh = jc.metadata.get_table_handle("default", "t")
    th = tc.metadata.get_table_handle("default", "t")
    assert tc.metadata.list_tables("default") == jc.metadata.list_tables("default")
    assert tc.metadata.list_schemas() == jc.metadata.list_schemas()
    assert tc.metadata.table_partitioning(th) == jc.metadata.table_partitioning(jh)
    for col in ("w", "r", "i"):
        jd = jc.metadata.column_dictionary(jh, col)
        td = tc.metadata.column_dictionary(th, col)
        assert (td.values if td is not None else None) == \
            (jd.values if jd is not None else None)
    js, ts = jc.metadata.get_table_statistics(jh), tc.metadata.get_table_statistics(th)
    assert ts.row_count == js.row_count
    assert set(ts.columns) == set(js.columns)
    for name in ("w", "i", "n", "r"):
        assert ts.columns[name] == js.columns[name], name


def test_pushed_down_filter_scans_equal_the_reference(connectors):
    jc, tc = connectors
    sql = "select w, i, n, r from t where n < 7 and i > 0 order by i"
    ref = JRunner(JSession(catalog="memory", schema="default"))
    ref.register_catalog("memory", jc)
    port = LocalQueryRunner(Session(catalog="memory", schema="default"), device="cpu")
    port.register_catalog("memory", tc)
    assert port.execute(sql).rows == ref.execute(sql).rows
    sql = "select r, count(*), sum(n) from t group by r order by r"
    assert port.execute(sql).rows == ref.execute(sql).rows


def test_write_side_and_nested_columns_raise():
    """The write side, once a raise naming ROADMAP §1 item 8: each
    package's page sink writes the batches its own page source scans out
    of a loaded table (an array column's flat store, sliced by splits and
    gathered by bucket ids) into a created table, and both read back the
    loaded values (item 4's nested columns, through the flat store)."""
    rows = [[1], [], None, [2, None, 3], [4, 5]] * 7
    want = dict(enumerate(rows))
    for mod, cm, types in ((tmemory, ColumnMetadata, T), (jmemory, JColumnMetadata, JT)):
        conn = mod.create_memory_connector()
        cols = [cm("k", types.BIGINT), cm("a", types.array_of(types.BIGINT))]
        conn.load_table("default", "a", cols,
                        [np.arange(len(rows), dtype=np.int64), rows], bucketed_by=("k",))
        handle = conn.metadata.get_table_handle("default", "a")
        copy = conn.metadata.create_table("default", "b", cols)
        sink = conn.page_sink(copy)
        for n in (1, 3):
            got = {}
            for split in conn.split_manager.get_splits(handle, n):
                for b in conn.page_source.batches(split, ["k", "a"], 4):
                    got.update(dict(b.to_pylists()))
                    if n == 3:
                        sink.append(b)
            assert got == want
        assert sink.finish() == len(rows)
        got = {}
        for split in conn.split_manager.get_splits(copy, 2):
            for b in conn.page_source.batches(split, ["k", "a"], 8):
                got.update(dict(b.to_pylists()))
        assert got == want


def test_bucketing_refuses_float_keys():
    conn = tmemory.create_memory_connector()
    with pytest.raises(ValueError, match="bucketed_by"):
        conn.load_table("default", "f", [ColumnMetadata("x", T.DOUBLE)],
                        [np.zeros(3)], bucketed_by=("x",))


@pytest.mark.parametrize("nb", [1, 5, 16])
def test_host_hashing_helpers_equal_the_reference(nb):
    rng = np.random.default_rng(9)
    h = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(TH.partition_of_np(h, nb), JH.partition_of_np(h, nb))
    d, jd = Dictionary(WORDS + ["é", ""]), JDictionary(WORDS + ["é", ""])
    assert np.array_equal(TH.dictionary_lut(d), JH.dictionary_lut(jd))
    assert TH.dictionary_lut(Dictionary([])) is None and TH.dictionary_lut(None) is None


# ---------------------------------------------------------------------------
# BASELINE config 5: the wide-string GROUP BY (bench.py WIDESTR), small
# ---------------------------------------------------------------------------

def _reference_widestr_runner(vals, codes, v):
    conn = jmemory.create_memory_connector()
    conn.load_table("bench", "widestr",
                    [JColumnMetadata("s", JT.VARCHAR), JColumnMetadata("v", JT.BIGINT)],
                    [codes, v], None, [JDictionary(vals), None])
    r = JRunner(JSession(catalog="memory", schema="bench", batch_rows=1 << 22))
    r.register_catalog("memory", conn)
    return r


@pytest.mark.parametrize("route", ["sort", "grouped_sum"])
def test_widestr_group_by_equals_numpy_and_reference(route, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_FORCE_MXU", "1" if route == "grouped_sum" else "0")
    # chip_smoke.py builds the same table at 2^21 rows on the card
    port, (vals, codes, v) = chip_smoke.widestr_runner(1 << 14, "cpu")
    want = chip_smoke.widestr_numpy(vals, codes, v)
    calls = []
    plain = TM.grouped_sum_reference

    def spy(gid, values, live, capacity):
        calls.append((int(gid.shape[0]), int(values.shape[0]), capacity))
        return plain(gid, values, live, capacity)

    monkeypatch.setattr(TM, "grouped_sum_reference", spy)
    got = port.execute(chip_smoke.WIDESTR).rows
    assert got == want
    # one scan batch: count(*), and sum(v) with its count, over 512
    # codes plus the NULL slot
    assert calls == ([(1 << 14, 3, 513)] if route == "grouped_sum" else [])
    ref = _reference_widestr_runner(vals, codes, v)
    assert ref.execute(chip_smoke.WIDESTR).rows == want
