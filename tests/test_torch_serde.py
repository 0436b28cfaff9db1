"""Page serde, the native page loops and hash partitioning: trino_tpu_torch
against trino_tpu.

- The same host rows, as a batch of each package, serialize to the same
  bytes for every flat type, decimal(19..38), TIMESTAMP WITH TIME ZONE
  and nested types, with and without dead rows, and the port's page
  decodes back to the input. tests/test_nested_types.py's three wire
  round trips (array of map with a row and a bigint, the live mask, the
  type tree) are held the same way.
- tests/test_native.py's five cases: the native library builds into
  trino_tpu_torch/_build/ and matches its numpy twins; a failed build
  raises; split_page keeps NULL flags.
- `partition_of` and `_partition_ids` are bit-equal to the reference's,
  and hash_split_batch's pages are byte-equal.
"""

import os

import numpy as np
import pytest
import torch

from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
import trino_tpu.runtime  # noqa: F401 - before exchange_ops, as the reference's own import order has it
import tests.test_native as native_corpus
from trino_tpu import types as JT
from trino_tpu.block import Column as JColumn
from trino_tpu.block import RelBatch as JBatch
from trino_tpu.exec import serde as jserde
from trino_tpu.ops import tz as jtz
from trino_tpu_torch import native
from trino_tpu_torch import types as T
from trino_tpu_torch.block import Column, RelBatch
from trino_tpu_torch.exec import exchange_ops as tex
from trino_tpu_torch.exec import serde
from trino_tpu_torch.ops import hashing as th
from trino_tpu_torch.ops import tz


def _both(type_name, *args):
    """The DataType of each package."""
    jt, tt = getattr(JT, type_name), getattr(T, type_name)
    return (jt(*args), tt(*args)) if args else (jt, tt)


def _decimal(p, s):
    return (JT.DataType(JT.TypeKind.DECIMAL, p, s), T.DataType(T.TypeKind.DECIMAL, p, s))


NY, TOKYO = tz.zone_id("America/New_York"), tz.zone_id("Asia/Tokyo")
TSTZ = [tz.pack_py(1_700_000_000_000, NY), None, tz.pack_py(-86_400_000, TOKYO),
        tz.pack_py(0, tz.zone_id("UTC"))]

FLAT = {
    "boolean": (_both("BOOLEAN"), [True, None, False, True]),
    "tinyint": (_both("TINYINT"), [1, -128, None, 127]),
    "smallint": (_both("SMALLINT"), [1, None, -32768, 7]),
    "integer": (_both("INTEGER"), [None, 2, -3, 2**31 - 1]),
    "bigint": (_both("BIGINT"), [1, None, -(2**63), 2**63 - 1]),
    "real": (_both("REAL"), [1.5, None, -0.0, 3.25]),
    "double": (_both("DOUBLE"), [1.5, None, float("inf"), -2.0e300]),
    "varchar": (_both("VARCHAR"), ["x", None, "zeta", "x"]),
    "date": (_both("DATE"), [0, None, 19000, -1]),
    "timestamp": (_both("TIMESTAMP"), [0, 1_700_000_000_000, None, -5]),
    "decimal(12,2)": (_decimal(12, 2), [123, None, -5, 999_999_999_999]),
    "decimal(19,0)": (_decimal(19, 0), [10**18, None, -(10**18), 7]),
    "decimal(30,2)": (_decimal(30, 2), [10**25, -5, None, 123]),
    "decimal(38,10)": (_decimal(38, 10), [10**37, None, -(10**37), 0]),
}
NESTED = {
    "array(bigint)": (lambda t: t.array_of(t.BIGINT), [[1, 2], None, [], [3]]),
    "array(varchar)": (lambda t: t.array_of(t.VARCHAR), [["a", None], None, ["b"], []]),
    "map(varchar,bigint)": (lambda t: t.map_of(t.VARCHAR, t.BIGINT),
                            [{"a": 1}, None, {}, {"b": 2, "c": 3}]),
    "row(x bigint,y varchar)": (lambda t: t.row_of(("x", t.BIGINT), ("y", t.VARCHAR)),
                                [(1, "p"), None, (3, None), (4, "q")]),
    "array(array(bigint))": (lambda t: t.array_of(t.array_of(t.BIGINT)),
                             [[[1], [2, 3]], [], None, [[]]]),
    "array(row(a double))": (lambda t: t.array_of(t.row_of(("a", t.DOUBLE))),
                             [[(1.5,), None], None, [], [(2.0,)]]),
}


def _batches(types, values):
    """(reference batch, port batch) of one column over `values`."""
    jt, tt = types
    return (JBatch.from_pydict([("c", jt)], {"c": values}),
            RelBatch.from_pydict([("c", tt)], {"c": values}))


def _tstz_batches():
    data = np.asarray([v if v is not None else 0 for v in TSTZ], dtype=np.int64)
    valid = np.asarray([v is not None for v in TSTZ])
    return (JBatch([JColumn.from_numpy(JT.TIMESTAMP_TZ, data, valid)], None),
            RelBatch([Column.from_numpy(T.TIMESTAMP_TZ, data, valid)], None))


def _masked(jb, tb, keep):
    import jax.numpy as jnp

    k = np.zeros(tb.capacity, dtype=bool)
    k[: len(keep)] = keep
    return jb.mask(jnp.asarray(k)), tb.mask(torch.from_numpy(k))


CASES = ({n: lambda v=v: _batches(*v) for n, v in FLAT.items()}
         | {n: lambda v=v: _batches((v[0](JT), v[0](T)), v[1]) for n, v in NESTED.items()}
         | {"timestamp with time zone": _tstz_batches})


@pytest.mark.parametrize("masked", [False, True], ids=["all_live", "dead_rows"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_pages_are_byte_equal_and_round_trip(name, masked):
    jb, tb = CASES[name]()
    if masked:
        jb, tb = _masked(jb, tb, [True, False, True, True])
    want = jserde.serialize_batch(jb)
    got = serde.serialize_batch(tb)
    assert got == want
    back = serde.deserialize_batch(got, "cpu")
    assert back.to_pylists() == tb.to_pylists()
    assert back.columns[0].type == tb.columns[0].type


def test_a_wide_batch_compresses_equally():
    n = 3000
    vals = {"a": list(range(n)), "s": [f"v{i % 7}" for i in range(n)],
            "d": [i * 0.5 for i in range(n)]}
    jb = JBatch.from_pydict([("a", JT.BIGINT), ("s", JT.VARCHAR), ("d", JT.DOUBLE)], vals)
    tb = RelBatch.from_pydict([("a", T.BIGINT), ("s", T.VARCHAR), ("d", T.DOUBLE)], vals)
    got = serde.serialize_batch(tb)
    assert got[0] == 1  # zlib framing above COMPRESS_MIN_BYTES
    assert got == jserde.serialize_batch(jb)
    assert serde.deserialize_batch(got, "cpu").to_pylists() == tb.to_pylists()


def _nested_round_trip_batches(t, module_block):
    amap = t.array_of(t.map_of(t.VARCHAR, t.BIGINT))
    vals = [[{"a": 1, "b": 2}, {}], None, [{"c": 3}], []]
    c1 = module_block.Column.from_pylist(amap, vals)
    c2 = module_block.Column.from_pylist(
        t.row_of(("x", t.BIGINT), ("y", t.VARCHAR)), [(1, "p"), None, (3, "q"), (4, None)])
    c3 = module_block.Column.from_pylist(t.BIGINT, [10, None, 30, 40])
    return module_block.RelBatch([c1, c2, c3], None), vals


def test_nested_round_trip_array_of_map():
    import trino_tpu.block as jblock
    import trino_tpu_torch.block as tblock

    jb, vals = _nested_round_trip_batches(JT, jblock)
    tb, _ = _nested_round_trip_batches(T, tblock)
    page = serde.Page.from_batch(tb)
    data = serde.serialize_page(page)
    assert data == jserde.serialize_page(jserde.Page.from_batch(jb))
    back = serde.deserialize_page(data).to_batch(device="cpu")
    assert back.columns[0].to_pylist(count=4) == vals
    assert back.columns[1].to_pylist(count=4) == [(1, "p"), None, (3, "q"), (4, None)]
    assert back.columns[2].to_pylist(count=4) == [10, None, 30, 40]


def test_nested_round_trip_respects_the_live_mask():
    """Dead rows and their element slices stay off the wire."""
    import jax.numpy as jnp

    vals = [[1, 2], [3], [4, 5, 6], [7]]
    jc = JColumn.from_pylist(JT.array_of(JT.BIGINT), vals)
    tc = Column.from_pylist(T.array_of(T.BIGINT), vals)
    live = np.array([True, False, True, False] + [False] * (tc.capacity - 4))
    page = serde.Page.from_batch(RelBatch([tc], torch.from_numpy(live)))
    assert page.row_count == 2
    data = serde.serialize_page(page)
    assert data == jserde.serialize_page(
        jserde.Page.from_batch(JBatch([jc], jnp.asarray(live))))
    back = serde.deserialize_page(data).to_batch(device="cpu")
    assert back.columns[0].to_pylist(count=2) == [[1, 2], [4, 5, 6]]
    # the flat store shrank to exactly the live rows' elements
    assert int(back.columns[0].data[:2].sum()) == 5


def test_nested_round_trip_keeps_the_type_tree():
    t = T.array_of(T.map_of(T.VARCHAR, T.array_of(T.BIGINT)))
    jt = JT.array_of(JT.map_of(JT.VARCHAR, JT.array_of(JT.BIGINT)))
    vals = [[{"k": [1, 2]}], []]
    page = serde.Page.from_batch(RelBatch([Column.from_pylist(t, vals)], None))
    data = serde.serialize_page(page)
    assert data == jserde.serialize_page(
        jserde.Page.from_batch(JBatch([JColumn.from_pylist(jt, vals)], None)))
    back = serde.deserialize_page(data)
    assert back.types[0] == t
    assert back.to_batch(device="cpu").columns[0].to_pylist(count=2) == vals


# ---- tests/test_native.py ----------------------------------------------------


def _native_names(monkeypatch):
    monkeypatch.setattr(native_corpus, "native", native)
    monkeypatch.setattr(native_corpus, "T", T)
    monkeypatch.setattr(native_corpus, "RelBatch", RelBatch)
    monkeypatch.setattr(native_corpus, "Page", serde.Page)
    monkeypatch.setattr(native_corpus, "split_page", tex.split_page)


def test_native_library_builds_into_the_build_directory(monkeypatch):
    _native_names(monkeypatch)
    native_corpus.test_native_library_builds()
    package = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert os.path.dirname(native.LIBRARY) == os.path.join(package, "_build")
    assert os.path.exists(native.LIBRARY)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64, np.bool_, np.int8])
def test_scatter_matches_numpy(dtype, monkeypatch):
    _native_names(monkeypatch)
    native_corpus.test_scatter_matches_numpy(dtype)


@pytest.mark.parametrize("name", ["test_mask_compact_matches_numpy",
                                  "test_split_page_with_nulls"])
def test_native_corpus_case(name, monkeypatch):
    _native_names(monkeypatch)
    getattr(native_corpus, name)()


def test_numpy_twins_equal_the_library():
    """The corpus's fallback case, with the plain versions called by
    name (the port never falls back on its own)."""
    rng = np.random.default_rng(1)
    n = 5000
    pids = rng.integers(-1, 3, n).astype(np.int32)
    cols = [rng.integers(0, 50, n).astype(np.int64),
            rng.integers(-9, 9, (n, 2)).astype(np.int64)]
    lib_out = native.partition_scatter(cols, pids, 3)
    np_out = native.partition_scatter_numpy(cols, pids, 3)
    for p in range(3):
        for a, b in zip(lib_out[p], np_out[p]):
            assert np.array_equal(a, b)
    mask = rng.integers(0, 2, n).astype(bool)
    for a, b in zip(native.mask_compact(cols, mask), native.mask_compact_numpy(cols, mask)):
        assert np.array_equal(a, b)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "pagesplit.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "_build" / "libpagesplit.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on pagesplit.cpp"):
        native.get_lib()
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ at all
    with pytest.raises(RuntimeError, match="g\\+\\+ could not build"):
        native.get_lib()


# ---- partitioning ------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13, 64])
def test_partition_of_is_bit_equal(n):
    import jax.numpy as jnp
    from trino_tpu.ops.hashing import partition_of as jpartition_of

    rng = np.random.default_rng(n)
    h = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jpartition_of(jnp.asarray(h), n))
    got = th.partition_of(torch.from_numpy(h.astype(np.int64)), n).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, th.partition_of_np(h, n))


def _key_batches():
    """A reference batch and a port batch over the same key columns:
    bigint with NULLs, a dictionary string, a double, a tstz, dead rows."""
    vals = {"k": [1, None, 3, 4, 5, 6, 7, 8], "s": ["a", "b", None, "a", "c", "b", "d", "a"],
            "d": [0.5, -0.0, 0.0, None, 2.5, 1e300, -7.25, 3.0]}
    jschema = [("k", JT.BIGINT), ("s", JT.VARCHAR), ("d", JT.DOUBLE)]
    tschema = [("k", T.BIGINT), ("s", T.VARCHAR), ("d", T.DOUBLE)]
    jb, tb = JBatch.from_pydict(jschema, vals), RelBatch.from_pydict(tschema, vals)
    packed = np.asarray([tz.pack_py(1000 * i, NY if i % 2 else TOKYO) for i in range(8)]
                        + [0] * (tb.capacity - 8), dtype=np.int64)
    jb = JBatch(jb.columns + [JColumn.from_numpy(JT.TIMESTAMP_TZ, packed[:8])], jb.live)
    tb = RelBatch(tb.columns + [Column.from_numpy(T.TIMESTAMP_TZ, packed[:8])], tb.live)
    return _masked(jb, tb, [True, True, True, False, True, True, True, True])


@pytest.mark.parametrize("channels", [[0], [1], [2], [3], [0, 1, 2, 3]],
                         ids=["bigint", "varchar", "double", "tstz", "all"])
@pytest.mark.parametrize("n", [4, 5])
def test_hash_split_batch_is_byte_equal(channels, n):
    from trino_tpu.exec.exchange_ops import hash_split_batch as jsplit

    jb, tb = _key_batches()
    want = [jserde.serialize_page(p) for p in jsplit(jb, channels, n)]
    got = [serde.serialize_page(p) for p in tex.hash_split_batch(tb, channels, n)]
    assert got == want
    assert sum(p.row_count for p in tex.hash_split_batch(tb, channels, n)) == 7


def test_partition_ids_equal_the_reference():
    import jax.numpy as jnp
    from trino_tpu.exec.exchange_ops import _partition_ids as jids
    from trino_tpu.ops.hashing import dictionary_lut as jlut

    jb, tb = _key_batches()
    jcols, tcols = jb.columns[:2], tb.columns[:2]
    want = jids(tuple(c.data for c in jcols), tuple(c.valid_mask() for c in jcols),
                (jnp.asarray(jlut(jcols[1].dictionary)),), jb.live_mask(), 7, (False, True))
    lut = torch.from_numpy(th.dictionary_lut(tcols[1].dictionary).astype(np.int64))
    got = tex._partition_ids([c.data for c in tcols], [c.valid_mask() for c in tcols],
                             [lut], tb.live_mask(), 7, [False, True])
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_zones_do_not_move_a_tstz_key():
    """Equal instants in different zones land in one partition."""
    packed = np.asarray([tz.pack_py(5000, NY), tz.pack_py(5000, TOKYO)], dtype=np.int64)
    col = Column.from_numpy(T.TIMESTAMP_TZ, packed)
    b = RelBatch([col], torch.arange(col.capacity) < 2)
    pages = tex.hash_split_batch(b, [0], 8)
    assert sorted(p.row_count for p in pages if p.row_count) == [2]
    assert jtz.zone_id("Asia/Tokyo") == TOKYO  # one registry on this host


def test_skewed_partition_rebalancer_corpus_cases(monkeypatch):
    import trino_tpu.exec.exchange_ops as jex
    import tests.test_local_exchange as lx_corpus

    monkeypatch.setattr(jex, "SkewedPartitionRebalancer", tex.SkewedPartitionRebalancer)
    lx_corpus.test_rebalancer_balances_uneven_pages()
    lx_corpus.test_rebalancer_even_stream_round_robins()
