"""The file connectors (CSV, JSON-lines and Parquet tables, the parquet
codec and snappy) and the blackhole sink: trino_tpu_torch (device="cpu")
against trino_tpu.

- The corpora run as written (tests/test_torch_write.py's patch_corpus):
  tests/test_file_connector.py, test_parquet.py and test_pushdown.py's
  two parquet cases on ParityRunners (equal column names, types and rows
  statement by statement, or the same error). Their file-connector
  constructor builds one connector per package: the port's on the
  fixture's root, the reference's on a copy of that tree made when the
  connector is built, so the packages never write into one root and the
  corpus's own checks of `root` read the port's files. The parquet
  codec's names (write_parquet, read_parquet, ParquetColumn and the type
  constants) are the port's, so the reference reads files the port's
  codec wrote.
- test_pushdown.py's cases: each statement's bytes_scanned delta of the
  port's METRICS equals the reference's METRICS delta.
- tests/test_parquet_interop.py and tests/test_connectors.py run on the
  port's modules (the codec, snappy; tpch's generator, memory and
  blackhole at the SPI).
- Reference faults (ROADMAP §3) are pinned with both packages' answers:
  a file table probed under a dynamic filter, long decimals written to
  CSV and to parquet, REAL written to CSV. Every type written by each
  sink and read back is recorded per package (`ROUND_TRIPS`).
- tests/test_file_connector.py's distributed scan runs on the port's
  DistributedQueryRunner (test_distributed_scan_over_files);
  test_the_corpora_are_covered checks that every corpus case runs.
"""

import dataclasses
import inspect
import os
import shutil

import pytest

import tests.test_connectors as connectors_corpus
import tests.test_file_connector as file_corpus
import tests.test_parquet as parquet_corpus
import tests.test_parquet_interop as interop_corpus
import tests.test_pushdown as pushdown_corpus
import tests.test_torch_write as W
from tests.test_torch_statements import _cases, _ids
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
import trino_tpu.connectors as jconnectors
from trino_tpu.connectors import file as jfile
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.runtime.metrics import METRICS
from trino_tpu_torch import types as TT
from trino_tpu_torch.block import RelBatch as TRelBatch
from trino_tpu_torch.connectors import blackhole as tblackhole
from trino_tpu_torch.connectors import file as tfile
from trino_tpu_torch.connectors import memory as tmemory
from trino_tpu_torch.connectors import parquet_format as TPQ
from trino_tpu_torch.connectors import spi as tspi
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.runtime.metrics import METRICS as TMETRICS
from trino_tpu_torch.utils import snappy as tsnappy

tpch = W.tpch

# the reference's constructor, kept before any patch replaces it
_J_FILE = jfile.create_file_connector


def _port_column(c):
    """A reference ParquetColumn as the port's."""
    return TPQ.ParquetColumn(**{f.name: getattr(c, f.name) for f in dataclasses.fields(c)})


def patch_files(monkeypatch, module, tpch, tmp_path_factory) -> list:
    """patch_corpus, and a file-connector constructor that builds the
    port's connector on `root` and the reference's on a copy of the tree
    (made now), and the parquet codec's names bound to the port's."""

    def file_connector(root, file_format="csv"):
        ref_root = str(tmp_path_factory.mktemp("ref") / "root")
        if os.path.isdir(root):
            shutil.copytree(root, ref_root)
        return W.Both(_J_FILE(ref_root, file_format=file_format),
                      tfile.create_file_connector(root, file_format=file_format))

    built = W.patch_corpus(monkeypatch, module, tpch)
    monkeypatch.setattr(module, "create_file_connector", file_connector, raising=False)
    # corpus functions import these from the reference modules
    monkeypatch.setattr(jfile, "create_file_connector", file_connector)
    monkeypatch.setattr(jtpch, "create_tpch_connector", lambda: W.Both(*tpch))
    for name in ("C_DATE", "C_DECIMAL", "C_UTF8", "ParquetColumn", "T_BOOLEAN",
                 "T_BYTE_ARRAY", "T_DOUBLE", "T_INT32", "T_INT64", "read_parquet",
                 "write_parquet"):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, getattr(TPQ, name))
    return built


# ---- tests/test_file_connector.py ------------------------------------------

_FILE_DISTRIBUTED = {"test_distributed_scan_over_files"}
_FILE = _cases(file_corpus, skip=_FILE_DISTRIBUTED)


def test_distributed_scan_over_files(tmp_path, monkeypatch):
    """The corpus's distributed case on the port's runner (2 workers,
    the page exchange), over the port's file connector: its names bound
    by test_torch_distributed.py's portify."""
    from tests.test_torch_distributed import portify

    portify(monkeypatch, file_corpus)
    file_corpus.test_distributed_scan_over_files(file_corpus.root.__wrapped__(tmp_path))


@pytest.mark.parametrize("case", _FILE, ids=_ids(_FILE))
def test_file_connector_corpus(case, tpch, tmp_path, tmp_path_factory, monkeypatch):
    _, name = case
    built = patch_files(monkeypatch, file_corpus, tpch, tmp_path_factory)
    root = file_corpus.root.__wrapped__(tmp_path)
    runner = file_corpus.runner.__wrapped__(root)
    fn = getattr(file_corpus, name)
    args = {"runner": runner, "root": root}
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})
    assert built and all(isinstance(r, W.ParityRunner) for r in built)


# ---- tests/test_parquet.py -------------------------------------------------

_PARQUET = _cases(parquet_corpus)


@pytest.mark.parametrize("case", _PARQUET, ids=_ids(_PARQUET))
def test_parquet_corpus(case, tpch, tmp_path, tmp_path_factory, monkeypatch):
    """The connector cases on ParityRunners over files the port's codec
    wrote; the codec cases (and TestR4Features, which imports the codec
    in its body) on the port's codec alone."""
    cls, name = case
    patch_files(monkeypatch, parquet_corpus, tpch, tmp_path_factory)
    if cls is not None:
        monkeypatch.setattr(jconnectors, "parquet_format", TPQ)
        return getattr(cls(), name)(tmp_path)
    getattr(parquet_corpus, name)(tmp_path)


# ---- tests/test_parquet_interop.py -----------------------------------------

_INTEROP = [(cls, name, codec) for cls, name in _cases(interop_corpus)
            for codec in (("snappy", "zstd", "gzip")
                          if "codec" in inspect.signature(getattr(cls, name)).parameters
                          else (None,))]


@pytest.mark.parametrize("case", _INTEROP,
                         ids=[f"{c.__name__}.{n}" + (f"[{k}]" if k else "")
                              for c, n, k in _INTEROP])
def test_parquet_interop_corpus(case, monkeypatch):
    """pyarrow against the port's codec and snappy."""
    cls, name, codec = case
    fn = getattr(cls, name)
    marks = getattr(fn, "pytestmark", [])
    if (codec == "zstd" or any(m.name == "skipif" for m in marks)) \
            and not interop_corpus._HAS_ZSTD:
        pytest.skip("zstandard not installed")  # the corpus's own condition
    monkeypatch.setattr(interop_corpus, "PQ", TPQ)
    monkeypatch.setattr(interop_corpus, "snappy", tsnappy)
    getattr(cls(), name)(*(() if codec is None else (codec,)))


# ---- tests/test_connectors.py ----------------------------------------------

_CONNECTORS = _cases(connectors_corpus)


@pytest.mark.parametrize("case", _CONNECTORS, ids=_ids(_CONNECTORS))
def test_connectors_corpus(case, monkeypatch):
    """tpch's generator, the memory connector and the blackhole sink at
    the SPI, on the port's modules."""
    _, name = case
    for attr, value in (("T", TT), ("RelBatch", TRelBatch),
                        ("create_blackhole_connector", tblackhole.create_blackhole_connector),
                        ("create_memory_connector", tmemory.create_memory_connector),
                        ("ColumnMetadata", tspi.ColumnMetadata), ("TABLES", ttpch.TABLES),
                        ("base_row_count", ttpch.base_row_count),
                        ("create_tpch_connector", ttpch.create_tpch_connector),
                        ("generate_column", ttpch.generate_column),
                        ("lineitem_row_count", ttpch.lineitem_row_count),
                        ("order_index_to_key", ttpch.order_index_to_key)):
        monkeypatch.setattr(connectors_corpus, attr, value)
    getattr(connectors_corpus, name)()


# ---- tests/test_pushdown.py's parquet cases --------------------------------

_PUSHDOWN = ["test_parquet_bytes_scanned_drops_with_pushdown",
             "test_parquet_row_groups_pruned_by_in_list"]


@pytest.mark.parametrize("name", _PUSHDOWN)
def test_pushdown_parquet_corpus(name, tpch, tmp_path, tmp_path_factory, monkeypatch):
    """Row-group pruning on ParityRunners: every statement's
    bytes_scanned delta equal in both packages."""
    from trino_tpu.connectors import parquet_format as JPQ

    patch_files(monkeypatch, pushdown_corpus, tpch, tmp_path_factory)
    monkeypatch.setattr(JPQ, "write_parquet", lambda path, cols, n, **kw: TPQ.write_parquet(
        path, [_port_column(c) for c in cols], n, **kw))
    deltas = []
    execute = W.ParityRunner.execute

    def counted(self, sql, **kw):
        j0, t0 = METRICS.snapshot().get("bytes_scanned", 0), TMETRICS.counter("bytes_scanned")
        try:
            return execute(self, sql, **kw)
        finally:
            deltas.append((sql, METRICS.snapshot().get("bytes_scanned", 0) - j0,
                           TMETRICS.counter("bytes_scanned") - t0))

    monkeypatch.setattr(W.ParityRunner, "execute", counted)
    getattr(pushdown_corpus, name)(tmp_path)
    assert any(j for _, j, _ in deltas)
    assert [(s, j) for s, j, _ in deltas] == [(s, t) for s, _, t in deltas]


# ---- the corpora's coverage ------------------------------------------------

WAITING: dict = {}


def test_the_corpora_are_covered():
    """Every case of the five corpora runs above or waits, named, for
    its item; test_pushdown.py's parquet cases are all of its cases that
    reach the file connector."""
    ran = {f"test_file_connector.py::{n}" for _, n in _FILE}
    ran |= {f"test_file_connector.py::{n}" for n in _FILE_DISTRIBUTED}
    ran |= {f"test_parquet.py::{n}" for _, n in _PARQUET}
    ran |= {f"test_parquet_interop.py::{n}" for _, n, _ in _INTEROP}
    ran |= {f"test_connectors.py::{n}" for _, n in _CONNECTORS}
    for f, module in (("test_file_connector.py", file_corpus),
                      ("test_parquet.py", parquet_corpus),
                      ("test_parquet_interop.py", interop_corpus),
                      ("test_connectors.py", connectors_corpus)):
        every = {f"{f}::{n}" for _, n in _cases(module)}
        assert every == (ran | set(WAITING)) & every, sorted(every - ran - set(WAITING))
    assert not ran & set(WAITING)
    reaching = {n for _, n in _cases(pushdown_corpus)
                if "create_file_connector" in inspect.getsource(getattr(pushdown_corpus, n))}
    assert reaching == set(_PUSHDOWN)
    assert (len(_FILE), len(_PARQUET), len(_INTEROP), len(_CONNECTORS)) == (10, 7, 8, 16)


# ---- reference faults, and what each sink does with each type -------------

FAULT_CTAS = ("create table f.s.orders as"
              " select o_orderkey, o_custkey, o_totalprice from orders")
FAULT_JOIN = ("select count(*), sum(o.o_totalprice) from {} o join customer c"
              " on o.o_custkey = c.c_custkey where c.c_custkey < 10")


def _runners(tpch, tmp_path, fmt):
    """A reference and a port runner over tpch tiny, each with a file
    catalog `f` writing `fmt` into a root of its own."""
    out = []
    for i, (runner, session, make) in enumerate((
            (JRunner, JSession, _J_FILE),
            (lambda s: LocalQueryRunner(s, device="cpu"), Session, tfile.create_file_connector))):
        r = runner(session(catalog="tpch", schema="tiny"))
        r.register_catalog("tpch", tpch[i])
        r.register_catalog("f", make(str(tmp_path / ("ref", "port")[i]), file_format=fmt))
        out.append(r)
    return out


@pytest.mark.parametrize("fmt", ["csv", "parquet"])
def test_dynamic_filter_over_a_file_probe(fmt, tpch, tmp_path, monkeypatch):
    """Reference fault: the build side's key domain folded into the file
    probe's splits re-filters the table under the ranges of the
    unfiltered one, and the scan fails. The port masks within the range
    and answers as over tpch."""
    ref, port = _runners(tpch, tmp_path, fmt)
    folded = []
    batches = tfile.FilePageSource.batches

    def recording(self, split, *args, **kw):
        folded.append(len(split.table.constraints) - len(split.payload))
        return batches(self, split, *args, **kw)

    monkeypatch.setattr(tfile.FilePageSource, "batches", recording)
    for r in (ref, port):
        assert r.execute(FAULT_CTAS).rows == [[15000]]
    with pytest.raises(ValueError, match="could not broadcast input array from shape"):
        ref.execute(FAULT_JOIN.format("f.s.orders"))
    want = [[89, 11406422.95]]
    assert ref.execute(FAULT_JOIN.format("orders")).rows == want
    assert port.execute(FAULT_JOIN.format("f.s.orders")).rows == want
    assert port.execute(FAULT_JOIN.format("orders")).rows == want
    assert max(folded) == 1  # the probe scan took the dynamic filter


DEC30 = "cast(o_totalprice as decimal(30,2))"


def test_long_decimal_through_csv(tpch, tmp_path):
    """Reference fault: the CSV sink writes a long decimal's limb pair as
    text, and it reads back NULL. The port writes the unscaled integer
    and reads back every value."""
    ref, port = _runners(tpch, tmp_path, "csv")
    src = f"select o_orderkey, {DEC30} p from orders where o_orderkey < 40"
    want = port.execute(src + " order by 1").rows
    for r in (ref, port):
        assert r.execute(f"create table f.s.d as {src}").rows == [[len(want)]]
    back = "select * from f.s.d order by 1"
    assert ref.execute(back).rows == [[k, None] for k, _ in want]
    got = port.execute(back)
    assert [str(t) for t in got.column_types] == ["bigint", "decimal(30,2)"]
    assert got.rows == want and all(p is not None for _, p in want)
    assert port.execute("select sum(p) from f.s.d").rows == port.execute(
        f"select sum({DEC30}) from orders where o_orderkey < 40").rows


def test_long_decimal_through_parquet(tpch, tmp_path):
    """Reference fault: the parquet sink writes a long decimal as INT64
    capped at precision 18, and the table no longer reads (its parts'
    schemas differ). The port refuses the CTAS before any file is
    made."""
    ref, port = _runners(tpch, tmp_path, "parquet")
    ctas = f"create table f.s.d as select o_orderkey, {DEC30} p from orders"
    assert ref.execute(ctas).rows == [[15000]]
    with pytest.raises(ValueError, match="schema mismatch across parquet parts"):
        ref.execute("select * from f.s.d")
    with pytest.raises(ValueError, match=r"^cannot write decimal\(30,2\) to parquet$"):
        port.execute(ctas)
    assert port.execute("show tables from f.s").rows == []
    assert not os.path.exists(tmp_path / "port" / "s" / "d")


def test_real_through_csv(tpch, tmp_path):
    """Reference fault: a REAL cell of a CSV table parses through int()
    and loses its fraction. The port parses it as a float."""
    ref, port = _runners(tpch, tmp_path, "csv")
    src = "select o_orderkey, cast(o_totalprice as real) p from orders where o_orderkey < 40"
    want = port.execute(src + " order by 1").rows
    for r in (ref, port):
        r.execute(f"create table f.s.r as {src}")
    back = "select * from f.s.r order by 1"
    assert ref.execute(back).rows == [[k, float(int(p))] for k, p in want]
    assert port.execute(back).rows == want


# (format, name) -> source of columns k, c; each sink's CTAS of it read back
ROUND_TRIP_SOURCES = {
    "dec12": "cast(o_totalprice as decimal(12,2))",
    "dec30": DEC30,
    "timestamp": "cast(o_orderdate as timestamp)",
    "tstz": "with_timezone(cast(o_orderdate as timestamp), 'America/New_York')",
    "array": "split(o_orderstatus, 'x')",
    "row": "row(o_orderkey, o_custkey)",
    "null_bigint": "cast(null as bigint)",
    "null_varchar": "cast(null as varchar)",
    "null": "null",
    "real": "cast(o_totalprice as real)",
    "smallint": "cast(o_custkey as smallint)",
}
MAP_SOURCE = ("select o_orderstatus k, histogram(o_orderpriority) c from orders"
              " group by 1")


def _round_trip(r, root, fmt, name) -> tuple:
    """('rows', read-back type, equal to the source) or ('error', the
    statement that raised, the error's type, its message, whether the
    table's directory is left)."""
    src = (MAP_SOURCE if name == "map" else
           f"select o_orderkey k, {ROUND_TRIP_SOURCES[name]} c from orders"
           " where o_orderkey < 40")
    stage = "ctas"
    try:
        want = r.execute(src + " order by 1").rows
        r.execute(f"create table f.s.t_{name} as {src}")
        stage = "read"
        got = r.execute(f"select * from f.s.t_{name} order by 1")
    except Exception as e:  # noqa: BLE001 - the outcome recorded
        return ("error", stage, type(e).__name__, str(e),
                os.path.isdir(os.path.join(root, "s", f"t_{name}")))
    return ("rows", str(got.column_types[1]), got.rows == want)


_ROWS = ("rows", None, True)  # read back equal, the source's type
# (format, name) -> (the reference's outcome, the port's); the port either
# reads back every value or refuses before any file is made
ROUND_TRIPS = {
    **{("csv", n): (_ROWS, _ROWS) for n in (
        "dec12", "timestamp", "tstz", "null_bigint", "null_varchar", "null", "smallint")},
    ("csv", "dec30"): (("rows", "decimal(30,2)", False), _ROWS),
    ("csv", "real"): (("rows", "real", False), _ROWS),
    ("csv", "array"): (("error", "ctas", "NotImplementedError",
                        "cast array(varchar) -> array(None)", True),
                       ("error", "ctas", "ValueError", "cannot write array(varchar) to csv",
                        False)),
    ("csv", "map"): (("error", "ctas", "NotImplementedError",
                      "cast map(varchar, bigint) -> map(None, None)", True),
                     ("error", "ctas", "ValueError",
                      "cannot write map(varchar, bigint) to csv", False)),
    ("csv", "row"): (("error", "ctas", "TypeError", "'NoneType' object is not iterable", True),
                     ("error", "ctas", "ValueError", "cannot write row(bigint, bigint) to csv",
                      False)),
    **{("parquet", n): (_ROWS, _ROWS) for n in (
        "dec12", "timestamp", "null_bigint", "null_varchar", "real")},
    # parquet has no 16-bit physical type: both read a smallint back as bigint
    ("parquet", "smallint"): (("rows", "bigint", True), ("rows", "bigint", True)),
    ("parquet", "dec30"): (("error", "read", "ValueError", None, True),
                           ("error", "ctas", "ValueError",
                            "cannot write decimal(30,2) to parquet", False)),
    **{("parquet", n): (("error", "ctas", "ValueError", f"cannot write {t} to parquet", True),
                        ("error", "ctas", "ValueError", f"cannot write {t} to parquet", False))
       for n, t in (("tstz", "timestamp with time zone"), ("array", "array(varchar)"),
                    ("map", "map(varchar, bigint)"), ("row", "row(bigint, bigint)"),
                    ("null", "unknown"))},
}


@pytest.mark.parametrize("key", sorted(ROUND_TRIPS), ids=lambda k: f"{k[0]}-{k[1]}")
def test_round_trip_through_each_sink(key, tpch, tmp_path):
    """Each type written by each sink (CTAS) and read back, in both
    packages, against ROUND_TRIPS."""
    fmt, name = key
    runners = _runners(tpch, tmp_path, fmt)
    for i, (r, want) in enumerate(zip(runners, ROUND_TRIPS[key])):
        got = _round_trip(r, str(tmp_path / ("ref", "port")[i]), fmt, name)
        if want[0] == "rows" and want[1] is None:
            want = (want[0], got[1], want[2])  # the source's own type
        if want[0] == "error" and want[3] is None:
            want = want[:3] + (got[3],) + want[4:]
        assert got == want, (("reference", "port")[i], got)
