"""The write side (CREATE/CTAS/INSERT/DELETE/UPDATE/MERGE/DROP and
transactions): trino_tpu_torch (device="cpu") against trino_tpu, statement
by statement.

- Each script of chip_smoke.WRITE_SCRIPTS runs on a fresh runner of each
  package, each with a memory catalog and tpch (one tpch connector per
  package for the module), its setup (chip_smoke.WRITE_SETUPS) first;
  the read-only scripts of one setup share their runners.
  Every statement must give equal column types and rows (doubles within
  tests/oracle.py::assert_rows_match's default tolerance; in order where
  the statement ends with ORDER BY), or raise the same exception type
  with the same message. After the script, every memory table, read
  with SELECT * and sorted by every column, must be equal.
- Where the corpus exposes the test function (tests/test_dml.py,
  tests/test_merge.py, tests/test_decimal128.py), that function runs
  against the pair: its own assertions hold on the port's results (an
  error is re-raised as the reference's, so its pytest.raises holds), and
  it must have run exactly the script's statements. The other scripts are
  copies of their test's statements (chip_smoke.py names each source).
- tests/test_dml.py's GROUPING SETS cases and tests/test_table_functions.py's
  runner tests through the same harness, and tests/test_merge.py's
  ScaledWriterSink counter test on the port's ScaledWriterSink.
- Two reference faults (ROADMAP §3) are pinned against python values: a
  MAP or ROW column written by the page sink reads back wrong in
  trino_tpu; the port reads back what was written.
"""

import re

import pytest

import chip_smoke as CS
import tests.test_decimal128 as decimal_corpus
import tests.test_dml as dml_corpus
import tests.test_merge as merge_corpus
import tests.test_table_functions as tf_corpus
from tests.oracle import assert_rows_match
from trino_tpu import security as jsecurity
from trino_tpu.connectors import memory as jmemory
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu_torch import security as tsecurity
from trino_tpu_torch.connectors import memory as tmemory
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session

_ORDERED = re.compile(r"order\s+by[^()]*$", re.IGNORECASE | re.DOTALL)


@pytest.fixture(scope="module")
def tpch():
    return jtpch.create_tpch_connector(), ttpch.create_tpch_connector()


_VOLATILE = re.compile(r"\brand\(\)", re.IGNORECASE)
# the statement-level protocol fields of a result
_PROTOCOL = ("column_names", "started_transaction_id", "cleared_transaction",
             "added_prepare", "deallocated_prepare", "data_plane")


class Both:
    """One object per package (a connector, an access control, an
    identity) for corpus code that builds its own runners."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port


def side(x, i):
    return (x.ref, x.port)[i] if isinstance(x, Both) else x


class BothSessions(Both):
    """The two runners' sessions: a write reaches both, a read must
    agree."""

    def __init__(self, ref, port):
        object.__setattr__(self, "ref", ref)
        object.__setattr__(self, "port", port)

    def __getattr__(self, name):
        a, b = getattr(self.ref, name), getattr(self.port, name)
        assert a == b, (name, a, b)
        return b

    def __setattr__(self, name, value):
        setattr(self.ref, name, value)
        setattr(self.port, name, value)


class BothCaches(Both):
    """The two runners' plan caches: every counter read must agree."""

    def __getattr__(self, name):
        a, b = getattr(self.ref, name), getattr(self.port, name)
        if callable(b):
            return lambda *args: _agree(name, a(*args), b(*args))
        return _agree(name, a, b)


def _agree(name, a, b):
    assert a == b, (name, a, b)
    return b


class ParityRunner:
    """Runs each statement on the reference and on the port and holds
    them equal; returns the port's result, or re-raises the reference's
    error once the port raised the same. A statement calling rand()
    compares types only. Corpus code that sets the session, the access
    control or the catalogs reaches both runners."""

    def __init__(self, ref, port, memory="memory"):
        self.ref, self.port, self.memory = ref, port, memory
        self.log = []

    @property
    def session(self):
        return BothSessions(self.ref.session, self.port.session)

    @property
    def access_control(self):
        return Both(self.ref.access_control, self.port.access_control)

    @access_control.setter
    def access_control(self, ac):
        self.ref.access_control, self.port.access_control = side(ac, 0), side(ac, 1)

    @property
    def _plan_cache(self):
        return BothCaches(self.ref._plan_cache, self.port._plan_cache)

    def register_catalog(self, name, connector):
        self.ref.register_catalog(name, side(connector, 0))
        self.port.register_catalog(name, side(connector, 1))

    def execute(self, sql, **kw):
        self.log.append(sql)
        want = got = None
        try:
            want = self.ref.execute(sql, **{k: side(v, 0) for k, v in kw.items()})
        except Exception as e:  # noqa: BLE001 - compared below
            want = e
        try:
            got = self.port.execute(sql, **{k: side(v, 1) for k, v in kw.items()})
        except Exception as e:  # noqa: BLE001 - compared below
            got = e
        if isinstance(want, Exception) or isinstance(got, Exception):
            assert type(got).__name__ == type(want).__name__ and str(got) == str(want), (
                sql, repr(want), repr(got))
            raise want
        assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types], sql
        for f in _PROTOCOL:
            if f != "started_transaction_id":  # each package mints its own ids
                assert getattr(got, f) == getattr(want, f), (sql, f)
        assert (got.started_transaction_id is None) == (want.started_transaction_id is None)
        if not _VOLATILE.search(sql):
            assert_rows_match(got.rows, [tuple(r) for r in want.rows],
                              ordered=bool(_ORDERED.search(sql)))
        return got

    def check_tables(self):
        """Every memory table equal between the packages, as multisets
        of rows (compared sorted by every column)."""
        conns = [r.catalogs.get(self.memory) for r in (self.ref, self.port)]
        tables = [sorted((s, t) for s in c.metadata.list_schemas()
                         for t in c.metadata.list_tables(s)) for c in conns]
        assert tables[0] == tables[1]
        for schema, table in tables[0]:
            sql = f"select * from {self.memory}.{schema}.{table}"
            want, got = self.ref.execute(sql), self.port.execute(sql)
            assert_rows_match(got.rows, [tuple(r) for r in want.rows], ordered=False)


# the reference's constructors, kept before any corpus patch replaces them
_J_MEMORY = jmemory.create_memory_connector
_J_ACCESS = jsecurity.FileBasedAccessControl


def patch_corpus(monkeypatch, module, tpch) -> list:
    """Replace the runner, session, connector and access-control
    constructors a corpus module reaches (its globals, and the
    reference modules its functions import from) by ones that build an
    object per package; a runner built so is a ParityRunner. Returns the
    ParityRunners built."""
    built = []

    def runner(session=None, access_control=None):
        pr = ParityRunner(
            JRunner(side(session, 0), access_control=side(access_control, 0)),
            LocalQueryRunner(side(session, 1), access_control=side(access_control, 1),
                             device="cpu"))
        built.append(pr)
        return pr

    names = {
        "LocalQueryRunner": runner,
        "Session": lambda *a, **kw: Both(JSession(*a, **kw), Session(*a, **kw)),
        "create_memory_connector": lambda: Both(_J_MEMORY(), tmemory.create_memory_connector()),
        "create_tpch_connector": lambda: Both(*tpch),
        "FileBasedAccessControl": lambda rules: Both(_J_ACCESS(rules),
                                                     tsecurity.FileBasedAccessControl(rules)),
    }
    for name, make in names.items():
        if hasattr(module, name):
            monkeypatch.setattr(module, name, make)
    monkeypatch.setattr(jmemory, "create_memory_connector", names["create_memory_connector"])
    monkeypatch.setattr(jsecurity, "FileBasedAccessControl", names["FileBasedAccessControl"])
    return built


def pair(tpch, catalog="memory", schema="default", setup=None, memory="memory", **session):
    """A ParityRunner over fresh runners of both packages, each with a
    memory catalog (named `memory`) and the module's tpch, the setup
    statements run."""
    ref = JRunner(JSession(catalog=catalog, schema=schema, **session))
    ref.register_catalog(memory, jmemory.create_memory_connector())
    ref.register_catalog("tpch", tpch[0])
    port = LocalQueryRunner(Session(catalog=catalog, schema=schema, **session), device="cpu")
    port.register_catalog(memory, tmemory.create_memory_connector())
    port.register_catalog("tpch", tpch[1])
    pr = ParityRunner(ref, port, memory)
    for sql in CS.WRITE_SETUPS.get(setup, ()):
        pr.execute(sql)
    pr.log.clear()
    return pr


def _delete_update(name):
    def call(pr):
        cls = type("PortDeleteUpdate", (dml_corpus.TestDeleteUpdate,),
                   {"_runner": staticmethod(lambda: pr)})
        getattr(cls(), name)()
    return call


def _method(cls, name):
    return lambda pr: getattr(cls(), name)(pr)


# script -> the corpus function that runs exactly its statements
CORPUS = {
    **{f"dml_{n}": getattr(dml_corpus, f"test_{n}") for n in (
        "create_insert_select_drop", "insert_from_query_with_coercion", "ctas",
        "values_standalone")},
    **{f"dml_{n}": _delete_update(f"test_{n}") for n in (
        "delete_predicate", "delete_all", "delete_null_predicate_keeps_row",
        "update_with_predicate", "update_all_rows_with_coercion",
        "duplicate_assignment_rejected", "update_unknown_column",
        "dml_rejected_in_explicit_transaction")},
    **{f"merge_{n}": _method(merge_corpus.TestMergeMatrix, f"test_{n}") for n in (
        "full_upsert", "clause_order_first_match_wins", "update_only", "delete_only",
        "insert_only_with_default_null", "subquery_source", "multiple_match_is_error",
        "no_matches_noop")},
}
for _cls in (decimal_corpus.TestTyping, decimal_corpus.TestArithmetic,
             decimal_corpus.TestRelational, decimal_corpus.TestFullDivision,
             decimal_corpus.TestHolisticLongDecimal):
    for _n in dir(_cls):
        if _n.startswith("test_"):
            CORPUS[f"decimal_{_n[5:]}"] = _method(_cls, _n)

# tests/test_dml.py's access-control cases build their own runners and
# access controls: test_dml_access_control runs them on ParityRunners
ACCESS_CASES = ("test_update_requires_update_privilege", "test_dml_subquery_scan_is_checked",
                "test_access_control_gates_delete")


def test_the_corpus_is_covered():
    """Every test of tests/test_dml.py (but the access-control cases,
    test_dml_access_control below), tests/test_merge.py and
    tests/test_decimal128.py has its script."""
    names = set()
    for mod, prefix in ((dml_corpus, "dml_"), (merge_corpus, "merge_"),
                        (decimal_corpus, "decimal_")):
        for attr in dir(mod):
            obj = getattr(mod, attr)
            tests = ([attr] if attr.startswith("test_") and callable(obj) else
                     [n for n in dir(obj) if n.startswith("test_")]
                     if attr.startswith("Test") else [])
            names |= {prefix + n[5:] for n in tests if n not in ACCESS_CASES}
    names -= {"dml_grouping_sets"}  # test_write_grouping_sets below
    assert names <= set(CS.WRITE_SCRIPTS), sorted(names - set(CS.WRITE_SCRIPTS))
    assert sum(n.startswith("decimal_") for n in CS.WRITE_SCRIPTS) == 24


@pytest.fixture(scope="module")
def shared():
    """Pairs shared by the read-only scripts of one setup, as the corpus
    shares its fixture's runner (tests/test_decimal128.py)."""
    return {}


@pytest.mark.parametrize("name", sorted(CS.WRITE_SCRIPTS))
def test_write_script(name, tpch, shared):
    script = CS.WRITE_SCRIPTS[name]
    key = (script["setup"], script["schema"])
    if script["setup"] and all(s.lower().startswith("select") for s in script["sql"]):
        if key not in shared:
            shared[key] = pair(tpch, script["catalog"], script["schema"], script["setup"],
                               **script["session"])
        pr = shared[key]
        pr.log.clear()
    else:
        pr = pair(tpch, script["catalog"], script["schema"], script["setup"],
                  **script["session"])
    if name in CORPUS:
        CORPUS[name](pr)
        assert pr.log == script["sql"]
    else:
        for sql in script["sql"]:
            try:
                pr.execute(sql)
            except AssertionError:
                raise
            except Exception:  # noqa: BLE001 - the port raised as the reference did
                pass
    pr.check_tables()


def test_phase_write_identities():
    """chip_smoke.py phase write's statements and identities at tiny on
    the port (the card runs them at sf1; their MERGE, UPDATE and DELETE
    forms are held to the reference by the scripts above)."""
    from trino_tpu_torch.connectors.tpch import base_row_count

    r = CS.write_runner("tiny", "cpu")

    def step(name, sql):
        try:
            return r.execute(sql).rows, None
        except Exception as e:  # noqa: BLE001 - write_identities checks which
            return None, e

    CS.write_identities(r, step, base_row_count("orders", 0.01))
    assert r.catalogs.get("w").metadata.list_tables("s") == []


@pytest.mark.parametrize("sql,oracle_sql", dml_corpus.GS_CASES)
def test_write_grouping_sets(sql, oracle_sql, tpch):
    pair(tpch, "tpch", "tiny").execute(sql)


def test_scaled_writer_sink_counts():
    """tests/test_merge.py TestScaledWriters.test_large_write_scales_out's
    counter half on the port's ScaledWriterSink (its SQL half is the
    merge_large_write_scales_out script)."""
    from trino_tpu_torch.exec import ScaledWriterSink

    before = dict(ScaledWriterSink.COUNTERS)
    made = []

    class FakeSink:
        def __init__(self):
            made.append(self)
            self.rows = 0

        def append(self, b):
            self.rows += b.capacity

        def finish(self):
            return self.rows

    class FakeBatch:
        capacity = 1 << 20

    s = ScaledWriterSink(FakeSink, max_writers=4, scale_rows=1 << 21)
    for _ in range(12):
        s.append(FakeBatch())
    assert s.finish() == 12 * (1 << 20)
    assert len(made) > 1, "writer count never scaled"
    assert ScaledWriterSink.COUNTERS["max_writers"] >= len(made)
    assert ScaledWriterSink.COUNTERS["scale_ups"] > before["scale_ups"]


def test_bulk_insert_scales_out_writers(tpch, monkeypatch):
    """An autocommit INSERT over many batches, its writers scaled out at
    a low volume: three page sinks take the batches round robin, and
    the table equals the reference's."""
    import trino_tpu_torch.engine as E

    class Scaled(E.ScaledWriterSink):
        def __init__(self, make_sink, max_writers):
            super().__init__(make_sink, max_writers, scale_rows=1 << 10)

    monkeypatch.setattr(E, "ScaledWriterSink", Scaled)
    pr = pair(tpch, schema="t", batch_rows=1 << 10, task_concurrency=3)
    opened = []
    conn = pr.port.catalogs.get("memory")
    inner = conn.page_sink
    conn.page_sink = lambda *a, **k: opened.append(1) or inner(*a, **k)
    pr.execute("create table big (k bigint, c varchar)")
    pr.execute("insert into big select o_orderkey, o_comment from tpch.tiny.orders")
    assert len(opened) == 3
    pr.check_tables()


def test_explicit_transaction_threading(tpch):
    """The protocol form: each statement names its transaction (or
    "NONE" for autocommit) and the runner keeps none of its own. A
    staged INSERT is seen by no statement until COMMIT, and ROLLBACK
    drops one; each package runs the same steps with its own ids."""
    pr = pair(tpch, setup="txn")
    counts = []
    for r in (pr.ref, pr.port):
        tx = r.execute("start transaction", transaction_id="NONE").started_transaction_id
        assert tx and r.execute("select count(*) from c", transaction_id=tx).rows == [[2]]
        r.execute("insert into c values (3, 'c')", transaction_id=tx)
        seen = [r.execute("select count(*) from c", transaction_id=t).rows[0][0]
                for t in (tx, "NONE")]
        r.execute("commit", transaction_id=tx)
        other = r.execute("start transaction", transaction_id="NONE").started_transaction_id
        r.execute("insert into c values (4, 'd')", transaction_id=other)
        r.execute("rollback", transaction_id=other)
        counts.append((seen, r.execute("select count(*) from c").rows))
    assert counts[1] == counts[0] == ([2, 2], [[3]])
    pr.check_tables()


@pytest.mark.parametrize("name", ACCESS_CASES)
def test_dml_access_control(name, tpch, monkeypatch):
    """tests/test_dml.py's access-control cases, each on ParityRunners:
    the denials (AccessDeniedError) are equal in both packages."""
    built = patch_corpus(monkeypatch, dml_corpus, tpch)
    getattr(dml_corpus.TestDeleteUpdate(), name)()
    assert built
    for pr in built:  # the tables, read back by a user allowed to
        pr.access_control = Both(jsecurity.AllowAllAccessControl(),
                                 tsecurity.AllowAllAccessControl())
        pr.check_tables()


@pytest.mark.parametrize("sql", [
    "explain select 1", "show session", "show functions", "show schemas", "show tables",
    "show columns from t", "set session batch_rows = 1024", "prepare p from select 1",
    "execute p", "deallocate prepare p"])
def test_the_rest_of_the_statement_surface_names_item_8b(sql, tpch):
    """EXPLAIN, SHOW, SET SESSION and the prepared statements, which
    waited for ROADMAP §1 item 8b: equal in both packages (rows, types
    and the protocol fields), a table t and a statement p prepared
    first."""
    pr = pair(tpch)
    for setup in ("create table t (a bigint, b varchar)", "prepare p from select 1"):
        pr.execute(setup)
    pr.execute(sql)
    assert pr.execute("show session").rows == pr.port.execute("show session").rows


@pytest.fixture(scope="module")
def tf_pair():
    """tests/test_table_functions.py's runner fixture in both packages:
    tpch with the connector-provided times_table."""
    from trino_tpu import types as JT
    from trino_tpu.connectors.spi import ColumnMetadata as JCM
    from trino_tpu.connectors.spi import TableFunction as JTF
    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.spi import ColumnMetadata, TableFunction

    runners = []
    for runner, session, tpch_mod, mod, cm, tf, kw in (
            (JRunner, JSession, jtpch, JT, JCM, JTF, {}),
            (LocalQueryRunner, Session, ttpch, T, ColumnMetadata, TableFunction,
             {"device": "cpu"})):
        def times_table(args, mod=mod, cm=cm):
            n = int(args.get("n", args.get("_0", 3)))
            cols = [cm("a", mod.BIGINT), cm("b", mod.BIGINT), cm("product", mod.BIGINT)]
            return cols, [(i, j, i * j) for i in range(1, n + 1) for j in range(1, n + 1)]

        r = runner(session(catalog="tpch", schema="tiny"), **kw)
        conn = tpch_mod.create_tpch_connector()
        conn.table_functions["times_table"] = tf(
            "times_table", times_table, "n x n multiplication table")
        r.register_catalog("tpch", conn)
        runners.append(r)
    return ParityRunner(*runners)


@pytest.mark.parametrize("name", sorted(
    n for n in dir(tf_corpus) if n.startswith("test_") and n != "test_formatter_roundtrip"))
def test_table_functions_through_the_port(name, tf_pair):
    getattr(tf_corpus, name)(tf_pair)


@pytest.mark.parametrize("sql,column,want", [
    ("create table m2 as select n_regionkey k, map_agg(n_name, n_nationkey) m"
     " from tpch.tiny.nation where n_nationkey < 4 group by n_regionkey",
     "m", [[0, {"ALGERIA": 0}], [1, {"ARGENTINA": 1, "BRAZIL": 2, "CANADA": 3}]]),
    ("create table m2 as select n_nationkey k, row(n_regionkey, n_name) m"
     " from tpch.tiny.nation where n_nationkey < 3",
     "m", [[0, (0, "ALGERIA")], [1, (1, "ARGENTINA")], [2, (1, "BRAZIL")]]),
])
def test_map_and_row_columns_read_back_as_written(sql, column, want, tpch):
    """Reference fault (ROADMAP §3): trino_tpu's page sink stores a MAP
    or ROW column as a flat array, and the table then fails to read
    back; the port keeps their python values and reads back what the
    query wrote."""
    pr = pair(tpch)
    pr.execute(sql)
    read = f"select k, {column} from m2 order by k"
    with pytest.raises((TypeError, IndexError)):
        pr.ref.execute(read)
    assert pr.port.execute(read).rows == want
    assert pr.port.execute("insert into m2 select k + 10, m from m2").rows == [[len(want)]]
    assert pr.port.execute(f"select count(*) from m2 where k >= 10").rows == [[len(want)]]


@pytest.mark.parametrize("sql", CS.NON_NUMERIC_UPDATES)
def test_update_where_over_a_non_numeric_column_raises(sql, tpch):
    """Reference fault (ROADMAP §3): UPDATE ... WHERE rewrites each
    assigned column as CASE WHEN pred THEN new ELSE old END, which
    trino_tpu's analyzer types as bigint for a TIMESTAMP WITH TIME ZONE
    or an ARRAY column; its plan validation refuses the plan and the
    table stays. The port's CASE keeps the column's type: the row with
    id 1 takes the new value and the other rows stay as the reference
    holds them."""
    pr = pair(tpch, schema="z", setup="tags")
    pr.execute(CS.WRITE_SCRIPTS["timestamptz_write"]["sql"][0])
    pr.execute(CS.WRITE_SCRIPTS["timestamptz_write"]["sql"][1])
    with pytest.raises(Exception, match="bigint") as refused:
        pr.ref.execute(sql)
    assert type(refused.value).__name__ == "PlanValidationError"
    assert pr.port.execute(sql).rows == [[1]]
    table, column = sql.split()[1], sql.split()[3]
    read = f"select * from {table} order by id"
    want = pr.ref.execute(read)
    at = want.column_names.index(column)
    want.rows[0][at] = {"t": "2021-03-14 03:30:00.000 America/New_York", "scores": [0]}[column]
    assert pr.port.execute(read).rows == want.rows
