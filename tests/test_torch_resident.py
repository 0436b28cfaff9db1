"""The resident state tier on trino_tpu_torch (device="cpu") against
trino_tpu.

- tests/test_resident.py's 22 cases run on the port's names
  (tests/test_torch_compile.port_names).
- The probe and compaction programs are held against the reference's
  jitted programs bit for bit, on the same numpy inputs from a seed.
- Through the coordinator server, a resident lookup answers the cold
  path's rows (and the reference's) before and after INSERT, UPDATE,
  DROP and COMMIT.
- The fast lane declines only on its typed conditions, each counted; a
  build that raises any other error propagates instead of answering
  cold, and a poisoned DeltaTap evicts the pin.
- Every case runs with the warm-class registry saved and restored
  (tests/test_torch_compile.isolated_registries, autouse).
"""

import inspect

import numpy as np
import pytest
import torch

import tests.test_resident as resident_corpus
from tests.test_torch_compile import isolated_registries, port_names  # noqa: F401
from tests.test_torch_statements import _cases, _ids
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.resident import table as jtable
from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.memory import create_memory_connector
from trino_tpu_torch.connectors.spi import ColumnMetadata
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.resident import RESIDENT, fastlane
from trino_tpu_torch.resident import table as ttable
from trino_tpu_torch.runtime.metrics import METRICS

RESIDENT_CASES = _cases(resident_corpus)


@pytest.mark.parametrize("case", RESIDENT_CASES, ids=_ids(RESIDENT_CASES))
def test_resident_corpus(case, monkeypatch):
    cls, name = case
    port_names(monkeypatch, resident_corpus)
    fn = getattr(cls(), name) if cls else getattr(resident_corpus, name)
    params = inspect.signature(fn).parameters
    if "kv_runner" not in params:
        return fn()
    gen = resident_corpus.kv_runner.__wrapped__()
    r = next(gen)
    try:
        fn(r)
    finally:
        next(gen, None)


def test_the_corpus_is_whole():
    assert len(RESIDENT_CASES) == 22


# ---- the programs against the reference's -----------------------------------------


@pytest.mark.parametrize("cap,out_cap,dup", [(16, 16, 1), (1024, 16, 3), (4096, 16, 40),
                                             (64, 8, 9)])
def test_probe_program_equals_the_references(cap, out_cap, dup):
    """_probe_program: the first out_cap match positions, padded with cap,
    and the match count: bit-equal to the reference's jitted program."""
    import jax.numpy as jnp

    rng = np.random.default_rng(cap + dup)
    keys = rng.integers(0, max(2, cap // dup), cap).astype(np.int64)
    valid = rng.random(cap) < 0.8
    for q in (int(keys[0]), int(keys[-1]), -5):
        j_idx, j_n = jtable._probe_program(cap, out_cap)(
            jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(q, dtype=jnp.int64))
        t_idx, t_n = ttable._probe_program(cap, out_cap, "cpu")(
            torch.from_numpy(keys), torch.from_numpy(valid), q)
        assert t_idx.dtype == torch.int64 and tuple(t_idx.shape) == (out_cap,)
        assert np.array_equal(t_idx.numpy(), np.asarray(j_idx))
        assert int(t_n) == int(j_n)


@pytest.mark.parametrize("base,delta,live", [(16, 16, (5, 3)), (64, 16, (64, 16)),
                                             (1024, 4096, (700, 2000)), (16, 16, (0, 0))])
def test_compact_program_equals_the_references(base, delta, live):
    """_compact_program: live base keys then live delta keys, padded to
    the rung of their total: bit-equal to the reference's."""
    import jax.numpy as jnp

    from trino_tpu_torch.block import bucket_capacity

    rng = np.random.default_rng(base + delta)
    bk, dk = (rng.integers(-1 << 40, 1 << 40, n).astype(np.int64) for n in (base, delta))
    bv = np.zeros(base, dtype=bool)
    bv[rng.choice(base, live[0], replace=False)] = True
    dv = np.arange(delta) < live[1]
    out_cap = bucket_capacity(max(16, sum(live)))
    want = jtable._compact_program(base, delta, out_cap)(
        *(jnp.asarray(a) for a in (bk, bv, dk, dv)))
    got = ttable._compact_program(base, delta, out_cap, "cpu")(
        *(torch.from_numpy(a) for a in (bk, bv, dk, dv)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_a_program_is_cached_per_capacity_and_device():
    a = ttable._probe_program(64, 16, "cpu")
    assert ttable._probe_program(64, 16, "cpu") is a
    assert ttable._probe_program(64, 16, "meta") is not a


# ---- through the server, against the cold path -------------------------------------

KV_N = 200


def _kv_runner(**session):
    from trino_tpu.connectors.memory import create_memory_connector as jmemory
    from trino_tpu.connectors.spi import ColumnMetadata as JColumn
    from trino_tpu import types as JT

    rng = np.random.default_rng(11)
    k = np.arange(KV_N, dtype=np.int64)
    v = rng.integers(0, 1 << 20, KV_N).astype(np.int64)
    s = np.array([f"s{i % 17}" for i in range(KV_N)], dtype=object)
    mem = create_memory_connector()
    r = LocalQueryRunner(Session(catalog="memory", schema="s", **session), device="cpu")
    r.register_catalog("memory", mem)
    mem.load_table("s", "kv", [ColumnMetadata("k", T.BIGINT), ColumnMetadata("v", T.BIGINT),
                               ColumnMetadata("s", T.VARCHAR)], [k, v, s])
    jmem = jmemory()
    from trino_tpu.engine import LocalQueryRunner as JRunner
    from trino_tpu.engine import Session as JSession

    ref = JRunner(JSession(catalog="memory", schema="s"))
    ref.register_catalog("memory", jmem)
    jmem.load_table("s", "kv", [JColumn("k", JT.BIGINT), JColumn("v", JT.BIGINT),
                                JColumn("s", JT.VARCHAR)], [k, v, s])
    return r, ref


@pytest.fixture()
def pinned():
    RESIDENT.evict_all()
    yield
    fastlane.drain_compactions()
    RESIDENT.evict_all()


def _lookup(srv, k, cols="v, s"):
    from trino_tpu_torch.client import Client

    return Client(srv.uri, timeout=60).execute(f"select {cols} from kv where k = {k}").rows


def test_resident_lookups_equal_the_cold_path_through_writes(pinned):
    """8 keys a round through the server's fast lane, each equal to the
    cold execute and to the reference's, before and after INSERT (the
    delta), UPDATE (evict and rebuild), COMMIT (every pin evicted) and
    DROP (the table gone: the lookup fails as the cold path does)."""
    from trino_tpu_torch.runtime.server import CoordinatorServer

    r, ref = _kv_runner(resident_tables="s.kv", resident_delta_max_rows=64)
    srv = CoordinatorServer(r, max_concurrent=4)
    keys = [0, 3, 7, 42, 99, 150, 199, 500]

    def round_equal(stage):
        hits0 = RESIDENT.stats()["hits"]
        for k in keys:
            want = r.execute(f"select v, s from kv where k = {k}").rows
            assert _lookup(srv, k) == want == ref.execute(
                f"select v, s from kv where k = {k}").rows, (stage, k)
        return RESIDENT.stats()["hits"] - hits0

    try:
        round_equal("cold")
        assert round_equal("warm") == len(keys)
        pins = RESIDENT.stats()["pins"]
        for stmt in ("insert into kv values (500, 5000, 'new')",
                     "insert into kv values (501, 5010, 'new')"):
            r.execute(stmt)
            ref.execute(stmt)
        assert round_equal("insert") == len(keys)
        assert RESIDENT.stats()["pins"] == pins  # the delta, no rebuild
        for stmt in ("update kv set v = -5 where k = 7",):
            r.execute(stmt)
            ref.execute(stmt)
        round_equal("update")
        assert RESIDENT.stats()["pins"] == pins + 1  # evicted and rebuilt
        r.execute("start transaction")
        r.execute("insert into kv values (502, 5020, 'txn')")
        ref.execute("insert into kv values (502, 5020, 'txn')")
        r.execute("commit")
        assert len(RESIDENT) == 0  # COMMIT evicts every pin
        round_equal("commit")
        r.execute("drop table kv")
        assert len(RESIDENT) == 0
        with pytest.raises(Exception, match="kv"):
            _lookup(srv, 3)
    finally:
        srv.stop()


def test_compaction_folds_the_delta_in(pinned):
    r, ref = _kv_runner(resident_tables="kv", resident_delta_max_rows=8)
    assert fastlane.try_resident_lookup(r, "select v from kv where k = 1") is not None
    compactions = RESIDENT.stats()["compactions"]
    for i in range(6):
        for runner in (r, ref):
            runner.execute(f"insert into kv values ({1000 + i}, {i}, 'c')")
    fastlane.drain_compactions()
    assert RESIDENT.stats()["compactions"] > compactions
    for k in (1, 1000, 1005):
        got = fastlane.try_resident_lookup(r, f"select v from kv where k = {k}").rows
        assert got == r.execute(f"select v from kv where k = {k}").rows == ref.execute(
            f"select v from kv where k = {k}").rows


def _null_round(r, ref, keys, stage):
    for k in keys:
        sql = f"select v, s from kv where k = {k}"
        got = fastlane.try_resident_lookup(r, sql)
        assert got is not None, (stage, k)
        assert got.rows == r.execute(sql).rows == ref.execute(sql).rows, (stage, k)


def test_a_null_key_build_equals_the_cold_path(pinned):
    """NULL keys are in the table when it is pinned: their rows stay
    dead in the pin (a NULL never equals a literal), and every lookup
    answers the cold path's rows and the reference's."""
    r, ref = _kv_runner(resident_tables="kv", resident_delta_max_rows=8)
    for stmt in ("insert into kv values (null, 1, 'n1')", "insert into kv values (null, 2, 'n2')",
                 "insert into kv values (0, 3, 'zero')"):
        r.execute(stmt)
        ref.execute(stmt)
    _null_round(r, ref, [0, 1, 5, 199, 777], "build")
    hits = RESIDENT.stats()["hits"]
    _null_round(r, ref, [0, 1, 5, 199, 777], "warm")
    assert RESIDENT.stats()["hits"] == hits + 5 and len(RESIDENT) == 1
    (table,) = [RESIDENT.peek(k) for k in RESIDENT.entries_for(("memory", "s", "kv"))]
    assert int(table.base_valid.sum()) == KV_N + 1


def test_a_null_key_insert_into_a_pinned_table_rides_the_delta(pinned):
    """An autocommit INSERT of NULL-key rows into a pinned table succeeds
    once, rides the delta without a rebuild, and a compaction drops the
    dead rows: lookups equal the cold path and the reference throughout."""
    r, ref = _kv_runner(resident_tables="kv", resident_delta_max_rows=8)
    _null_round(r, ref, [0, 3], "cold")
    pins = RESIDENT.stats()["pins"]
    for stmt in ("insert into kv values (null, 7, 'n')", "insert into kv values (300, 8, 'a')"):
        r.execute(stmt)
        ref.execute(stmt)
    assert r.execute("select count(*) from kv where v = 7").rows == [[1]]
    _null_round(r, ref, [0, 3, 300, 301], "insert")
    assert RESIDENT.stats()["pins"] == pins
    compactions = RESIDENT.stats()["compactions"]
    for i in range(3):
        stmt = f"insert into kv values ({'null' if i % 2 else 310 + i}, {i}, 'c')"
        r.execute(stmt)
        ref.execute(stmt)
    fastlane.drain_compactions()
    assert RESIDENT.stats()["compactions"] > compactions
    assert RESIDENT.stats()["pins"] == pins
    _null_round(r, ref, [0, 3, 300, 310, 312, 311], "compacted")
    (table,) = [RESIDENT.peek(k) for k in RESIDENT.entries_for(("memory", "s", "kv"))]
    # the compaction kept the live rows only: every base row's key is live
    assert int(table.base_valid.sum()) == len(table.base_rows) == table.base_live


@pytest.mark.parametrize("ddl,literal", [("k double, v bigint", "2"),
                                         ("k decimal(10, 2), v bigint", "2"),
                                         ("k varchar, v bigint", "2"),
                                         ("k bigint, v bigint", "'2'"),
                                         ("k real, v bigint", "2")])
def test_a_key_column_of_another_kind_declines_counted(pinned, ddl, literal):
    """A key is pinned only where its column's type is the literal's
    kind; any other column declines, counted, and the cold path answers
    (a pinned DOUBLE or DECIMAL key would truncate to the integer)."""
    mem = create_memory_connector()
    r = LocalQueryRunner(Session(catalog="memory", schema="s", resident_tables="t"),
                         device="cpu")
    r.register_catalog("memory", mem)
    r.execute(f"create table t ({ddl})")
    before = METRICS.counter("resident.skips_key_type")
    assert fastlane.try_resident_lookup(r, f"select v from t where k = {literal}") is None
    assert METRICS.counter("resident.skips_key_type") == before + 1
    assert len(RESIDENT) == 0


# ---- declines and errors ---------------------------------------------------------


def test_each_decline_is_typed_and_counted(pinned):
    r, _ = _kv_runner(resident_tables="s.kv")
    assert fastlane.try_resident_lookup(r, "select sum(v) from kv") is None  # not a lookup
    r.session.resident_tables = "other"
    assert fastlane.try_resident_lookup(r, "select v from kv where k = 1") is None
    r.session.resident_tables = "kv"
    # a key whose fanout passes the probe rung
    for _ in range(ttable.PROBE_OUT_CAP + 1):
        r.execute("insert into kv values (7777, 1, 'f')")
    before = METRICS.counter("resident.skips_fanout")
    assert fastlane.try_resident_lookup(r, "select v from kv where k = 7777") is None
    assert METRICS.counter("resident.skips_fanout") == before + 1
    # the budget refuses the pin: served from the transient build
    RESIDENT.evict_all()
    r.session.resident_pin_budget_mb = 0
    before = METRICS.counter("resident.skips")
    res = fastlane.try_resident_lookup(r, "select v from kv where k = 3")
    assert res.rows == r.execute("select v from kv where k = 3").rows
    assert METRICS.counter("resident.skips") == before + 1 and len(RESIDENT) == 0
    RESIDENT.configure(64 << 20)


def test_a_nested_column_declines_counted(pinned):
    mem = create_memory_connector()
    r = LocalQueryRunner(Session(catalog="memory", schema="s", resident_tables="arr"),
                         device="cpu")
    r.register_catalog("memory", mem)
    r.execute("create table arr (k bigint, a array(bigint))")
    r.execute("insert into arr values (1, array[1, 2])")
    before = METRICS.counter("resident.skips_nested")
    assert fastlane.try_resident_lookup(r, "select a from arr where k = 1") is None
    assert METRICS.counter("resident.skips_nested") == before + 1


def test_a_build_error_propagates_instead_of_answering_cold(pinned, monkeypatch):
    """Any error that is not a typed decline propagates: on the card a
    device or kernel failure must not turn into a cold execution (the
    reference answers cold)."""
    r, _ = _kv_runner(resident_tables="kv")

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(fastlane, "ResidentTable", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fastlane.try_resident_lookup(r, "select v from kv where k = 1")


def test_a_poisoned_tap_evicts_the_pin(pinned):
    r, _ = _kv_runner(resident_tables="kv")
    assert fastlane.try_resident_lookup(r, "select v from kv where k = 1") is not None
    assert len(RESIDENT) == 1
    tap = fastlane.delta_tap("memory", "s", "kv", ["k", "v", "s"])

    class _Unreadable:
        def to_pylists(self):
            raise ValueError("cannot read this batch")

    class _Sink:
        def append(self, batch):
            pass

    fastlane.TeeSink(_Sink(), tap).append(_Unreadable())
    assert tap.rows is None
    r._invalidate_plans(table=("memory", "s", "kv"), appended=True, tap=tap)
    assert len(RESIDENT) == 0


def test_a_delta_append_that_raises_evicts_the_pin_and_propagates(pinned, monkeypatch):
    """An error appending an insert's rows to the delta is not a
    decline: it propagates, the pin is evicted first, and the next
    lookup rebuilds from the committed rows."""
    r, ref = _kv_runner(resident_tables="kv")
    assert fastlane.try_resident_lookup(r, "select v from kv where k = 1") is not None

    def broken(self, key_values, value_rows):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ttable.ResidentTable, "append_delta", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        r.execute("insert into kv values (900, 9, 't')")
    ref.execute("insert into kv values (900, 9, 't')")
    assert len(RESIDENT) == 0
    monkeypatch.undo()
    _null_round(r, ref, [1, 900], "rebuilt")


def test_an_insert_inside_a_transaction_evicts_instead_of_riding_the_delta(pinned):
    """Rows written in a transaction are not visible before COMMIT, so
    they never reach a pin's delta (the reference taps them)."""
    r, _ = _kv_runner(resident_tables="kv")
    assert fastlane.try_resident_lookup(r, "select v from kv where k = 1") is not None
    r.execute("start transaction")
    r.execute("insert into kv values (900, 9, 't')")
    assert len(RESIDENT) == 0
    r.execute("rollback")


def test_pinned_bytes_are_the_keys_and_mask():
    t = ttable.ResidentTable("k", ["v"], ["bigint"], list(range(40)), [[i] for i in range(40)],
                             string_key=False, delta_max_rows=8, device="cpu")
    assert t.base_cap == 64 and t.device_bytes == 64 * 8 + 64
    assert t.append_delta([100], [[1]])
    assert t.device_bytes == 64 * 9 + 16 * 9


def test_a_finished_querys_pool_charges_no_later_pin(pinned):
    """A query under a small pool attaches the pins to it while it runs;
    once it ends the pool is detached, so a later pin is not refused by
    a pool whose query is gone (the reference keeps it attached)."""
    r, _ = _kv_runner(resident_tables="kv", memory_pool_bytes=1024)
    r.execute("select count(*) from kv")
    r.session.memory_pool_bytes = None
    before = RESIDENT.stats()
    assert fastlane.try_resident_lookup(r, "select v from kv where k = 1") is not None
    after = RESIDENT.stats()
    assert after["pins"] == before["pins"] + 1 and after["pin_rejects"] == before["pin_rejects"]
    assert len(RESIDENT) == 1


def test_a_table_registers_its_probe_and_compaction_warm_entries():
    """A table registers a probe entry for each rung it probes, and a
    compaction entry; a WarmupService drives them all to compiled."""
    from trino_tpu_torch.compile.warmup import WarmupService

    t = ttable.ResidentTable("k", ["v"], ["bigint"], list(range(40)), [[i] for i in range(40)],
                             string_key=False, delta_max_rows=8, device="cpu")
    t.append_delta([100], [[1]])
    t.compact()
    entries = [e for e in ttable.resident_warmup_entries() if str(e.device) == "cpu"]
    ops = {(e.operator, e.capacities) for e in entries}
    assert {("ResidentProbe", (64,)), ("ResidentProbe", (16,)),
            ("ResidentCompact", (64,))} <= ops
    svc = WarmupService(entries, mode="block").start()
    assert svc.wait(30) and svc.failures() == []
    assert svc.status_counts()["compiled"] == len(entries)
