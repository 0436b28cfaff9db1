"""Memory pools, revocation and spill: tests/test_memory.py's pool,
spiller, aggregation and sort cases on trino_tpu_torch (device="cpu"),
held against trino_tpu.

- The pool and spiller cases run unedited with the corpus module's names
  bound to the port's.
- The aggregation and sort cases run through test_torch_write's
  ParityRunner (each statement on both packages, rows equal). Each must
  spill exactly where the reference spills: the corpus's SORT_Q orders
  with LIMIT, which plans a TopN (no spill path) in both packages, so a
  full ORDER BY under the same pool is added, and spills in both.
- Without a pool nothing spills; SET SESSION memory_pool_bytes changes
  the next query's pool; a query's spill files are gone when it ends,
  also when it fails.
"""

import os
import tempfile

import pytest

import tests.test_memory as memory_corpus
from tests.test_torch_write import ParityRunner, patch_corpus
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.exec import spill as jspill
from trino_tpu_torch import types as T
from trino_tpu_torch.block import RelBatch
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.exec import operators as tops
from trino_tpu_torch.exec import spill
from trino_tpu_torch.runtime import memory as tmemory

FULL_SORT = ("select o_orderkey, o_totalprice from orders"
             " order by o_totalprice desc, o_orderkey")
# every wire column kind of a spilled group state: a long-decimal sum
# (four limb slots), an average, min/max over dictionary strings, counts
STATE_Q = ("select o_custkey, sum(cast(o_totalprice as decimal(30,2))) s,"
           " avg(o_totalprice) a, min(o_orderpriority) lo, max(o_clerk) hi,"
           " count(*) c, count(o_comment) cc from orders group by o_custkey"
           " order by o_custkey")


@pytest.fixture(scope="module")
def tpch():
    return jtpch.create_tpch_connector(), ttpch.create_tpch_connector()


@pytest.fixture
def ref_spilled(monkeypatch):
    """Bytes trino_tpu's spillers write while the test runs."""
    seen = {"bytes": 0}
    append = jspill.FileSpiller._append

    def counting(self, data, capacity=None):
        seen["bytes"] += len(data)
        return append(self, data, capacity)

    monkeypatch.setattr(jspill.FileSpiller, "_append", counting)
    return seen


def _pair(tpch, **session):
    ref = JRunner(JSession(catalog="tpch", schema="tiny", **session))
    ref.register_catalog("tpch", tpch[0])
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny", **session), device="cpu")
    port.register_catalog("tpch", tpch[1])
    return ParityRunner(ref, port)


@pytest.fixture(scope="module")
def baseline(tpch):
    return _pair(tpch)


@pytest.mark.parametrize("name", ["test_pool_reserve_free", "test_pool_limit_enforced",
                                  "test_pool_revokes_largest_first"])
def test_pool_corpus_case(name, monkeypatch):
    for attr in ("MemoryPool", "MemoryContext", "ExceededMemoryLimitError"):
        monkeypatch.setattr(memory_corpus, attr, getattr(tmemory, attr))
    getattr(memory_corpus, name)()


def test_spiller_roundtrip(monkeypatch):
    monkeypatch.setattr(memory_corpus, "FileSpiller", spill.FileSpiller)
    monkeypatch.setattr(memory_corpus, "RelBatch", RelBatch)
    monkeypatch.setattr(memory_corpus, "T", T)
    before = spill.stats()["spilled_bytes"]
    memory_corpus.test_spiller_roundtrip()
    assert spill.stats()["spilled_bytes"] > before


@pytest.mark.parametrize("name, spills", [("test_aggregation_spills_and_matches", True),
                                          ("test_sort_spills_and_matches", False)])
def test_query_corpus_case(name, spills, tpch, baseline, ref_spilled, monkeypatch):
    patch_corpus(monkeypatch, memory_corpus, tpch)
    before = spill.stats()["spilled_bytes"]
    getattr(memory_corpus, name)(baseline)
    assert (spill.stats()["spilled_bytes"] > before) is spills
    assert (ref_spilled["bytes"] > 0) is spills


@pytest.mark.parametrize("sql, batch_rows", [(FULL_SORT, 2048), (STATE_Q, 1024)],
                         ids=["full_order_by", "group_state_columns"])
def test_spills_in_both_and_matches(sql, batch_rows, tpch, ref_spilled):
    pr = _pair(tpch, batch_rows=batch_rows, memory_pool_bytes=128 * 1024)
    before = spill.stats()["spilled_bytes"]
    got = pr.execute(sql)
    assert spill.stats()["spilled_bytes"] > before and ref_spilled["bytes"] > 0
    plain = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    plain.register_catalog("tpch", tpch[1])
    assert got.rows == plain.execute(sql).rows


def test_no_pool_no_spill(tpch):
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny", batch_rows=4096),
                         device="cpu")
    r.register_catalog("tpch", tpch[1])
    before = spill.stats()
    for sql in (memory_corpus.AGG_Q, FULL_SORT, memory_corpus.JOIN_QS["semi"]):
        r.execute(sql)
        assert r._last_pool is None
    assert spill.stats() == before


def test_set_session_memory_pool_bytes_sets_the_next_pool(tpch):
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny", batch_rows=8192),
                         device="cpu")
    r.register_catalog("tpch", tpch[1])
    want = r.execute(memory_corpus.AGG_Q).rows
    r.execute("set session memory_pool_bytes = 262144")
    before = spill.stats()["spilled_bytes"]
    assert r.execute(memory_corpus.AGG_Q).rows == want
    assert r._last_pool.max_bytes == 262144
    assert r._last_pool.reserved_bytes == 0  # every context closed
    assert spill.stats()["spilled_bytes"] > before
    r.execute("set session memory_pool_bytes = 0")
    r.execute(memory_corpus.AGG_Q)
    assert r._last_pool is None


def test_spill_files_are_removed_also_when_the_query_fails(tpch, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny", batch_rows=4096,
                                 memory_pool_bytes=192 * 1024), device="cpu")
    r.register_catalog("tpch", tpch[1])
    made = []
    mkstemp = tempfile.mkstemp

    def recording(*a, **kw):
        fd, path = mkstemp(*a, **kw)
        made.append(path)
        return fd, path

    monkeypatch.setattr(tempfile, "mkstemp", recording)
    r.execute(memory_corpus.JOIN_QS["inner_agg"])
    assert made and os.listdir(tmp_path) == []

    def boom(self, batch):
        raise RuntimeError("sink failed")

    made.clear()
    monkeypatch.setattr(tops.CollectorSink, "add_input", boom)
    with pytest.raises(RuntimeError, match="sink failed"):
        r.execute(memory_corpus.JOIN_QS["inner_agg"])
    # the grace build spilled before the probe pipeline failed
    assert made and os.listdir(tmp_path) == []
    assert r._last_pool.reserved_bytes == 0


def test_batch_bytes_counts_every_tensor():
    b = RelBatch.from_pydict(
        [("a", T.BIGINT), ("s", T.VARCHAR), ("xs", T.array_of(T.BIGINT))],
        {"a": [1, None, 3], "s": ["x", "y", None], "xs": [[1, 2], None, []]},
    )
    want = b.live.nbytes
    for c in b.columns:
        want += c.data.nbytes + (c.valid.nbytes if c.valid is not None else 0)
    xs = b.columns[2]
    want += xs.starts.nbytes + xs.flat.data.nbytes
    want += xs.flat.valid.nbytes if xs.flat.valid is not None else 0
    assert tmemory.batch_bytes(b) == want


def test_chip_smoke_carries_the_memory_corpus():
    """chip_smoke.py's copy of tests/test_memory.py's queries and their
    sessions (the card machine has no jax to import the corpus with)."""
    import chip_smoke as CS

    want = {"agg": (memory_corpus.AGG_Q, {"batch_rows": 8192, "memory_pool_bytes": 256 * 1024}),
            "sort": (memory_corpus.SORT_Q, {"batch_rows": 4096,
                                            "memory_pool_bytes": 256 * 1024})}
    want.update({k: (q, {"batch_rows": 4096, "memory_pool_bytes": 192 * 1024})
                 for k, q in memory_corpus.JOIN_QS.items()})
    assert CS.MEMORY_QS == want
