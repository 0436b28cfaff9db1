"""Grace hash join: tests/test_memory.py's four JOIN_QS shapes and its
mid-build revocation case on trino_tpu_torch (device="cpu"), held
against trino_tpu.

Each shape runs at the corpus's session (batch_rows=4096,
memory_pool_bytes=192 KiB) on both packages through test_torch_write's
ParityRunner, and must equal the reference's unspilled answer, computed
once for the module. Each package must spill exactly where the other
does: the anti join's build side (orders.o_custkey, four 4,096-row
batches) fits the corpus's pool in both, so it runs once more at 64 KiB,
where both spill. The revocation case drives each package's
HashBuildSink and LookupJoinOperator by hand.
"""

import pytest

import tests.test_memory as memory_corpus
from tests.test_torch_spill import _pair
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu import types as JT
from trino_tpu.block import RelBatch as JBatch
from trino_tpu.connectors import tpch as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.exec import operators as jops
from trino_tpu.exec import spill as jspill
from trino_tpu_torch import types as T
from trino_tpu_torch.block import RelBatch
from trino_tpu_torch.connectors import tpch as ttpch
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.exec import operators as tops
from trino_tpu_torch.exec import spill

# the corpus's session for JOIN_QS, and the anti join's smaller pool
CORPUS_POOL = 192 * 1024
CASES = [(shape, CORPUS_POOL, shape != "anti") for shape in sorted(memory_corpus.JOIN_QS)]
CASES.append(("anti", 64 * 1024, True))


@pytest.fixture(scope="module")
def tpch():
    return jtpch.create_tpch_connector(), ttpch.create_tpch_connector()


@pytest.fixture(scope="module")
def reference_answers(tpch):
    """trino_tpu's unspilled rows of each shape, computed once."""
    r = JRunner(JSession(catalog="tpch", schema="tiny"))
    r.register_catalog("tpch", tpch[0])
    return {shape: r.execute(sql).rows for shape, sql in memory_corpus.JOIN_QS.items()}


@pytest.fixture
def ref_grace(monkeypatch):
    """trino_tpu's grace spills made while the test runs."""
    made = []
    init = jspill.GracePartitionSpill.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(jspill.GracePartitionSpill, "__init__", recording)
    return made


@pytest.mark.parametrize("shape, pool, spills", CASES,
                         ids=[f"{s}-{p // 1024}k" for s, p, _ in CASES])
def test_grace_join_spills_and_matches(shape, pool, spills, tpch, reference_answers,
                                       ref_grace):
    pr = _pair(tpch, batch_rows=4096, memory_pool_bytes=pool)
    before = spill.stats()
    got = pr.execute(memory_corpus.JOIN_QS[shape])
    after = spill.stats()
    assert got.rows == reference_answers[shape]
    ref_bytes = sum(g.spilled_bytes for g in ref_grace)
    assert (ref_bytes > 0) is spills
    assert (after["spilled_bytes"] > before["spilled_bytes"]) is spills
    # a spilled build finishes partition by partition
    assert (after["grace_partitions"] > before["grace_partitions"]) is spills


def _revocation_rows(T_, RelBatch_, ops, make_sink, make_join):
    bridge = ops.JoinBridge()
    schema = [(T_.BIGINT, None), (T_.BIGINT, None)]
    sink = make_sink(ops, bridge, schema)
    b1 = RelBatch_.from_pydict([("k", T_.BIGINT), ("v", T_.BIGINT)],
                               {"k": [1, 2, 3, 4], "v": [10, 20, 30, 40]})
    b2 = RelBatch_.from_pydict([("k", T_.BIGINT), ("v", T_.BIGINT)],
                               {"k": [3, 5], "v": [33, 50]})
    sink.add_input(b1)
    sink._revoke_memory()  # mid-build revocation
    sink.add_input(b2)
    sink.finish()
    assert bridge.grace is not None and bridge.lookup_source is None
    spilled = bridge.grace.spilled_bytes
    probe = RelBatch_.from_pydict([("pk", T_.BIGINT)], {"pk": [2, 3, 6]})
    join = make_join(ops, bridge, [(T_.BIGINT, None)])
    join.add_input(probe)
    join.finish()
    rows = []
    while True:
        out = join.get_output()
        if out is None:
            break
        rows.extend(out.to_pylists())
    return sorted(rows), spilled


def test_grace_join_revocation_mid_build():
    """The corpus's protocol check on both packages: a revoke while build
    batches accumulate, then more input; pre- and post-revoke rows all
    reach the partitioned spill."""
    want, ref_spilled = _revocation_rows(
        JT, JBatch, jops,
        lambda ops, bridge, schema: ops.HashBuildSink(bridge, [0], schema),
        lambda ops, bridge, schema: ops.LookupJoinOperator(bridge, [0], "inner", schema))
    got, port_spilled = _revocation_rows(
        T, RelBatch, tops,
        lambda ops, bridge, schema: ops.HashBuildSink(bridge, [0], schema, "cpu"),
        lambda ops, bridge, schema: ops.LookupJoinOperator(bridge, [0], "inner", schema))
    assert want == [[2, 2, 20], [3, 3, 30], [3, 3, 33]]
    assert got == want
    assert ref_spilled > 0 and port_spilled > 0


@pytest.mark.parametrize("kind", ["inner", "left", "full", "semi", "anti", "mark"])
def test_force_spill_build_matches_in_memory_join(kind):
    """force_spill opens the grace partitions before the first build
    batch; every join kind answers as the in-memory join does."""
    build = RelBatch.from_pydict([("k", T.BIGINT), ("v", T.VARCHAR)],
                                 {"k": [1, 2, 2, None, 7], "v": ["a", "b", "c", "d", "e"]})
    probe = RelBatch.from_pydict([("pk", T.BIGINT)], {"pk": [2, 3, None, 7, 7]})
    schema = [(T.BIGINT, None), (T.VARCHAR, build.columns[1].dictionary)]

    def run(force):
        bridge = tops.JoinBridge()
        sink = tops.HashBuildSink(bridge, [0], schema, "cpu", force_spill=force)
        sink.add_input(build)
        sink.finish()
        assert (bridge.grace is not None) is force
        join = tops.LookupJoinOperator(bridge, [0], kind, [(T.BIGINT, None)])
        join.add_input(probe)
        join.finish()
        rows = []
        while (out := join.get_output()) is not None:
            rows.extend(out.to_pylists())
        return sorted(rows, key=repr)

    assert run(True) == run(False)


MARK_Q = ("select count(*) from orders where o_custkey < 10 or o_orderkey in"
          " (select l_orderkey from lineitem where l_quantity > 48)")


def test_spilled_mark_join_reads_the_whole_build_side(tpch):
    """Reference fault (ROADMAP §3): an IN under OR plans a mark join;
    when its build side spills, trino_tpu's LookupJoinOperator reads the
    bridge's build batch, which grace mode leaves empty, and raises. The
    port takes the IN's three-valued flags (build non-empty, a NULL key)
    from the whole partitioned build and answers as without a pool."""
    plain = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    plain.register_catalog("tpch", tpch[1])
    want = plain.execute(MARK_Q).rows
    session = dict(catalog="tpch", schema="tiny", batch_rows=4096,
                   memory_pool_bytes=64 * 1024)
    port = LocalQueryRunner(Session(**session), device="cpu")
    port.register_catalog("tpch", tpch[1])
    before = spill.stats()["grace_partitions"]
    assert port.execute(MARK_Q).rows == want == [[2245]]
    assert spill.stats()["grace_partitions"] > before
    ref = JRunner(JSession(**session))
    ref.register_catalog("tpch", tpch[0])
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'live_mask'"):
        ref.execute(MARK_Q)


def test_phase_spill_identities_at_tiny():
    """chip_smoke.py phase spill's statements and identities at tiny on
    the port's CPU runners (the card runs them at sf1): each equal to its
    unspilled twin and spilling (the bounded GROUP BY reads one batch of
    ten clerks at tiny), each join partition by partition, EXPLAIN
    ANALYZE's operator rows as without a pool."""
    import chip_smoke as CS

    pool = CS.spill_pool_bytes(CS.orders_batches("tiny", "cpu")[0])
    steps = CS.spill_identities("tiny", "cpu", lambda msg: None, pool,
                                unspilled=("group_bounded",))
    assert set(steps) == {name for name, _ in CS.SPILL_STATEMENTS} | {"explain_analyze"}
    assert steps["sort"]["rows"] == 15000 and steps["group"]["rows"] == 1000
