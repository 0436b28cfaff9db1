"""The recovery tier of trino_tpu_torch (device="cpu") against trino_tpu:
tests/test_recovery.py's 8 cases on the port's names
(tests/test_torch_adaptive.adaptive_names; the mesh runners get 8 CPU
shards), and the checkpoint's own contract.

- Mesh checkpoints with in-run resume: a fault mid-run or at the last
  chunk resumes with every chunk executed once, a fault at chunk 0
  falls back to the page plane (typed, counted), INSERT and UPDATE drop
  checkpoints over the written table, the generation guard catches an
  unannounced write, and a deadline during the resumed stretch stays
  typed and names the chunk. The page-plane oracle comes from a port
  runner with mesh_execution off.
- Stage-output recovery: a QUERY retry replays the finished stage from
  the subtree spool instead of re-running its producers (the corpus's
  Worker is a port Worker subclass built on the CPU, so the corpus can
  patch its create_task); under retry_policy = 'task' a later submission
  replays the committed stages.
- The corpus's zero-new-lowerings case reads jax's compile counter: a
  port-side copy reads the port's, `programs_built`.
- A MeshCheckpoint round-trips through to_bytes/from_bytes; a snapshot
  is a copy that a later write to the live carry does not reach; a
  restore gives every shard its own tensors; the typed declines of a
  restore and of an import are counted, and an unexpected error inside a
  snapshot propagates.
"""

import inspect

import numpy as np
import pytest
import torch

import tests.test_recovery as recovery_corpus
from tests.test_torch_adaptive import adaptive_names, clean_tiers, corpus_params  # noqa: F401
from tests.test_torch_compile import isolated_registries  # noqa: F401
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu_torch.parallel import mesh_chunk
from trino_tpu_torch.recovery import CHECKPOINTS, MeshCheckpoint
from trino_tpu_torch.runtime.metrics import METRICS


def _recovery_names(mp):
    """adaptive_names, with the corpus's Worker a CPU subclass of the
    port's (the corpus patches Worker.create_task)."""
    from trino_tpu_torch.runtime.worker import Worker

    adaptive_names(mp, recovery_corpus)

    class CpuWorker(Worker):
        def __init__(self, *args, **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*args, **kw)

    mp.setattr(recovery_corpus, "Worker", CpuWorker)


@pytest.fixture(scope="module")
def baseline_rows():
    """Q_GROUP on the page plane, on the port."""
    mp = pytest.MonkeyPatch()
    adaptive_names(mp, recovery_corpus)
    try:
        return recovery_corpus.mk_runner(mesh_execution=False).execute(
            recovery_corpus.Q_GROUP).rows
    finally:
        mp.undo()


COPIES = {"test_resume_zero_new_lowerings": "test_resume_builds_nothing"}
RECOVERY = [n for _, n in _cases(recovery_corpus) if n not in COPIES]


@pytest.mark.parametrize("name,kwargs", corpus_params(recovery_corpus, RECOVERY))
def test_recovery_corpus(name, kwargs, baseline_rows, monkeypatch):
    _recovery_names(monkeypatch)
    fn = getattr(recovery_corpus, name)
    args = {"baseline_rows": baseline_rows, **kwargs}
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


def test_the_corpus_is_whole():
    assert len(_cases(recovery_corpus)) == 8
    assert set(RECOVERY) | set(COPIES) == {n for _, n in _cases(recovery_corpus)}


def test_resume_builds_nothing(baseline_rows, monkeypatch):
    """tests/test_recovery.py's zero-new-lowerings case on the port's
    counter: a resumed run builds no program."""
    _recovery_names(monkeypatch)
    r = recovery_corpus.mk_runner()
    assert r.execute(recovery_corpus.Q_GROUP).rows == baseline_rows
    K = mesh_chunk.LAST_RUN_INFO["chunks"]
    mesh_chunk.MESH_FAULT_HOOK = recovery_corpus.OneShotFault(
        max(K // 2, 1), mesh_chunk.MeshDeviceLost)
    before = METRICS.counter("programs_built")
    assert r.execute(recovery_corpus.Q_GROUP).rows == baseline_rows
    assert METRICS.counter("programs_built") - before == 0
    info = mesh_chunk.last_run_info()
    assert info["resumes"] == 1 and info["executed_chunk_steps"] == K


def test_a_join_resumes_from_its_checkpoint(monkeypatch):
    """The chunked join of tests/test_mesh_chunking.py (carries of a
    stream fragment feeding the flush) resumes mid-run with the page
    plane's rows and every chunk executed once."""
    import tests.test_mesh_chunking as chunk_corpus

    adaptive_names(monkeypatch, chunk_corpus, recovery_corpus)
    want = chunk_corpus.mk_runner(mesh_execution=False).execute(chunk_corpus.Q_JOIN).rows
    r = recovery_corpus.mk_runner(mesh_chunk_rows=256)
    assert r.execute(chunk_corpus.Q_JOIN).rows == want
    K = mesh_chunk.LAST_RUN_INFO["chunks"]
    assert K >= 4
    fault = recovery_corpus.OneShotFault(K // 2, mesh_chunk.MeshDeviceLost)
    mesh_chunk.MESH_FAULT_HOOK = fault
    assert r.execute(chunk_corpus.Q_JOIN).rows == want
    info = mesh_chunk.last_run_info()
    assert fault.fired and r.last_mesh_fallback is None
    assert (info["resumes"], info["resumed_from_chunk"], info["executed_chunk_steps"]) == (
        1, K // 2, K)
    assert info["checkpoints"] >= 1 and info["checkpoint_bytes"] > 0


def test_a_committed_fte_stage_is_replayed_by_the_next_submission(monkeypatch):
    """retry_policy = 'task' with recovery_spool_stages: the first
    submission banks every settled non-root stage from its spool files;
    the second replays them (counted hits) with equal rows."""
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.runtime import DistributedQueryRunner

    sql = ("select n_name, count(*) c from supplier, nation "
           "where s_nationkey = n_nationkey group by n_name order by n_name")
    def runner(**session):
        r = DistributedQueryRunner(
            Session(catalog="tpch", schema="tiny", retry_policy="task", **session),
            n_workers=2, hash_partitions=2, device="cpu")
        r.register_catalog("tpch", create_tpch_connector())
        return r

    want = runner().execute(sql).rows
    r = runner(recovery_spool_stages=True)
    hits0 = METRICS.counter("recovery.spooled_stage_hits")
    assert r.execute(sql).rows == want
    assert METRICS.counter("recovery.spooled_stage_hits") == hits0
    assert r.execute(sql).rows == want
    assert METRICS.counter("recovery.spooled_stage_hits") - hits0 >= 1


# ---- the checkpoint's contract ---------------------------------------------------


def _carry(n=4, cap=16, seed=0):
    """A carry of `n` shards on the CPU: a bigint and a varchar column,
    the first `cap // 2` rows of each shard live."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.block import Column, Dictionary, RelBatch

    rng = np.random.default_rng(seed)
    d = Dictionary(["a", "b", "c"])
    out = []
    for _ in range(n):
        live = torch.arange(cap) < cap // 2
        out.append(RelBatch([
            Column(T.BIGINT, torch.from_numpy(rng.integers(0, 1 << 40, cap)), live.clone()),
            Column(T.VARCHAR, torch.from_numpy(rng.integers(0, 3, cap).astype(np.int32)),
                   torch.ones(cap, dtype=torch.bool), d)], live))
    return out


def _snapshot(carries, next_chunk=2, caps=None):
    from trino_tpu_torch.resident import GENERATIONS

    tables = (("memory", "s", "t"),)
    return MeshCheckpoint(
        next_chunk=next_chunk, n_chunks=8, chunk_cap=16,
        resolved_caps=caps or {"carry:f1": 16},
        carries_host=tuple(mesh_chunk._carry_to_host(c) for c in carries),
        tables=tables, generations=GENERATIONS.snapshot(tables))


def test_a_checkpoint_round_trips_through_bytes():
    ck = _snapshot([_carry()])
    back = MeshCheckpoint.from_bytes(ck.to_bytes())
    assert (back.next_chunk, back.n_chunks, back.resolved_caps, back.tables,
            back.generations) == (ck.next_chunk, ck.n_chunks, ck.resolved_caps, ck.tables,
                                  ck.generations)
    for a, b in zip(ck.carries_host, back.carries_host):
        assert np.array_equal(a.live, b.live)
        for (ta, da, va, xa), (tb, db, vb, xb) in zip(a.columns, b.columns):
            assert ta == tb and xa == xb
            assert np.array_equal(da, db) and np.array_equal(va, vb)
    # numpy arrays only: the bytes never hold a tensor
    assert all(isinstance(x, np.ndarray) for hc in back.carries_host
               for col in hc.columns for x in col[1:3])


def test_a_snapshot_is_a_copy_of_the_live_carry():
    """On the CPU `.cpu()` returns the tensor itself: the snapshot must
    still be a copy that a later write to the carry does not reach."""
    carry = _carry()
    ck = _snapshot([carry])
    before = ck.carries_host[0].columns[0][1].copy()
    for b in carry:
        b.columns[0].data.fill_(-1)
        b.live.fill_(False)
    assert np.array_equal(ck.carries_host[0].columns[0][1], before)
    assert ck.carries_host[0].live.sum() == 4 * 8


class _Ex:
    def __init__(self, devices):
        from trino_tpu_torch.parallel.mesh import ShardMesh

        self.mesh = ShardMesh(devices)
        self.n = len(devices)


def _runner_for(devices, caps):
    runner = mesh_chunk.ChunkedMeshRunner.__new__(mesh_chunk.ChunkedMeshRunner)
    runner.ex = _Ex(devices)
    record = mesh_chunk.MeshProgramRecord(
        n_chunks=8, chunk_cap=16, resolved_caps=dict(caps), pctx_fids=(),
        carry_meta=(("out", 1),), prelude_sps=[], stream_sps=[], flush_sps=[])
    return runner, record


@pytest.mark.parametrize("new_cap", [16, 32])
def test_a_restore_gives_every_shard_its_own_tensors(new_cap):
    """Shard i's carry lands on devices[i] equal to the snapshot (padded
    with dead rows when the rung grew), sharing storage with neither
    the checkpoint nor another shard, so a write to one restored carry
    leaves the checkpoint and the other shards as they were."""
    carry = _carry()
    ck = _snapshot([carry])
    runner, record = _runner_for([torch.device("cpu")] * 4, {"carry:f1": new_cap})
    (restored,) = runner._restore_carries(ck, record)
    assert len(restored) == 4
    for s, (old, new) in enumerate(zip(carry, restored)):
        assert new.capacity == new_cap
        assert torch.equal(new.live[:16], old.live) and not new.live[16:].any()
        for a, b in zip(old.columns, new.columns):
            assert torch.equal(b.data[:16], a.data) and b.dictionary == a.dictionary
    ptrs = [c.data.data_ptr() for b in restored for c in b.columns]
    assert len(set(ptrs)) == len(ptrs)
    restored[0].columns[0].data.fill_(7)
    assert not torch.equal(restored[1].columns[0].data, restored[0].columns[0].data)
    assert (ck.carries_host[0].columns[0][1] != 7).any()


def _declines(reason):
    return METRICS.counter(f"recovery.restore_declined.{reason}")


def test_a_restore_declines_on_typed_disagreements_counted():
    carry = _carry()
    runner, record = _runner_for([torch.device("cpu")] * 4, {"carry:f1": 8})
    before = _declines("rung_shrank")
    assert runner._restore_carries(_snapshot([carry]), record) is None
    assert _declines("rung_shrank") == before + 1
    runner, record = _runner_for([torch.device("cpu")] * 4, {})
    before = _declines("carry_count")
    assert runner._restore_carries(_snapshot([carry, carry]), record) is None
    assert _declines("carry_count") == before + 1
    # a snapshot of another mesh width
    runner, record = _runner_for([torch.device("cpu")] * 2, {})
    before = _declines("shape")
    assert runner._restore_carries(_snapshot([carry]), record) is None
    assert _declines("shape") == before + 1


def test_an_undecodable_import_is_refused_counted_and_a_good_one_lands():
    key = ("mesh-ckpt", "import")
    before = METRICS.counter("recovery.import_refused")
    good = _snapshot([_carry()]).to_bytes()
    assert CHECKPOINTS.import_bytes(key, good[: len(good) // 2]) is False
    assert CHECKPOINTS.import_bytes(key, b"not a pickle") is False
    assert METRICS.counter("recovery.import_refused") == before + 2
    assert CHECKPOINTS.get(key) is None
    assert CHECKPOINTS.import_bytes(key, good) is True
    assert CHECKPOINTS.get(key).next_chunk == 2
    assert CHECKPOINTS.export_bytes(key) is not None


def test_an_error_inside_a_snapshot_propagates(monkeypatch):
    """The reference's snapshot is best-effort (any error ignored); the
    port's propagates: on the card it is a device error."""
    from tests.test_torch_distributed import MESH_DEVICES
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.runtime import DistributedQueryRunner

    def boom(_shards):
        raise RuntimeError("a device copy failed")

    monkeypatch.setattr(mesh_chunk, "_carry_to_host", boom)
    r = DistributedQueryRunner(
        Session(catalog="tpch", schema="tiny", mesh_chunk_rows=4096,
                mesh_checkpoint_interval_chunks=1),
        n_workers=2, hash_partitions=2, device="cpu", mesh_devices=MESH_DEVICES)
    r.register_catalog("tpch", create_tpch_connector())
    with pytest.raises(RuntimeError, match="a device copy failed"):
        r.execute(recovery_corpus.Q_GROUP)
    assert r.last_mesh_fallback is None


def test_a_stage_spool_file_that_does_not_decode_declines_counted(tmp_path):
    """record_committed_stage declines a stage whose committed spool file
    is corrupt (SerdeError, counted) and banks nothing."""
    import json

    from trino_tpu_torch.recovery import record_committed_stage
    from trino_tpu_torch.sql.fragmenter import PlanFragment, SubPlan
    from trino_tpu_torch.sql.plan import Field, ValuesNode
    from trino_tpu_torch import types as T

    task = tmp_path / "q1.0.0"
    task.mkdir()
    (task / "committed").write_text(json.dumps({"pages": [1]}))
    (task / "0-0.page").write_bytes(b"\x00" * 40)
    sp = SubPlan(PlanFragment(0, ValuesNode((Field("a", T.BIGINT),), ((1,),)),
                              "single", "single"), [])
    before = METRICS.counter("recovery.stage_declined.serde")
    assert record_committed_stage(str(tmp_path), ["q1.0.0"], sp, 1, is_root=False) is False
    assert METRICS.counter("recovery.stage_declined.serde") == before + 1


# ---- chip_smoke.py's phase adaptive at tiny ----------------------------------------


def test_the_phase_copies_equal_the_corpora():
    import chip_smoke as CS
    import tests.test_skew_join as skew_corpus

    assert CS.SALT_SQL == skew_corpus.SALT_SQL
    assert CS.RECOVERY_Q_GROUP == recovery_corpus.Q_GROUP


def test_phase_adaptive_steps_at_tiny(monkeypatch):
    """chip_smoke.adaptive_identities on 4 CPU shards at tiny sizes (the
    spool bound lowered so the spill step overflows it): every step's
    assertions hold, as they must on the card at full size."""
    import chip_smoke as CS
    from trino_tpu_torch.adaptive import controller as ctl_mod

    monkeypatch.setattr(ctl_mod, "MAX_SPOOL_ROWS", 1000)
    lines = []
    out = CS.adaptive_identities(
        "cpu", [torch.device("cpu")] * CS.MESH_SHARDS, "tiny", lines.append, fact_rows=16384,
        dim_rows=500, spill_rows=8192, chunk_rows=2048, salt_chunk_rows=1024,
        spill_min_rows=1000)
    assert out["replan"]["report"]["replans"] == 2
    assert out["replan"]["warm_programs_built"] == 0
    assert out["spill"]["report"]["spill_builds"] == 1 and out["spill"]["spill"]["spilled_bytes"] > 0
    assert out["salted"]["salted_exchanges"] >= 1
    for name in ("q_group", "segment_join", "salted_chunked"):
        rec = out["resume"][name]
        assert rec["chunks"] >= 2 and rec["checkpoint_bytes"] > 0
    assert out["stage_recovery"]["spooled_stage_hits"] >= 1
    assert out["stage_recovery"]["fte_hits"] >= 1
    assert len(lines) == 8
