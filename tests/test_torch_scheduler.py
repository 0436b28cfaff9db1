"""The mesh run queue of trino_tpu_torch (device="cpu") against trino_tpu.

- tests/test_scheduler.py's cases run on the port's names
  (tests/test_torch_adaptive.adaptive_names; the runners get 8 CPU
  shards). The park case that reads jax's compile counter runs as a
  port-side copy reading the port's, `programs_built`.
- The same scripted seat sequence gives the same decisions and counters
  in both packages' MeshSchedulers.
- A parked run holds no carry tensor: while it waits, its carries live
  only as numpy arrays in the host store.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import tests.test_scheduler as scheduler_corpus
from tests.test_torch_adaptive import adaptive_names, clean_tiers  # noqa: F401
from tests.test_torch_compile import isolated_registries  # noqa: F401
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.runtime.scheduler import MeshScheduler as JMeshScheduler
from trino_tpu_torch.parallel import mesh_chunk
from trino_tpu_torch.recovery import CHECKPOINTS
from trino_tpu_torch.runtime.coordinator import DistributedQueryRunner
from trino_tpu_torch.runtime.metrics import METRICS
from trino_tpu_torch.runtime.scheduler import MeshJob, MeshScheduler

COPIES = {"test_park_byte_identity_at_every_chunk_index":
          "test_park_at_every_chunk_index_builds_nothing"}
CORPUS = [n for _, n in _cases(scheduler_corpus) if n not in COPIES]


@pytest.mark.parametrize("name", CORPUS)
def test_scheduler_corpus(name, monkeypatch):
    adaptive_names(monkeypatch, scheduler_corpus)
    getattr(scheduler_corpus, name)()


def test_the_corpus_is_whole():
    assert len(_cases(scheduler_corpus)) == 8
    assert set(CORPUS) | set(COPIES) == {n for _, n in _cases(scheduler_corpus)}


def test_park_at_every_chunk_index_builds_nothing(monkeypatch):
    """::test_park_byte_identity_at_every_chunk_index with the port's
    compile counter: wherever the point lookup parks the analytic, the
    rows are the uninterrupted run's, every chunk runs once, one park
    and one resume are counted, and no program is built."""
    adaptive_names(monkeypatch, scheduler_corpus)
    C = scheduler_corpus
    r = C.mk_runner()
    clean = r.execute(C.ANALYTIC).rows
    K = int(mesh_chunk.last_run_info()["chunks"])
    assert K >= 3, f"query too small to exercise every index ({K})"
    point_clean = r.execute(C.POINT).rows
    sched = r._mesh_scheduler
    assert sched is not None, "scheduled dispatch did not engage"
    built0 = METRICS.counter("programs_built")
    for target in range(K - 1):
        state = {"fired": False, "point_rows": None}
        parks0, resumes0 = sched.parks, sched.resumes
        steps0 = METRICS.counter("mesh.chunk_steps")
        mesh_chunk.MESH_FAULT_HOOK = C.spawn_point_at(r, sched, target, state)
        try:
            rows = r.execute(C.ANALYTIC).rows
        finally:
            mesh_chunk.MESH_FAULT_HOOK = None
        assert state["fired"] and rows == clean
        info = mesh_chunk.last_run_info()
        assert info["parks"] == 1 and info["unparks"] == 1, info
        assert info["executed_chunk_steps"] == K, info
        assert (sched.parks, sched.resumes) == (parks0 + 1, resumes0 + 1)
        assert C.await_point(state) == point_clean
        assert METRICS.counter("mesh.chunk_steps") - steps0 == K + 1
    assert METRICS.counter("programs_built") - built0 == 0
    assert CHECKPOINTS.parked_count() == 0


def test_scripted_seats_decide_as_the_reference():
    """One holder, a lagging group's waiter, then a fast waiter: the
    boundary decisions, the stats and the group accounts of the port's
    scheduler are the reference's."""
    def script(cls):
        s = cls(name="unit", weights={"etl": 1.0, "serving": 4.0})
        a = s.submit("qa", group="etl")
        s.acquire(a)
        out = [a.boundary(1, 10, 0.5), a.boundary(2, 10, 0.5, parkable=True)]
        f = s.submit("qf", group="serving", fast=True)
        f.ready = True
        out.append(a.boundary(3, 10, 0.5, parkable=True))
        out.append(s.park_budget_for(a, 1000))
        a.park_refused()
        out.append(s.waiting_count(fast=True))
        out.append(s.holder_query())
        s.finish(f)
        s.finish(a)
        st = s.stats()
        return out, {k: v for k, v in st.items() if k != "vtime"}, sorted(st["vtime"].items())

    ref = script(JMeshScheduler)
    got = script(MeshScheduler)
    assert got == ref
    assert ref[0][2] == "park" and ref[0][3] == 200


def test_a_parked_run_holds_no_carry_tensor(monkeypatch):
    """While the analytic sits parked, its carries list holds no tensor,
    the parked store entry holds numpy arrays only, and the frames of
    the parked chunk loop (the park and the loop that called it) hold
    no tensor but the runner's immutable feeds (the reference keeps
    those placed too)."""
    adaptive_names(monkeypatch, scheduler_corpus)
    C = scheduler_corpus
    r = C.mk_runner()
    clean = r.execute(C.ANALYTIC).rows
    seen = {}
    park_wait = MeshJob.park_wait

    def tensors_in(obj, depth=0):
        if isinstance(obj, torch.Tensor):
            return 1
        if depth > 3:
            return 0
        if isinstance(obj, (list, tuple)):
            return sum(tensors_in(x, depth + 1) for x in obj)
        if isinstance(obj, dict):
            return sum(tensors_in(x, depth + 1) for x in obj.values())
        if hasattr(obj, "columns") and hasattr(obj, "live"):  # a RelBatch
            return tensors_in([obj.live] + [(c.data, c.valid) for c in obj.columns], depth + 1)
        return 0

    def spy(job, done, total):
        frame = sys._getframe(1)
        while frame is not None and frame.f_code.co_name != "_park":
            frame = frame.f_back
        loop = frame.f_back
        seen["carries"] = tensors_in(frame.f_locals["carries"])
        seen["frames"] = sum(tensors_in(v) for f in (frame, loop)
                             for k, v in f.f_locals.items() if k != "self")
        entry = CHECKPOINTS._entries[frame.f_locals["key"]]
        arrays = [a for hc in entry.carries_host for _t, d, v, _dic in hc.columns
                  for a in (d, v)] + [hc.live for hc in entry.carries_host]
        seen["numpy"] = all(isinstance(a, np.ndarray) for a in arrays) and bool(arrays)
        return park_wait(job, done, total)

    monkeypatch.setattr(MeshJob, "park_wait", spy)
    sched = r._mesh_scheduler
    state = {"fired": False, "point_rows": None}
    mesh_chunk.MESH_FAULT_HOOK = C.spawn_point_at(r, sched, 0, state)
    try:
        assert r.execute(C.ANALYTIC).rows == clean
    finally:
        mesh_chunk.MESH_FAULT_HOOK = None
    assert C.await_point(state) is not None
    assert seen == {"carries": 0, "frames": 0, "numpy": True}, seen


def test_a_wait_polls_the_kill_hook_and_frees_the_seat():
    """A queued job whose preemption hook raises leaves the queue (the
    next waiter is granted) and the error propagates typed."""
    s = MeshScheduler(name="unit")
    a = s.submit("qa")
    s.acquire(a)

    class Killed(RuntimeError):
        pass

    def poll(done, total):
        raise Killed("deadline")

    b = s.submit("qb", poll=poll)
    out = {}

    def wait():
        try:
            s.acquire(b)
        except Killed as e:
            out["err"] = e

    t = threading.Thread(target=wait)
    t.start()
    t.join(5)
    assert isinstance(out.get("err"), Killed)
    assert s.stats()["waiting"] == 0
    s.finish(a)
    c = s.submit("qc")
    t0 = time.monotonic()
    s.acquire(c)
    assert s.holder_query() == "qc" and time.monotonic() - t0 < 1.0
    s.finish(c)


# ---- the steal merge's typed declines ---------------------------------------------

_STEAL_Q = "select l_orderkey, l_linenumber from lineitem where l_quantity < 4"


def _steal_run(monkeypatch, helper_hook=None, primary_hook=None, **session):
    """::test_drain_steal_splits_unstarted_chunks_across_siblings's
    setup (4 replicas, 64-row chunks, a drain at K // 2), with
    `helper_hook(k)` called before each of the helper's chunk steps and
    `primary_hook(replica, k)` at each of the split's primary's chunk
    boundaries (`session` on top); returns the warm rows, the faulted
    run's rows (or its error) and the counters' moves."""
    adaptive_names(monkeypatch, scheduler_corpus)
    if helper_hook is not None:
        step = mesh_chunk.ChunkedMeshRunner._checked_step

        def checked_step(self, record, k, *args):
            if threading.current_thread().name == "trino-tpu-steal-helper":
                helper_hook(k)
            return step(self, record, k, *args)

        monkeypatch.setattr(mesh_chunk.ChunkedMeshRunner, "_checked_step", checked_step)
    r = scheduler_corpus.mk_runner(mesh_replicas=4, mesh_chunk_rows=64,
                                   mesh_checkpoint_interval_chunks=1, **session)
    for _ in range(4):
        rows0 = r.execute(_STEAL_Q).rows
    K = int(mesh_chunk.last_run_info()["chunks"])
    rm = r._replicas
    state = {"victim": None}

    def hook(k, K_):
        rep = mesh_chunk.active_replica()
        if state["victim"] is None:
            state["victim"] = rep
        if rep == state["victim"] and k >= K_ // 2 and "drained" not in state:
            state["drained"] = True
            rm.request_drain(rep)
        elif "drained" in state and rep != state["victim"] and primary_hook is not None:
            primary_hook(rep, k)

    before = METRICS.snapshot()
    mesh_chunk.MESH_FAULT_HOOK = hook
    try:
        out = r.execute(_STEAL_Q).rows
    except Exception as e:  # noqa: BLE001 - returned to the caller's assert
        out = e
    finally:
        mesh_chunk.MESH_FAULT_HOOK = None
    after = METRICS.snapshot()
    moved = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after}
    return rows0, out, moved, K


def test_a_merge_disagreement_declines_counted_and_the_primary_runs_on(monkeypatch):
    """_merge_out_carry refusing the helper's rows: the merge declines,
    counted in scheduler.steal_declined.disagreement, and the primary
    runs [mid, K) itself: rows unchanged, no steal."""
    monkeypatch.setattr(mesh_chunk, "_merge_out_carry", lambda mine, theirs, n: None)
    rows0, out, moved, K = _steal_run(monkeypatch)
    assert sorted(out) == sorted(rows0)
    assert moved.get("scheduler.steal_declined.disagreement") == 1
    assert moved.get("scheduler.steals", 0) == 0
    assert mesh_chunk.last_run_info()["steals"] == 0


def test_a_helper_mesh_fault_declines_and_any_other_error_propagates(monkeypatch):
    """A mesh fault on the helper's replica is a counted decline (the
    primary runs on); any other error of the helper is raised by the
    primary at the merge (the reference drops both)."""
    def lost(k):
        raise mesh_chunk.MeshDeviceLost("helper lost")

    rows0, out, moved, _K = _steal_run(monkeypatch, lost)
    assert sorted(out) == sorted(rows0)
    assert moved.get("scheduler.steal_declined.helper_fault") == 1

    class HelperBug(Exception):
        pass

    def bug(k):
        raise HelperBug("a bug in the helper")

    _rows0, out, _moved, _K = _steal_run(monkeypatch, bug)
    assert isinstance(out, HelperBug), out


def _steal_threads():
    return [t for t in threading.enumerate() if t.name == "trino-tpu-steal-helper"]


def test_a_primary_fault_before_mid_fails_over_and_calls_the_helper_off(monkeypatch):
    """The split's primary loses its device before mid (no in-run
    resume): the helper is
    called off and joined before its replica goes back, its snapshot
    key is gone, the primary counts as a failed placement (its breaker,
    `tried`, one more failover) and the caller resumes the query whole
    on another sibling: rows unchanged, no steal (the reference drops
    the fault and counts nothing)."""
    state = {}

    def primary(rep, k):
        if "prim" not in state:
            state["prim"] = rep
            raise mesh_chunk.MeshDeviceLost("primary lost before mid")

    real_dispatch = DistributedQueryRunner._try_steal_dispatch

    def dispatch(self, *args):
        state["rm"] = args[4]
        return real_dispatch(self, *args)

    monkeypatch.setattr(DistributedQueryRunner, "_try_steal_dispatch", dispatch)
    rows0, out, moved, _K = _steal_run(monkeypatch, primary_hook=primary,
                                       mesh_resume_attempts=0)
    assert sorted(out) == sorted(rows0)
    rm = state["rm"]
    prim = next(r for r in rm.replicas if r.replica_id == state["prim"])
    assert prim.breaker.consecutive_failures == 1
    assert rm.failovers == 2 and moved.get("replica.failovers") == 2
    assert moved.get("scheduler.steals", 0) == 0
    assert not _steal_threads()
    assert not [k for k in CHECKPOINTS._entries if k and k[0] == "steal"]
    assert all(r.inflight == 0 for r in rm.replicas)


def test_a_helper_error_the_primary_never_merged_propagates(monkeypatch):
    """The helper raises a bug and the primary faults before mid, so no
    merge reads the helper's error: the dispatcher raises it after the
    join (the reference drops it)."""
    class HelperBug(Exception):
        pass

    raised, state = threading.Event(), {}

    def bug(k):
        raised.set()
        raise HelperBug("a bug in the helper")

    def primary(rep, k):
        if "prim" not in state:
            state["prim"] = rep
            assert raised.wait(60)
            raise mesh_chunk.MeshDeviceLost("primary lost before mid")

    _rows0, out, _moved, _K = _steal_run(monkeypatch, helper_hook=bug, primary_hook=primary,
                                         mesh_resume_attempts=0)
    assert isinstance(out, HelperBug), out
    assert not _steal_threads()
