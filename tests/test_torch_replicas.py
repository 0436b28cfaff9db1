"""The replica plane of trino_tpu_torch (device="cpu") against trino_tpu.

- tests/test_replicas.py's cases run on the port's names
  (tests/test_torch_adaptive.adaptive_names, whose portify binds
  runtime.replicas, runtime.scheduler, runtime.fabric and runtime.chaos
  too; a DistributedQueryRunner gets 8 CPU shards, so 2 replicas are 2x4
  as on the reference's 8 CPU devices). Their oracle is the port's page
  plane. The case that reads jax's compile counter runs as a port-side
  copy reading the port's, `programs_built`.
- The port's own contract: a checkpoint key holds neither the replica
  nor a device, so a sibling finds the snapshot as its own; EXPLAIN
  ANALYZE's replicas=, scheduler= and membership= lines equal the
  reference's after the same statements; a DistributedQueryRunner with
  mesh_replicas = 2 answers RECOVERY_Q_GROUP with the page plane's rows;
  concurrent statements land on both replicas.
"""

import inspect
import threading

import pytest
import torch

import tests.test_replicas as replicas_corpus
from tests.test_torch_adaptive import adaptive_names, clean_tiers  # noqa: F401
from tests.test_torch_compile import isolated_registries  # noqa: F401
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu_torch.connectors.tpch import create_tpch_connector
from trino_tpu_torch.engine import Session
from trino_tpu_torch.parallel import mesh_chunk
from trino_tpu_torch.recovery import CHECKPOINTS
from trino_tpu_torch.runtime import DistributedQueryRunner
from trino_tpu_torch.runtime.metrics import METRICS

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def baseline_rows():
    """Q_GROUP on the port's page plane."""
    r = DistributedQueryRunner(Session(catalog="tpch", schema="tiny", mesh_execution=False),
                               n_workers=2, hash_partitions=2, device="cpu")
    r.register_catalog("tpch", create_tpch_connector())
    return r.execute(replicas_corpus.Q_GROUP).rows


COPIES = {"test_failover_resumes_on_sibling_byte_identical":
          "test_failover_resumes_on_sibling_and_builds_nothing"}
CORPUS = [n for _, n in _cases(replicas_corpus) if n not in COPIES]


@pytest.mark.parametrize("name", CORPUS)
def test_replicas_corpus(name, baseline_rows, monkeypatch):
    adaptive_names(monkeypatch, replicas_corpus)
    fn = getattr(replicas_corpus, name)
    args = {"baseline_rows": baseline_rows}
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


def test_the_corpus_is_whole():
    assert len(_cases(replicas_corpus)) == 11
    assert set(CORPUS) | set(COPIES) == {n for _, n in _cases(replicas_corpus)}


def test_failover_resumes_on_sibling_and_builds_nothing(baseline_rows, monkeypatch):
    """::test_failover_resumes_on_sibling_byte_identical with the port's
    compile counter: a replica lost at 3K/4 fails over to its sibling,
    which resumes from the host checkpoint with the rows unchanged,
    every chunk executed once and no program built (the sibling is
    warm), and EXPLAIN ANALYZE counts the failover."""
    adaptive_names(monkeypatch, replicas_corpus)
    C = replicas_corpus
    r = C.mk_runner(mesh_replicas=2, mesh_resume_attempts=0)
    K = C.warm_replicas(r, baseline_rows)
    assert K >= 4, f"query too small to chunk ({K})"
    rm = r._replicas
    assert rm is not None and rm.n_replicas == 2
    target = max(1, (3 * K) // 4)
    hook = C.VictimKill(target)
    mesh_chunk.MESH_FAULT_HOOK = hook
    resumed0 = CHECKPOINTS.resumed
    steps0 = METRICS.counter("mesh.chunk_steps")
    built0 = METRICS.counter("programs_built")
    try:
        assert r.execute(C.Q_GROUP).rows == baseline_rows
    finally:
        mesh_chunk.MESH_FAULT_HOOK = None
    assert hook.fired
    assert r._last_data_plane == "mesh", r.last_mesh_fallback
    assert rm.failovers == 1
    assert CHECKPOINTS.resumed == resumed0 + 1
    assert mesh_chunk.last_run_info()["resumed_from_chunk"] == target
    assert METRICS.counter("mesh.chunk_steps") - steps0 == K
    assert METRICS.counter("programs_built") - built0 == 0
    out = r.execute(f"EXPLAIN ANALYZE {C.Q_GROUP}").rows[0][0]
    assert "replicas= n=2x4 " in out
    assert "failovers=1" in out


# ---- the port's own contract ---------------------------------------------------


def _runner(**session):
    r = DistributedQueryRunner(Session(catalog="tpch", schema="tiny", **session), n_workers=2,
                               hash_partitions=2, device="cpu", mesh_devices=CPU8)
    r.register_catalog("tpch", create_tpch_connector())
    return r


def test_recovery_q_group_over_two_replicas(baseline_rows):
    """mesh_replicas = 2 over 8 CPU shards answers RECOVERY_Q_GROUP (the
    chip smoke's copy of the corpus's Q_GROUP) with the page plane's
    rows, chunked and not."""
    import chip_smoke as CS

    assert CS.RECOVERY_Q_GROUP == replicas_corpus.Q_GROUP
    for chunk_rows in (0, 512):
        r = _runner(mesh_replicas=2, mesh_chunk_rows=chunk_rows)
        assert r.execute(CS.RECOVERY_Q_GROUP).rows == baseline_rows
        assert r._last_data_plane == "mesh" and r._replicas.n_replicas == 2


def _flatten(x):
    if isinstance(x, (tuple, list, frozenset, set)):
        for y in x:
            yield from _flatten(y)
    else:
        yield x


def test_a_checkpoint_key_holds_no_replica_and_no_device():
    """Each replica's run of one statement checkpoints under the same
    key, and the key holds no device and no replica id: a sibling finds
    the snapshot as its own."""
    r = _runner(mesh_replicas=2, mesh_chunk_rows=512, mesh_checkpoint_interval_chunks=1)
    keys = {}

    def capture(k, K):
        rep = mesh_chunk.active_replica()
        if k == 2 and rep not in keys:
            (key,) = [key for key in CHECKPOINTS._entries if key[0] == "mesh-ckpt"]
            keys[rep] = key

    mesh_chunk.MESH_FAULT_HOOK = capture
    try:
        for _ in range(2):  # sequential placements alternate replicas
            CHECKPOINTS.clear()
            r.execute(replicas_corpus.Q_GROUP)
    finally:
        mesh_chunk.MESH_FAULT_HOOK = None
    assert set(keys) == {0, 1}
    assert keys[0] == keys[1]
    leaves = list(_flatten(keys[0]))
    assert not any(isinstance(v, torch.device) for v in leaves)
    assert "cpu" not in repr(keys[0])


def test_concurrent_statements_land_on_both_replicas(baseline_rows):
    """Four threads at once over two replicas: placements on both, every
    answer the page plane's."""
    r = _runner(mesh_replicas=2, mesh_chunk_rows=2048)
    out, errors = [], []

    def go():
        try:
            out.append(r.execute(replicas_corpus.Q_GROUP).rows)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert out == [baseline_rows] * 4
    served = [rep.served for rep in r._replicas.replicas]
    assert all(n >= 1 for n in served) and sum(served) == 4


_LINES_Q = "select n_regionkey, count(*) from nation group by n_regionkey order by 1"


def _three_lines(text):
    keep = ("replicas=", "scheduler=", "membership=")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def test_explain_analyze_lines_equal_the_reference():
    """After the same statements (one mesh run, then EXPLAIN ANALYZE),
    the replicas=, scheduler= and membership= lines equal the
    reference's over 2 replicas."""
    from trino_tpu.connectors import tpch as jtpch
    from trino_tpu.engine import Session as JSession
    from trino_tpu.runtime import DistributedQueryRunner as JRunner

    for session in ({"mesh_replicas": 2},):
        j = JRunner(JSession(catalog="tpch", schema="tiny", **session), n_workers=2,
                    hash_partitions=2)
        j.register_catalog("tpch", jtpch.create_tpch_connector())
        t = _runner(**session)
        got = []
        for r in (j, t):
            r.execute(_LINES_Q)
            got.append(_three_lines(r.execute(f"EXPLAIN ANALYZE {_LINES_Q}").rows[0][0]))
        assert got[0] == got[1] and len(got[1]) == 3, got


def test_phase_replicas_steps_at_tiny():
    """chip_smoke.py phase replicas' steps at tiny on 6 CPU shards (the
    card runs them at sf1): placements on both replicas from 4 threads,
    one park and one resume with every chunk run once and no program
    built, a drain failover resumed from the host checkpoint, and a
    drain split between two siblings (a steal), every answer its
    twin's. The chaos cases run in tests/test_torch_chaos.py."""
    import chip_smoke as CS

    out = CS.replica_identities("tiny", "cpu", [torch.device("cpu")] * 6, lambda msg: None,
                                chunk_rows=1024, park_chunk_rows=4096, steal_chunk_rows=1024)
    assert min(out["placement"]["served"]) >= 1 and len(out["placement"]["explain_lines"]) == 3
    assert (out["park"]["parks"], out["park"]["resumes"], out["park"]["programs_built"]) == (
        1, 1, 0)
    assert out["failover"]["failovers"] == 1 and out["failover"]["resumes"] == 1
    assert out["steal"]["steals"] >= 1 and out["steal"]["chunk_steps"] == out["steal"]["chunks"]
