"""The adaptive tier of trino_tpu_torch (device="cpu") against trino_tpu.

- tests/test_adaptive.py's 10 cases run on the port's names
  (`adaptive_names`: tests/test_torch_compile.port_names plus the
  adaptive and recovery modules, the controller built on the CPU). The
  one that reads jax's compile counter runs as a port-side copy reading
  the port's, `programs_built`.
- The observer's functions against the reference's on the same seeded
  rows; the controller's report and the re-planned plan text against the
  reference's for each case of test_oracle_equality_across_replans.
- Materialized rows of every round-trippable type come back equal to the
  reference's, and the query over them equals the query without the
  controller.
- The typed declines that replace the reference's catch-alls (ROADMAP
  §3), each counted; an unexpected error inside a materialization
  propagates; the controller runs its barriers on the runner's device.
- Every case runs with the process-wide tiers cleared before and after
  (`clean_tiers`: the subtree spool, the checkpoint store, the stage
  recorder and the mesh fault hook) and the warm-class registry saved
  and restored, so no outcome depends on test order.
"""

import importlib
import inspect

import numpy as np
import pytest

import tests.test_adaptive as adaptive_corpus
from tests.test_torch_compile import isolated_registries, port_names  # noqa: F401
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu_torch.adaptive import SPOOL, AdaptiveController
from trino_tpu_torch.runtime.metrics import METRICS

# the adaptive and recovery tiers' modules, beyond port_names's
_TIERS = ["adaptive", "adaptive.spool", "adaptive.observer", "adaptive.controller",
          "recovery", "recovery.checkpoint", "recovery.stage_spool"]
_TIERS_ORIGINAL = {name: dict(vars(importlib.import_module("trino_tpu." + name)))
                   for name in _TIERS}


def _on_cpu(cls):
    def make(*args, **kw):
        kw.setdefault("device", "cpu")
        return cls(*args, **kw)

    return make


def adaptive_names(mp, *corpora) -> None:
    """port_names, plus the adaptive and recovery modules: every public
    name of those reference modules that the port's module also has is
    bound to the port's (AdaptiveController built on the CPU), in the
    reference module and in each corpus."""
    port_names(mp, *corpora)
    swap = {}
    for name in _TIERS:
        j = importlib.import_module("trino_tpu." + name)
        t = importlib.import_module("trino_tpu_torch." + name)
        swap[id(j)] = t
        parent, _, leaf = ("trino_tpu." + name).rpartition(".")
        mp.setattr(importlib.import_module(parent), leaf, t)
        for attr, obj in _TIERS_ORIGINAL[name].items():
            if attr.startswith("_") or inspect.ismodule(obj) or not hasattr(t, attr):
                continue
            new = getattr(t, attr)
            if attr == "AdaptiveController":
                new = _on_cpu(new)
            mp.setattr(j, attr, new)
            swap.setdefault(id(obj), new)
    for corpus in corpora:
        for attr, obj in list(vars(corpus).items()):
            if id(obj) in swap:
                mp.setattr(corpus, attr, swap[id(obj)])


def _clear_tiers():
    from trino_tpu_torch.parallel import mesh_chunk
    from trino_tpu_torch.recovery import CHECKPOINTS, RECORDER

    SPOOL.clear()
    CHECKPOINTS.clear()
    RECORDER.clear()
    mesh_chunk.MESH_FAULT_HOOK = None


@pytest.fixture(autouse=True)
def clean_tiers():
    """The adaptive and recovery tiers' process-wide state, empty before
    and after the case."""
    _clear_tiers()
    yield
    _clear_tiers()


# ---- tests/test_adaptive.py --------------------------------------------------

def corpus_params(corpus, names):
    """pytest.param of every case of `names` in `corpus`, one per set of
    its parametrize values (the tier-2 ones, marked slow in the corpus,
    left out as the reference's tier 1 leaves them out): (name, kwargs)."""
    out = []
    for name in names:
        marks = [m for m in getattr(getattr(corpus, name), "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append(pytest.param(name, {}, id=name))
            continue
        (mark,) = marks
        argnames = [a.strip() for a in mark.args[0].split(",")]
        for i, values in enumerate(mark.args[1]):
            if hasattr(values, "marks"):
                if any(m.name == "slow" for m in values.marks):
                    continue
                values = values.values
            if len(argnames) == 1 and not isinstance(values, tuple):
                values = (values,)
            out.append(pytest.param(name, dict(zip(argnames, values)), id=f"{name}[{i}]"))
    return out


COPIES = {"test_replanned_programs_mint_no_new_lowerings":
          "test_replanned_programs_build_nothing"}
ADAPTIVE = [n for _, n in _cases(adaptive_corpus) if n not in COPIES]


@pytest.mark.parametrize("name,kwargs", corpus_params(adaptive_corpus, ADAPTIVE))
def test_adaptive_corpus(name, kwargs, monkeypatch):
    adaptive_names(monkeypatch, adaptive_corpus)
    getattr(adaptive_corpus, name)(**kwargs)


def test_the_corpus_is_whole():
    assert len(_cases(adaptive_corpus)) == 10
    assert set(ADAPTIVE) | set(COPIES) == {n for _, n in _cases(adaptive_corpus)}


_ONE_JOIN_Q = ("select d1.name, sum(f.v) from facts f join dim1 d1 "
               "on f.k1 = d1.k group by d1.name order by 1 limit 5")


def test_replanned_programs_build_nothing(monkeypatch):
    """tests/test_adaptive.py's zero-new-lowerings gate on the port's
    counter: the second adaptive run (same re-plan, warm spool) builds
    no program, and its re-plan is served by the spool."""
    adaptive_names(monkeypatch, adaptive_corpus)
    conn = adaptive_corpus._connector()
    adaptive_corpus._lie_about_rows(conn, {"dim1": 0.1})
    r = adaptive_corpus._runner(conn, adaptive_execution=True, adaptive_replan_threshold=2.0)
    first = r.execute(_ONE_JOIN_Q).rows
    assert r._last_adaptive_report.replans == 1
    before = METRICS.counter("programs_built")
    assert r.execute(_ONE_JOIN_Q).rows == first
    assert METRICS.counter("programs_built") - before == 0
    assert r._last_adaptive_report.spool_hits == 1


# ---- the observer against the reference's --------------------------------------


def _seeded_rows(seed):
    rng = np.random.default_rng(seed)
    n = 500
    keys = np.concatenate([np.full(120, 7), rng.integers(0, 60, n - 120)])
    rng.shuffle(keys)
    names = [f"n{i % 13}" for i in range(n)]
    return [(int(k) if i % 17 else None, names[i], bool(i % 3), float(i % 5) / 4)
            for i, k in enumerate(keys)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observer_equals_the_references(seed):
    from trino_tpu.adaptive import observer as jobs
    from trino_tpu_torch.adaptive import observer as tobs

    rows = _seeded_rows(seed)
    for channels in (None, [0], [1, 3]):
        j, t = jobs.observe_rows(rows, channels=channels), tobs.observe_rows(rows, channels=channels)
        assert (t.rows, t.ndv, t.heavy_hitter, t.hot) == (j.rows, j.ndv, j.heavy_hitter, j.hot)
        assert t.plan_stats().row_count == j.plan_stats().row_count
        for ch in t.ndv:
            for threshold in (0.0, 0.05, 0.2, 0.24, 0.5):
                assert tobs.hot_keys(t, ch, threshold) == jobs.hot_keys(j, ch, threshold)
    for est, obs in ((1.0, 1.0), (0.0, 40.0), (400.0, 40.0), (40.0, 400.0), (2.5, 1e9)):
        assert tobs.divergence_ratio(est, obs) == jobs.divergence_ratio(est, obs)
        assert (tobs.estimated_vs_observed_line("build:X", est, obs, 2.0)
                == jobs.estimated_vs_observed_line("build:X", est, obs, 2.0))


# ---- the controller against the reference's ------------------------------------


def _prepared(package, factors):
    """(report as_dict, re-planned plan text, rows) of TWO_JOIN_Q under
    the package's controller, on the corpus's data with `factors` lied
    about."""
    from trino_tpu.sql.parser import parse as jparse

    if package == "trino_tpu":
        from trino_tpu.adaptive import SPOOL as spool
        from trino_tpu.adaptive import AdaptiveController as JController
        from trino_tpu.sql.plan import explain_text

        conn = adaptive_corpus._connector(n_keys=200)
        adaptive_corpus._lie_about_rows(conn, factors)
        r = adaptive_corpus._runner(conn, adaptive_execution=True,
                                    adaptive_replan_threshold=2.0)
        spool.clear()
        ctl = JController(r.catalogs, r.session)
        root = ctl.prepare(r._analyze(jparse(adaptive_corpus.TWO_JOIN_Q)))
        spool.clear()
        return ctl.report.as_dict(), explain_text(root), r.execute(adaptive_corpus.TWO_JOIN_Q).rows
    mp = pytest.MonkeyPatch()
    adaptive_names(mp, adaptive_corpus)
    try:
        from trino_tpu_torch.sql.parser import parse
        from trino_tpu_torch.sql.plan import explain_text

        conn = adaptive_corpus._connector(n_keys=200)
        adaptive_corpus._lie_about_rows(conn, factors)
        r = adaptive_corpus._runner(conn, adaptive_execution=True,
                                    adaptive_replan_threshold=2.0)
        SPOOL.clear()
        ctl = AdaptiveController(r.catalogs, r.session, device="cpu")
        root = ctl.prepare(r._analyze(parse(adaptive_corpus.TWO_JOIN_Q)))
        SPOOL.clear()
        return ctl.report.as_dict(), explain_text(root), r.execute(adaptive_corpus.TWO_JOIN_Q).rows
    finally:
        mp.undo()


_REPLAN_CASES = adaptive_corpus.test_oracle_equality_across_replans.pytestmark[0].args[1]


@pytest.mark.parametrize("factors,expected_replans", _REPLAN_CASES)
def test_report_and_replanned_plan_equal_the_references(factors, expected_replans):
    want = _prepared("trino_tpu", factors)
    got = _prepared("trino_tpu_torch", factors)
    assert got[0]["replans"] == expected_replans
    assert got[0] == want[0]
    # spool keys fingerprint each package's own plan reprs: compare the
    # text with them masked, then the keys' shape
    import re

    mask = re.compile(r"spool=[0-9a-f]{24}")
    assert mask.sub("spool=*", got[1]) == mask.sub("spool=*", want[1])
    assert len(mask.findall(got[1])) == len(mask.findall(want[1]))
    assert got[2] == want[2]


# ---- materialized rows round-trip ------------------------------------------------


def _typed_tables(package):
    """A dimension of every round-trippable type and a fact table over
    its keys, loaded into `package`'s memory connector."""
    T = importlib.import_module(package + ".types")
    memory = importlib.import_module(package + ".connectors.memory")
    C = importlib.import_module(package + ".connectors.spi").ColumnMetadata
    rng = np.random.default_rng(23)
    n = 64
    conn = memory.create_memory_connector()
    conn.load_table("s", "dim", [
        C("k", T.BIGINT), C("s", T.VARCHAR), C("d", T.DATE), C("ts", T.TIMESTAMP),
        C("r", T.REAL), C("b", T.BOOLEAN), C("i", T.INTEGER), C("x", T.DOUBLE)], [
        np.arange(n, dtype=np.int64),
        np.array([f"s{i % 9}" for i in range(n)], dtype=object),
        rng.integers(0, 20000, n).astype(np.int32),
        rng.integers(0, 1 << 50, n).astype(np.int64),
        rng.standard_normal(n).astype(np.float32),
        rng.random(n) < 0.5,
        rng.integers(-1000, 1000, n).astype(np.int32),
        rng.standard_normal(n)],
        valids=[None, None, None, rng.random(n) < 0.9, None, rng.random(n) < 0.9, None, None])
    conn.load_table("s", "facts", [C("k1", T.BIGINT), C("v", T.BIGINT)], [
        rng.integers(0, n, 2000).astype(np.int64), rng.integers(0, 100, 2000).astype(np.int64)])
    return conn


_TYPED_Q = ("select d.s, d.d, d.ts, d.r, d.b, d.i, d.x, sum(f.v) from facts f "
            "join dim d on f.k1 = d.k group by d.s, d.d, d.ts, d.r, d.b, d.i, d.x "
            "order by 1, 2, 3, 4, 5, 6, 7")


def test_materialized_rows_of_every_type_equal_the_references():
    """A build side of varchar, DATE, TIMESTAMP, REAL, BOOLEAN, INTEGER
    and DOUBLE columns materializes to the reference's Python rows, and
    the query that replays them equals the query without the controller
    (and the reference's)."""
    from trino_tpu.adaptive import spool as jspool
    from trino_tpu.engine import LocalQueryRunner as JRunner
    from trino_tpu.engine import Session as JSession
    from trino_tpu_torch.adaptive import spool as tspool
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    def runner(package_runner, session, conn, **kw):
        extra = {} if package_runner is JRunner else {"device": "cpu"}
        r = package_runner(session(catalog="memory", schema="s", **kw), **extra)
        r.register_catalog("memory", conn)
        return r

    jconn, tconn = _typed_tables("trino_tpu"), _typed_tables("trino_tpu_torch")
    for conn in (jconn, tconn):
        adaptive_corpus._lie_about_rows(conn, {"dim": 0.01})
    kw = dict(adaptive_execution=True, adaptive_replan_threshold=2.0)
    jspool.SPOOL.clear()
    want = runner(JRunner, JSession, jconn, **kw).execute(_TYPED_Q).rows
    jrows = [e.rows for e in jspool.SPOOL._entries.values()]
    tr = runner(LocalQueryRunner, Session, tconn, **kw)
    got = tr.execute(_TYPED_Q).rows
    trows = [e.rows for e in tspool.SPOOL._entries.values()]
    jspool.SPOOL.clear()
    assert tr._last_adaptive_report.spool_stores == 1
    assert trows == jrows and len(trows[0]) == 64
    assert got == want
    assert got == runner(LocalQueryRunner, Session, tconn).execute(_TYPED_Q).rows


# ---- typed declines, propagation and the device ------------------------------------


def _port_runner(conn, **session):
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    r = LocalQueryRunner(Session(catalog="memory", schema="s", **session), device="cpu")
    r.register_catalog("memory", conn)
    return r


def _port_connector(**kw):
    mp = pytest.MonkeyPatch()
    adaptive_names(mp, adaptive_corpus)
    try:
        return adaptive_corpus._connector(**kw)
    finally:
        mp.undo()


def _declined(reason):
    return METRICS.counter(f"adaptive.declined.{reason}")


def test_an_unmaterializable_build_side_declines_counted():
    """A build side with a decimal column cannot round-trip through
    Python rows: the barrier is declined, counted, and the query still
    answers as it does without the controller."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.spi import ColumnMetadata

    conn = _port_connector()
    conn.load_table("s", "ddim", [ColumnMetadata("k", T.BIGINT),
                                  ColumnMetadata("p", T.DataType(T.TypeKind.DECIMAL, 12, 2))],
                    [np.arange(40, dtype=np.int64), np.arange(40, dtype=np.int64) * 7])
    q = "select sum(d.p), count(*) from facts f join ddim d on f.k1 = d.k"
    before = _declined("unmaterializable")
    r = _port_runner(conn, adaptive_execution=True, adaptive_replan_threshold=2.0)
    rows = r.execute(q).rows
    assert _declined("unmaterializable") == before + 1
    assert r._last_adaptive_report.observations == []
    assert rows == _port_runner(conn).execute(q).rows


def test_rows_past_the_spool_bound_decline_counted(monkeypatch):
    """A build side past MAX_SPOOL_ROWS stays in the plan (declined,
    counted) and still reports its observed rows; a shared subtree past
    the bound is declined the same way."""
    from trino_tpu_torch.adaptive import controller as ctl_mod

    monkeypatch.setattr(ctl_mod, "MAX_SPOOL_ROWS", 10)
    conn = _port_connector()
    adaptive_corpus._lie_about_rows(conn, {"dim1": 0.1})
    before = _declined("spool_rows")
    r = _port_runner(conn, adaptive_execution=True, adaptive_replan_threshold=2.0)
    rows = r.execute(_ONE_JOIN_Q).rows
    rep = r._last_adaptive_report
    assert _declined("spool_rows") == before + 1
    assert rep.replans == 0 and rep.spool_stores == 0
    assert rep.observations[0]["observed"] == 40
    assert rows == _port_runner(conn).execute(_ONE_JOIN_Q).rows
    q = "select count(*) from facts where k1 not in (select k from dim1 where k < 30)"
    r = _port_runner(conn, shared_subtree_materialization=True)
    assert r.execute(q).rows == _port_runner(conn).execute(q).rows
    assert r._last_adaptive_report.shared_subtrees == 0
    assert _declined("spool_rows") == before + 2


def test_an_estimate_past_the_bound_declines_counted(monkeypatch):
    from trino_tpu_torch.adaptive import controller as ctl_mod

    monkeypatch.setattr(ctl_mod, "MAX_SPOOL_ROWS", 2)
    conn = _port_connector()
    before = _declined("estimate_rows")
    r = _port_runner(conn, adaptive_execution=True, adaptive_replan_threshold=2.0)
    assert r.execute(_ONE_JOIN_Q).rows == _port_runner(conn).execute(_ONE_JOIN_Q).rows
    assert _declined("estimate_rows") == before + 1
    assert r._last_adaptive_report.observations == []


@pytest.mark.parametrize("session", [
    {"adaptive_execution": True, "adaptive_replan_threshold": 2.0},
    {"shared_subtree_materialization": True},
])
def test_an_error_inside_a_materialization_propagates(session, monkeypatch):
    """The reference skips a barrier whose materialization raised; the
    port propagates the error (on the card it may be a kernel or device
    failure), for a build side and for a shared subtree alike."""
    from trino_tpu_torch.exec import CollectorSink

    def boom(self):
        raise RuntimeError("a kernel failed")

    conn = _port_connector()
    r = _port_runner(conn, **session)
    monkeypatch.setattr(CollectorSink, "rows", boom)
    q = (_ONE_JOIN_Q if "adaptive_execution" in session else
         "select count(*) from facts where k1 not in (select k from dim1 where k < 10)")
    with pytest.raises(RuntimeError, match="a kernel failed"):
        r.execute(q)


def test_the_controller_runs_its_barriers_on_the_runners_device(monkeypatch):
    """Each barrier's LocalPlanner gets the runner's device; a
    controller built without one takes the card, and raises here."""
    import torch

    from trino_tpu_torch.sql import local_planner

    seen = []
    orig = local_planner.LocalPlanner.__init__

    def spy(self, catalogs, device, **kw):
        seen.append(torch.device(device))
        orig(self, catalogs, device, **kw)

    monkeypatch.setattr(local_planner.LocalPlanner, "__init__", spy)
    conn = _port_connector()
    adaptive_corpus._lie_about_rows(conn, {"dim1": 0.1})
    r = _port_runner(conn, adaptive_execution=True, adaptive_replan_threshold=2.0)
    r.execute(_ONE_JOIN_Q)
    assert len(seen) >= 2 and set(seen) == {r.device}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AdaptiveController(r.catalogs, r.session)


def test_a_write_makes_a_spooled_subtree_unreachable():
    """An INSERT bumps the generation of the table a spooled subtree
    read: the next run materializes afresh (a store, no hit)."""
    conn = _port_connector()
    r = _port_runner(conn, shared_subtree_materialization=True)
    q = "select count(*) from facts where k1 not in (select k from dim1 where k < 100)"
    first = r.execute(q).rows
    assert r.execute(q).rows == first and r._last_adaptive_report.spool_stores == 0
    inv = SPOOL.invalidations
    r.execute("insert into dim1 values (50, 'late')")
    assert r.execute(q).rows == first
    assert r._last_adaptive_report.spool_stores == 1 and SPOOL.invalidations == inv + 1
