"""The statement surface (PREPARE/EXECUTE with the plan cache, EXPLAIN,
SHOW, SET SESSION, access control and plan validation): trino_tpu_torch
(device="cpu") against trino_tpu, statement by statement, at tpch tiny
and over small memory tables.

- The corpora run as written: their runner, session, connector and
  access-control constructors are replaced by ones that build one of
  each per package (tests/test_torch_write.py's patch_corpus), so every
  statement runs on a ParityRunner: equal column names and types, rows
  and protocol fields (added_prepare, deallocated_prepare,
  cleared_transaction, data_plane), or the same error type and message,
  re-raised as the reference's so the corpus's own pytest.raises hold.
  Plan-cache counters read through the runner must agree between the
  packages.
- tests/test_formatter.py runs on the port's formatter and parser, and
  each of its statements renders to the same text in both packages;
  tests/test_plan_validate.py's cases run on the port's plan nodes and
  checkers, and a refused plan names the same checker, node and message
  in both.
- Host-only units (the authenticators, PlanCache itself) run on the
  port's classes.
- Reference faults (ROADMAP §3) are pinned against the port's answer:
  the plan-cache key without mxu_join_enabled, and CASE/COALESCE over
  TIMESTAMP WITH TIME ZONE (tests/test_torch_timestamptz.py) or ARRAY.
- test_the_corpora_are_covered lists the cases that run elsewhere (the
  HTTP server and admission: tests/test_torch_front_door.py) and those
  that wait for a later item (the batcher, the worker deadline and the
  shape census, EXPLAIN ANALYZE's included: item 13).
- chip_smoke.py's phase statements, its identities at tiny.
"""

import inspect

import pytest

import chip_smoke as CS
import tests.test_formatter as formatter_corpus
import tests.test_plan_validate as validate_corpus
import tests.test_security as security_corpus
import tests.test_semantics as semantics_corpus
import tests.test_serving as serving_corpus
import tests.test_subquery_r5 as subquery_corpus
import tests.test_torch_write as W
import trino_tpu.sql.optimizer as joptimizer
from tests.tpch_queries import QUERIES
from trino_tpu.sql import formatter as jformatter
from trino_tpu.sql import parser as jparser
from trino_tpu_torch import config as tconfig
from trino_tpu_torch import security as tsecurity
from trino_tpu_torch import types as T
from trino_tpu_torch.engine import LocalQueryRunner, Session
from trino_tpu_torch.expr import ir as tir
from trino_tpu_torch.serving import plan_cache as tplan_cache
from trino_tpu_torch.sql import ast as tast
from trino_tpu_torch.sql import formatter as tformatter
from trino_tpu_torch.sql import fragmenter as tfragmenter
from trino_tpu_torch.sql import optimizer as toptimizer
from trino_tpu_torch.sql import parser as tparser
from trino_tpu_torch.sql import plan as TP
from trino_tpu_torch.sql import validate as tvalidate

tpch = W.tpch


def _cases(module, skip=()):
    """(class or None, name) of every test of a corpus module."""
    out = []
    for attr, obj in sorted(vars(module).items()):
        if attr.startswith("test_") and inspect.isfunction(obj):
            out.append((None, attr))
        elif attr.startswith("Test") and inspect.isclass(obj):
            out.extend((obj, n) for n in sorted(vars(obj)) if n.startswith("test_"))
    return [c for c in out if c[1] not in skip]


def _ids(cases):
    return [f"{c.__name__}.{n}" if c else n for c, n in cases]


# ---- tests/test_formatter.py ----------------------------------------------

_STATEMENTS = formatter_corpus.test_statement_roundtrip.pytestmark[0].args[1]


@pytest.fixture()
def port_formatter(monkeypatch):
    """tests/test_formatter.py's names bound to the port's formatter,
    parser and AST."""
    import trino_tpu.sql as jsql

    monkeypatch.setattr(formatter_corpus, "format_statement", tformatter.format_statement)
    monkeypatch.setattr(formatter_corpus, "format_expression", tformatter.format_expression)
    monkeypatch.setattr(formatter_corpus, "parse", tparser.parse)
    monkeypatch.setattr(jsql, "ast", tast)  # test_expression_formatting's import


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_formatter_tpch_roundtrip(qid, port_formatter):
    formatter_corpus.test_tpch_roundtrip(qid)


@pytest.mark.parametrize("sql", _STATEMENTS)
def test_formatter_statement_roundtrip(sql, port_formatter):
    formatter_corpus.test_statement_roundtrip(sql)


@pytest.mark.parametrize("name", ["test_quoted_identifier", "test_string_escaping",
                                  "test_expression_formatting", "test_canonical_is_stable"])
def test_formatter_cases(name, port_formatter):
    getattr(formatter_corpus, name)()


@pytest.mark.parametrize("sql", [QUERIES[q] for q in sorted(QUERIES)] + list(_STATEMENTS)
                         + [CS.MR_V])
def test_formatter_text_equals_the_reference(sql):
    """The canonical text (PREPARE's stored text and the plan-cache key)
    is the reference's, MATCH_RECOGNIZE's included."""
    assert (tformatter.format_statement(tparser.parse(sql))
            == jformatter.format_statement(jparser.parse(sql)))


def test_match_recognize_formatter_roundtrip(monkeypatch):
    """tests/test_match_recognize.py's formatter round trip on the port."""
    import tests.test_match_recognize as mr_corpus
    import trino_tpu.sql.formatter as jf
    import trino_tpu.sql.parser as jp

    monkeypatch.setattr(jf, "format_statement", tformatter.format_statement)
    monkeypatch.setattr(jp, "parse", tparser.parse)
    mr_corpus.test_formatter_roundtrip()


# ---- tests/test_semantics.py and tests/test_subquery_r5.py ---------------

_SEMANTICS = _cases(semantics_corpus)
_SUBQUERY = _cases(subquery_corpus)


@pytest.fixture(scope="module")
def semantics_env(tpch):
    """The corpus's env fixture on a ParityRunner (beside its sqlite)."""
    mp = pytest.MonkeyPatch()
    W.patch_corpus(mp, semantics_corpus, tpch)
    gen = semantics_corpus.env.__wrapped__()
    env = next(gen)
    dec = semantics_corpus.LocalQueryRunner(semantics_corpus.Session(catalog="memory", schema="t"))
    dec.register_catalog("memory", semantics_corpus.create_memory_connector())
    dec.execute("create table memory.t.d (p decimal(12,2), q decimal(12,2))")
    dec.execute("insert into d values (10.00, 4.00), (1.00, 3.00)")
    mp.undo()
    yield env, dec
    gen.close()


@pytest.mark.parametrize("case", _SEMANTICS, ids=_ids(_SEMANTICS))
def test_semantics_corpus(case, semantics_env):
    env, dec = semantics_env
    cls, name = case
    getattr(cls(), name)(dec if cls is semantics_corpus.TestDecimalTyping else env)


@pytest.fixture(scope="module")
def subquery_runner(tpch):
    mp = pytest.MonkeyPatch()
    W.patch_corpus(mp, subquery_corpus, tpch)
    pr = subquery_corpus.r.__wrapped__()
    mp.undo()
    return pr


@pytest.mark.parametrize("case", _SUBQUERY, ids=_ids(_SUBQUERY))
def test_subquery_corpus(case, subquery_runner, monkeypatch):
    """EXPLAIN text and rows equal in both packages (rand() rows by the
    corpus's own check); the rule-count floor on the port's rules."""
    cls, name = case
    if name == "test_rule_count_floor":
        monkeypatch.setattr(joptimizer, "SIMPLIFICATION_RULES",
                            toptimizer.SIMPLIFICATION_RULES)
        return getattr(cls(), name)()
    getattr(cls(), name)(subquery_runner)


# ---- tests/test_security.py ------------------------------------------------

_SERVER = {"test_server_401", "test_http_identity_drives_access_control",
           "test_unauthenticated_delete_rejected"}
_SECURITY = _cases(security_corpus, skip=_SERVER)


@pytest.mark.parametrize("case", _SECURITY, ids=_ids(_SECURITY))
def test_security_corpus(case, tpch, monkeypatch):
    """Access control and transactions on ParityRunners (denials equal
    in both packages); the authenticators on the port's classes."""
    cls, name = case
    if cls is security_corpus.TestAuthenticators:
        for attr in ("AuthenticationError", "InsecureAuthenticator", "JwtAuthenticator",
                     "PasswordAuthenticator"):
            monkeypatch.setattr(security_corpus, attr, getattr(tsecurity, attr))
        return getattr(cls(), name)()
    built = W.patch_corpus(monkeypatch, security_corpus, tpch)
    getattr(cls(), name)()
    assert built


# ---- tests/test_serving.py -------------------------------------------------

_SERVING = [c for c in _cases(serving_corpus)
            if c[1].startswith(("test_plan_cache", "test_execute_using"))]


@pytest.mark.parametrize("case", _SERVING, ids=_ids(_SERVING))
def test_serving_corpus(case, tpch, monkeypatch):
    """The plan-cache and EXECUTE ... USING cases: rows and errors equal
    in both packages, and every plan-cache counter the case reads equal
    too. The LRU and generation cases build a PlanCache alone: the
    port's."""
    _, name = case
    fn = getattr(serving_corpus, name)
    if "PlanCache" in fn.__code__.co_names:
        monkeypatch.setattr(serving_corpus, "PlanCache", tplan_cache.PlanCache)
        monkeypatch.setattr(serving_corpus, "Session", Session)
        return fn()
    built = W.patch_corpus(monkeypatch, serving_corpus, tpch)
    if "runner" in inspect.signature(fn).parameters:
        fn(serving_corpus.runner.__wrapped__())
    else:
        fn()
    assert built


# ---- tests/test_plan_validate.py -------------------------------------------

_VALIDATE_WAITS = {
    # the shape census counts XLA lowerings (EXPLAIN ANALYZE's too)
    "test_shape_census_simple_aggregation": "item 13",
    "test_shape_census_join_marks_retry_variant": "item 13",
    "test_explain_analyze_census_matches_observed": "item 13",
    "test_explain_analyze_census_tail_classes": "item 13",
    "test_census_warns_above_threshold": "item 13",
}
_VALIDATE = _cases(validate_corpus, skip=set(_VALIDATE_WAITS))


@pytest.fixture(scope="module")
def port_tpch_runner(tpch):
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    r.register_catalog("tpch", tpch[1])
    return r


def _validate_run(name, port, runner, monkeypatch):
    """Runs the corpus case, on the port's names when `port`; returns
    the messages of the PlanValidationErrors its _err helper caught."""
    caught = []
    err = validate_corpus._err

    def recording(fn):
        e = err(fn)
        caught.append((e.checker, e.node_path, str(e)))
        return e

    with monkeypatch.context() as mp:
        mp.setattr(validate_corpus, "_err", recording)
        if port:
            for attr, value in (("T", T), ("ir", tir), ("P", TP), ("parse", tparser.parse),
                                ("IterativeOptimizer", toptimizer.IterativeOptimizer)):
                mp.setattr(validate_corpus, attr, value)
            for attr in ("PlanValidationError", "check_plan_determinism",
                         "check_sql_stability", "validate_logical", "validate_subplan"):
                mp.setattr(validate_corpus, attr, getattr(tvalidate, attr))
            for attr in ("PlanFragment", "SubPlan",
                         "push_partial_aggregation_through_exchange"):
                mp.setattr(validate_corpus, attr, getattr(tfragmenter, attr))
        fn = getattr(validate_corpus, name)
        if "tpch_runner" in inspect.signature(fn).parameters:
            fn(runner)
        else:
            fn()
    return caught


@pytest.mark.parametrize("case", _VALIDATE, ids=_ids(_VALIDATE))
def test_plan_validate_corpus(case, port_tpch_runner, tpch, monkeypatch):
    """On the port's plan nodes and checkers; a refused plan gives the
    reference's checker, node path and message."""
    _, name = case
    want = []
    if "tpch_runner" not in inspect.signature(getattr(validate_corpus, name)).parameters:
        want = _validate_run(name, False, None, monkeypatch)
    assert _validate_run(name, True, port_tpch_runner, monkeypatch) == want


def test_partial_step_aggregate_validates_as_the_reference():
    """A partial-step AggregateNode passes validate_logical in both
    packages (its state layout is the fragmenter's), and one whose
    fields miss the state layout is refused the same way."""
    from trino_tpu import types as JT
    from trino_tpu.sql import plan as JP
    from trino_tpu.sql import validate as jvalidate

    def agg(Tm, Pm, fields):
        vals = Pm.ValuesNode((Pm.Field("k", Tm.BIGINT), Pm.Field("v", Tm.BIGINT)), ((0, 1),))
        return Pm.AggregateNode(vals, (0,), (Pm.AggCall("sum", 1, Tm.BIGINT),),
                                tuple(Pm.Field(n, getattr(Tm, t)) for n, t in fields),
                                step="partial")

    good = [("k", "BIGINT"), ("sum_1_val", "BIGINT"), ("sum_1_cnt", "BIGINT")]
    jvalidate.validate_logical(agg(JT, JP, good))
    tvalidate.validate_logical(agg(T, TP, good))
    bad = [("k", "BIGINT"), ("sum_1_val", "DOUBLE"), ("sum_1_cnt", "BIGINT")]
    errors = []
    for mod, Tm, Pm in ((jvalidate, JT, JP), (tvalidate, T, TP)):
        with pytest.raises(mod.PlanValidationError) as e:
            mod.validate_logical(agg(Tm, Pm, bad))
        errors.append((e.value.checker, e.value.node_path, str(e.value)))
    assert errors[0] == errors[1]


def test_rules_mode_validates_every_tpch_query(port_tpch_runner):
    """plan_validation = 'rules' (every rule application checked, and
    double planning) over the 22 TPC-H queries on the port."""
    r = port_tpch_runner
    r.session.plan_validation = "rules"
    try:
        for qid in sorted(QUERIES):
            stmt = tparser.parse(QUERIES[qid])
            r._analyze(stmt.query if hasattr(stmt, "query") else stmt)
    finally:
        r.session.plan_validation = "passes"


# ---- the corpora's coverage ------------------------------------------------

# corpus case -> the test file that runs it on the port
_ADMISSION = {"test_admission_sheds_past_depth", "test_server_sheds_with_429_and_retry_after",
              "test_fast_path_probe_requires_warm_plan"}
ELSEWHERE = {
    **{f"test_security.py::{n}": "tests/test_torch_front_door.py" for n in sorted(_SERVER)},
    **{f"test_serving.py::{n}": "tests/test_torch_front_door.py" for n in sorted(_ADMISSION)},
}
# corpus case -> the ROADMAP §1 item it waits for
WAITING = {
    **{f"test_plan_validate.py::{n}": i for n, i in _VALIDATE_WAITS.items()},
    **{f"test_serving.py::{n}": "item 13 (the batcher, the worker deadline)"
       for _, n in _cases(serving_corpus)
       if (None, n) not in _SERVING and n not in _ADMISSION},
}


def test_the_corpora_are_covered():
    """Every case of the six corpora runs above or waits, named, for its
    item; test_formatter.py's six with test_match_recognize.py's round
    trip."""
    ran = {f"{f}::{n}" for f, cases in (
        ("test_semantics.py", _SEMANTICS), ("test_subquery_r5.py", _SUBQUERY),
        ("test_security.py", _SECURITY), ("test_serving.py", _SERVING),
        ("test_plan_validate.py", _VALIDATE)) for _, n in cases}
    ran |= {f"test_formatter.py::{n}" for _, n in _cases(formatter_corpus)}
    for f, module in (("test_semantics.py", semantics_corpus),
                      ("test_subquery_r5.py", subquery_corpus),
                      ("test_security.py", security_corpus),
                      ("test_serving.py", serving_corpus),
                      ("test_plan_validate.py", validate_corpus),
                      ("test_formatter.py", formatter_corpus)):
        every = {f"{f}::{n}" for _, n in _cases(module)}
        accounted = ran | set(WAITING) | set(ELSEWHERE)
        assert every == accounted & every, sorted(every - accounted)
    assert not ran & set(WAITING) and not ran & set(ELSEWHERE) and not set(WAITING) & set(ELSEWHERE)
    assert all(v.startswith("item 13") for v in WAITING.values())
    assert (len(_SEMANTICS), len(_SUBQUERY), len(_SERVING)) == (13, 20, 8)
    assert len(_cases(formatter_corpus)) == 6


# ---- the session properties ------------------------------------------------


def test_show_session_lists_the_reference_properties(tpch):
    pr = W.pair(tpch, "tpch", "tiny")
    rows = pr.execute("show session").rows
    assert len(rows) == 70 == len(tconfig.SYSTEM_PROPERTIES.all())
    pr.execute("set session enable_dynamic_filtering = false")
    pr.execute("set session query_trace = 'on'")
    assert pr.execute("show session").rows != rows


@pytest.mark.parametrize("name", sorted(tconfig.UNPORTED_READERS))
def test_a_property_whose_reader_is_not_ported_raises(name):
    """Away from its default, a property read only by an unported tier
    raises naming the item, by SET SESSION and on a session set
    directly; at its default it is accepted."""
    meta = next(m for m in tconfig.SYSTEM_PROPERTIES.all() if m.name == name)
    other = {bool: not meta.default, int: 4096, float: 8.0,
             str: (meta.allowed or ("", "x"))[-1]}[meta.type]
    r = LocalQueryRunner(Session(), device="cpu")
    literal = f"'{other}'" if meta.type is str else str(other).lower()
    item = tconfig.UNPORTED_READERS[name].split(" (")[0]
    with pytest.raises(NotImplementedError, match=f"ROADMAP §1 {item}"):
        r.execute(f"set session {name} = {literal}")
    setattr(r.session, name, other)
    with pytest.raises(NotImplementedError, match=name):
        r.execute("select 1")
    setattr(r.session, name, None if name == "memory_pool_bytes" else meta.default)
    default = f"'{meta.default}'" if meta.type is str else str(meta.default).lower()
    r.execute(f"set session {name} = {default}")
    assert r.execute("select 1").rows == [[1]]


def test_explain_analyze_answers():
    r = LocalQueryRunner(Session(), device="cpu")
    text = r.execute("explain analyze select 1").only_value()
    assert text.startswith(r.execute("explain select 1").only_value() + "\n\n")
    assert "Pipeline 0:" in text and "CollectorSink: in=1 rows/1 batches" in text


# ---- the plan cache --------------------------------------------------------


def test_mxu_join_enabled_misses_the_plan_cache(tpch):
    """Reference fault (ROADMAP §3): trino_tpu's plan-cache key leaves
    out mxu_join_enabled, so after SET SESSION mxu_join_enabled = true it
    serves the plan made under the old setting (a hit); the port's key
    carries it and plans again (a miss), taking the join-project route.
    The rows stay equal."""
    from tests.test_torch_mxu_join import Q_MXJ
    from trino_tpu_torch.sql import local_planner as LP

    pr = W.pair(tpch, "tpch", "tiny", mxu_join_min_work=0.0)
    first = pr.execute(Q_MXJ).rows
    pr.execute("set session mxu_join_enabled = true")
    counts = [(c.hits, c.misses) for c in (pr.ref._plan_cache, pr.port._plan_cache)]
    selected = LP.mxu_join_selected
    again = pr.execute(Q_MXJ).rows
    (ref_h, ref_m), (port_h, port_m) = counts
    assert (pr.ref._plan_cache.hits, pr.ref._plan_cache.misses) == (ref_h + 1, ref_m)
    assert (pr.port._plan_cache.hits, pr.port._plan_cache.misses) == (port_h, port_m + 1)
    assert LP.mxu_join_selected == selected + 1
    assert again == first


def test_execute_hits_and_plans_nothing(tpch, monkeypatch):
    """A hit re-instantiates the cached physical plan: no analysis and
    no planning, equal rows; a write to another table keeps the entry,
    a write to its own drops it."""
    import trino_tpu_torch.engine as E

    pr = W.pair(tpch, "memory", "s")
    pr.execute("create table k (a bigint)")
    pr.execute("insert into k values (1), (2), (3)")
    pr.execute("create table other (a bigint)")
    pr.execute("prepare q from select count(*), sum(a) from k where a > ?")
    first = pr.execute("execute q using 1").rows
    planned = []
    monkeypatch.setattr(E.LocalPlanner, "plan",
                        lambda self, node, inner=E.LocalPlanner.plan: (
                            planned.append(node), inner(self, node))[1])
    assert pr.execute("execute q using 1").rows == first and not planned
    pr.execute("insert into other values (9)")
    planned.clear()
    assert pr.execute("execute q using 1").rows == first and not planned
    pr.execute("insert into k values (4)")
    planned.clear()
    assert pr.execute("execute q using 1").rows == [[3, 9]] and planned
    pr.execute("deallocate prepare q")
    with pytest.raises(ValueError, match="not found"):
        pr.execute("execute q using 1")


def test_prepared_statements_carried_by_the_request(tpch):
    """execute(prepared=) takes the client's statements before the
    runner's store, in both packages."""
    pr = W.pair(tpch, "tpch", "tiny")
    pr.execute("prepare p from select count(*) from nation where n_regionkey = ?")
    carried = {"p": "select count(*) from region where r_regionkey < ?"}
    assert pr.execute("execute p using 2", prepared=carried).rows == [[2]]
    assert pr.execute("execute p using 2").rows == [[5]]


def test_volatile_plans_are_not_cached(tpch):
    pr = W.pair(tpch, "tpch", "tiny")
    pr.execute("select current_date")
    pr.execute("select current_date")
    assert pr._plan_cache.hits == 0 and len(pr.port._plan_cache) == 0


def test_identity_overrides_the_session_user(tpch):
    """execute(identity=) decides access, not the session's user."""
    rules = [{"user": "alice", "privileges": ["SELECT"]}]
    pr = W.pair(tpch, "tpch", "tiny", user="alice")
    pr.access_control = W.Both(W._J_ACCESS(rules), tsecurity.FileBasedAccessControl(rules))
    assert pr.execute("select count(*) from region").rows == [[5]]
    from trino_tpu.security import AccessDeniedError, Identity

    with pytest.raises(AccessDeniedError, match="mallory"):
        pr.execute("select count(*) from region",
                   identity=W.Both(Identity("mallory"), tsecurity.Identity("mallory")))


# ---- CASE and COALESCE over temporal and nested types ----------------------


@pytest.mark.parametrize("sql,want", zip(CS.NESTED_CHOICE_SQL, [
    [[1, ["x", "red"]], [2, ["green"]], [3, []], [4, ["red", "green", "blue"]]],
    [[1, None, [7]], [2, None, [30]], [3, [], []], [4, ["red", "green", "blue"], [1, 2, 3]]],
    [[1, (1, "ann")], [2, (12, "zz")], [3, (13, "zz")], [4, (14, "zz")]],
]))
def test_case_over_nested_values_keeps_their_type(sql, want, tpch):
    """Reference fault (ROADMAP §3): trino_tpu types CASE and COALESCE
    over one ARRAY or ROW type as bigint and its plan validation refuses
    the plan; the port keeps the type and answers."""
    pr = W.pair(tpch, schema="z", setup="tags")
    with pytest.raises(Exception, match="bigint"):
        pr.ref.execute(sql)
    got = pr.port.execute(sql)
    assert got.rows == want
    assert not any(t.kind == T.TypeKind.BIGINT for t in got.column_types[1:])


def test_choice_script_runs_on_the_port():
    """Phase parity's CHOICE_SCRIPT (nested and zoned CASE, UPDATE ...
    WHERE over tstz and ARRAY columns) runs through same_writes as the
    card does, and both updates land on row 1 only."""
    a, b = (CS.script_runner(CS.CHOICE_SCRIPT, "cpu") for _ in range(2))
    CS.same_writes(a, b, CS.CHOICE_SCRIPT["sql"], "choice script", "memory")
    assert a.execute("select id, t from ev order by id").rows[:2] == [
        [1, "2021-03-14 03:30:00.000 America/New_York"],
        [2, "2021-03-14 03:30:00.000 America/New_York"]]
    assert a.execute("select id, scores from orders_tags order by id").rows == [
        [1, [0]], [2, [30]], [3, []], [4, [1, 2, 3]]]


# ---- chip_smoke.py's phase statements --------------------------------------


def test_phase_statements_identities():
    """Phase statements' steps and identities at tiny on the port (the
    card runs them at sf1): hits and misses, equal rows, access control
    and table-granular invalidation."""
    steps = CS.statement_identities("tiny", "cpu", lambda *a: None)
    assert steps["group_hit"]["hits"] == steps["group_miss"]["hits"] + 1
    assert steps["join_hit"]["rows"] == steps["join_miss"]["rows"]
