"""The local exchange and the driver's blocked wait on trino_tpu_torch.

tests/test_local_exchange.py's cases run unedited with the corpus
module's names bound to the port's LocalExchange and its operators
(test_distributed_with_task_concurrency on the port's
DistributedQueryRunner, its names bound by test_torch_distributed.py's
portify; the rebalancer cases run in test_torch_serde.py beside the
rest of exchange_ops). Every thread a case
starts is joined with a timeout and must be dead when the case ends. The
port's own cases drive the exchange through Driver on two threads: the
consumer's driver waits while its source is blocked, a failed producer
fails the consumer, and should_stop aborts a pipeline.
"""

import threading

import pytest

import tests.test_local_exchange as lx_corpus
from trino_tpu_torch import types as T
from trino_tpu_torch.block import RelBatch
from trino_tpu_torch.exec import local_exchange as lx
from trino_tpu_torch.exec.driver import Driver, Pipeline, TaskAbortedError, run_pipelines
from trino_tpu_torch.exec.operators import CollectorSink, ValuesOperator

DISTRIBUTED = {"test_distributed_with_task_concurrency"}
REBALANCER = {"test_rebalancer_balances_uneven_pages", "test_rebalancer_even_stream_round_robins"}
CASES = sorted(n for n in dir(lx_corpus) if n.startswith("test_")
               and n not in DISTRIBUTED and n not in REBALANCER)

JOIN_S = 10.0


def _join_all(started):
    for t in started:
        t.join(JOIN_S)
    alive = [t.name for t in started if t.is_alive()]
    assert not alive, f"threads left alive: {alive}"


@pytest.fixture
def threads():
    """Threads started during the test, joined with a timeout and
    asserted dead at its end."""
    before = set(threading.enumerate())
    started = []
    yield started
    started.extend(t for t in threading.enumerate() if t not in before)
    _join_all(started)


def test_the_corpus_is_covered():
    names = {n for n in dir(lx_corpus) if n.startswith("test_")}
    assert names == set(CASES) | DISTRIBUTED | REBALANCER


def test_distributed_with_task_concurrency(monkeypatch, threads):
    """The corpus's distributed case on the port's runner (4 workers,
    the page exchange): the remote-source chain splits at a local
    exchange under task_concurrency = 2 and answers as with 1."""
    from tests.test_torch_distributed import _port_cluster, portify

    portify(monkeypatch, lx_corpus)
    lx_corpus.test_distributed_with_task_concurrency(_port_cluster())


@pytest.mark.parametrize("name", CASES)
def test_local_exchange_corpus_case(name, monkeypatch, threads):
    for attr in ("LocalExchange", "LocalExchangeSinkOperator", "LocalExchangeSourceOperator"):
        monkeypatch.setattr(lx_corpus, attr, getattr(lx, attr))
    getattr(lx_corpus, name)()


def _batches(n, rows=5):
    return [RelBatch.from_pydict([("k", T.BIGINT)], {"k": list(range(i * rows, (i + 1) * rows))})
            for i in range(n)]


def _rows(sink):
    return sorted(r[0] for r in sink.rows())


def _run_on_thread(fn, errors):
    def body():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - the test reads it
            errors.append(e)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("mode, consumers", [("arbitrary", 2), ("round_robin", 2),
                                             ("broadcast", 2)])
def test_driven_pipelines_cross_the_exchange(mode, consumers, threads):
    """A producer pipeline (values -> sink) and consumer pipelines
    (source -> collector) on their own threads; each consumer's driver
    waits while its source is blocked."""
    ex = lx.LocalExchange(n_consumers=consumers, mode=mode, max_buffered_batches=2)
    batches = _batches(12)
    producer = Pipeline([ValuesOperator(batches), lx.LocalExchangeSinkOperator(ex)])
    sinks = [CollectorSink() for _ in range(consumers)]
    errors = []
    started = [
        _run_on_thread(
            lambda i=i: Driver(Pipeline([lx.LocalExchangeSourceOperator(ex, i), sinks[i]])).run(),
            errors)
        for i in range(consumers)
    ]
    started.append(_run_on_thread(lambda: Driver(producer).run(), errors))
    threads.extend(started)
    _join_all(started)
    assert not errors
    everything = list(range(60))
    if mode == "broadcast":
        assert all(_rows(s) == everything for s in sinks)
    else:
        assert sorted(r for s in sinks for r in _rows(s)) == everything
    if mode == "round_robin":
        assert all(len(s.rows()) == 30 for s in sinks)


def test_a_failed_producer_fails_the_driven_consumer(threads):
    ex = lx.LocalExchange(n_consumers=1)
    lx.LocalExchangeSinkOperator(ex)
    errors = []
    t = _run_on_thread(
        lambda: Driver(Pipeline([lx.LocalExchangeSourceOperator(ex, 0), CollectorSink()])).run(),
        errors)
    threads.append(t)
    boom = RuntimeError("upstream died")
    ex.producer_failed(boom)
    _join_all([t])
    assert len(errors) == 1 and errors[0].__cause__ is boom


def test_should_stop_aborts_and_observer_sees_moves():
    moved = []
    sink = CollectorSink()
    driver = Driver(Pipeline([ValuesOperator(_batches(3)), sink]),
                    observer=lambda name, m: moved.append((name, m)))
    driver.run()
    assert moved == [("ValuesOperator", True)] * 3
    stop = Driver(Pipeline([ValuesOperator(_batches(3)), CollectorSink()]),
                  should_stop=lambda: True)
    with pytest.raises(TaskAbortedError, match="task aborted"):
        stop.run()


def test_run_pipelines_runs_each_in_order():
    sinks = [CollectorSink(), CollectorSink()]
    run_pipelines([Pipeline([ValuesOperator(_batches(2)), sinks[0]]),
                   Pipeline([ValuesOperator(_batches(1)), sinks[1]])])
    assert _rows(sinks[0]) == list(range(10)) and _rows(sinks[1]) == list(range(5))


def test_a_pipeline_with_nothing_blocked_still_reports_a_stall():
    class Stuck(ValuesOperator):
        def is_finished(self) -> bool:
            return False

        def get_output(self):
            return None

    with pytest.raises(RuntimeError, match="pipeline stalled"):
        Driver(Pipeline([Stuck([]), CollectorSink()])).run()


def test_many_threads_lose_no_batch(threads):
    """More producers and consumers than cores, the interpreter switching
    threads every microsecond: every batch arrives exactly once."""
    import os
    import sys

    n_prod, n_cons, per = 2 * (os.cpu_count() or 4), 4, 50
    ex = lx.LocalExchange(n_consumers=n_cons, mode="arbitrary", max_buffered_batches=2)
    sinks = [lx.LocalExchangeSinkOperator(ex) for _ in range(n_prod)]
    got = [[] for _ in range(n_cons)]
    errors = []

    def produce(p):
        for i in range(per):
            sinks[p].add_input((p, i))
        sinks[p].finish()

    def consume(c):
        src = lx.LocalExchangeSourceOperator(ex, c)
        while not src.is_finished():
            b = src.get_output()
            if b is not None:
                got[c].append(b)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        started = [_run_on_thread(lambda c=c: consume(c), errors) for c in range(n_cons)]
        started += [_run_on_thread(lambda p=p: produce(p), errors) for p in range(n_prod)]
        threads.extend(started)
        _join_all(started)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    seen = sorted(b for g in got for b in g)
    assert seen == sorted((p, i) for p in range(n_prod) for i in range(per))


def test_abort_frees_a_blocked_producer_and_ends_the_consumers(threads):
    ex = lx.LocalExchange(n_consumers=2, mode="broadcast", max_buffered_batches=1)
    sink = lx.LocalExchangeSinkOperator(ex)
    sink.add_input("a")  # both queues full
    errors = []
    t = _run_on_thread(lambda: sink.add_input("b"), errors)  # blocks on the full queues
    threads.append(t)
    ex.abort()
    _join_all([t])
    assert not errors
    srcs = [lx.LocalExchangeSourceOperator(ex, c) for c in range(2)]
    assert [s.get_output() for s in srcs] == [None, None]
    assert all(s.is_finished() for s in srcs)
    with pytest.raises(ValueError, match="mode"):
        lx.LocalExchange(mode="hash")
