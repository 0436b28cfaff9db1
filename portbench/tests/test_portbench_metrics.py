"""The metric arithmetic on synthetic inputs."""

import pytest

from portbench import stats
from portbench.metrics import (device_idle_pct, engine_ms, kernel_busy_pct, latency_p90_ms,
                               protocol_ms, qps)
from portbench.record import RunRecord, Statement
from portbench.trace import DeviceTrace


def _record(statements, events=(), trace=None, start=100.0, end=110.0):
    sql_of = {s.id: f"select {s.id}" for s in statements}
    return RunRecord(start, end, list(statements), sql_of, list(events), 0, 0, 1.0,
                     trace, ["take_flat_kernel", "bounds_kernel"])


def test_qps_counts_statements_completed_inside_the_window():
    done = [Statement(0, "a", 100.0 + i, 100.5 + i, [], None) for i in range(12)]
    failed = Statement(1, "b", 101.0, 102.0, None, "QueryError: boom")
    r = _record(done + [failed])
    # completions at 100.5 .. 109.5 lie inside [100, 110]; 110.5 and 111.5 do not
    assert qps.read(r) == pytest.approx(10 / 10.0)


def test_nearest_rank_p90():
    samples = [float(x) for x in range(1, 101)]  # 1..100
    # nearest rank over the sorted samples: index round(0.9 * 99) = 89
    assert stats.exact_percentile(samples, 0.9) == 90.0
    assert stats.exact_percentile([5.0], 0.9) == 5.0
    assert stats.exact_percentile([], 0.9) == 0.0


@pytest.mark.parametrize("n", [99, 100, 250])
def test_p90_reads_every_statement_of_the_window_from_100_samples(n):
    # latencies 1..n ms, answered inside the window; one late and one failed
    # statement lie outside the sample
    sts = [Statement(0, f"s{i}", 100.0, 100.0 + (i + 1) / 1e3, [], None) for i in range(n)]
    sts.append(Statement(1, "late", 109.0, 111.0, [], None))
    sts.append(Statement(2, "failed", 100.0, 109.0, None, "QueryError: boom"))
    got = latency_p90_ms.read(_record(sts))
    if n < latency_p90_ms.MIN_SAMPLES:
        assert got is None
    else:
        assert got == pytest.approx(stats.exact_percentile([i + 1.0 for i in range(n)], 0.9))


def test_kernel_share_is_left_out_where_no_port_kernel_ran():
    dev = [("void at::native::vectorized_elementwise_kernel", 0, 10)]
    tr = DeviceTrace(0, 100, dev, 0, 0, [])
    assert kernel_busy_pct.read(_record([], trace=tr)) is None


def test_union_of_intervals_and_idle_share():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]
    assert stats.union(iv) == [(0, 15), (20, 31)]
    assert stats.covered(iv, 0, 100) == 26
    assert stats.covered(iv, 10, 25) == 10
    assert stats.gaps(iv, 0, 50) == [(15, 20), (31, 50)]
    dev = [("take_flat_kernel(int*)", 0, 10), ("Memcpy HtoD (Pageable -> Device)", 5, 15),
           ("void at::native::vectorized_elementwise_kernel", 20, 30)]
    tr = DeviceTrace(0, 100, dev, 1 << 20, 1, [("aten::nonzero", 14, 40)])
    r = _record([Statement(0, "a", 100.0, 101.0, [], None)], trace=tr)
    assert device_idle_pct.read(r) == pytest.approx(75.0)
    # the port's kernel covers 10 of the 25 busy nanoseconds
    assert kernel_busy_pct.read(r) == pytest.approx(40.0)
    b = tr.breakdown()
    assert b["idle_gaps"][0] == ["no host operation recorded", 70e-9]
    assert ["aten::nonzero", 5e-9] in b["idle_gaps"]


def test_quartile_spread():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([90.0, 95.0, 100.0, 105.0, 110.0, 100.0]) == pytest.approx(
        (106.25 - 93.75) / 100.0)


def test_protocol_and_engine_split_the_client_latency():
    sts = [Statement(0, "a", 100.0, 101.0, [], None), Statement(1, "b", 100.5, 102.5, [], None)]
    events = [(100.9, "select a", 0.8, "finished"), (102.4, "select b", 1.5, "finished"),
              (105.0, "select a", 0.1, "finished")]  # no client waited for the third
    r = _record(sts, events)
    assert engine_ms.read(r) == pytest.approx((0.8 + 1.5) / 2 * 1e3)
    assert protocol_ms.read(r) == pytest.approx(((1.0 - 0.8) + (2.0 - 1.5)) / 2 * 1e3)
