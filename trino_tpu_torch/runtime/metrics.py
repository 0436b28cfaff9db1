"""Process-wide metrics registry.

Counterpart of trino_tpu/runtime/metrics.py: the port's one counter
registry (`METRICS`). The scan, exchange, parquet reader, tracker and
coordinator count through it. Analogue of the reference's JMX metrics surface (airlift @Managed beans
exported through the jmx connector / GET /v1/jmx/mbean): named counters,
gauges, and fixed-bucket distributions (CounterStat / DistributionStat /
TimeStat) that subsystems bump, snapshotted as JSON by the coordinator's
`/v1/metrics` endpoint. Counters are monotonically increasing; gauges
are set-to-current; distributions expose count/total/min/max and
p50/p95/p99 quantile estimates.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional


class Distribution:
    """Fixed-bucket histogram (DistributionStat/TimeStat analogue).

    Buckets are geometric — powers of two over 1e-6..~5e5 in whatever
    unit the caller observes (seconds here) — so one layout serves
    microsecond page pulls and hour-long queries. Quantiles come from
    the bucket upper edge the cumulative count crosses, clamped to the
    exact observed min/max; for a fixed-bucket sketch that bounds the
    error at one bucket width (~2x), which is what p50-vs-p99 gating
    needs. All-zero-cost: add() is two dict-free array ops under the
    registry lock."""

    _LO = 1e-6
    _N = 40  # 1µs * 2^39 ≈ 6.4 days — saturates the top bucket beyond

    __slots__ = ("counts", "count", "total", "min", "max")

    def __init__(self):
        self.counts = [0] * self._N
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def add(self, value: float) -> None:
        v = float(value)
        if v <= self._LO:
            idx = 0
        else:
            idx = min(self._N - 1, 1 + int(math.log2(v / self._LO)))
        self.counts[idx] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def _edge(self, idx: int) -> float:
        return self._LO * (2.0 ** idx)

    def percentile(self, p: float) -> float:
        if self.count == 0:
            return 0.0
        target = p * self.count
        seen = 0
        for idx, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                hi = min(self._edge(idx), self.max)
                return max(hi, self.min)
        return self.max or 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "total": self.total,
            "avg": self.total / self.count if self.count else 0.0,
            "min": self.min or 0.0,
            "max": self.max or 0.0,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._distributions: Dict[str, Distribution] = {}
        self._lock = threading.Lock()  # MetricsRegistry._lock

    def increment(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        """fn is evaluated at snapshot time (@Managed getter analogue)."""
        with self._lock:
            self._gauges[name] = fn

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the named distribution."""
        with self._lock:
            dist = self._distributions.get(name)
            if dist is None:
                dist = self._distributions[name] = Distribution()
            dist.add(value)

    def distribution(self, name: str) -> Optional[Dict[str, float]]:
        with self._lock:
            dist = self._distributions.get(name)
            return dist.summary() if dist is not None else None

    # -- retention ------------------------------------------------------
    #
    # Per-query counters (xla_compiles_by_query.{qid}) would otherwise
    # accumulate one entry per query for the life of the process; the
    # coordinator retires them into the query's final QueryInfo at
    # completion and prunes here, keeping the registry bounded.

    def remove(self, name: str) -> float:
        """Drop one counter, returning its final value (0.0 if absent)."""
        with self._lock:
            return self._counters.pop(name, 0.0)

    def remove_prefix(self, prefix: str) -> Dict[str, float]:
        """Drop every counter and distribution whose name starts with
        `prefix`; returns the removed counters' final values."""
        with self._lock:
            removed = {
                k: self._counters.pop(k)
                for k in [k for k in self._counters if k.startswith(prefix)]
            }
            for k in [k for k in self._distributions
                      if k.startswith(prefix)]:
                del self._distributions[k]
            return removed

    def counter_names(self) -> List[str]:
        with self._lock:
            return list(self._counters)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            gauges = list(self._gauges.items())
            dists = [(n, d.summary()) for n, d in
                     self._distributions.items()]
        for name, summary in dists:
            for stat, v in summary.items():
                out[f"{name}.{stat}"] = v
        for name, fn in gauges:
            try:
                out[name] = float(fn())
            except Exception:
                pass  # a failing gauge must not poison the snapshot
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._distributions.clear()


# the process singleton (MBeanServer analogue)
METRICS = MetricsRegistry()


# -- per-query compile counters ----------------------------------------
#
# The reference charges every XLA backend compile to the query whose
# thread dispatched it (set_compile_attribution and
# install_xla_compile_listener over jax.monitoring). Those counters
# count XLA lowerings and have no torch meaning, so the port leaves both
# out: nothing writes `xla_compiles` or `xla_compiles_by_query.*`, and a
# QueryInfo's compile_count reads 0. The retirement below stays so a
# counter written under those names is still pruned per query.


def retire_query_compiles(query_id) -> float:
    """Pull a query's compile-attribution counters out of the registry
    (base id plus every `{qid}r*` QUERY-retry namespace) and return the
    summed count, for retirement into the final QueryInfo. Exact-match
    plus an `r`-suffix prefix so q3 never swallows q30's counters."""
    total = METRICS.remove(f"xla_compiles_by_query.{query_id}")
    total += sum(
        METRICS.remove_prefix(f"xla_compiles_by_query.{query_id}r").values()
    )
    return total
