"""Observed-stats collection + divergence recording.

Counterpart of trino_tpu/adaptive/observer.py, host code over the
Python rows a barrier materialized, as in the reference. One snapshot
per materialization barrier: row count, per-channel NDV and the
heavy-hitter (modal key) count — the JSPIM-motivated skew signal.
Divergence is the symmetric ratio max(est,obs)/min(est,obs), so a 100x
under- and a 100x over-estimate read the same. Recording is shared by
every barrier kind (completed build sides, shared-subtree spools,
distributed stage roots, mesh fragment exports): a tracer instant event
+ the `adaptive.divergences` counter when the ratio crosses the session
threshold — divergence is always RECORDED; only re-planning is gated on
`adaptive_execution`."""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

from trino_tpu_torch.sql.stats import ColStats, PlanStats

# heavy-hitter candidates retained per channel: replicating more than a
# handful of hot build keys approaches a broadcast join, which the
# planner would have chosen outright if it were profitable
MAX_HOT_KEYS = 4


@dataclasses.dataclass
class ObservedStats:
    rows: int
    ndv: Dict[int, int]  # channel -> distinct non-null values
    heavy_hitter: Dict[int, int]  # channel -> modal value count
    # channel -> ((value, count), ...) for the top values, so the skew
    # classifier can name WHICH keys are hot, not just how hot the
    # modal one is
    hot: Dict[int, Tuple[Tuple[object, int], ...]] = dataclasses.field(
        default_factory=dict
    )

    def plan_stats(self) -> PlanStats:
        """Exact PlanStats for re-optimization seeding (low/high ride
        along when the channel values are orderable numbers)."""
        cols = {
            ch: ColStats(ndv=float(n)) for ch, n in self.ndv.items()
        }
        return PlanStats(float(self.rows), cols)


def observe_rows(
    rows: Sequence[Sequence[object]],
    channels: Optional[Sequence[int]] = None,
    ndv_channel_cap: int = 8,
) -> ObservedStats:
    """Host-side snapshot over materialized python rows. `channels`
    bounds the per-channel work (join keys first); default: the first
    `ndv_channel_cap` channels."""
    n = len(rows)
    width = len(rows[0]) if n else 0
    if channels is None:
        channels = range(min(width, ndv_channel_cap))
    ndv: Dict[int, int] = {}
    hh: Dict[int, int] = {}
    hot: Dict[int, Tuple[Tuple[object, int], ...]] = {}
    for ch in channels:
        if ch >= width:
            continue
        counts = Counter(r[ch] for r in rows if r[ch] is not None)
        ndv[ch] = len(counts)
        hh[ch] = max(counts.values()) if counts else 0
        hot[ch] = tuple(counts.most_common(MAX_HOT_KEYS))
    return ObservedStats(n, ndv, hh, hot)


def hot_keys(
    obs: ObservedStats, channel: int, threshold: float
) -> Tuple[object, ...]:
    """Heavy-hitter classification (the JSPIM skew test): key values
    whose observed count is at least `threshold` of the rows. Hot keys
    must be plain hashable scalars — integer join keys in practice —
    because they are carried on the plan node and compared against the
    key column at trace time."""
    if obs.rows <= 0 or threshold <= 0.0:
        return ()
    return tuple(
        v
        for v, c in obs.hot.get(channel, ())
        if c >= threshold * obs.rows and isinstance(v, int)
        and not isinstance(v, bool)
    )


def divergence_ratio(estimated: float, observed: float) -> float:
    """Symmetric misestimation factor, >= 1.0."""
    e = max(float(estimated), 1.0)
    o = max(float(observed), 1.0)
    return e / o if e >= o else o / e


def record_observation(
    site: str,
    estimated: float,
    observed: float,
    threshold: float,
    span=None,
    extra: Optional[dict] = None,
) -> float:
    """The shared recording protocol: instant event on the query span
    + `adaptive.divergences` when the ratio crosses `threshold`.
    Returns the ratio so callers gate re-planning on the same number
    they recorded."""
    from trino_tpu_torch.runtime.metrics import METRICS

    ratio = divergence_ratio(estimated, observed)
    divergent = ratio >= threshold
    if span is not None:
        span.event(
            "adaptive_observation",
            site=site[:120],
            estimated_rows=round(float(estimated), 1),
            observed_rows=int(observed),
            divergence=round(ratio, 3),
            divergent=divergent,
            **(extra or {}),
        )
    if divergent:
        METRICS.increment("adaptive.divergences")
    return ratio


def fragment_estimates(catalogs, subplans) -> Dict[int, float]:
    """Optimizer row estimate per fragment root of the SubPlan trees in
    `subplans`. RemoteSourceNode leaves resolve to the (already
    computed) producer-fragment estimates, so every stage diffs against
    the same numbers the fragmenter's partition-count decision used
    (the coordinator's stages and the mesh plane's fragments alike)."""
    from trino_tpu_torch.sql.stats import StatsCalculator

    frag_rows: Dict[int, float] = {}

    class _FragmentStats(StatsCalculator):
        def _RemoteSourceNode(self, node):
            rows = sum(frag_rows.get(fid, 1.0) for fid in node.fragment_ids)
            return PlanStats(max(rows, 1.0))

    calc = _FragmentStats(catalogs)

    def walk(sp):
        for c in sp.children:
            walk(c)
        if sp.fragment.id not in frag_rows:
            frag_rows[sp.fragment.id] = calc.stats(sp.fragment.root).row_count

    for sp in subplans:
        walk(sp)
    return frag_rows


def estimated_vs_observed_line(
    site: str, estimated: float, observed: float, ratio: float
) -> str:
    """The EXPLAIN ANALYZE rendering shared by the local and
    distributed paths (so the two cannot drift apart)."""
    return (
        f"estimated_vs_observed: {site} rows "
        f"est={estimated:.0f} obs={observed:.0f} ratio={ratio:.2f}"
    )
