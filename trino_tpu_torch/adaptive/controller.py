"""The adaptive execution controller.

Counterpart of trino_tpu/adaptive/controller.py. `prepare(root)` runs
BETWEEN logical optimization and physical planning (single-node
LocalPlanner or the distributed fragmenter — both paths call it), and
closes the estimate->observe->re-plan loop:

1. shared-subtree materialization: identical subtrees (the analyzer's
   NOT IN rewrite plans its subquery twice; CTEs referenced twice) are
   materialized ONCE into the generation-guarded spool and every seat
   is substituted with the same SpooledValuesNode.
2. barrier observation: the innermost join's build side is a pipeline
   barrier — it completes before its probe starts — so the controller
   materializes it, snapshots observed rows/NDV/heavy-hitters, and
   records the divergence against the optimizer's estimate.
3. mid-query re-planning: when divergence crosses
   `adaptive_replan_threshold`, the REMAINING plan is re-optimized
   with the materialized subtree substituted as a literal source
   carrying exact observed stats (StatsCalculator short-circuits on
   `plan_stats`), so the reorderer/broadcast/partial-agg decisions see
   truth. Completed work is never redone: it rides along as rows. When
   divergence stays under the threshold the loop STOPS — estimates are
   trusted and no further barriers pay the materialization toll.

A barrier's subtree runs on the controller's `device`: the runner's
device, so on the card the barrier launches the same kernels as the
query (`device=None` is the card, raising without one). Re-planned
programs re-land on existing capacity-ladder shape classes:
materialized batches pad to bucket_capacity like every other batch, and
the re-optimization runs the same rule set, so a warm re-plan builds no
program.

Unlike the reference, no failure is skipped quietly. A barrier is
declined only on a typed, named condition, each counted in METRICS
`adaptive.declined.<reason>` (`declines` on the controller): a build
side with a type or node the spool cannot hold (`unmaterializable`), an
estimate past the spool bound (`estimate_rows`), or rows past
MAX_SPOOL_ROWS (`spool_rows`, which still feeds the spill re-plan). Any
error raised while a subtree runs or its stats are estimated propagates:
on the card it may be a kernel or device failure (ROADMAP §3).

`preempt` is called at every barrier: a deadline kill latched during
materialization or re-planning surfaces as the same typed error the
execution path raises (EXCEEDED_TIME_LIMIT stays non-retryable
mid-re-plan)."""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, List, Optional, Tuple

from trino_tpu_torch.adaptive.observer import (
    divergence_ratio,
    estimated_vs_observed_line,
    hot_keys,
    observe_rows,
    record_observation,
)
from trino_tpu_torch.adaptive.spool import (
    MAX_SPOOL_ROWS,
    SPOOL,
    SpooledValuesNode,
    duplicate_subtrees,
    materializable,
    plan_fingerprint,
    spooled_node,
    substitute,
    subtree_tables,
)
from trino_tpu_torch.sql import plan as P

MAX_REPLANS = 2


@dataclasses.dataclass
class _MatResult:
    """One materialization attempt. `entry` is None on spool overflow,
    in which case `overflow_rows` carries the observed row count."""

    entry: Optional[object]
    key: str
    hit: bool
    obs: Optional[object]  # observer.ObservedStats
    overflow_rows: Optional[int]


@dataclasses.dataclass
class AdaptiveReport:
    """What the controller did to one query — rides into QueryInfo and
    the EXPLAIN ANALYZE `adaptive=` section."""

    observations: List[dict] = dataclasses.field(default_factory=list)
    replans: int = 0
    spool_hits: int = 0
    spool_stores: int = 0
    shared_subtrees: int = 0
    transformed: bool = False
    # skew plane: heavy hitters classified at build-side
    # barriers, joins annotated for salted repartition, joins re-planned
    # into hybrid-hash spill mode after a build overflow
    heavy_hitters: int = 0
    salted_joins: int = 0
    spill_builds: int = 0

    def as_dict(self) -> dict:
        return {
            "observations": list(self.observations),
            "replans": self.replans,
            "spool_hits": self.spool_hits,
            "spool_stores": self.spool_stores,
            "shared_subtrees": self.shared_subtrees,
            "heavy_hitters": self.heavy_hitters,
            "salted_joins": self.salted_joins,
            "spill_builds": self.spill_builds,
        }

    def lines(self) -> List[str]:
        out = [
            f"adaptive: observations={len(self.observations)} "
            f"replans={self.replans} spool_hits={self.spool_hits} "
            f"spool_stores={self.spool_stores} "
            f"shared_subtrees={self.shared_subtrees}"
        ]
        # the skew line appears only when a skew action fired, so
        # no-skew queries render byte-identically to before
        if self.heavy_hitters or self.salted_joins or self.spill_builds:
            out.append(
                f"skew: heavy_hitters={self.heavy_hitters} "
                f"salted_joins={self.salted_joins} "
                f"spill_builds={self.spill_builds}"
            )
        for o in self.observations:
            suffix = ""
            if o.get("salted"):
                suffix += f" -> salted[{o['salted']}]"
            if o.get("spill"):
                suffix += " -> spill_build"
            if o.get("replanned"):
                suffix += " -> replanned"
                if o.get("trigger") == "ndv":
                    suffix += " (ndv)"
            out.append(
                estimated_vs_observed_line(
                    o["site"], o["estimated"], o["observed"], o["ratio"]
                )
                + suffix
            )
        return out


class AdaptiveController:
    def __init__(
        self,
        catalogs,
        session,
        span=None,
        preempt: Optional[Callable[[], None]] = None,
        stabilizer=None,
        max_replans: int = MAX_REPLANS,
        device=None,
    ):
        from trino_tpu_torch.engine import resolve_device

        self.device = resolve_device(device)
        self.catalogs = catalogs
        self.session = session
        self.span = span
        self.preempt = preempt
        self.stabilizer = stabilizer
        self.max_replans = max_replans
        self.report = AdaptiveReport()
        # typed declines of this controller (METRICS adaptive.declined.*)
        self.declines: Counter = Counter()
        self._stats_calc = None

    # -- config ------------------------------------------------------
    @property
    def _adaptive_on(self) -> bool:
        return bool(getattr(self.session, "adaptive_execution", False))

    @property
    def _shared_on(self) -> bool:
        return bool(
            getattr(self.session, "shared_subtree_materialization", False)
        )

    @property
    def _threshold(self) -> float:
        return float(
            getattr(self.session, "adaptive_replan_threshold", 4.0) or 4.0
        )

    @property
    def _salting_on(self) -> bool:
        return bool(getattr(self.session, "skewed_join_salting", False))

    @property
    def _hot_threshold(self) -> float:
        return float(
            getattr(self.session, "skew_hot_key_threshold", 0.2) or 0.2
        )

    @property
    def _spill_min_rows(self) -> int:
        return int(
            getattr(self.session, "skew_spill_min_rows", 1 << 18) or 1 << 18
        )

    def enabled(self) -> bool:
        return self._adaptive_on or self._shared_on

    # -- stats -------------------------------------------------------
    def _estimate_stats(self, node: P.PlanNode):
        from trino_tpu_torch.sql.stats import StatsCalculator

        if self._stats_calc is None:
            self._stats_calc = StatsCalculator(self.catalogs)
        # the reference turns any estimation error into "no estimate";
        # here it propagates (the calculator's own scan lookup already
        # answers a connector without statistics)
        return self._stats_calc.stats(node)

    def _estimate(self, node: P.PlanNode) -> float:
        st = self._estimate_stats(node)
        return st.row_count if st is not None else 1e9

    def _check_preempt(self) -> None:
        if self.preempt is not None:
            self.preempt()

    def _decline(self, reason: str, site: str) -> None:
        """Count one typed decline of a barrier."""
        from trino_tpu_torch.runtime.metrics import METRICS

        self.declines[reason] += 1
        METRICS.increment(f"adaptive.declined.{reason}")
        if self.span is not None:
            self.span.event("adaptive_decline", reason=reason, site=site)

    # -- materialization ---------------------------------------------
    def _run_subtree(self, node: P.PlanNode) -> list:
        """Execute one subtree on the controller's device to python rows
        (the completed build side / shared subtree). Deterministic by
        the materializable() gate, so running it here and substituting
        the rows is semantically the plan itself."""
        from trino_tpu_torch.engine import _raise_deferred_checks
        from trino_tpu_torch.exec import CollectorSink, Driver, Pipeline
        from trino_tpu_torch.sql.local_planner import LocalPlanner

        planner = LocalPlanner(
            self.catalogs,
            self.device,
            batch_rows=self.session.batch_rows,
            target_splits=self.session.target_splits,
            dynamic_filtering=self.session.enable_dynamic_filtering,
            stabilizer=self.stabilizer,
        )
        physical = planner.plan(node)
        ctx: dict = {}
        pipelines, chain = physical.instantiate(ctx)
        sink = CollectorSink()
        for ops in pipelines:
            Driver(Pipeline(ops)).run()
        Driver(Pipeline(chain + [sink])).run()
        _raise_deferred_checks(ctx)
        return sink.rows()

    def _materialize(
        self, node: P.PlanNode, key_channels=None
    ) -> "_MatResult":
        """Materialize one subtree into the spool. entry is None when
        the rows exceed the spool bound — the subtree stays in the plan
        — but overflow_rows still reports the observed count, which is
        exactly the DHHJ spill signal (the rows were computed either
        way)."""
        key = SPOOL.key(node)
        tables = subtree_tables(node)
        entry = SPOOL.get(key, tables)
        if entry is not None:
            self.report.spool_hits += 1
            obs = getattr(entry, "obs", None)
            if key_channels and (
                obs is None
                or any(ch not in obs.ndv for ch in key_channels)
            ):
                # entry stored by another consumer (or an older path)
                # without this join's key channels — re-observe from the
                # spooled rows so warm runs classify identically to cold
                obs = observe_rows(entry.rows, channels=key_channels)
            return _MatResult(entry, key, True, obs, None)
        rows = self._run_subtree(node)
        if len(rows) > MAX_SPOOL_ROWS:
            return _MatResult(None, key, False, None, len(rows))
        obs = observe_rows(rows, channels=key_channels)
        entry = SPOOL.put(
            key, rows, node.fields, obs.plan_stats(), tables, obs=obs
        )
        self.report.spool_stores += 1
        return _MatResult(entry, key, False, obs, None)

    # -- barrier selection -------------------------------------------
    def _next_barrier(
        self, root: P.PlanNode, visited: set
    ) -> Optional[Tuple[P.JoinNode, P.PlanNode]]:
        """Innermost join whose build side is materializable and not
        yet observed — the first barrier runtime would complete."""
        found: List[Tuple[P.JoinNode, P.PlanNode]] = []

        def walk(n):
            for c in n.children():
                walk(c)
            if isinstance(n, P.JoinNode) and n.kind != "cross":
                sub = n.right
                fp = plan_fingerprint(sub)
                if fp in visited:
                    return
                if materializable(sub):
                    found.append((n, sub))
                elif not isinstance(sub, P.ValuesNode):
                    # typed decline: a node or an output type the spool
                    # cannot round-trip (decimals, zoned timestamps,
                    # nested values, exchanges); counted once
                    visited.add(fp)
                    self._decline("unmaterializable", f"build:{type(sub).__name__}")

        walk(root)
        return found[0] if found else None

    def _validate(self, root: P.PlanNode) -> None:
        if getattr(self.session, "plan_validation", "passes") == "off":
            return
        from trino_tpu_torch.sql.validate import validate_logical

        validate_logical(root, stage="adaptive", rule="adaptive_controller")

    def _replan(self, root: P.PlanNode) -> P.PlanNode:
        """Re-optimize the remaining plan seeded with observed stats
        (the spooled nodes' plan_stats short-circuit the calculator)."""
        from trino_tpu_torch.sql.optimizer import canonicalize_tstz_keys, optimize

        self._stats_calc = None  # new plan, fresh memo
        out = canonicalize_tstz_keys(
            optimize(root, self.catalogs, self.session)
        )
        self._validate(out)
        return out

    # -- entry point --------------------------------------------------
    def prepare(self, root: P.PlanNode) -> P.PlanNode:
        """The estimate->observe->re-plan loop. Returns the (possibly
        transformed) plan; self.report records what happened."""
        if not self.enabled():
            return root
        if self._shared_on:
            root = self._materialize_shared(root)
        if self._adaptive_on:
            root = self._observe_barriers(root)
        if self.report.transformed:
            self._validate(root)
        return root

    def _materialize_shared(self, root: P.PlanNode) -> P.PlanNode:
        for nodes in duplicate_subtrees(root):
            self._check_preempt()
            proto = nodes[0]
            est = self._estimate(proto)
            # a failed materialization propagates (the reference skips
            # it): on the card it may be a kernel or device failure
            res = self._materialize(proto)
            if res.entry is None:
                self._decline("spool_rows", f"shared:{type(proto).__name__}")
                continue
            entry, key = res.entry, res.key
            site = f"shared:{type(proto).__name__}[x{len(nodes)}]"
            ratio = record_observation(
                site, est, entry.stats.row_count, self._threshold,
                span=self.span,
            )
            self.report.observations.append({
                "site": site,
                "estimated": est,
                "observed": entry.stats.row_count,
                "ratio": ratio,
            })
            spooled = spooled_node(entry, key, site)
            root = substitute(root, {id(n): spooled for n in nodes})
            # the extra seats reuse the one materialization
            extra = len(nodes) - 1
            self.report.spool_hits += extra
            self.report.shared_subtrees += 1
            from trino_tpu_torch.runtime.metrics import METRICS

            METRICS.increment("adaptive.spool_hits", extra)
            self.report.transformed = True
        return root

    def _observe_barriers(self, root: P.PlanNode) -> P.PlanNode:
        from trino_tpu_torch.runtime.metrics import METRICS

        visited: set = set()
        replans = 0
        while True:
            self._check_preempt()
            barrier = self._next_barrier(root, visited)
            if barrier is None:
                break
            join, sub = barrier
            visited.add(plan_fingerprint(sub))
            est = self._estimate(sub)
            site = f"build:{type(sub).__name__}"
            if est > MAX_SPOOL_ROWS * 4:
                # the estimate itself says this barrier is too big to
                # spool; skip it rather than materialize-and-discard
                self._decline("estimate_rows", site)
                continue
            # a failed materialization propagates (the reference skips
            # it): on the card it may be a kernel or device failure
            res = self._materialize(
                sub, key_channels=tuple(join.right_keys)
            )
            if res.entry is None:
                self._decline("spool_rows", site)
                # spool overflow: the build side blew past the estimate
                # hard enough that materializing it is off the table —
                # the DHHJ signal. Annotate the join to pre-open grace
                # partitions (hybrid hash) instead of letting the build
                # thrash through memory revocation at run time.
                observed = int(res.overflow_rows or 0)
                ratio = record_observation(
                    site, est, observed, self._threshold, span=self.span
                )
                obs = {
                    "site": site,
                    "estimated": est,
                    "observed": observed,
                    "ratio": ratio,
                }
                self.report.observations.append(obs)
                if (
                    ratio >= self._threshold
                    and observed > self._spill_min_rows
                    and not join.spill_build
                    and replans < self.max_replans
                ):
                    root = substitute(
                        root,
                        {id(join): dataclasses.replace(
                            join, spill_build=True
                        )},
                    )
                    self.report.transformed = True
                    self.report.spill_builds += 1
                    replans += 1  # spill re-plan spends re-plan budget
                    obs["spill"] = True
                    METRICS.increment("skew.spill_mode_replans")
                    if self.span is not None:
                        self.span.event(
                            "skew_spill_replan",
                            site=site,
                            observed_rows=observed,
                            divergence=round(ratio, 3),
                        )
                continue
            entry, key = res.entry, res.key
            ratio = record_observation(
                site, est, entry.stats.row_count, self._threshold,
                span=self.span,
            )
            obs = {
                "site": site,
                "estimated": est,
                "observed": entry.stats.row_count,
                "ratio": ratio,
            }
            self.report.observations.append(obs)
            # NDV divergence: a build side whose
            # key NDV estimate is badly wrong flips build-side selection
            # even when the row count held, so it triggers re-planning
            # on its own — the spooled node's exact plan_stats then seed
            # the re-optimization with observed NDV.
            ndv_ratio = 1.0
            est_stats = self._estimate_stats(sub)
            if res.obs is not None and est_stats is not None:
                for rk in join.right_keys:
                    o_ndv = res.obs.ndv.get(rk)
                    if not o_ndv:
                        continue
                    e_ndv = est_stats.col(rk).ndv
                    if e_ndv is None:
                        e_ndv = est_stats.row_count
                    ndv_ratio = max(
                        ndv_ratio, divergence_ratio(e_ndv, o_ndv)
                    )
            # heavy-hitter classification (JSPIM): the modal build keys
            # against the session threshold, from OBSERVED stats
            hot: Tuple = ()
            if res.obs is not None and len(join.right_keys) == 1:
                hot = hot_keys(
                    res.obs, join.right_keys[0], self._hot_threshold
                )
            if hot:
                self.report.heavy_hitters += len(hot)
                METRICS.increment(
                    "skew.heavy_hitters_detected", len(hot)
                )
                if self.span is not None:
                    self.span.event(
                        "skew_heavy_hitters",
                        site=site,
                        hot_keys=len(hot),
                        modal_count=res.obs.heavy_hitter.get(
                            join.right_keys[0], 0
                        ),
                        build_rows=entry.stats.row_count,
                    )
            salt = bool(
                hot
                and self._salting_on
                and join.kind in ("inner", "left", "semi", "anti")
                and len(join.right_keys) == 1
                and not join.skew_hot_keys
            )
            spooled = spooled_node(entry, key, site)
            if salt:
                root = substitute(
                    root,
                    {id(join): dataclasses.replace(
                        join, right=spooled, skew_hot_keys=tuple(hot)
                    )},
                )
                self.report.salted_joins += 1
                obs["salted"] = len(hot)
            else:
                root = substitute(root, {id(sub): spooled})
            self.report.transformed = True
            trigger_ratio = max(ratio, ndv_ratio)
            if trigger_ratio >= self._threshold and replans < self.max_replans:
                self._check_preempt()
                root = self._replan(root)
                replans += 1
                obs["replanned"] = True
                if ratio < self._threshold <= ndv_ratio:
                    obs["trigger"] = "ndv"
                self.report.replans += 1
                METRICS.increment("adaptive.replans")
                if self.span is not None:
                    self.span.event(
                        "adaptive_replan",
                        site=site,
                        divergence=round(ratio, 3),
                        ndv_divergence=round(ndv_ratio, 3),
                        attempt=replans,
                    )
                if salt:
                    # re-optimization rebuilds join nodes from scratch;
                    # re-seat the salting annotation on the join that
                    # still builds from our spooled rows
                    root = self._reannotate(root, key, tuple(hot))
            else:
                # estimates held (or the budget is spent): stop paying
                # the materialization toll
                break
        return root

    def _reannotate(
        self, root: P.PlanNode, spool_key: str, hot: Tuple
    ) -> P.PlanNode:
        """Re-apply skew_hot_keys after a re-plan: find the join whose
        build side is still the spooled node we classified. If the
        re-optimizer flipped build sides the hot set describes the
        wrong side — leave the join unannotated (correct, just not
        salted)."""
        replacements = {}

        def walk(n):
            for c in n.children():
                walk(c)
            if (
                isinstance(n, P.JoinNode)
                and n.kind in ("inner", "left", "semi", "anti")
                and len(n.right_keys) == 1
                and not n.skew_hot_keys
                and isinstance(n.right, SpooledValuesNode)
                and n.right.spool_key == spool_key
            ):
                replacements[id(n)] = dataclasses.replace(
                    n, skew_hot_keys=hot
                )

        walk(root)
        return substitute(root, replacements) if replacements else root
