"""Adaptive execution tier: estimate -> observe -> re-plan.

Counterpart of trino_tpu/adaptive/, host code that drives the port's
device path: a barrier's subtree runs on the runner's device, and its
rows come back to the plan as a literal source. Closes the loop between the optimizer's estimates (sql/stats.py), the
truth observed at materialization barriers, and the plan that executes
the remaining work. Three cooperating pieces:

- spool.py: SpooledValuesNode (a ValuesNode carrying exact observed
  stats) + the generation-guarded SubtreeSpool that caches materialized
  subtrees across consumers and executions.
- observer.py: observed-stats snapshots (rows / NDV / heavy hitters),
  divergence math, and the shared recording protocol (tracer instant
  events + the adaptive.{replans,divergences,spool_hits} counters).
- controller.py: the AdaptiveController that materializes barriers
  (completed build sides, shared subtrees), diffs observed vs estimated
  stats, and re-optimizes the remaining plan when divergence crosses
  `adaptive_replan_threshold` — completed work is substituted back as
  literal sources so it is never redone.
"""

from trino_tpu_torch.adaptive.controller import AdaptiveController, AdaptiveReport
from trino_tpu_torch.adaptive.observer import (
    ObservedStats,
    divergence_ratio,
    observe_rows,
    record_observation,
)
from trino_tpu_torch.adaptive.spool import (
    SPOOL,
    SpooledValuesNode,
    SubtreeSpool,
    plan_fingerprint,
)

__all__ = [
    "AdaptiveController",
    "AdaptiveReport",
    "ObservedStats",
    "divergence_ratio",
    "observe_rows",
    "record_observation",
    "SPOOL",
    "SpooledValuesNode",
    "SubtreeSpool",
    "plan_fingerprint",
]
