"""Serving tier: the prepared-statement plan cache, typed EXECUTE ...
USING binding, lane-based admission, the micro-batcher and the open-loop
load harness.

Counterpart of trino_tpu/serving/: `plan_cache` (PREPARE/EXECUTE skips
parse -> analyze -> optimize -> plan on a hit), `params`, `admission`,
`batcher` (concurrent point lookups coalesce into one execution) and
`harness` (`serve_smoke`, the serving gate).
"""

from trino_tpu_torch.serving.params import ParameterBindingError  # noqa: F401
from trino_tpu_torch.serving.plan_cache import PlanCache  # noqa: F401
