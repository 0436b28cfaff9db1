"""Serving tier: the prepared-statement plan cache and typed EXECUTE
... USING binding.

Counterpart of trino_tpu/serving/: `plan_cache` (PREPARE/EXECUTE skips
parse -> analyze -> optimize -> plan on a hit) and `params`. Admission,
the micro-batcher and the load harness are ROADMAP §1 item 13.
"""

from trino_tpu_torch.serving.params import ParameterBindingError  # noqa: F401
from trino_tpu_torch.serving.plan_cache import PlanCache  # noqa: F401
