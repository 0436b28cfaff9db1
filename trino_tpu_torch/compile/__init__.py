"""Compile regime: the capacity ladder, census-driven warmup and the
managed caches.

Counterpart of trino_tpu/compile/:

- `shapes`: the capacity-class ladder and the per-plan ShapeStabilizer
  that pads scan chunks onto a closed set of capacity classes.
- `warmup`: the warmup service fed by the shape census
  (sql/validate.py), which drives each predicted stage once on an
  all-dead batch, and the process-wide WARM_CLASSES registry the
  stuck-task watchdog reads.
- `cache`: the in-process program cache (bound filter/project closures
  and mesh program records, keyed by structure and device), the salted
  directory of built kernel libraries, and the port's compile counter
  (`programs_built`).
"""

__all__ = ["shapes", "warmup", "cache"]
