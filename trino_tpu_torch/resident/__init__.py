"""Resident state tier: device-pinned warm state shared across queries.

Counterpart of trino_tpu/resident/:

- `manager.py`: per-table generation counters (the plan cache's
  generation guard made table-granular) and the `ResidentStateManager`:
  a pin budget with LRU eviction, an optional charge against a
  MemoryPool (the pool revokes pins before it considers killing a
  query), and the `resident.*` counters.
- `table.py`: `ResidentTable`, a point-lookup table whose probe side
  lives on the device at a capacity-ladder rung, probed by a
  shape-stable torch program, with an append-only delta and a
  compaction that folds it back at ladder rungs.
- `fastlane.py`: the serving hook: classify a point lookup (the
  micro-batcher's strict classifier), probe the pinned table on a hit,
  build and pin on a miss, and decline only on typed conditions.

Invalidation: DML bumps the written table's generation (an autocommit
INSERT may instead ride the delta and re-key the entry), DDL drops the
table's entries, and wholesale events (COMMIT, catalog registration)
bump a global epoch that stales every key.
"""

from trino_tpu_torch.resident.manager import (  # noqa: F401
    GENERATIONS,
    RESIDENT,
    ResidentStateManager,
    TableGenerations,
)
