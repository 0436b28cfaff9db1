"""Shape stabilization: the capacity-class ladder.

Counterpart of trino_tpu/compile/shapes.py, line for line (host code).
The mesh plane's chunk runner (parallel/mesh_chunk.py) reads the
ladder; the engine and the distributed task hand a ShapeStabilizer to
the local planner, which threads it into the connectors' page sources
and predicts its warmup capacities from it.

In the reference, the static-shape discipline compiles one XLA program
per (operator, capacity, dtype-sig); in the port each such class is one
set of kernel launch shapes and allocator block sizes. Anything that makes batch capacities
data-dependent — connector pushdown pruning, dynamic-filter pruning,
tail chunks of large tables, spill re-reads — mints fresh capacities
and therefore fresh lowerings, which is exactly the compile churn the
shape census (sql/validate.py) was built to count.

The fix is a *policy*, not a mechanism: batches already carry a `live`
mask, so any batch can be padded to a larger capacity for free. The
CapacityLadder defines the closed set of admissible capacities and the
ShapeStabilizer decides which rung each batch lands on:

- **Scan chunks pad to the rung of their pre-pruning span.** A chunk
  covering source rows [a, b) pads to rung(b - a) no matter how many
  rows survive pushdown or dynamic-filter pruning. That makes the
  runtime capacity a function of table size and batch_rows alone —
  statically predictable by the census, identical across retries, and
  independent of selectivity estimates. The tail chunk of a table
  larger than batch_rows lands on its own (smaller, equally
  predictable) rung.
- **Spill re-reads restore their original capacity** (exec/spill.py
  records it per entry), so an unspilled batch re-enters the operator
  on the class it was first compiled for.

The default ladder (base=2) is exactly the `bucket_capacity` power-of-
two grid, so stabilization changes *which* rung a pruned batch lands on
(its span's, not its survivor-count's) without introducing any new
capacities. A coarser base (capacity_ladder_base session property)
trades padding waste for fewer classes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from trino_tpu_torch.block import MIN_CAPACITY, bucket_capacity


@dataclasses.dataclass(frozen=True)
class CapacityLadder:
    """The closed set of admissible batch capacities: min_capacity,
    min_capacity*base, min_capacity*base^2, ... Base must be a power of
    two so every rung stays on the bucket_capacity grid (device
    kernels assume power-of-two capacities)."""

    base: int = 2
    min_capacity: int = MIN_CAPACITY

    def __post_init__(self):
        if self.base < 2 or (self.base & (self.base - 1)) != 0:
            raise ValueError(f"ladder base must be a power of two >= 2, got {self.base}")
        if self.min_capacity < MIN_CAPACITY or (
            self.min_capacity & (self.min_capacity - 1)
        ) != 0:
            raise ValueError(
                f"ladder min_capacity must be a power of two >= {MIN_CAPACITY}"
            )

    def rung(self, n: int) -> int:
        """Smallest rung >= n (>= min_capacity for n <= min_capacity)."""
        c = bucket_capacity(max(int(n), 1))
        r = self.min_capacity
        while r < c:
            r *= self.base
        return r

    def rungs(self, up_to: int) -> List[int]:
        """All rungs <= rung(up_to), ascending."""
        out = [self.min_capacity]
        top = self.rung(up_to)
        while out[-1] < top:
            out.append(out[-1] * self.base)
        return out


class ShapeStabilizer:
    """Per-plan capacity policy: maps row spans/counts onto ladder
    rungs. Created by the engine per (session, plan) from the
    shape_stabilization / capacity_ladder_base session properties and
    threaded through LocalPlanner into connector page sources."""

    def __init__(self, ladder: Optional[CapacityLadder] = None,
                 batch_rows: int = 1 << 20):
        self.ladder = ladder or CapacityLadder()
        self.batch_rows = int(batch_rows)

    def chunk_capacity(self, span_rows: int) -> int:
        """Capacity for a scan chunk spanning `span_rows` source rows
        BEFORE pruning. Pruned chunks re-land on the unpruned class.
        No batch_rows clamp: generator-backed sources (tpch lineitem)
        can emit more rows per chunk than the nominal batch_rows and
        the capacity must cover every generated row."""
        return self.ladder.rung(span_rows)

    def page_capacity(self, row_count: int, floor: Optional[int] = None) -> int:
        """Capacity for a materialized page (exchange / spill re-read):
        the rung of its live row count, optionally floored to a known
        class so small pages join a larger closed set."""
        cap = self.ladder.rung(max(int(row_count), 1))
        if floor:
            cap = max(cap, int(floor))
        return cap

    def scan_classes(self, table_rows: float,
                     batch_rows: Optional[int] = None) -> Tuple[int, ...]:
        """Predicted chunk capacity classes for scanning a table of
        `table_rows` rows: the main class plus (for tables larger than
        batch_rows with a remainder) the tail class. This is the same
        arithmetic the shape census uses, so warmup precompiles exactly
        the classes the ledger will observe."""
        br = int(batch_rows or self.batch_rows)
        rows = int(max(table_rows, 1))
        caps = [self.ladder.rung(min(rows, br))]
        tail = rows % br if rows > br else 0
        if tail:
            t = self.ladder.rung(tail)
            if t not in caps:
                caps.append(t)
        return tuple(caps)
