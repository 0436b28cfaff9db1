"""Chunk-granular mesh checkpoints: host-side snapshots of the step loop.

Counterpart of trino_tpu/recovery/checkpoint.py. The chunked mesh plane
(parallel/mesh_chunk.py) owns a natural recovery boundary — the host
regains control between chunk steps, and carry shapes are ladder-stable
across the whole run — so a checkpoint is cheap and exact: each carry's
shards are copied to host numpy arrays right after a step returns (the
flag readback has already synced the device), plus the chunk index.
Feed offsets are implied: chunk k reads the slice [k*chunk_cap,
(k+1)*chunk_cap) of each shard's immutable padded feed, so resuming at
`next_chunk` replays exactly the unexecuted slices.

A snapshot holds numpy arrays only, never a torch tensor: its bytes
(`to_bytes`, pickled) never touch a card, and restoring it places each
shard's carry on that shard's device as a tensor of its own.

Entries are generation-guarded exactly like the subtree spool
(adaptive/spool.py) and the resident pins: the key carries the feed
tables' write-generation vector at snapshot time, and `get` revalidates
it — DML on any table the run read makes the checkpoint unreachable
(counted as recovery.invalidations) instead of serving stale carries.

The store is host-memory LRU, process-wide, and deliberately small:
checkpoints exist to survive a fault *within or immediately after* a
run, not to archive history. A successful run discards its own entry.
The park and host-transfer methods (`park`, `unpark`, `export_bytes`,
`import_bytes`) serve the mesh scheduler's parks
(parallel/mesh_chunk.py `_park`) and the checkpoint fabric
(runtime/fabric.py). Unlike
the reference, an import refuses only undecodable bytes
(CheckpointDecodeError, counted in `recovery.import_refused`); any
other error propagates.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from trino_tpu_torch.analysis.witness import named_lock

# counter names exported through /v1/metrics (registered as zero-valued
# keys by register_recovery_metrics so the surface is visible before the
# first fault)
CHECKPOINTS_TAKEN = "recovery.checkpoints"
RESUMES = "recovery.resumes"
INVALIDATIONS = "recovery.invalidations"
SPOOLED_STAGE_HITS = "recovery.spooled_stage_hits"
# typed declines of the port (not registered: they appear on first use)
IMPORT_REFUSED = "recovery.import_refused"

_COUNTERS = (CHECKPOINTS_TAKEN, RESUMES, INVALIDATIONS, SPOOLED_STAGE_HITS)


def register_recovery_metrics() -> None:
    """Make the recovery counters appear in /v1/metrics snapshots at
    zero (a counter otherwise only materializes on first bump, hiding
    the surface from dashboards until something fails)."""
    from trino_tpu_torch.runtime.metrics import METRICS

    for name in _COUNTERS:
        METRICS.increment(name, 0.0)


class CheckpointDecodeError(ValueError):
    """Checkpoint bytes that do not decode to a MeshCheckpoint."""


@dataclasses.dataclass
class HostCarry:
    """One carry of the chunk loop on the host: every shard's
    accumulator stacked shard-major, (n * cap, ...) rows. `columns` is
    ((type, data, valid, dictionary), ...) with numpy data and valid
    lanes; `live` is the numpy live lane."""

    columns: tuple
    live: object

    def nbytes(self) -> int:
        return int(self.live.nbytes) + sum(
            int(d.nbytes) + int(v.nbytes) for _t, d, v, _dict in self.columns)


@dataclasses.dataclass
class MeshCheckpoint:
    """One resumable position in a chunk-step loop.

    `carries_host` holds one HostCarry per carry of the loop (numpy
    arrays, never a tensor) as of having completed chunks
    [0, next_chunk); `resolved_caps` is the capacity dict the carries
    were shaped under, so a resume that lands after an overflow cap-bump
    can re-pad them onto the new rungs.
    """

    next_chunk: int  # first chunk NOT yet executed
    n_chunks: int
    chunk_cap: int
    resolved_caps: Dict[str, int]
    carries_host: tuple
    tables: Tuple[Tuple[str, str, str], ...]
    generations: Tuple[int, ...]
    query_id: str = ""

    # -- host portability (replicated meshes / multi-host failover) --
    # `carries_host` is already a pure host value (numpy arrays in
    # HostCarry records), so a checkpoint serializes without touching
    # the device: a sibling sub-mesh — or another host
    # in the pod — deserializes the bytes and `_restore_carries` places
    # them under ITS sharding. The generation vector travels inside, so
    # the receiving store's `get` revalidation still fences DML that
    # landed between snapshot and restore.
    def to_bytes(self) -> bytes:
        import pickle

        return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def from_bytes(data: bytes) -> "MeshCheckpoint":
        import pickle

        try:
            ckpt = pickle.loads(data)
        except (pickle.UnpicklingError, EOFError) as e:
            raise CheckpointDecodeError(
                f"checkpoint bytes do not decode: {e}") from e
        if not isinstance(ckpt, MeshCheckpoint):
            raise CheckpointDecodeError(
                f"checkpoint bytes decoded to {type(ckpt).__name__}"
            )
        return ckpt


class MeshCheckpointStore:
    """Generation-guarded LRU of mesh checkpoints, keyed by the program
    identity (the mesh record key minus capacities, so a resume across
    overflow cap bumps still finds its checkpoint)."""

    def __init__(self, max_entries: int = 16):
        self._lock = named_lock("MeshCheckpointStore._lock")
        self._entries: "OrderedDict[tuple, MeshCheckpoint]" = OrderedDict()  # guarded_by: _lock
        self._max = max_entries
        self.taken = 0
        self.resumed = 0
        self.invalidated = 0
        # park lifecycle (runtime/scheduler.py): keys whose entry is a
        # *parked* query's snapshot — the query's device memory is
        # gone, so the entry is the only copy of its progress. Parked
        # keys are pinned (immune to LRU eviction) and their host
        # bytes are accounted against the session park budget.
        self._parked: Dict[tuple, int] = {}  # guarded_by: _lock — key -> accounted bytes
        # resource group a parked entry is accounted to (admission-
        # weighted park budgets: runtime/scheduler.py park_budget_for)
        self._park_groups: Dict[tuple, str] = {}  # guarded_by: _lock
        self.parked_refused = 0

    def _generations(self, tables) -> Tuple[int, ...]:
        from trino_tpu_torch.resident import GENERATIONS

        return GENERATIONS.snapshot(tables)

    def put(self, key: tuple, ckpt: MeshCheckpoint) -> None:
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            self._entries[key] = ckpt
            self._entries.move_to_end(key)
            self.taken += 1
            while len(self._entries) > self._max:
                # evict oldest UNPARKED entry: a parked entry is the
                # only copy of its query's progress
                victim = next(
                    (k for k in self._entries if k not in self._parked),
                    None,
                )
                if victim is None:
                    break
                del self._entries[victim]
        METRICS.increment(CHECKPOINTS_TAKEN)

    def get(self, key: tuple) -> Optional[MeshCheckpoint]:
        """Return a live checkpoint, or None. A stale generation vector
        (DML landed on a feed table since the snapshot) drops the entry:
        its carries aggregate rows the tables no longer hold."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if self._generations(e.tables) != e.generations:
                del self._entries[key]
                self.invalidated += 1
                from trino_tpu_torch.runtime.metrics import METRICS

                METRICS.increment(INVALIDATIONS)
                return None
            self._entries.move_to_end(key)
            return e

    def note_resume(self) -> None:
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            self.resumed += 1
        METRICS.increment(RESUMES)

    def discard(self, key: tuple) -> None:
        with self._lock:
            self._entries.pop(key, None)
            self._parked.pop(key, None)
            self._park_groups.pop(key, None)

    # -- park lifecycle (preemptive scheduler) ------------------------
    @staticmethod
    def _ckpt_nbytes(ckpt: MeshCheckpoint) -> int:
        """Host footprint of a snapshot: its arrays' nbytes."""
        return sum(c.nbytes() for c in ckpt.carries_host)

    def park(self, key: tuple, ckpt: MeshCheckpoint,
             max_bytes: int, group: Optional[str] = None) -> bool:
        """Install a parked query's snapshot, accounting its host bytes
        against `max_bytes`. With `group=None` the budget is shared by
        every parked entry (the park_max_bytes pool); with a group the
        budget is that GROUP's share of the admission-weighted pool
        (mesh_park_max_bytes apportioned by scheduler weight) and only
        same-group entries count against it — one group past its share
        cannot starve another's parks. Returns False (store untouched)
        when the budget refuses — the caller keeps its device carries
        and runs to completion."""
        from trino_tpu_torch.runtime.metrics import METRICS

        nbytes = self._ckpt_nbytes(ckpt)
        with self._lock:
            in_use = sum(
                b for k, b in self._parked.items()
                if k != key
                and (group is None or self._park_groups.get(k) == group)
            )
            if max_bytes >= 0 and in_use + nbytes > max_bytes:
                self.parked_refused += 1
                return False
            self._entries[key] = ckpt
            self._entries.move_to_end(key)
            self._parked[key] = nbytes
            if group is not None:
                self._park_groups[key] = group
            else:
                self._park_groups.pop(key, None)
            self.taken += 1
        METRICS.increment(CHECKPOINTS_TAKEN)
        return True

    def unpark(self, key: tuple, keep: bool = True) -> None:
        """Release a parked entry's budget accounting. `keep=True`
        leaves the snapshot in the store as an ordinary LRU entry (the
        resume path — and drain failover, which re-reads it on a
        sibling — still finds it); `keep=False` drops it entirely
        (typed kills: a dead query must never resume)."""
        with self._lock:
            self._parked.pop(key, None)
            self._park_groups.pop(key, None)
            if not keep:
                self._entries.pop(key, None)

    def parked_bytes(self) -> int:
        with self._lock:
            return sum(self._parked.values())

    def parked_count(self) -> int:
        with self._lock:
            return len(self._parked)

    # -- host-boundary transfer (replicated meshes) -------------------
    def export_bytes(self, key: tuple) -> Optional[bytes]:
        """Serialize a live checkpoint for transfer across the host
        boundary. Goes through `get` so a stale generation vector is
        never exported — the receiver would only re-discover the
        invalidation it could have learned here."""
        ckpt = self.get(key)
        return None if ckpt is None else ckpt.to_bytes()

    def import_bytes(self, key: tuple, data: bytes,
                     rebase_epoch: bool = False) -> bool:
        """Install a checkpoint received from another host (or another
        store). The entry lands under THIS process's generation check:
        if local DML advanced any feed table past the snapshot's
        vector, the very next `get` drops it — imported bytes can never
        resurface pre-write state. Returns False on undecodable bytes
        (a truncated transfer must not poison the store), counted in
        `recovery.import_refused`; any other error propagates.

        `rebase_epoch=True` is the cross-HOST transport mode (the
        fabric's receive/pull paths): the global generation epoch
        counts process-local wholesale events (catalog registration,
        COMMIT), so two coordinators' epochs are incomparable and a
        peer's snapshot would be stillborn under the local epoch.
        Rebasing adopts the local epoch per table while KEEPING the
        snapshot's per-table write counters — table-level DML fencing
        stays live across the wire."""
        try:
            ckpt = MeshCheckpoint.from_bytes(data)
        except CheckpointDecodeError:
            from trino_tpu_torch.runtime.metrics import METRICS

            METRICS.increment(IMPORT_REFUSED)
            return False
        if rebase_epoch and ckpt.tables:
            from trino_tpu_torch.resident import GENERATIONS

            ckpt = dataclasses.replace(ckpt, generations=tuple(sorted(
                (k, (GENERATIONS.get(k)[0], gen))
                for (k, (_ep, gen)) in ckpt.generations
            )))
        self.put(key, ckpt)
        return True

    def invalidate_table(self, catalog: str, schema: str, table: str) -> int:
        """Proactive drop for the DML path (engine.py): generation
        guarding already makes stale entries unreachable lazily; this
        reclaims their host memory eagerly and makes the invalidation
        visible in metrics at write time."""
        triple = (catalog.lower(), schema.lower(), table.lower())
        with self._lock:
            stale = [
                k for k, e in self._entries.items() if triple in e.tables
            ]
            for k in stale:
                del self._entries[k]
            self.invalidated += len(stale)
        if stale:
            from trino_tpu_torch.runtime.metrics import METRICS

            METRICS.increment(INVALIDATIONS, float(len(stale)))
        return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._parked.clear()
            self._park_groups.clear()

    def reset_stats(self) -> None:
        """Zero the lifetime counters (corpus generation and tests pin
        exact counts; mirrors RESIDENT.reset_stats)."""
        with self._lock:
            self.taken = 0
            self.resumed = 0
            self.invalidated = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats_line(self) -> str:
        with self._lock:
            return (
                f"checkpoints: entries={len(self._entries)} "
                f"taken={self.taken} resumed={self.resumed} "
                f"invalidated={self.invalidated}"
            )


# the process singleton (one coordinator process, one store — mirrors
# adaptive.spool.SPOOL and resident.RESIDENT)
CHECKPOINTS = MeshCheckpointStore()
