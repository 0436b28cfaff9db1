"""Recovery tier: chunk-granular checkpoint/resume for the mesh plane
and spooled stage-output reuse for distributed retry.

Counterpart of trino_tpu/recovery/. A checkpoint holds numpy copies of
the chunk loop's carries, never a device tensor; a replayed stage's rows
re-enter the plan as a literal source that the replay task uploads to
its device.

Two complementary halves of one idea — degrade by the increment that
failed, not by the whole plan:

- `checkpoint`: the chunked mesh step loop snapshots its device carries
  at configurable chunk boundaries into a host-side, generation-guarded
  store; MeshStuck / device loss / chaos faults resume from the last
  checkpoint instead of chunk 0 (parallel/mesh_chunk.py drives it).
- `stage_spool`: completed fragment outputs are teed (pipelined) or
  lifted from durable FTE spool files into the adaptive tier's subtree
  spool, so QUERY-level retry substitutes finished stages as
  SpooledValuesNode fragments rather than recomputing them.

Both stores follow the resident tier's invalidation protocol: entries
carry per-table write-generation vectors and a mismatch makes them
unreachable, so DML can never resurface pre-write state.
"""

from trino_tpu_torch.recovery.checkpoint import (
    CHECKPOINTS,
    CheckpointDecodeError,
    HostCarry,
    CHECKPOINTS_TAKEN,
    INVALIDATIONS,
    RESUMES,
    SPOOLED_STAGE_HITS,
    MeshCheckpoint,
    MeshCheckpointStore,
    register_recovery_metrics,
)
from trino_tpu_torch.recovery.stage_spool import (
    RECORDER,
    StageOutputRecorder,
    fragment_recordable,
    fragment_spool_key,
    harvest_recorded_stages,
    record_committed_stage,
    substitute_spooled_fragments,
)

__all__ = [
    "CHECKPOINTS",
    "CheckpointDecodeError",
    "HostCarry",
    "CHECKPOINTS_TAKEN",
    "INVALIDATIONS",
    "RESUMES",
    "SPOOLED_STAGE_HITS",
    "MeshCheckpoint",
    "MeshCheckpointStore",
    "register_recovery_metrics",
    "RECORDER",
    "StageOutputRecorder",
    "fragment_recordable",
    "fragment_spool_key",
    "harvest_recorded_stages",
    "record_committed_stage",
    "substitute_spooled_fragments",
]
