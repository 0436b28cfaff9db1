"""Spooled stage outputs: completed fragments survive a query failure.

Counterpart of trino_tpu/recovery/stage_spool.py. The pipelined page plane streams fragment outputs through pull+ack
OutputBuffers, which DROP pages below the acknowledged token — by the
time a downstream failure fires, the upstream stage's output is gone
and QUERY-level retry recomputes everything. This module tees
the output at production time instead: when the session opts in
(`recovery_spool_stages`), every non-root task's terminal
PartitionedOutputOperator writes through a `RecordingBuffer` proxy
(the _MidFailureBuffer pattern) that keeps a host-side copy of each
wire page. When the query fails and retries, the coordinator harvests
every FULLY completed fragment into the generation-guarded subtree
spool (adaptive/spool.py) and substitutes each with a
`SpooledValuesNode` fragment — partitioning flipped to "single" so one
task replays the recorded rows and its PartitionedOutputOperator
re-partitions them for the consumers — so only the work that actually
failed is recomputed.

The FTE scheduler gets the same treatment from its durable side:
committed task attempts already persist per-partition spool files, so
`record_committed_stage` lifts a settled stage's files into the same
subtree spool, and a later attempt of the same query (QUERY retry over
FTE, or a fresh submission) substitutes it without touching the
upstream tables.

Eligibility mirrors the adaptive spool's guard rails: round-trippable
field types only, bounded by MAX_SPOOL_ROWS, no merge-ordered outputs
(a single replay task cannot reproduce per-producer sorted streams),
and generation guarding makes entries from before a DML unreachable.

Unlike the reference, no failure is swallowed: a committed stage whose
spool file does not decode (SerdeError) is declined, counted in
`recovery.stage_declined.serde`, and a stage past MAX_SPOOL_ROWS in
`recovery.stage_declined.rows`; any other error (a recorded page that
does not decode to rows, a spool file that cannot be read) propagates.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from trino_tpu_torch.adaptive.spool import (
    MAX_SPOOL_ROWS,
    SPOOL,
    _field_materializable,
    plan_fingerprint,
    spooled_node,
    subtree_tables,
)
from trino_tpu_torch.analysis.witness import named_lock


def _pages_to_rows(pages) -> List[list]:
    """Decode wire pages to python rows host-side (the coordinator's
    _page_rows rules, local copy to keep recovery import-light)."""
    import numpy as np

    from trino_tpu_torch.block import decode_values
    from trino_tpu_torch.exec.serde import HostNested

    rows: List[list] = []
    for page in pages:
        cols = []
        for t, data, valid, dvals in zip(
            page.types, page.columns, page.valids, page.dictionaries
        ):
            if isinstance(data, HostNested):
                cols.append(data.to_pylist())
                continue
            ok = (
                valid
                if valid is not None
                else np.ones(len(data), dtype=bool)
            )
            cols.append(decode_values(t, data, ok, dvals))
        rows.extend(list(r) for r in zip(*cols))
    return rows


def fragment_spool_key(fragment) -> str:
    """Spool key for one fragment's complete output. Fingerprints the
    FRAGMENT root (RemoteSourceNodes and partial-agg shapes included),
    not the logical plan: two fragments are interchangeable exactly
    when their physical trees match."""
    return "frag:" + plan_fingerprint(fragment.root)


def subplan_tables(sp) -> Tuple[Tuple[str, str, str], ...]:
    """Generation-guard domain of a fragment's output: every table read
    by the fragment OR any producer below it (a stale upstream table
    makes the recorded output stale even though this fragment's own
    scans are elsewhere)."""
    out = set()
    for s in _walk(sp):
        out.update(subtree_tables(s.fragment.root))
    return tuple(sorted(out))


def _walk(sp):
    yield sp
    for c in sp.children:
        yield from _walk(c)


def fragment_recordable(sp, is_root: bool) -> bool:
    """Whether a fragment's output may be recorded for replay. The root
    fragment is excluded (its consumer is the client: if it finished,
    the query succeeded); merge-ordered outputs are excluded (one
    replay task cannot reproduce N per-producer sorted streams); every
    output field must round-trip through python rows."""
    f = sp.fragment
    if is_root or f.output_merge_keys:
        return False
    return all(_field_materializable(fl.type) for fl in f.root.fields)


class RecordingBuffer:
    """Sink-buffer proxy that tees each produced wire page into the
    recorder while passing everything through (the _MidFailureBuffer
    shape). Completion is only signalled on a clean set_no_more_pages —
    a task that dies mid-stream leaves its recording incomplete and the
    fragment stays ineligible."""

    def __init__(self, inner, recorder, key, task_key):
        self._inner = inner
        self._recorder = recorder
        self._key = key
        self._task_key = task_key

    def enqueue(self, partition, page):
        self._inner.enqueue(partition, page)
        self._recorder.add_page(self._key, self._task_key, page)

    def set_no_more_pages(self):
        self._inner.set_no_more_pages()
        self._recorder.task_done(self._key, self._task_key)


class _FragmentRecording:
    __slots__ = ("expected_tasks", "pages", "done_tasks", "rows",
                 "overflowed")

    def __init__(self, expected_tasks: int):
        self.expected_tasks = expected_tasks
        self.pages: List[object] = []
        self.done_tasks: set = set()
        self.rows = 0
        self.overflowed = False

    def complete(self) -> bool:
        return (
            not self.overflowed
            and len(self.done_tasks) >= self.expected_tasks
        )


class StageOutputRecorder:
    """Process-wide registry of in-flight fragment-output recordings,
    keyed (query_id, fragment_id) per attempt namespace. The scheduler
    declares expected task counts up front; RecordingBuffers feed pages
    in; the coordinator harvests complete fragments into the subtree
    spool on retry and purges the query's recordings at finalize."""

    def __init__(self):
        self._lock = named_lock("StageOutputRecorder._lock")
        self._recs: Dict[Tuple[str, int], _FragmentRecording] = {}

    def expect(self, query_id: str, fragment_id: int, n_tasks: int) -> None:
        with self._lock:
            self._recs[(query_id, fragment_id)] = _FragmentRecording(n_tasks)

    def add_page(self, key, task_key, page) -> None:
        with self._lock:
            rec = self._recs.get(key)
            if rec is None or rec.overflowed:
                return
            rec.rows += int(page.row_count)
            if rec.rows > MAX_SPOOL_ROWS:
                # unbounded stage: recording it would trade a retry for
                # an equally unbounded host copy — drop, keep the flag
                rec.overflowed = True
                rec.pages = []
                return
            rec.pages.append(page)

    def task_done(self, key, task_key) -> None:
        with self._lock:
            rec = self._recs.get(key)
            if rec is not None:
                rec.done_tasks.add(task_key)

    def recording_buffer(self, inner, query_id: str, fragment_id: int,
                         task_key: str):
        return RecordingBuffer(
            inner, self, (query_id, fragment_id), task_key
        )

    def complete_pages(self, query_id: str, fragment_id: int):
        with self._lock:
            rec = self._recs.get((query_id, fragment_id))
            if rec is None or not rec.complete():
                return None
            return list(rec.pages)

    def purge(self, query_id_prefix: str) -> None:
        """Drop every recording whose query id is the prefix or one of
        its `r<N>` retry namespaces (qN / qNr1 / ...)."""
        with self._lock:
            for qid, fid in [
                k for k in self._recs
                if k[0] == query_id_prefix
                or k[0].startswith(query_id_prefix + "r")
            ]:
                del self._recs[(qid, fid)]

    def clear(self) -> None:
        with self._lock:
            self._recs.clear()


RECORDER = StageOutputRecorder()


def _spool_rows(sp, rows) -> None:
    from trino_tpu_torch.sql.stats import PlanStats

    SPOOL.put(
        fragment_spool_key(sp.fragment),
        rows,
        sp.fragment.root.fields,
        PlanStats(float(max(len(rows), 1))),
        subplan_tables(sp),
    )


def _decline(reason: str) -> None:
    from trino_tpu_torch.runtime.metrics import METRICS

    METRICS.increment(f"recovery.stage_declined.{reason}")


def harvest_recorded_stages(query_id: str, subplan) -> int:
    """Lift every fully-recorded fragment of a failed attempt into the
    subtree spool (called by QUERY retry before replanning the next
    attempt). Returns the number of fragments banked. The recorded
    pages are host pages already decoded from the wire; an error
    turning them into rows propagates (the reference skips the
    fragment)."""
    banked = 0
    stages = list(_walk(subplan))
    root_id = subplan.fragment.id
    for sp in stages:
        if not fragment_recordable(sp, sp.fragment.id == root_id):
            continue
        pages = RECORDER.complete_pages(query_id, sp.fragment.id)
        if pages is None:
            continue
        rows = _pages_to_rows(pages)
        if len(rows) > MAX_SPOOL_ROWS:
            _decline("rows")
            continue
        _spool_rows(sp, rows)
        banked += 1
    return banked


def record_committed_stage(spool_dir: str, task_keys, sp,
                           n_out: int, is_root: bool) -> bool:
    """FTE settle hook: a stage whose every partition committed has
    durable per-partition spool files — decode them once into the
    subtree spool so the NEXT attempt of this query substitutes the
    stage instead of re-running it. `task_keys` lists the committed
    attempt task keys (spool directory names), one per task; each task
    dir holds pages for every OUTPUT partition 0..n_out-1. A spool
    file that does not decode declines the stage (SerdeError, counted);
    any other error propagates (the reference declines on any)."""
    import os

    from trino_tpu_torch.exec.serde import SerdeError
    from trino_tpu_torch.runtime.spool import read_spool

    if not fragment_recordable(sp, is_root):
        return False
    rows: List[list] = []
    try:
        for task_key in task_keys:
            task_dir = os.path.join(spool_dir, task_key)
            for p in range(n_out):
                token, done = 0, False
                while not done:
                    pages, token, done = read_spool(task_dir, p, token)
                    rows.extend(_pages_to_rows(pages))
                    if len(rows) > MAX_SPOOL_ROWS:
                        _decline("rows")
                        return False
    except SerdeError:
        _decline("serde")
        return False
    _spool_rows(sp, rows)
    return True


def substitute_spooled_fragments(subplan, span=None):
    """Rebuild a SubPlan tree with every fragment whose complete output
    sits live in the subtree spool replaced by a single-task
    SpooledValuesNode fragment (children dropped — the replay has no
    remote inputs). Outermost-first: a spooled fragment subsumes its
    producers. Returns (new_subplan, substituted_fragment_ids)."""
    import dataclasses

    from trino_tpu_torch.runtime.metrics import METRICS
    from trino_tpu_torch.sql.fragmenter import SubPlan

    from trino_tpu_torch.recovery.checkpoint import SPOOLED_STAGE_HITS

    hits: List[int] = []
    root_id = subplan.fragment.id

    def sub(sp):
        f = sp.fragment
        if fragment_recordable(sp, f.id == root_id):
            key = fragment_spool_key(f)
            entry = SPOOL.get(key, subplan_tables(sp))
            if entry is not None:
                hits.append(f.id)
                METRICS.increment(SPOOLED_STAGE_HITS)
                if span is not None:
                    span.event(
                        "spooled_stage_hit", fragment=f.id,
                        rows=len(entry.rows),
                    )
                node = spooled_node(
                    entry, key, f"recovered stage {f.id}"
                )
                return SubPlan(
                    dataclasses.replace(
                        f, root=node, partitioning="single",
                        suggested_partitions=None,
                    ),
                    [],
                )
        return SubPlan(f, [sub(c) for c in sp.children])

    return sub(subplan), hits
