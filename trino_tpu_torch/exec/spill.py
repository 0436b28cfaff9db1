"""Spill to disk: out-of-core state for aggregation, sort and join.

Counterpart of trino_tpu/exec/spill.py (FileSingleStreamSpiller and
GenericPartitioningSpiller). The wire serde (exec/serde.py) is the spill
format, so spilled state is exactly what an exchange would ship: an
aggregation's spilled partial states merge back through the final-step
ingestion. Files go to `spill_dir` (the query's temporary directory,
which the engine removes when the query ends, also when it fails) or the
process's temporary directory; `close` deletes a spiller's file.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Iterator, List, Optional

import torch

from trino_tpu_torch.block import RelBatch
from trino_tpu_torch.exec.serde import Page, deserialize_page, serialize_batch, serialize_page
from trino_tpu_torch.analysis.witness import named_lock


_stats_lock = named_lock("spill._stats_lock")
# process-wide spill counters: bytes written, files that received data,
# grace partitions joined (exec/operators.LookupJoinOperator)
_STATS: Dict[str, int] = {"spilled_bytes": 0, "spill_files": 0, "grace_partitions": 0}


def record(name: str, n: int = 1) -> None:
    with _stats_lock:
        _STATS[name] += n


def stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(_STATS)


def reset_stats() -> None:
    with _stats_lock:
        for k in _STATS:
            _STATS[k] = 0


class FileSpiller:
    """Append-only single-stream spiller. `unspill` puts each batch back
    on the device it was spilled from."""

    def __init__(self, spill_dir: Optional[str] = None):
        self._dir = spill_dir or tempfile.gettempdir()
        os.makedirs(self._dir, exist_ok=True)
        fd, self._path = tempfile.mkstemp(
            prefix="trino-tpu-torch-spill-", suffix=".pages", dir=self._dir
        )
        self._file = os.fdopen(fd, "wb+")
        # (offset, length, capacity or None, device or None)
        self._offsets: List[tuple] = []
        self.spilled_bytes = 0

    def spill(self, batch: RelBatch) -> None:
        # the source capacity and device come back with the batch
        self._append(serialize_batch(batch), batch.capacity, batch.device)

    def spill_page(self, page: Page, capacity: Optional[int] = None) -> None:
        self._append(serialize_page(page), capacity, None)

    def _append(self, data: bytes, capacity: Optional[int], device) -> None:
        off = self._file.tell()
        self._file.write(data)
        if not self._offsets:
            record("spill_files")
        self._offsets.append((off, len(data), capacity, device))
        self.spilled_bytes += len(data)
        record("spilled_bytes", len(data))

    @property
    def batch_count(self) -> int:
        return len(self._offsets)

    def unspill(self, device=None) -> Iterator[RelBatch]:
        """Read batches back at their spill-time capacity, on their
        spill-time device (or `device` for pages spilled as pages)."""
        self._file.flush()
        for off, ln, cap, dev in self._offsets:
            self._file.seek(off)
            page = deserialize_page(self._file.read(ln))
            yield page.to_batch(capacity=cap, device=dev if dev is not None else device)

    def unspill_pages(self) -> Iterator[Page]:
        self._file.flush()
        for off, ln, _cap, _dev in self._offsets:
            self._file.seek(off)
            yield deserialize_page(self._file.read(ln))

    def close(self) -> None:
        try:
            self._file.close()
        finally:
            try:
                os.unlink(self._path)
            except OSError:
                pass


class GracePartitionSpill:
    """Hash-partitioned spill of one join side
    (PartitionedLookupSourceFactory): rows route to one of N partition
    files by canonical key hash (the exchange's routing, so build and
    probe sides agree), and the join later builds and probes one
    partition at a time. `device` is where the added batches lived."""

    def __init__(self, n_partitions: int, key_channels,
                 spill_dir: Optional[str] = None):
        self.n = n_partitions
        self.key_channels = list(key_channels)
        self._spillers = [
            FileSpiller(spill_dir) for _ in range(n_partitions)
        ]
        self._lut_cache: dict = {}
        self.spilled_bytes = 0
        self.device: Optional[torch.device] = None
        # over every partition: the rows added, and whether a key was NULL
        # (an IN's three-valued result reads the whole side)
        self.rows = 0
        self.null_keys = False

    def add(self, batch: RelBatch) -> None:
        from trino_tpu_torch.exec.exchange_ops import hash_split_batch

        if self.device is None:
            self.device = batch.device
        pages = hash_split_batch(
            batch, self.key_channels, self.n, self._lut_cache
        )
        for p, page in enumerate(pages):
            if page.row_count:
                self._spillers[p].spill_page(page)
                self.rows += page.row_count
                self.null_keys = self.null_keys or any(
                    page.valids[c] is not None and not page.valids[c].all()
                    for c in self.key_channels)
        self.spilled_bytes = sum(s.spilled_bytes for s in self._spillers)

    def partition_pages(self, p: int) -> List[Page]:
        return list(self._spillers[p].unspill_pages())

    def close(self) -> None:
        for s in self._spillers:
            s.close()
