"""Exchange operators and the hash partitioning of batches into pages.

Counterpart of trino_tpu/exec/exchange_ops.py. The partitioning core
(PagePartitioner): `_partition_ids` computes each row's destination on
the batch's device, `split_page` splits a compacted host page by those
ids in one native scatter pass, and `hash_split_batch` chains the two.
The grace hash join (exec/spill.py) and the distributed exchange both
route through it, so equal keys always land in the same partition.
`SkewedPartitionRebalancer` is the least-loaded routing of "arbitrary"
partitions.

`PartitionedOutputOperator` ends every fragment pipeline of a
distributed task and `RemoteSourceOperator` starts a consumer's. Every
exchanged page goes through host memory, as in the reference: one
device-to-host copy when a batch becomes a Page, one host-to-device copy
when the consuming task's operator turns the page back into a batch on
its own device. Both copies are timed on the host clock into METRICS
(`exchange.page_out_s`: the Page.from_batch of single, broadcast and
arbitrary output and the whole hash split of hash output;
`exchange.page_in_s`: Page.to_batch).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import RelBatch
from trino_tpu_torch.exec.operators import Operator, _concat_sort
from trino_tpu_torch.exec.serde import HostNested, Page, slice_host_nested, to_host
from trino_tpu_torch.ops import tz
from trino_tpu_torch.ops.hashing import canonical_hash_input, hash32, partition_of
from trino_tpu_torch.ops.sort import SortKey
from trino_tpu_torch.runtime.metrics import METRICS


def _partition_ids(keys, valids, luts, live, n: int, has_lut) -> torch.Tensor:
    """Row -> destination partition (dead rows -> -1). Keys are
    canonicalized (widened; dictionary codes mapped to value hashes via
    `luts`) so co-partitioned fragments agree."""
    lanes = []
    li = 0
    for k, h in zip(keys, has_lut):
        if h:
            lanes.append(canonical_hash_input(k, luts[li]))
            li += 1
        else:
            lanes.append(canonical_hash_input(k))
    pid = partition_of(hash32(lanes, list(valids)), n)
    return torch.where(live, pid, torch.full_like(pid, -1))


def split_page(page: Page, pid: np.ndarray, n: int) -> List[Page]:
    """Split a compacted wire page by per-row partition id: one native
    scatter pass over all partitions. Nested columns (HostNested)
    partition by a per-partition row-index gather; their flattened
    children follow the selected rows' slices."""
    from trino_tpu_torch import native

    nested_idx = [
        i for i, c in enumerate(page.columns) if isinstance(c, HostNested)
    ]
    flat: List[np.ndarray] = []
    for i, c in enumerate(page.columns):
        if i in nested_idx:
            # placeholder keeps column positions aligned in `parts`
            flat.append(np.zeros(len(pid), dtype=np.int8))
        else:
            flat.append(c)
    for v in page.valids:
        if v is not None:
            flat.append(v)
    parts = native.partition_scatter(flat, pid, n)
    counts = np.bincount(pid[pid >= 0], minlength=n)
    nested_rows = (
        {p: np.nonzero(pid == p)[0] for p in range(n)} if nested_idx else {}
    )
    width = page.width
    out = []
    for p in range(n):
        cols = list(parts[p][:width])
        for i in nested_idx:
            cols[i] = slice_host_nested(page.columns[i], nested_rows[p])
        valids: List = []
        vi = width
        for v in page.valids:
            if v is None:
                valids.append(None)
            else:
                valids.append(parts[p][vi])
                vi += 1
        out.append(
            Page(page.types, cols, valids, page.dictionaries, int(counts[p]))
        )
    return out


def hash_split_batch(
    batch: RelBatch,
    key_channels: Sequence[int],
    n: int,
    lut_cache: Optional[dict] = None,
) -> List[Page]:
    """Split a device batch into n wire pages by canonical key hash: the
    PagePartitioner core shared by the exchange and the grace join."""
    from trino_tpu_torch.ops.hashing import dictionary_lut

    lut_cache = lut_cache if lut_cache is not None else {}
    dev = batch.device
    keys, valids, luts, has_lut = [], [], [], []
    for c in key_channels:
        col = batch.columns[c]
        lut = None
        if col.dictionary is not None and len(col.dictionary) > 0:
            ck = (col.dictionary.values, str(dev))
            lut = lut_cache.get(ck)
            if lut is None:
                lut = torch.from_numpy(
                    dictionary_lut(col.dictionary).astype(np.int64)).to(dev)
                lut_cache[ck] = lut
        if lut is not None:
            luts.append(lut)
            has_lut.append(True)
        else:
            has_lut.append(False)
        data = col.data
        if col.type.kind == T.TypeKind.TIMESTAMP_TZ:
            # equal instants in different zones must land in the same
            # partition: hash the packed millis, never the zone bits
            data = data & ~tz.ZONE_MASK
        keys.append(data)
        valids.append(col.valid_mask())
    pid = _partition_ids(keys, valids, luts, batch.live_mask(), n, has_lut)
    page = Page.from_batch(batch)
    (pid_host,) = to_host([pid])
    return split_page(page, pid_host[pid_host >= 0], n)


class SkewedPartitionRebalancer:
    """Load-balanced routing for "arbitrary" output partitions
    (SkewedPartitionRebalancer): every page goes to the partition with
    the fewest cumulative bytes, which needs no key colocation."""

    def __init__(self, n_partitions: int):
        self._bytes = [0.0] * max(n_partitions, 1)

    def pick(self, size_bytes: int) -> int:
        i = min(range(len(self._bytes)), key=lambda p: self._bytes[p])
        self._bytes[i] += max(size_bytes, 1)
        return i

    def skew(self) -> float:
        """max/mean load (1.0 = perfectly even)."""
        mean = sum(self._bytes) / len(self._bytes)
        return (max(self._bytes) / mean) if mean else 1.0


class PartitionedOutputOperator(Operator):
    """Terminal sink of every fragment pipeline: splits each output batch
    into the task's OutputBuffer partitions. kind: "single" | "hash" |
    "broadcast" | "arbitrary" (the SystemPartitioningHandle set)."""

    def __init__(
        self,
        buffer,  # runtime.buffers.OutputBuffer
        kind: str,
        hash_channels: Sequence[int] = (),
        n_partitions: int = 1,
    ):
        assert kind in ("single", "hash", "broadcast", "arbitrary"), kind
        self._buffer = buffer
        self._kind = kind
        self._hash_channels = list(hash_channels)
        self._n = n_partitions
        self._rebalancer = SkewedPartitionRebalancer(n_partitions)
        self._finishing = False
        self._lut_cache: dict = {}

    def add_input(self, batch: RelBatch) -> None:
        t0 = time.monotonic()
        if self._kind == "hash" and self._n > 1:
            parts = hash_split_batch(
                batch, self._hash_channels, self._n, self._lut_cache
            )
            METRICS.increment("exchange.page_out_s", time.monotonic() - t0)
            for p, part in enumerate(parts):
                if part.row_count:
                    METRICS.increment("rows_shuffled", part.row_count)
                    self._buffer.enqueue(p, part)
            return
        page = Page.from_batch(batch)
        METRICS.increment("exchange.page_out_s", time.monotonic() - t0)
        if page.row_count == 0:
            return
        if self._kind == "broadcast":
            # each replica crosses the wire: count the copies
            METRICS.increment("rows_shuffled", page.row_count * self._n)
            for p in range(self._n):
                self._buffer.enqueue(p, page)
        elif self._kind == "arbitrary":
            # least-loaded by bytes: uneven page sizes otherwise skew
            # downstream tasks
            METRICS.increment("rows_shuffled", page.row_count)
            self._buffer.enqueue(self._rebalancer.pick(page.size_bytes()), page)
        else:
            # single/gather (and hash collapsed to one partition) still
            # crosses the exchange: count it
            METRICS.increment("rows_shuffled", page.row_count)
            self._buffer.enqueue(0, page)

    def finish(self) -> None:
        if not self._finishing:
            self._finishing = True
            self._buffer.set_no_more_pages()

    def is_finished(self) -> bool:
        return self._finishing


class RemoteSourceOperator(Operator):
    """Source operator pulling wire pages from an exchange client onto
    `device`. With `merge_keys` it behaves like MergeOperator: waits for
    all producers, then emits one merged sorted batch.

    `ladder` (compile.shapes.CapacityLadder) snaps each page's capacity
    onto the session's ladder (base 2 is the native bucket grid, so the
    default changes nothing; a coarser ladder collapses classes)."""

    def __init__(
        self,
        source,  # poll() -> Optional[Page]; is_finished() -> bool
        merge_keys: Optional[Sequence[SortKey]] = None,
        ladder=None,
        *,
        device,
    ):
        self._ladder = ladder
        self._source = source
        self._merge_keys = tuple(merge_keys) if merge_keys else None
        self._device = torch.device(device)
        self._pending: List[RelBatch] = []
        self._done = False

    def _to_batch(self, page: Page) -> RelBatch:
        t0 = time.monotonic()
        cap = self._ladder.rung(page.row_count) if self._ladder is not None else None
        batch = page.to_batch(capacity=cap, device=self._device)
        METRICS.increment("exchange.page_in_s", time.monotonic() - t0)
        return batch

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[RelBatch]:
        if self._done:
            return None
        if self._merge_keys is not None:
            page = self._source.poll()
            while page is not None:
                if page.row_count:
                    self._pending.append(self._to_batch(page))
                page = self._source.poll()
            if not self._source.is_finished():
                return None
            self._done = True
            if not self._pending:
                return None
            out = _concat_sort(tuple(self._pending), self._merge_keys)
            self._pending = []
            return out
        page = self._source.poll()
        # skip zero-row pages inside the call: returning None for one
        # while is_blocked() reports "drained, not blocked" would let the
        # driver diagnose a stall one poll before _done could be set
        while page is not None and page.row_count == 0:
            page = self._source.poll()
        if page is None:
            if self._source.is_finished():
                self._done = True
            return None
        return self._to_batch(page)

    def is_blocked(self) -> bool:
        return not self._done and not self._source.is_finished()

    def is_finished(self) -> bool:
        # set by get_output once the source reports finished and the
        # last page has been drained (or merged and emitted)
        return self._done
