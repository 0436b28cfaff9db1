"""Hash partitioning of batches into wire pages.

Counterpart of the partitioning core of trino_tpu/exec/exchange_ops.py
(PagePartitioner): `_partition_ids` computes each row's destination on
the batch's device, `split_page` splits a compacted host page by those
ids in one native scatter pass, and `hash_split_batch` chains the two.
The grace hash join (exec/spill.py) routes both join sides through it,
and the distributed exchange will (ROADMAP §1 item 11), so equal keys
always land in the same partition. `SkewedPartitionRebalancer` is the
least-loaded routing of "arbitrary" partitions. The exchange's
PartitionedOutputOperator and RemoteSourceOperator are item 11.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import RelBatch
from trino_tpu_torch.exec.serde import HostNested, Page, slice_host_nested, to_host
from trino_tpu_torch.ops import tz
from trino_tpu_torch.ops.hashing import canonical_hash_input, hash32, partition_of


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
