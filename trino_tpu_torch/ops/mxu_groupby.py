"""Grouped int64 sums: the bounded-domain GROUP BY accumulate loop.

Counterpart of trino_tpu/ops/mxu_groupby.py. The TPU kernel there
(`grouped_sum_mxu`, Pallas body `_make_kernel`) contracts 8-bit limbs of
the values against a one-hot of the group ids on the matrix unit. On
Hopper the hand-written CUDA kernel in ../csrc/grouped_sum.cu replaces
it. It is bound by the bytes it must read (gid 4 B and live 1 B a row,
8 B a value column for each used row). Each block keeps a shared-memory
accumulator per (column, slot) and sorts each tile of `TILE_ROWS` rows
by slot (a counting sort: one 32-bit shared atomic per used row gives
its rank), so each slot's run in the tile is added once per column
rather than each (row, column) with a 64-bit shared atomic, the first
design, whose count of atomics held it at three times its bound. The
source's header says how the runs are reduced.

Contract (identical to the reference): per-group int64 sums of each
value column, with the live-row count appended last; gid in
[0, capacity) for live rows; dead rows, and rows whose gid falls
outside [0, capacity), drop out; sums wrap mod 2^64.

`grouped_sum` takes the plain version (`grouped_sum_reference`, one
`index_add_` per column) only for tensors on the CPU. For CUDA tensors
it launches the kernel or raises. Each kernel launch adds one to
`grouped_sum.launches`.
"""

from __future__ import annotations

from typing import List

import torch

from trino_tpu_torch.ops import cuda_build

# routing limits kept from the reference, so the engine takes this band
# for exactly the same queries
ROW_TILE = 256
MAX_CAPACITY = 2048
MAX_ROWS = ROW_TILE << 15

# shared accumulator budget per block: with the sorted tile beside it,
# two blocks fit an SM; wider shapes split their columns over gridDim.y
SMEM_BUDGET = 64 * 1024
# rows a block sorts at a time (the kernel's TILE: 512 threads x 8 rows)
TILE_ROWS = 4096


def _load():
    return cuda_build.load("grouped_sum", {"grouped_sum_launch": [
        cuda_build.PTR, cuda_build.PTR, cuda_build.PTR, cuda_build.I64,
        cuda_build.I32, cuda_build.I32, cuda_build.PTR, cuda_build.I32,
        cuda_build.I32, cuda_build.PTR,
    ]})


def grouped_sum_reference(gid, values, live, capacity: int) -> List[torch.Tensor]:
    """Plain version: one index_add_ per column into capacity+1 slots
    (the last slot takes dead and out-of-range rows)."""
    n = gid.shape[0]
    g = gid.to(torch.int64)
    idx = torch.where(live & (g >= 0) & (g < capacity), g, capacity)
    outs = []
    ones = torch.ones(n, dtype=torch.int64, device=gid.device)
    for v in list(values.unbind(0)) + [ones]:
        z = torch.zeros(capacity + 1, dtype=torch.int64, device=gid.device)
        outs.append(z.index_add_(0, idx, v)[:capacity])
    return outs


def columns_per_block(n_cols: int, capacity: int) -> int:
    """Columns whose (column, slot) accumulators fit one block's budget."""
    return max(1, min(n_cols, SMEM_BUDGET // (capacity * 8)))


def _launch(gid, values, live, capacity: int) -> List[torch.Tensor]:
    lib = _load()
    n = int(gid.shape[0])
    k = int(values.shape[0])
    dev = gid.device
    gid = gid.to(torch.int32).contiguous()
    live_u8 = live.contiguous().view(torch.uint8)
    for name, t in (("gid", gid), ("live", live_u8), ("values", values)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"grouped_sum: {name} must be contiguous on {dev}")
    if live_u8.shape[0] != n:
        raise ValueError("grouped_sum: gid and live differ in length")
    out = torch.zeros((k + 1, capacity), dtype=torch.int64, device=dev)
    if n == 0:
        return list(out.unbind(0))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.grouped_sum_launch(
        gid.data_ptr(), live_u8.data_ptr(), values.data_ptr(), n, k, capacity,
        out.data_ptr(), columns_per_block(k + 1, capacity), cuda_build.sm_count(dev),
        stream,
    )
    cuda_build.check(err, "grouped_sum")
    cuda_build.count_launch(grouped_sum, (n, k, capacity))
    return list(out.unbind(0))


def grouped_sum(
    gid: torch.Tensor,
    values: torch.Tensor,
    live: torch.Tensor,
    capacity: int,
) -> List[torch.Tensor]:
    """Per-group int64 sums of each row of `values`, a (k, n) int64
    tensor, with the live-row count appended last. CPU tensors take the
    plain version; CUDA tensors run the hand-written kernel."""
    if not 0 < capacity <= MAX_CAPACITY:
        raise ValueError(f"capacity {capacity} outside [1, {MAX_CAPACITY}]")
    if live.dtype != torch.bool:
        raise ValueError(f"grouped_sum: live must be bool, got {live.dtype}")
    if (not isinstance(values, torch.Tensor) or values.dtype != torch.int64
            or values.dim() != 2):
        raise ValueError("grouped_sum: values must be a (k, n) int64 tensor")
    if values.shape[1] != gid.shape[0]:
        raise ValueError("grouped_sum: gid and values differ in length")
    if gid.device.type == "cpu":
        return grouped_sum_reference(gid, values, live, capacity)
    if gid.device.type != "cuda":
        raise ValueError(f"grouped_sum: unsupported device {gid.device}")
    return _launch(gid, values, live, capacity)


grouped_sum.launches = 0
grouped_sum.shapes = set()  # distinct (rows, value columns, capacity) launched

# the reference's names, for readers moving between the two packages
grouped_sum_mxu = grouped_sum
