"""Gathers: flat take, 128-wide row-gather-sum and take-along-lanes.

Counterparts of the three TPU kernels of benchmarks/explore_pallas_gather.py
(in-kernel gather formulations for the bucket-hash probe); the
hand-written CUDA kernels are in ../csrc/gather.cu, whose header says
what bounds each and what its design does about that.

- `take_flat(table, idx)` <- v1 (k1): out = table[clip(idx, 0, len-1)]
  for 4- and 8-byte elements and int32/int64 indices. The join path runs
  its index gathers through it on the card (ops/join.py and the
  fanout-1 expansion in exec/operators.py). Bound by bytes: indices and
  outputs once, and the table sectors the indices touch. Each thread
  issues `flat_ilp` gathers (four, or one for a call too short to fill
  the SMs) 32 outputs apart before it stores, so that a warp's every
  instruction covers 32 consecutive positions, with indices and outputs
  streamed past L2 and the grid from the occupancy API.
- `take_rows_sum(table2d, ridx)` <- v2 (k2): out[i] = sum over the lanes
  of row clip(ridx[i]) of an int32 table, wrapping mod 2^32. Bound by
  bytes: each index read and each output written once, and each row the
  outputs need read once. `rows_sum_path` picks by shape: with no more
  rows than indices every row is summed once into a scratch array and
  the sums gathered (two launches, "row_sums"); with more rows than
  indices each output sums its own row ("per_output"), so no row is read
  that no output needs. The first design read one row per output at
  every shape, 512 MB from L2 at the explorer's shape.
- `take_along_lanes(src, sel)` <- v3 (k3): out[r, l] = src[r, clip(sel[r, l])]
  for a 2-D table of 4-byte elements and int32 selectors. Bound by bytes
  (src and sel read once, out written once). At width 128 a warp holds a
  row in registers, 16 bytes a lane, and picks each output by shuffles;
  other widths read src through L1 with coalesced sel reads and out
  writes.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises. Each launch adds one to
the wrapper's `launches`.
"""

from __future__ import annotations

import torch

from trino_tpu_torch.ops import cuda_build
from trino_tpu_torch.ops.gather import take_clip
from trino_tpu_torch.ops.window_rank import wrap_i32

THREADS = 256
BLOCKS_PER_SM = 16

_P, _I, _L = cuda_build.PTR, cuda_build.I32, cuda_build.I64
_FUNCTIONS = {
    "take_flat_launch": [_P, _L, _I, _P, _I, _L, _I, _P, _I, _P],
    "take_rows_sum_launch": [_P, _L, _I, _P, _I, _L, _P, _P, _I, _I, _I, _P],
    "take_along_lanes_launch": [_P, _P, _L, _I, _P, _I, _I, _P],
}
_INDEX_TYPES = (torch.int32, torch.int64)


def _lib():
    return cuda_build.load("gather", _FUNCTIONS)


def _grid(n: int, dev, per_block: int = THREADS) -> int:
    return max(1, min(-(-n // per_block), BLOCKS_PER_SM * cuda_build.sm_count(dev)))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _route(name: str, *tensors) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


# ---------------------------------------------------------------------------
# flat take (v1)
# ---------------------------------------------------------------------------


def take_flat_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return take_clip(table, idx)


def take_flat(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[clip(idx, 0, len(table) - 1)], shaped like idx."""
    if table.dim() != 1 or table.element_size() not in (4, 8):
        raise ValueError("take_flat: table must be 1-D with 4- or 8-byte elements")
    if idx.dtype not in _INDEX_TYPES:
        raise ValueError(f"take_flat: int32 or int64 indices, got {idx.dtype}")
    if table.shape[0] == 0 and idx.numel():
        raise ValueError("take_flat: gather from an empty table")
    if not _route("take_flat", table, idx):
        return take_flat_reference(table, idx)
    return _launch_flat(table, idx)


# a block of take_flat's kernel, and the outputs a thread gathers at once
# on a call long enough (FLAT_THREADS, FLAT_ILP in ../csrc/gather.cu)
FLAT_THREADS = 256
FLAT_ILP = 4


def flat_ilp(n: int, sms: int) -> int:
    """Outputs each thread of take_flat's kernel gathers at once: FLAT_ILP
    when the call gives every one of the `sms` SMs a block's chunk
    (FLAT_THREADS x FLAT_ILP outputs), else 1, so that a short call
    spreads over as many SMs as it has blocks."""
    return FLAT_ILP if n >= FLAT_THREADS * FLAT_ILP * sms else 1


def flat_launcher(table: torch.Tensor, idx: torch.Tensor):
    """(go, out) for CUDA tensors: `go()` launches the kernel into `out`
    and nothing else (the kernel timed apart from the wrapper)."""
    dev = table.device
    table, flat = table.contiguous(), idx.reshape(-1).contiguous()
    n, sms = flat.shape[0], cuda_build.sm_count(dev)
    out = torch.empty(n, dtype=table.dtype, device=dev)
    args = (table.data_ptr(), int(table.shape[0]), table.element_size(),
            flat.data_ptr(), flat.element_size(), n, flat_ilp(n, sms), out.data_ptr(),
            sms, _stream(dev))
    lib = _lib()

    def go(_keep=(table, flat, out)):
        cuda_build.check(lib.take_flat_launch(*args), "take_flat")

    return go, out.reshape(idx.shape)


def _launch_flat(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    go, out = flat_launcher(table, idx)
    if out.numel():
        go()
        cuda_build.count_launch(take_flat, (
            int(table.shape[0]), out.numel(), table.element_size(), idx.element_size(),
            flat_ilp(out.numel(), cuda_build.sm_count(table.device))))
    return out


take_flat.launches = 0
# distinct (table length, indices, elem bytes, idx bytes, flat_ilp)
take_flat.shapes = set()


# ---------------------------------------------------------------------------
# row-gather-sum (v2)
# ---------------------------------------------------------------------------


def take_rows_sum_reference(table2d: torch.Tensor, ridx: torch.Tensor) -> torch.Tensor:
    rows = table2d.shape[0]
    pos = torch.clamp(ridx.reshape(-1).to(torch.int64), 0, max(rows - 1, 0))
    sums = table2d.to(torch.int64).sum(dim=1)  # exact; wrap once at the end
    return wrap_i32(sums.index_select(0, pos)).reshape(ridx.shape)


def take_rows_sum(table2d: torch.Tensor, ridx: torch.Tensor) -> torch.Tensor:
    """Per index, the int32 sum (wrapping) of row clip(ridx) of table2d."""
    if table2d.dim() != 2 or table2d.dtype != torch.int32:
        raise ValueError("take_rows_sum: table2d must be a 2-D int32 tensor")
    if ridx.dtype not in _INDEX_TYPES:
        raise ValueError(f"take_rows_sum: int32 or int64 indices, got {ridx.dtype}")
    if table2d.shape[0] == 0 and ridx.numel():
        raise ValueError("take_rows_sum: gather from an empty table")
    if not _route("take_rows_sum", table2d, ridx):
        return take_rows_sum_reference(table2d, ridx)
    go, out = rows_sum_launcher(table2d, ridx)
    if out.numel():
        go()
        cuda_build.count_launch(take_rows_sum, tuple(table2d.shape) + (
            out.numel(), rows_sum_path(int(table2d.shape[0]), out.numel())))
    return out


def rows_sum_path(rows: int, n: int) -> str:
    """"row_sums" (sum every row once, then gather the sums) when the
    table has no more rows than there are indices, else "per_output"
    (each output sums its own row): the path that reads fewer bytes."""
    return "row_sums" if rows <= n else "per_output"


def rows_sum_launcher(table2d: torch.Tensor, ridx: torch.Tensor):
    """(go, out): `go()` launches the row-gather-sum kernels of the path
    `rows_sum_path` picks into `out`."""
    dev = table2d.device
    table2d, flat = table2d.contiguous(), ridx.reshape(-1).contiguous()
    rows, n = int(table2d.shape[0]), flat.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if rows_sum_path(rows, n) == "row_sums":
        sums = torch.empty(rows, dtype=torch.int32, device=dev)
        # the gather sizes its own grid (four indices a thread)
        sums_ptr, grid_rows, grid = sums.data_ptr(), _grid(rows * 32, dev), 0
    else:  # one warp per output row
        sums, sums_ptr, grid_rows, grid = None, None, 0, _grid(n * 32, dev)
    args = (table2d.data_ptr(), rows, int(table2d.shape[1]), flat.data_ptr(),
            flat.element_size(), n, out.data_ptr(), sums_ptr, grid_rows, grid,
            THREADS, _stream(dev))
    lib = _lib()

    def go(_keep=(table2d, flat, out, sums)):
        cuda_build.check(lib.take_rows_sum_launch(*args), "take_rows_sum")

    return go, out.reshape(ridx.shape)


take_rows_sum.launches = 0
take_rows_sum.shapes = set()  # distinct (rows, width, indices, path)


# ---------------------------------------------------------------------------
# take-along-lanes (v3)
# ---------------------------------------------------------------------------


def take_along_lanes_reference(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    width = src.shape[1]
    s = torch.clamp(sel.to(torch.int64), 0, max(width - 1, 0))
    return torch.gather(src, 1, s)


def take_along_lanes(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """out[r, l] = src[r, clip(sel[r, l], 0, width - 1)]."""
    if src.dim() != 2 or src.element_size() != 4:
        raise ValueError("take_along_lanes: src must be 2-D with 4-byte elements")
    if sel.dtype != torch.int32 or sel.shape != src.shape:
        raise ValueError("take_along_lanes: sel must be int32 shaped like src")
    if not _route("take_along_lanes", src, sel):
        return take_along_lanes_reference(src, sel)
    go, out = along_launcher(src, sel)
    if out.numel():
        go()
        cuda_build.count_launch(take_along_lanes, tuple(src.shape))
    return out


def along_launcher(src: torch.Tensor, sel: torch.Tensor):
    """(go, out): `go()` launches the take-along-lanes kernel into `out`
    (the kernel picks its width-128 vector path or the direct one)."""
    dev = src.device
    rows, width = int(src.shape[0]), int(src.shape[1])
    src, sel = src.contiguous(), sel.contiguous()
    out = torch.empty_like(src)
    args = (src.data_ptr(), sel.data_ptr(), rows, width, out.data_ptr(),
            BLOCKS_PER_SM * cuda_build.sm_count(dev), THREADS, _stream(dev))
    lib = _lib()

    def go(_keep=(src, sel, out)):
        cuda_build.check(lib.take_along_lanes_launch(*args), "take_along_lanes")

    return go, out


take_along_lanes.launches = 0
take_along_lanes.shapes = set()  # distinct (rows, width)
