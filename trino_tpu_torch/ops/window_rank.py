"""Windowed rank: the merge-path count step, and the join probe's bounds.

Counterpart of the TPU kernels of benchmarks/explore_kernel_costs.py
(`call(kernel)` -> `f`, bodies k0..k4) and, on the join path, of the two
packed sorts in trino_tpu/ops/join.py::sorted_run_bounds. The
hand-written CUDA kernel is ../csrc/window_rank.cu; its header says what
bounds it and what its design does about that.

Contract, over a flattened `a` and a flat `b` of one integer type (int32
or int64), with 128-element windows of `b`:

    out[i] = 128 * s_i + sum_{w < nwin} sum_{l < 128} [b[(s_i + w) * 128 + l] < a[i]]

counting only positions < len(b). With `edge` (int32 only), out[i] also
adds the int32 sum, wrapping, of b[(s_i + w) * 128] + b[(s_i + w) * 128 + 127]
over the same windows (k3's scalar reads). `out` is int32, shaped like a.

- fixed mode (`searched=False`): s_i = w0. With w0 = 0 and nwin 2 or 8
  this is k0..k4 for any b (k0, k1 and k2 compute one function; they
  differed only in how Mosaic lowered the loop).
- searched mode (`searched=True`, nwin = 1, b sorted ascending):
  s_i = max(0, #{w : b[128 w] < a[i]} - 1), which makes out[i] the exact
  lower bound #{b < a[i]}.

`rank` takes the plain version (`rank_reference`) only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises. Each launch
adds one to `rank.launches`.
"""

from __future__ import annotations

import torch

from trino_tpu_torch.ops import cuda_build

LANES = 128
THREADS = 256
BLOCKS_PER_SM = 16
_CHUNK = 1 << 16  # rows of `a` per step of the plain version
_SMEM_LIMIT = 96 * 1024

_FUNCTIONS = {"window_rank_launch": [
    cuda_build.PTR, cuda_build.I64, cuda_build.PTR, cuda_build.I64,
    cuda_build.I32, cuda_build.I32, cuda_build.I64, cuda_build.I32,
    cuda_build.I32, cuda_build.PTR, cuda_build.I32, cuda_build.I32,
    cuda_build.PTR,
]}


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 as two's-complement int32."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _window_counts(a: torch.Tensor, b: torch.Tensor, start: torch.Tensor,
                   span: int) -> torch.Tensor:
    """#{b[start_i + l] < a_i : l < span, start_i + l < len(b)} per i."""
    n_b = b.shape[0]
    out = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    if n_b == 0 or span == 0:
        return out
    lanes = torch.arange(span, device=a.device)
    for c in range(0, a.shape[0], _CHUNK):
        pos = start[c:c + _CHUNK, None] + lanes[None, :]
        vals = b[torch.clamp(pos, 0, n_b - 1)]
        hit = (vals < a[c:c + _CHUNK, None]) & (pos < n_b)
        out[c:c + _CHUNK] = hit.sum(dim=1)
    return out


def _bisect(b: torch.Tensor, a: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, stride: int) -> torch.Tensor:
    """Per i, the first k in [lo_i, hi_i) with b[k * stride] >= a_i (b
    sorted), by vectorized bisection; hi_i when there is none."""
    n = b.shape[0]
    if n == 0:
        return lo
    steps = int(torch.max(hi - lo)) if hi.numel() else 0
    for _ in range(max(steps, 1).bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        below = b[torch.clamp(mid * stride, 0, max(n - 1, 0))] < a
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


def rank_reference(a: torch.Tensor, b: torch.Tensor, searched: bool,
                   w0: int = 0, nwin: int = 1, edge: bool = False) -> torch.Tensor:
    """Plain version of the contract (see the module docstring)."""
    flat = a.reshape(-1)
    n_b = b.shape[0]
    zero = torch.zeros(flat.shape[0], dtype=torch.int64, device=a.device)
    if searched:
        # windows whose head lies below a, then the count inside window
        # s, both by bisection: for sorted b that is the count itself
        heads = _bisect(b, flat, zero, zero + -(-n_b // LANES), LANES)
        start = torch.clamp(heads - 1, min=0) * LANES
        end = torch.clamp(start + LANES, max=n_b)
        out = _bisect(b, flat, start, torch.maximum(end, start), 1)
    else:
        start = zero + w0 * LANES
        out = start + _window_counts(flat, b, start, nwin * LANES)
    if edge:
        base = w0 * LANES
        for w in range(nwin):
            for p in (base + w * LANES, base + w * LANES + LANES - 1):
                if p < n_b:
                    out = out + int(b[p])
    return wrap_i32(out).reshape(a.shape)


def launcher(a, b, searched: bool, w0: int = 0, nwin: int = 1, edge: bool = False):
    """(go, out) for CUDA tensors: `go()` launches the kernel into `out`
    (int32, shaped like a) and nothing else, so a caller can time the
    kernel apart from the wrapper's checks and allocation."""
    dev = a.device
    flat = a.reshape(-1).contiguous()
    b = b.contiguous()
    if b.device != dev:
        raise ValueError(f"rank: a on {dev}, b on {b.device}")
    n = flat.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    elem = flat.element_size()
    if nwin * LANES * elem > _SMEM_LIMIT:
        raise ValueError(f"rank: {nwin} windows exceed the shared-memory budget")
    lib = cuda_build.load("window_rank", _FUNCTIONS)
    grid = max(1, min(-(-n // THREADS), BLOCKS_PER_SM * cuda_build.sm_count(dev)))
    args = (flat.data_ptr(), n, b.data_ptr(), int(b.shape[0]), elem, int(searched),
            w0, nwin, int(edge), out.data_ptr(), grid, THREADS,
            torch.cuda.current_stream(dev).cuda_stream)

    def go(_keep=(flat, b, out)):
        cuda_build.check(lib.window_rank_launch(*args), "window_rank")

    return go, out.reshape(a.shape)


def _launch(a, b, searched: bool, w0: int, nwin: int, edge: bool) -> torch.Tensor:
    go, out = launcher(a, b, searched, w0, nwin, edge)
    if out.numel():
        go()
        rank.launches += 1
        rank.shapes.add((out.numel(), int(b.shape[0]),
                         "searched" if searched else "fixed", nwin, a.element_size()))
    return out


def rank(a: torch.Tensor, b: torch.Tensor, searched: bool, w0: int = 0,
         nwin: int = 1, edge: bool = False) -> torch.Tensor:
    """out[i] per the module contract: int32, shaped like `a`. CPU
    tensors take the plain version; CUDA tensors run the kernel."""
    if a.dtype not in (torch.int32, torch.int64) or b.dtype != a.dtype:
        raise ValueError(f"rank: a and b must share int32 or int64, got "
                         f"{a.dtype} and {b.dtype}")
    if b.dim() != 1:
        raise ValueError("rank: b must be one-dimensional")
    if searched and (nwin != 1 or w0 != 0 or edge):
        raise ValueError("rank: searched mode takes nwin=1, w0=0, no edge sum")
    if nwin < 1 or w0 < 0:
        raise ValueError("rank: nwin >= 1 and w0 >= 0")
    if edge and a.dtype != torch.int32:
        raise ValueError("rank: the edge sum is defined for int32 only")
    if a.device.type == "cpu":
        return rank_reference(a, b, searched, w0, nwin, edge)
    if a.device.type != "cuda":
        raise ValueError(f"rank: unsupported device {a.device}")
    return _launch(a, b, searched, w0, nwin, edge)


rank.launches = 0
rank.shapes = set()  # distinct (n_a, n_b, mode, nwin, element bytes) launched
