"""Windowed rank, the join probe's run bounds, and the expansion's run owners.

Counterpart of the TPU kernels of benchmarks/explore_kernel_costs.py
(`call(kernel)` -> `f`, bodies k0..k4) and, on the join path, of the
packed sorts in trino_tpu/ops/join.py::sorted_run_bounds. The
hand-written CUDA kernels are in ../csrc/window_rank.cu; its header says
what bounds each and what its design does about that.

`rank(a, b, searched, w0, nwin, edge)`, over a flattened `a` and a flat
`b` of one integer type (int32 or int64), with 128-element windows of `b`:

    out[i] = 128 * s_i + sum_{w < nwin} sum_{l < 128} [b[(s_i + w) * 128 + l] < a[i]]

counting only positions < len(b). With `edge` (int32 only), out[i] also
adds the int32 sum, wrapping, of b[(s_i + w) * 128] + b[(s_i + w) * 128 + 127]
over the same windows (k3's scalar reads). `out` is int32, shaped like a.

- fixed mode (`searched=False`): s_i = w0. With w0 = 0 and nwin 2 or 8
  this is k0..k4 for any b (k0, k1 and k2 compute one function; they
  differed only in how Mosaic lowered the loop). Bound by operations.
- searched mode (`searched=True`, nwin = 1, b sorted ascending):
  s_i = max(0, #{w : b[128 w] < a[i]} - 1), which makes out[i] the exact
  lower bound #{b < a[i]}. It is the lo half of `bounds`' kernel.

`bounds(q, b)`, b sorted ascending: (lo, hi) = (#{b < q}, #{b < q + 1}),
q + 1 wrapping in the type, in one launch: a persistent grid searches the
window heads in shared memory, then the window in L2, several queries a
thread in lockstep, and gallops from lo to hi. The join probe's
`sorted_run_bounds`. Bound by bytes (q read, lo and hi written, b read
once); the kernel pays a few random L2 sectors of b per query.

`run_owner(off, n_out)`, off int32, nondecreasing, >= 0:
out[j] = #{off <= j} for j < n_out, which is `rank` of arange(1, n_out + 1)
in searched mode. The expansion's "which probe row produced output j":
each row fills its own run of outputs, no search per output; every warp
takes an equal slice of rows and outputs together, so a skewed build key
splits over the grid. Bound by bytes (off read once, out written once).

Each wrapper takes its plain version (built on `rank_reference`) only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
Each launch adds one to the wrapper's `launches`.
"""

from __future__ import annotations

import torch

from trino_tpu_torch.ops import cuda_build

LANES = 128
THREADS = 256
BLOCKS_PER_SM = 16
_CHUNK = 1 << 16  # rows of `a` per step of the plain version
_SMEM_LIMIT = 96 * 1024

_P, _I, _L = cuda_build.PTR, cuda_build.I32, cuda_build.I64
_FUNCTIONS = {
    # a, n_a, b, n_b, elem bytes, w0, nwin, edge, out, grid, threads, stream
    "window_rank_launch": [_P, _L, _P, _L, _I, _L, _I, _I, _P, _I, _I, _P],
    # q, n, b, n_b, elem bytes, lo, hi (null: lo only), SMs, stream
    "rank_bounds_launch": [_P, _L, _P, _L, _I, _P, _P, _I, _P],
    # off, n, n_out, out, SMs, stream
    "run_owner_launch": [_P, _L, _I, _P, _I, _P],
}


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


def _lib():
    return cuda_build.load("window_rank", _FUNCTIONS)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _same_device(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device != y.device:
        raise ValueError(f"{name}: inputs on {x.device} and {y.device}")


def _route(name: str, x: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _check_sorted_pair(name: str, q: torch.Tensor, b: torch.Tensor) -> None:
    if q.dtype not in (torch.int32, torch.int64) or b.dtype != q.dtype:
        raise ValueError(f"{name}: a and b must share int32 or int64, got "
                         f"{q.dtype} and {b.dtype}")
    if b.dim() != 1:
        raise ValueError(f"{name}: b must be one-dimensional")
    _same_device(name, q, b)


# ---------------------------------------------------------------------------
# rank (fixed mode: k0..k4; searched mode: the lower bound)
# ---------------------------------------------------------------------------


def launcher(a, b, searched: bool, w0: int = 0, nwin: int = 1, edge: bool = False):
    """(go, out) for CUDA tensors: `go()` launches the kernel into `out`
    (int32, shaped like a) and nothing else, so a caller can time the
    kernel apart from the wrapper's checks and allocation."""
    dev = a.device
    flat = a.reshape(-1).contiguous()
    b = b.contiguous()
    _same_device("rank", a, b)
    n = flat.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    elem = flat.element_size()
    lib = _lib()
    if searched:
        args = (flat.data_ptr(), n, b.data_ptr(), int(b.shape[0]), elem,
                out.data_ptr(), None, cuda_build.sm_count(dev), _stream(dev))

        def go(_keep=(flat, b, out)):
            cuda_build.check(lib.rank_bounds_launch(*args), "window_rank")
    else:
        if nwin * LANES * elem > _SMEM_LIMIT:
            raise ValueError(f"rank: {nwin} windows exceed the shared-memory budget")
        grid = max(1, min(-(-n // THREADS), BLOCKS_PER_SM * cuda_build.sm_count(dev)))
        args = (flat.data_ptr(), n, b.data_ptr(), int(b.shape[0]), elem, w0, nwin,
                int(edge), out.data_ptr(), grid, THREADS, _stream(dev))

        def go(_keep=(flat, b, out)):
            cuda_build.check(lib.window_rank_launch(*args), "window_rank")

    return go, out.reshape(a.shape)


def _launch(a, b, searched: bool, w0: int, nwin: int, edge: bool) -> torch.Tensor:
    go, out = launcher(a, b, searched, w0, nwin, edge)
    if out.numel():
        go()
        cuda_build.count_launch(rank, (out.numel(), int(b.shape[0]),
                                       "searched" if searched else "fixed", nwin,
                                       a.element_size()))
    return out


def rank(a: torch.Tensor, b: torch.Tensor, searched: bool, w0: int = 0,
         nwin: int = 1, edge: bool = False) -> torch.Tensor:
    """out[i] per the module contract: int32, shaped like `a`. CPU
    tensors take the plain version; CUDA tensors run the kernel."""
    _check_sorted_pair("rank", a, b)
    if searched and (nwin != 1 or w0 != 0 or edge):
        raise ValueError("rank: searched mode takes nwin=1, w0=0, no edge sum")
    if nwin < 1 or w0 < 0:
        raise ValueError("rank: nwin >= 1 and w0 >= 0")
    if edge and a.dtype != torch.int32:
        raise ValueError("rank: the edge sum is defined for int32 only")
    if not _route("rank", a):
        return rank_reference(a, b, searched, w0, nwin, edge)
    return _launch(a, b, searched, w0, nwin, edge)


rank.launches = 0
rank.shapes = set()  # distinct (n_a, n_b, mode, nwin, element bytes) launched


# ---------------------------------------------------------------------------
# bounds: the join probe's (lo, hi) in one launch
# ---------------------------------------------------------------------------


def bounds_reference(q: torch.Tensor, b: torch.Tensor):
    """Plain version: two lower bounds."""
    return rank_reference(q, b, True), rank_reference(q + 1, b, True)


def bounds_launcher(q: torch.Tensor, b: torch.Tensor):
    """(go, (lo, hi)) for CUDA tensors: `go()` launches the kernel into
    lo and hi (int32, shaped like q) and nothing else."""
    dev = q.device
    flat, b = q.reshape(-1).contiguous(), b.contiguous()
    n = flat.shape[0]
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    hi = torch.empty(n, dtype=torch.int32, device=dev)
    args = (flat.data_ptr(), n, b.data_ptr(), int(b.shape[0]), flat.element_size(),
            lo.data_ptr(), hi.data_ptr(), cuda_build.sm_count(dev), _stream(dev))
    lib = _lib()

    def go(_keep=(flat, b, lo, hi)):
        cuda_build.check(lib.rank_bounds_launch(*args), "bounds")

    return go, (lo.reshape(q.shape), hi.reshape(q.shape))


def _launch_bounds(q: torch.Tensor, b: torch.Tensor):
    go, (lo, hi) = bounds_launcher(q, b)
    if lo.numel():
        go()
        cuda_build.count_launch(bounds, (lo.numel(), int(b.shape[0]), q.element_size()))
    return lo, hi


def bounds(q: torch.Tensor, b: torch.Tensor):
    """(lo, hi) = (#{b < q}, #{b < q + 1}) per element of q, each int32
    shaped like q; b sorted ascending, q + 1 wrapping in the type. CPU
    tensors take the plain version; CUDA tensors run the kernel."""
    _check_sorted_pair("bounds", q, b)
    if not _route("bounds", q):
        return bounds_reference(q, b)
    return _launch_bounds(q, b)


bounds.launches = 0
bounds.shapes = set()  # distinct (queries, n_b, element bytes) launched


# ---------------------------------------------------------------------------
# run_owner: which probe row produced output j
# ---------------------------------------------------------------------------


def run_owner_reference(off: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version: the lower bound of j + 1 among the offsets."""
    j = torch.arange(1, n_out + 1, dtype=torch.int32, device=off.device)
    return rank_reference(j, off, True)


def run_owner_launcher(off: torch.Tensor, n_out: int):
    """(go, out) for CUDA tensors: `go()` launches the kernel into `out`
    ((n_out,) int32) and nothing else."""
    dev = off.device
    off = off.contiguous()
    n = int(off.shape[0])
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    args = (off.data_ptr(), n, n_out, out.data_ptr(), cuda_build.sm_count(dev), _stream(dev))
    lib = _lib()

    def go(_keep=(off, out)):
        cuda_build.check(lib.run_owner_launch(*args), "run_owner")

    return go, out


def _launch_run_owner(off: torch.Tensor, n_out: int) -> torch.Tensor:
    go, out = run_owner_launcher(off, n_out)
    if out.numel():
        go()
        cuda_build.count_launch(run_owner, (n_out, int(off.shape[0])))
    return out


def run_owner(off: torch.Tensor, n_out: int) -> torch.Tensor:
    """out[j] = #{off <= j} for j < n_out, int32 (n_out,): for the
    inclusive cumulative sum `off` of nonnegative int32 counts, the row
    whose run holds output j (len(off) past the total). CPU tensors take
    the plain version; CUDA tensors run the kernel."""
    if off.dtype != torch.int32 or off.dim() != 1:
        raise ValueError(f"run_owner: off must be 1-D int32, got {off.dtype}, "
                         f"{off.dim()}-D")
    if not 0 <= n_out < (1 << 31):
        raise ValueError(f"run_owner: n_out {n_out} outside [0, 2^31)")
    if not _route("run_owner", off):
        return run_owner_reference(off, n_out)
    return _launch_run_owner(off, n_out)


run_owner.launches = 0
run_owner.shapes = set()  # distinct (n_out, len(off)) launched
