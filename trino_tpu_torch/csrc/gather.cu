// Gathers: flat take, 128-wide row-gather-sum, and take-along-lanes.
//
// Replaces the three TPU kernels of benchmarks/explore_pallas_gather.py
// (in-kernel gather formulations for the bucket-hash probe):
//
//   take_flat          <- v1 (k1) "pallas_take_flat":
//                         out[i] = table[clip(idx[i], 0, n_table - 1)]
//                         for 4- and 8-byte elements, int32 or int64 idx.
//                         The join's index gathers (the build permutation
//                         at the matched sorted positions, and the packed
//                         lo|start words in expand_matches) run on it.
//   take_rows_sum      <- v2 (k2) "pallas_take_rows128":
//                         out[i] = sum_l table[clip(ridx[i]), l], an int32
//                         sum that wraps, over rows of `width` lanes.
//   take_along_lanes   <- v3 (k3) "pallas_take_along_lanes":
//                         out[r, l] = src[r, clip(sel[r, l], 0, width - 1)].
//
// What bounds them: bytes. take_flat reads each index and each gathered
// element once and writes each output once (the table is read at random,
// so a table that fits the 50 MB L2 is read from device memory about
// once); it is a grid-stride loop of read-only loads. The TPU versions
// held the whole table in VMEM; Hopper's shared memory is too small for
// that, so the flat and row gathers go through L2.
//
// take_rows_sum: a row's sum does not depend on which output asks for it,
// and int32 addition mod 2^32 is associative, so the least work reads
// each needed row once: bytes n x (index + 4) + min(rows, n) x width x 4.
// The launcher picks one of two paths by shape:
//   - rows <= n ("row sums"): every row is summed once, one warp a row
//     with coalesced (16-byte where aligned) loads and a shuffle
//     reduction, into a scratch array of rows int32 sums; then a second
//     kernel gathers those sums by clipped index. Two launches, because
//     every output may need any row's sum and blocks of one grid cannot
//     wait on each other; the sums (4 bytes a row) stay in L2 for the
//     gather. The gather is a programmatic dependent launch (Hopper): its
//     blocks start while the row sums run, load their indices, and wait
//     (griddepcontrol.wait) only before reading the sums, so the second
//     launch's start and its index reads overlap the first kernel.
//   - rows > n ("per output"): summing every row would read rows the
//     function never needs, so each output reads its own row: one warp an
//     output, the row from L2 with coalesced loads, reduced by shuffles.
// The first design took the per-output path at every shape: at the
// explorer's shape (1 M outputs over 1,024 rows of 128) it read 512 MB
// from L2 where the function needs 8.9 MB. There the two launches and the
// 8 MB of indices and outputs now pace it.
//
// take_along_lanes reads src and sel once and writes out once. At width 128
// (the TPU kernel's lane count) a row is 512 bytes, one 16-byte vector per
// lane of a warp: each warp takes whole rows in a grid-stride loop, every
// lane loads its vector of src and of sel into registers, and each output
// takes lane s >> 2, component s & 3 of the row by shuffles, so the random
// part of the access never leaves the warp's registers (no shared memory,
// no barrier, and the row loop keeps loads in flight). Other widths, and
// pointers not 16-byte aligned, take a direct path: coalesced sel reads and
// out writes, src read through L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, typename I>
__global__ void take_flat_kernel(const T* __restrict__ table, long long n_table,
                                 const I* __restrict__ idx, long long n,
                                 T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long j = (long long)__ldg(&idx[i]);
    j = j < 0 ? 0 : (j >= n_table ? n_table - 1 : j);
    out[i] = __ldg(&table[j]);
  }
}

template <typename I>
__global__ void take_rows_sum_kernel(const int32_t* __restrict__ table,
                                     long long n_rows, int width,
                                     const I* __restrict__ ridx, long long n,
                                     int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long i = warp; i < n; i += n_warps) {
    long long r = (long long)__ldg(&ridx[i]);
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const int32_t* row = table + r * width;
    unsigned int s = 0u;
    for (int l = lane; l < width; l += 32) s += (unsigned int)__ldg(&row[l]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[i] = (int32_t)s;
  }
}

// sum of each row, one warp a row; 16-byte loads where the rows allow
__global__ void row_sums_kernel(const int32_t* __restrict__ table, long long n_rows,
                                int width, bool vec4, int32_t* __restrict__ sums) {
  // let the dependent gather start now; it waits for this grid's sums
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = warp; r < n_rows; r += n_warps) {
    const int32_t* row = table + r * width;
    unsigned int s = 0u;
    if (vec4) {
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      for (int l = lane; l < width / 4; l += 32) {
        const uint4 q = __ldg(&row4[l]);
        s += q.x + q.y + q.z + q.w;
      }
    } else {
      for (int l = lane; l < width; l += 32) s += (unsigned int)__ldg(&row[l]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) sums[r] = (int32_t)s;
  }
}

// out[i] = sums[clip(ridx[i])], launched as a programmatic dependent of
// row_sums_kernel: each thread loads its first GATHER_AHEAD indices, which
// do not depend on the sums, then waits for the row sums to be complete
// and visible (griddepcontrol.wait) before it reads them.
constexpr int GATHER_AHEAD = 4;

template <typename I>
__global__ void gather_sums_kernel(const int32_t* __restrict__ sums, long long n_rows,
                                   const I* __restrict__ ridx, long long n,
                                   int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long r[GATHER_AHEAD];
#pragma unroll
  for (int j = 0; j < GATHER_AHEAD; ++j) {
    const long long i = i0 + j * stride;
    r[j] = i < n ? (long long)__ldg(&ridx[i]) : 0;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
  for (int j = 0; j < GATHER_AHEAD; ++j) {
    const long long i = i0 + j * stride;
    if (i < n) out[i] = sums[r[j] < 0 ? 0 : (r[j] >= n_rows ? n_rows - 1 : r[j])];
  }
  for (long long i = i0 + GATHER_AHEAD * stride; i < n; i += stride) {
    const long long j = (long long)__ldg(&ridx[i]);
    out[i] = sums[j < 0 ? 0 : (j >= n_rows ? n_rows - 1 : j)];
  }
}

template <typename I>
cudaError_t launch_gather_sums(const int32_t* sums, long long n_rows, const void* ridx,
                               long long n, int32_t* out, int threads, cudaStream_t s) {
  long long grid = (n + (long long)threads * GATHER_AHEAD - 1) / ((long long)threads * GATHER_AHEAD);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(grid < 1 ? 1 : grid));
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gather_sums_kernel<I>, sums, n_rows, (const I*)ridx, n, out);
}

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clip_lane(int s, int width) {
  return s < 0 ? 0 : (s >= width ? width - 1 : s);
}

// element s of the warp's 128-lane row, each lane holding four in v
__device__ __forceinline__ uint32_t lane_pick(const uint4& v, int s) {
  const int from = s >> 2;
  const uint32_t x = __shfl_sync(FULL, v.x, from);
  const uint32_t y = __shfl_sync(FULL, v.y, from);
  const uint32_t z = __shfl_sync(FULL, v.z, from);
  const uint32_t w = __shfl_sync(FULL, v.w, from);
  const int c = s & 3;
  return c == 0 ? x : (c == 1 ? y : (c == 2 ? z : w));
}

__global__ void take_along_lanes128_kernel(const uint4* __restrict__ src,
                                           const int4* __restrict__ sel,
                                           long long rows,
                                           uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = warp; r < rows; r += n_warps) {
    const long long at = r * 32 + lane;
    const uint4 v = __ldg(&src[at]);
    const int4 s = __ldg(&sel[at]);
    uint4 o;
    o.x = lane_pick(v, clip_lane(s.x, 128));
    o.y = lane_pick(v, clip_lane(s.y, 128));
    o.z = lane_pick(v, clip_lane(s.z, 128));
    o.w = lane_pick(v, clip_lane(s.w, 128));
    out[at] = o;
  }
}

__global__ void take_along_lanes_kernel(const uint32_t* __restrict__ src,
                                        const int32_t* __restrict__ sel,
                                        long long rows, int width,
                                        uint32_t* __restrict__ out) {
  const long long n = rows * width;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long row_start = i - i % width;
    out[i] = __ldg(&src[row_start + clip_lane(__ldg(&sel[i]), width)]);
  }
}

template <typename T>
int flat_for_index(const void* table, long long n_table, const void* idx,
                   int idx_bytes, long long n, void* out, int grid,
                   int threads, cudaStream_t s) {
  if (idx_bytes == 4)
    take_flat_kernel<T, int32_t><<<grid, threads, 0, s>>>(
        (const T*)table, n_table, (const int32_t*)idx, n, (T*)out);
  else if (idx_bytes == 8)
    take_flat_kernel<T, long long><<<grid, threads, 0, s>>>(
        (const T*)table, n_table, (const long long*)idx, n, (T*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int take_flat_launch(const void* table, long long n_table,
                                int elem_bytes, const void* idx, int idx_bytes,
                                long long n, void* out, int grid, int threads,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return flat_for_index<uint32_t>(table, n_table, idx, idx_bytes, n, out,
                                    grid, threads, s);
  if (elem_bytes == 8)
    return flat_for_index<unsigned long long>(table, n_table, idx, idx_bytes,
                                              n, out, grid, threads, s);
  return (int)cudaErrorInvalidValue;
}

// sums == nullptr: one warp per output (grid blocks); else the row sums
// into `sums` (n_rows int32, grid_rows blocks), then the gather of them,
// launched as a programmatic dependent of the row sums. Returns a
// cudaError_t.
extern "C" int take_rows_sum_launch(const void* table, long long n_rows,
                                    int width, const void* ridx, int idx_bytes,
                                    long long n, void* out, void* sums,
                                    int grid_rows, int grid, int threads,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes != 4 && idx_bytes != 8) return (int)cudaErrorInvalidValue;
  if (sums) {
    const bool vec4 = width % 4 == 0 && ((uintptr_t)table & 15) == 0;
    row_sums_kernel<<<grid_rows, threads, 0, s>>>((const int32_t*)table, n_rows,
                                                  width, vec4, (int32_t*)sums);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)(idx_bytes == 4
                     ? launch_gather_sums<int32_t>((const int32_t*)sums, n_rows, ridx, n,
                                                   (int32_t*)out, threads, s)
                     : launch_gather_sums<long long>((const int32_t*)sums, n_rows, ridx,
                                                     n, (int32_t*)out, threads, s));
  }
  if (idx_bytes == 4)
    take_rows_sum_kernel<int32_t><<<grid, threads, 0, s>>>(
        (const int32_t*)table, n_rows, width, (const int32_t*)ridx, n,
        (int32_t*)out);
  else
    take_rows_sum_kernel<long long><<<grid, threads, 0, s>>>(
        (const int32_t*)table, n_rows, width, (const long long*)ridx, n,
        (int32_t*)out);
  return (int)cudaGetLastError();
}

// max_blocks caps the grid; the kernel is picked here from the width and
// the pointers' alignment. Returns a cudaError_t.
extern "C" int take_along_lanes_launch(const void* src, const void* sel,
                                       long long rows, int width, void* out,
                                       int max_blocks, int threads,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned =
      (((uintptr_t)src | (uintptr_t)sel | (uintptr_t)out) & 15) == 0;
  const bool vector = width == 128 && aligned;
  const long long work = vector ? rows * 32 : rows * (long long)width;
  long long grid = (work + threads - 1) / threads;
  grid = grid > max_blocks ? max_blocks : (grid < 1 ? 1 : grid);
  if (vector)
    take_along_lanes128_kernel<<<(int)grid, threads, 0, s>>>(
        (const uint4*)src, (const int4*)sel, rows, (uint4*)out);
  else
    take_along_lanes_kernel<<<(int)grid, threads, 0, s>>>(
        (const uint32_t*)src, (const int32_t*)sel, rows, width, (uint32_t*)out);
  return (int)cudaGetLastError();
}
