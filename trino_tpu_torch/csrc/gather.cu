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
// once); it is a grid-stride loop of read-only loads. take_rows_sum reads
// one index and one 128-lane row per output: one warp per output row reads
// the row with coalesced loads and reduces it with shuffles; counted once
// per distinct row its bytes are tiny and it is bound by its adds (127 per
// output). The TPU versions held the whole table in VMEM; Hopper's shared
// memory is too small for that, so the flat and row gathers go through L2.
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

extern "C" int take_rows_sum_launch(const void* table, long long n_rows,
                                    int width, const void* ridx, int idx_bytes,
                                    long long n, void* out, int grid,
                                    int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 4)
    take_rows_sum_kernel<int32_t><<<grid, threads, 0, s>>>(
        (const int32_t*)table, n_rows, width, (const int32_t*)ridx, n,
        (int32_t*)out);
  else if (idx_bytes == 8)
    take_rows_sum_kernel<long long><<<grid, threads, 0, s>>>(
        (const int32_t*)table, n_rows, width, (const long long*)ridx, n,
        (int32_t*)out);
  else
    return (int)cudaErrorInvalidValue;
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
