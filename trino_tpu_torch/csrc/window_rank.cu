// Windowed rank: how many elements of b lie below each element of a.
//
// Replaces the TPU kernels of benchmarks/explore_kernel_costs.py
// (`call(kernel)` -> `f`, bodies k0..k4: the in-window count step of a
// merge-path probe) and, on the join probe, the two packed sorts of
// trino_tpu/ops/join.py::sorted_run_bounds. One contract covers both:
//
//   out[i] = 128 * s_i + sum_{w < nwin} sum_{l < 128} [b[(s_i + w) * 128 + l] < a[i]]
//
// counting only positions < n_b, plus (when `edge` is set, int32 elements
// only) the int32 sum, wrapping, of b[(s_i + w) * 128] + b[(s_i + w) * 128 + 127]
// over the same windows (k3's two scalar reads per window).
//
// fixed mode:    s_i = w0 for every i. The windows are the same for every
//                thread, so a block stages them in shared memory once and
//                each thread compares its element against all of them
//                (every lane of a warp reads the same word: a broadcast).
// searched mode: b sorted ascending, nwin = 1, s_i = max(0, #{w : b[128 w] < a[i]} - 1).
//                A thread bisects the window heads, then bisects inside
//                its window; for sorted b that equals the count above, and
//                the result is the exact lower bound #{b < a[i]}.
//
// What bounds it: fixed mode is bound by operations, one compare and one
// add per (element, window position): 2 * 128 * nwin INT32 operations per
// element of a (W = 2 at 1 M elements is ~32 us on an H100). Searched mode
// reads a (8 B), writes out (4 B) and touches about log2(n_b) words of b
// per element; its bound is the bytes of a, b and out read or written
// once. The TPU version counted on the vector unit against windows held in
// VMEM; on Hopper the window lives in shared memory and the count is a
// plain loop, unrolled by four.
//
// Elements are int32 or int64 (the join's u32 hash domain rides in int64
// carriers holding [0, 2^32)); out is int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void rank_fixed_kernel(const T* __restrict__ a, long long n_a,
                                  const T* __restrict__ b, long long n_b,
                                  long long w0, int nwin, int edge,
                                  int* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const long long base = w0 * 128;
  const long long span = (long long)nwin * 128;
  long long avail = n_b - base;
  avail = avail < 0 ? 0 : (avail > span ? span : avail);
  const int m = (int)avail;
  for (int j = threadIdx.x; j < m; j += blockDim.x) win[j] = b[base + j];
  __syncthreads();

  unsigned int edge_sum = 0u;
  if (edge) {
    for (int w = 0; w < nwin; ++w) {
      const int p0 = w * 128, p1 = w * 128 + 127;
      if (p0 < m) edge_sum += (unsigned int)win[p0];
      if (p1 < m) edge_sum += (unsigned int)win[p1];
    }
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_a;
       i += stride) {
    const T x = a[i];
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    int j = 0;
    for (; j + 4 <= m; j += 4) {
      c0 += win[j] < x;
      c1 += win[j + 1] < x;
      c2 += win[j + 2] < x;
      c3 += win[j + 3] < x;
    }
    for (; j < m; ++j) c0 += win[j] < x;
    const unsigned int r =
        (unsigned int)(base + c0 + c1 + c2 + c3) + edge_sum;
    out[i] = (int)r;
  }
}

template <typename T>
__global__ void rank_searched_kernel(const T* __restrict__ a, long long n_a,
                                     const T* __restrict__ b, long long n_b,
                                     int* __restrict__ out) {
  const long long n_win = (n_b + 127) / 128;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_a;
       i += stride) {
    const T x = a[i];
    // windows whose head lies below x
    long long lo = 0, hi = n_win;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(&b[mid * 128]) < x) lo = mid + 1; else hi = mid;
    }
    const long long start = (lo > 0 ? lo - 1 : 0) * 128;
    long long len = n_b - start;
    len = len > 128 ? 128 : (len < 0 ? 0 : len);
    int l = 0, h = (int)len;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (__ldg(&b[start + mid]) < x) l = mid + 1; else h = mid;
    }
    out[i] = (int)(start + l);
  }
}

template <typename T>
int launch(const void* a, long long n_a, const void* b, long long n_b,
           int searched, long long w0, int nwin, int edge, void* out,
           int grid, int threads, cudaStream_t stream) {
  if (searched) {
    rank_searched_kernel<T><<<grid, threads, 0, stream>>>(
        (const T*)a, n_a, (const T*)b, n_b, (int*)out);
  } else {
    const size_t smem = (size_t)nwin * 128 * sizeof(T);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          rank_fixed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    rank_fixed_kernel<T><<<grid, threads, smem, stream>>>(
        (const T*)a, n_a, (const T*)b, n_b, w0, nwin, edge, (int*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 (int32) or 8 (int64). Returns a cudaError_t.
extern "C" int window_rank_launch(const void* a, long long n_a, const void* b,
                                  long long n_b, int elem_bytes, int searched,
                                  long long w0, int nwin, int edge, void* out,
                                  int grid, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return launch<int32_t>(a, n_a, b, n_b, searched, w0, nwin, edge, out,
                           grid, threads, s);
  if (elem_bytes == 8)
    return launch<long long>(a, n_a, b, n_b, searched, w0, nwin, edge, out,
                             grid, threads, s);
  return (int)cudaErrorInvalidValue;
}
