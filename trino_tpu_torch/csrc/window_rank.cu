// Windowed rank, the join probe's run bounds, and the expansion's run owners.
//
// Replaces the TPU kernels of benchmarks/explore_kernel_costs.py
// (`call(kernel)` -> `f`, bodies k0..k4: the in-window count step of a
// merge-path probe) and, on the join path, the packed sorts of
// trino_tpu/ops/join.py::sorted_run_bounds (the probe's bounds, and the
// expansion's "which probe row produced output j").
//
// fixed mode (rank_fixed_kernel), k0..k4:
//
//   out[i] = 128 * w0 + sum_{w < nwin} sum_{l < 128} [b[(w0 + w) * 128 + l] < a[i]]
//
//   counting only positions < n_b, plus (when `edge` is set, int32 only)
//   the int32 sum, wrapping, of b[(w0 + w) * 128] + b[(w0 + w) * 128 + 127]
//   over the same windows (k3's two scalar reads per window). The windows
//   are the same for every thread, so a block stages them in shared memory
//   once and each thread compares its element against all of them (every
//   lane of a warp reads the same word: a broadcast). Bound by operations:
//   one compare and one add per (element, window position).
//
// bounds (bounds_kernel), b sorted ascending:
//
//   lo[i] = #{b < q[i]},  hi[i] = #{b < q[i] + 1}   (q + 1 wraps in the type)
//
//   The searched mode of `rank` is the lo half alone. What paces a search of
//   random queries is the number of load instructions with 32 scattered
//   addresses a warp issues (each costs up to 32 L1 wavefronts and as many
//   L2 sector reads), so the design spends as few as it can. One persistent
//   grid of one to two blocks per SM. Each block first copies the window
//   heads b[0], b[S], b[2S], ... into shared memory, S the smallest power of
//   two whose heads fit 200 KB (64 for 1.5 M int64 hashes; 1, all of b, for
//   builds up to 25 K int64), so the top levels of the search are shared-
//   memory reads. The last log2(S) levels bisect one window of b in L2: the
//   window halves exactly, so the value just past the bracket is always
//   known (the next head, or the last load that was not below x), and lo
//   costs log2(S) loads and no final compare. Each thread steps QPT
//   independent queries through both searches in lockstep (the same trip
//   counts for all), so QPT loads are in flight per thread instead of one
//   dependent chain. hi starts from the known value b[lo]: a query that
//   matches nothing reads nothing more; one that matches gallops forward
//   (b[lo+1], b[lo+2], b[lo+4], ...) and bisects the bracket, exact for any
//   run length. Bound by bytes: q read once, lo and hi written once, b read
//   once; the scattered reads of b inside the windows are not counted.
//
// run owners (run_owner_kernel), off int32 nondecreasing >= 0 (the inclusive
// cumulative sum of the probe rows' match counts):
//
//   out[j] = #{i : off[i] <= j}   for j < n_out
//
//   No search per output: probe row i owns the outputs [off[i-1], off[i])
//   (off[-1] = 0) and the tail [off[n-1], n_out) belongs to n. The kernel
//   walks the merge of the n run ends with the n_out outputs (row i before
//   output j when off[i] <= j; j's owner is the number of rows before it)
//   and gives each warp an equal slice of it, rows and outputs together,
//   so neither one long run (a skewed build key) nor a long stretch of
//   empty runs lands on one warp. A warp finds where its slice starts by
//   one 32-way search of off (about five rounds of loads), then steps 32
//   rows at a time: the lanes hold 32 consecutive run ends (coalesced
//   reads, four windows ahead of the fill) and fill the outputs of those
//   runs with coalesced stores, each output finding its row among the 32
//   ends by a five-step shuffle bisection.
//   Bound by bytes: off read once and out written once.
//
// Elements are int32 or int64 (the join's u32 hash domain rides in int64
// carriers holding [0, 2^32)); outputs are int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BOUNDS_THREADS = 512;
constexpr int QPT = 4;                        // queries per thread, in lockstep
constexpr int STAGE = 8;                      // head loads in flight per thread
constexpr long long HEAD_BUDGET = 200 * 1024; // shared-memory bytes for heads
constexpr int BOUNDS_BLOCKS_PER_SM = 2;
constexpr int RUN_OWNER_THREADS = 256;
constexpr int RUN_OWNER_WINDOWS = 4;           // windows of 32 run ends read at once
constexpr long long RUN_OWNER_MIN_ITEMS = 256; // rows and outputs a warp, at least
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T type_max();
template <> __device__ __forceinline__ int32_t type_max<int32_t>() { return 0x7fffffff; }
template <> __device__ __forceinline__ long long type_max<long long>() {
  return 0x7fffffffffffffffLL;
}

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

// b[p], or the type's maximum past the end (never below any query)
template <typename T>
__device__ __forceinline__ T at_or_max(const T* __restrict__ b, long long n_b,
                                       long long p) {
  return p < n_b ? __ldg(&b[p]) : type_max<T>();
}

// First position p >= lo with b[p] > x (n_b if none); every position
// below lo holds a value <= x.
template <typename T>
__device__ __forceinline__ long long run_end(const T* __restrict__ b,
                                             long long n_b, long long lo, T x) {
  long long known = lo, end = n_b;
  for (long long d = 1;; d <<= 1) {  // gallop: lo, lo + 1, lo + 3, lo + 7, ...
    const long long p = lo + d - 1;
    if (p >= n_b) break;
    if (__ldg(&b[p]) > x) { end = p; break; }
    known = p + 1;
  }
  while (known < end) {  // bisect the bracket [known, end)
    const long long mid = (known + end) >> 1;
    if (__ldg(&b[mid]) <= x) known = mid + 1; else end = mid;
  }
  return known;
}

template <typename T, bool HI>
__global__ void __launch_bounds__(BOUNDS_THREADS)
bounds_kernel(const T* __restrict__ q, long long n, const T* __restrict__ b,
              long long n_b, long long stride, int n_heads,
              int* __restrict__ lo_out, int* __restrict__ hi_out) {
  extern __shared__ unsigned char smem_raw[];
  T* heads = reinterpret_cast<T*>(smem_raw);
  // STAGE independent loads in flight per thread: each head is a scattered
  // read of b, and one at a time the copy would wait out a latency per
  // head (46 a thread at the probe's 1.5 M int64)
  for (int j0 = threadIdx.x; j0 < n_heads; j0 += STAGE * blockDim.x) {
    T v[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int j = j0 + u * blockDim.x;
      v[u] = j < n_heads ? __ldg(&b[(long long)j * stride]) : T(0);
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < n_heads) heads[j] = v[u];
    }
  }
  __syncthreads();

  const long long per_block = (long long)blockDim.x * QPT;
  for (long long first = (long long)blockIdx.x * per_block; first < n;
       first += (long long)gridDim.x * per_block) {
    T x[QPT], at_lo[QPT];  // each query, and the value of b at its lower bound
    long long lo[QPT];
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const long long i = first + (long long)k * blockDim.x + threadIdx.x;
      x[k] = i < n ? q[i] : T(0);
    }
    if (n_heads == 0) {  // empty b: nothing lies below anything
#pragma unroll
      for (int k = 0; k < QPT; ++k) lo[k] = 0, at_lo[k] = type_max<T>();
    } else {
      // top levels: c = #{heads < x} by branchless bisection in shared memory
      int h[QPT];
#pragma unroll
      for (int k = 0; k < QPT; ++k) h[k] = 0;
      for (int len = n_heads; len > 1;) {
        const int half = len >> 1;
#pragma unroll
        for (int k = 0; k < QPT; ++k)
          h[k] = heads[h[k] + half] < x[k] ? h[k] + half : h[k];
        len -= half;
      }
      // c >= 1: b[pos] = heads[c - 1] < x <= up, the value at pos + stride
      // (heads[c], or past the end). c = 0: the lower bound is 0.
      int c[QPT];
      long long pos[QPT];
      T up[QPT];
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        c[k] = h[k] + (heads[h[k]] < x[k]);
        pos[k] = (long long)(c[k] > 0 ? c[k] - 1 : 0) * stride;
        up[k] = c[k] < n_heads ? heads[c[k]] : type_max<T>();
      }
      // last levels in L2, all QPT loads issued together: the window halves
      // exactly, so b[pos] < x <= up = the value at pos + len holds throughout
      for (long long half = stride >> 1; half > 0; half >>= 1) {
        T v[QPT];
#pragma unroll
        for (int k = 0; k < QPT; ++k) v[k] = at_or_max(b, n_b, pos[k] + half);
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          if (v[k] < x[k]) pos[k] += half; else up[k] = v[k];
        }
      }
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        lo[k] = c[k] > 0 ? pos[k] + 1 : 0;
        at_lo[k] = c[k] > 0 ? up[k] : heads[0];
      }
    }
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const long long i = first + (long long)k * blockDim.x + threadIdx.x;
      if (i >= n) continue;
      lo_out[i] = (int)lo[k];
      if (HI) {
        // q + 1 wraps to the type's minimum at its maximum: nothing is
        // below it. Otherwise the run of x starts at lo; the value there
        // is known, so a query that matches nothing reads no more of b.
        long long hi = lo[k];
        if (x[k] == type_max<T>()) hi = 0;
        else if (lo[k] < n_b && at_lo[k] == x[k]) hi = run_end(b, n_b, lo[k] + 1, x[k]);
        hi_out[i] = (int)hi;
      }
    }
  }
}

template <typename T, bool HI>
int launch_bounds(const void* q, long long n, const void* b, long long n_b,
                  void* lo, void* hi, int sms, cudaStream_t stream) {
  long long stride = 1;  // a power of two: the window halves exactly
  while (((n_b + stride - 1) / stride) * (long long)sizeof(T) > HEAD_BUDGET)
    stride <<= 1;
  const int n_heads = (int)((n_b + stride - 1) / stride);
  const size_t smem = (size_t)n_heads * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      bounds_kernel<T, HI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bounds_kernel<T, HI>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bounds_kernel<T, HI>, BOUNDS_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  per_sm = per_sm < 1 ? 1 : (per_sm > BOUNDS_BLOCKS_PER_SM ? BOUNDS_BLOCKS_PER_SM : per_sm);
  const long long per_block = (long long)BOUNDS_THREADS * QPT;
  const long long need = (n + per_block - 1) / per_block;
  long long grid = (long long)per_sm * sms;
  grid = grid < need ? grid : need;
  grid = grid < 1 ? 1 : grid;
  bounds_kernel<T, HI><<<(int)grid, BOUNDS_THREADS, smem, stream>>>(
      (const T*)q, n, (const T*)b, n_b, stride, n_heads, (int*)lo, (int*)hi);
  return (int)cudaGetLastError();
}

// off[i] clipped to [0, n_out]: where row i's run ends among the outputs
__device__ __forceinline__ int run_end_at(const int* __restrict__ off, long long i,
                                          int n_out) {
  const int v = __ldg(&off[i]);
  return v < 0 ? 0 : (v > n_out ? n_out : v);
}

// The rows among the first d items of the merge: the largest r in
// [max(0, d - n_out), min(d, n)] whose row r - 1 precedes output d - r.
// That holds for r up to the answer and fails past it, so each round the
// warp's 32 lanes test 32 evenly spaced r and keep the gap after the last
// that holds: log32 of the range in rounds.
__device__ __forceinline__ long long merge_rows(const int* __restrict__ off,
                                                long long n, int n_out, long long d,
                                                int lane) {
  long long lo = d - n_out > 0 ? d - n_out : 0, hi = d < n ? d : n;
  while (hi > lo) {
    const long long step = (hi - lo + 31) >> 5;
    const long long r = lo + (lane + 1) * step;
    const bool holds = r <= hi && run_end_at(off, r - 1, n_out) <= d - r;
    const long long c = __popc(__ballot_sync(FULL, holds));
    hi = hi < lo + (c + 1) * step - 1 ? hi : lo + (c + 1) * step - 1;
    lo += c * step;
  }
  return lo;
}

// Fills the outputs of the window of 32 rows starting at r (this lane's
// run end e) that lie in [t, ...) and in the slice ending at d1; returns
// true when the outputs or the slice end inside the window, else moves t
// past it. The per-output work is 32-bit: outputs lie below n_out < 2^31,
// so j + 32 fits an unsigned int.
__device__ __forceinline__ bool fill_window(int e, int lane, long long r, long long& t,
                                            int n_out, long long d1,
                                            int* __restrict__ out) {
  const int last = __shfl_sync(FULL, e, 31);
  // the window's outputs [t, last), cut at n_out and at the slice's end:
  // output j's place in the merge is j + its owner, and its owner >= r
  const long long room = d1 - r;
  long long hi = last < n_out ? last : n_out;
  hi = hi < room ? hi : room;
  const unsigned t_hi = (unsigned)hi;
  const unsigned lim = room < 0xffffffffLL ? (unsigned)room : 0xffffffffu;
  const int row = (int)r;
  for (unsigned t0 = (unsigned)t; t0 < t_hi; t0 += 32) {
    const unsigned j = t0 + lane;
    // c = #{lanes whose run ends at or before j}: j's row is r + c
    unsigned c = 0;
#pragma unroll
    for (unsigned step = 16; step >= 1; step >>= 1) {
      const unsigned em = (unsigned)__shfl_sync(FULL, e, c + step - 1);
      c += em <= j ? step : 0;
    }
    if (j < t_hi && j + c < lim) out[j] = row + (int)c;
  }
  if (t_hi < (unsigned)last || hi >= n_out || r + 32 + last >= d1) return true;
  t = last;
  return false;
}

__global__ void __launch_bounds__(RUN_OWNER_THREADS)
run_owner_kernel(const int* __restrict__ off, long long n, int n_out,
                 int* __restrict__ out) {
  constexpr int PAST = 0x7fffffff;  // the end of a row past n: after every output
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long total = n + n_out;
  const long long per = (total + n_warps - 1) / n_warps;
  const long long d0 = warp * per;
  if (d0 >= total) return;  // the whole warp
  const long long d1 = d0 + per < total ? d0 + per : total;
  long long r = merge_rows(off, n, n_out, d0, lane);  // rows before the slice
  long long t = d0 - r;                               // its first output
  // RUN_OWNER_WINDOWS windows of 32 run ends are read together, and the
  // next ones while these are filled: each warp walks its slice alone, so
  // its loads in flight are what hides device memory's latency
  int e[RUN_OWNER_WINDOWS], next[RUN_OWNER_WINDOWS];
#pragma unroll
  for (int k = 0; k < RUN_OWNER_WINDOWS; ++k) {
    const long long i = r + 32 * k + lane;
    e[k] = i < n ? run_end_at(off, i, n_out) : PAST;
  }
  for (;;) {
#pragma unroll
    for (int k = 0; k < RUN_OWNER_WINDOWS; ++k) {
      const long long i = r + 32 * (RUN_OWNER_WINDOWS + k) + lane;
      next[k] = i < n ? run_end_at(off, i, n_out) : PAST;
    }
#pragma unroll
    for (int k = 0; k < RUN_OWNER_WINDOWS; ++k) {
      if (fill_window(e[k], lane, r, t, n_out, d1, out)) return;
      r += 32;
    }
#pragma unroll
    for (int k = 0; k < RUN_OWNER_WINDOWS; ++k) e[k] = next[k];
  }
}

}  // namespace

// Fixed mode. elem_bytes: 4 (int32) or 8 (int64). Returns a cudaError_t.
extern "C" int window_rank_launch(const void* a, long long n_a, const void* b,
                                  long long n_b, int elem_bytes, long long w0,
                                  int nwin, int edge, void* out, int grid,
                                  int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)nwin * 128 * elem_bytes;
  if (elem_bytes == 4) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          rank_fixed_kernel<int32_t>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    rank_fixed_kernel<int32_t><<<grid, threads, smem, s>>>(
        (const int32_t*)a, n_a, (const int32_t*)b, n_b, w0, nwin, edge, (int*)out);
  } else if (elem_bytes == 8) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          rank_fixed_kernel<long long>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    rank_fixed_kernel<long long><<<grid, threads, smem, s>>>(
        (const long long*)a, n_a, (const long long*)b, n_b, w0, nwin, edge, (int*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// lo (and hi, unless it is null) of every query against sorted b; `sms` is
// the card's SM count. Returns a cudaError_t.
extern "C" int rank_bounds_launch(const void* q, long long n, const void* b,
                                  long long n_b, int elem_bytes, void* lo,
                                  void* hi, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return hi ? launch_bounds<int32_t, true>(q, n, b, n_b, lo, hi, sms, s)
              : launch_bounds<int32_t, false>(q, n, b, n_b, lo, hi, sms, s);
  if (elem_bytes == 8)
    return hi ? launch_bounds<long long, true>(q, n, b, n_b, lo, hi, sms, s)
              : launch_bounds<long long, false>(q, n, b, n_b, lo, hi, sms, s);
  return (int)cudaErrorInvalidValue;
}

// out[j] = #{off <= j} for j < n_out (n_out < 2^31); `sms` is the card's
// SM count. One slice of the merge a warp, with as many warps as the card
// holds at once. Returns a cudaError_t.
extern "C" int run_owner_launch(const void* off, long long n, int n_out,
                                void* out, int sms, void* stream) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, run_owner_kernel, RUN_OWNER_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = RUN_OWNER_MIN_ITEMS * (RUN_OWNER_THREADS / 32);
  const long long need = (n + n_out + per_block - 1) / per_block;
  long long grid = (long long)(per_sm < 1 ? 1 : per_sm) * sms;
  grid = grid < need ? grid : need;
  grid = grid < 1 ? 1 : grid;
  run_owner_kernel<<<(int)grid, RUN_OWNER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)off, n, n_out, (int*)out);
  return (int)cudaGetLastError();
}
