// Exact per-group int64 sums of k value columns plus the live-row count.
//
// Replaces the TPU kernel trino_tpu/ops/mxu_groupby.py::grouped_sum_mxu
// (Pallas body _make_kernel). The TPU version splits int64 values into
// 8-bit limbs and contracts them against a one-hot of the group ids on
// the matrix unit; that trick exists for the systolic array and does not
// carry over. Here each block keeps a private accumulator per (column,
// slot) in shared memory; unsigned wraparound equals two's-complement
// wraparound, so the sums are exact mod 2^64 and independent of the
// order of additions.
//
// What bounds it: bytes read. Each row is read once: gid (4 B), live
// (1 B) and, for a used row, k values (8 B each). At the main path's
// shape (k = 13, ~4.2 M rows per scan batch) that is ~457 MB per call,
// ~137 us at the H100's 3.35 TB/s. The first design added every (row,
// column) into the accumulator with a 64-bit shared atomic, and its time
// followed the count of those atomics, three times the bound.
//
// This design sorts each tile of TILE rows by slot in shared memory and
// adds each slot's run once (a per-tile counting sort):
//   1. one 32-bit shared atomicAdd per used row on a histogram of the
//      tile's slots; the value it returns is the row's rank in its slot;
//   2. a block-wide exclusive scan of the histogram gives each slot's
//      first sorted position; the histogram itself is the tile's live
//      count per slot and goes straight into the count column;
//   3. per value column: coalesced loads of the tile's values, a plain
//      shared store of each at start[slot] + rank, a barrier, then each
//      warp reduces a span of SPAN sorted positions, eight consecutive
//      positions a lane: sequential sums inside the lane and a segmented
//      shuffle scan across the lanes. The lane where a run ends adds the
//      run's sum into the accumulator once.
// A run that lies inside one warp's span belongs to that warp alone and
// is added with a plain read-modify-write. Only the two runs a warp
// shares with its neighbours (the slots just before and just after its
// span) take a 64-bit shared atomic, which on sm_90 compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64): at most two a warp per
// column and tile, whatever the skew. Ranks come from atomics in no fixed order;
// nothing here assumes the rows of a slot keep their row order.
// The next column's loads are issued before the barrier, so they overlap
// the reduction; the tile of one column, the slot of each sorted position
// and the accumulator stay on chip, and each block flushes its nonzero
// slots to device memory with one global atomic each at the end.
// On an H100 this runs about a tenth above one streaming read of the same
// values, whatever the slots a tile touches (PERF.md); what remains is the
// reduce between each column's two barriers, whose run-end branches
// diverge across a warp.
//
// Layout: values is a contiguous (k, n) int64 array; out is (k + 1,
// capacity) int64, zero-filled by the caller; the extra last column is
// the count of live rows. gridDim.y splits the k + 1 columns into chunks
// of cols_per_block so the shared accumulator fits the per-block budget
// at any capacity; each chunk sorts the tile again. Rows that are dead,
// or whose gid lies outside [0, capacity), add nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 8;                   // rows a thread loads, positions a lane reduces
constexpr int TILE = THREADS * PER_THREAD;      // 4096 rows
constexpr int SPAN = 32 * PER_THREAD;           // sorted positions a warp reduces
constexpr int MAX_SLOTS = 4 * THREADS;          // the scan gives a thread four slots
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffu;              // slot of a position past the used rows

typedef unsigned long long u64;

// The sorted tile is read by lanes as four 16-byte chunks each (chunks
// 4l..4l+3 of the warp's span); chunk q is stored at q ^ ((q >> 3) & 3),
// so the eight lanes of each quarter-warp hit eight different bank groups.
__device__ __forceinline__ int word_of(int p) {
  const int q = p >> 1;
  return ((q ^ ((q >> 3) & 3)) << 1) | (p & 1);
}

// Adds a run's sum into the block's accumulator: a plain add when no
// other warp holds the slot, an atomic for the two slots a warp's span
// may share with its neighbours.
__device__ __forceinline__ void add_run(u64* acc, unsigned slot, u64 sum,
                                        unsigned prev_slot, unsigned next_slot) {
  if (slot == NONE) return;
  if (slot == prev_slot || slot == next_slot)
    atomicAdd(&acc[slot], sum);
  else
    acc[slot] += sum;
}

__device__ __forceinline__ unsigned half(const uint4& raw, int i) {
  const unsigned w = i < 2 ? raw.x : (i < 4 ? raw.y : (i < 6 ? raw.z : raw.w));
  return (i & 1) ? (w >> 16) : (w & 0xffffu);
}

__global__ void __launch_bounds__(THREADS, 2)
grouped_sum_kernel(const int32_t* __restrict__ gid, const uint8_t* __restrict__ live,
                   const u64* __restrict__ values, long long n, int k, int capacity,
                   int cols_per_block, u64* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sv = reinterpret_cast<u64*>(smem);                               // TILE
  unsigned short* sg = reinterpret_cast<unsigned short*>(sv + TILE);    // TILE
  const int c0 = blockIdx.y * cols_per_block;
  const int ncols = min(cols_per_block, k + 1 - c0);
  const int nvals = min(ncols, k - c0);          // value columns; the count is c == k
  const bool has_count = c0 + ncols == k + 1;
  u64* acc = reinterpret_cast<u64*>(sg + TILE);                         // ncols x capacity
  unsigned* start = reinterpret_cast<unsigned*>(acc + ncols * capacity);  // capacity
  unsigned* warp_total = start + capacity;                              // WARPS + 1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < ncols * capacity; j += THREADS) acc[j] = 0ULL;
  for (int j = tid; j < capacity; j += THREADS) start[j] = 0u;
  __syncthreads();

  const int per = (capacity + THREADS - 1) / THREADS;  // slots a thread scans, <= 4
  const int span0 = warp * SPAN;
  const int p0 = span0 + lane * PER_THREAD;            // this lane's first position
  const long long tiles = (n + TILE - 1) / TILE;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * TILE;
    // 1. the used rows, and each one's rank inside its slot
    int slot[PER_THREAD], pos[PER_THREAD];
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const long long row = base + r * THREADS + tid;
      int g = -1;
      if (row < n) {
        const int x = gid[row];
        if (live[row] && (unsigned)x < (unsigned)capacity) g = x;
      }
      slot[r] = g;
    }
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r)
      pos[r] = slot[r] >= 0 ? (int)atomicAdd(&start[slot[r]], 1u) : -1;
    // the first value column's loads, in flight through the scan
    const u64* col = values + (long long)c0 * n;
    u64 v[PER_THREAD];
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r)
      v[r] = (nvals > 0 && slot[r] >= 0) ? col[base + r * THREADS + tid] : 0ULL;
    __syncthreads();

    // 2. exclusive scan of the counts; the counts are the count column
    unsigned cnt[4], mine = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = tid * per + i;
      cnt[i] = (i < per && j < capacity) ? start[j] : 0u;
      mine += cnt[i];
    }
    unsigned incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const unsigned w = lane < WARPS ? warp_total[lane] : 0u;
      unsigned wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, wi, off);
        if (lane >= off) wi += y;
      }
      if (lane < WARPS) warp_total[lane] = wi - w;
      if (lane == WARPS - 1) warp_total[WARPS] = wi;
    }
    __syncthreads();
    unsigned at = warp_total[warp] + incl - mine;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = tid * per + i;
      if (i < per && j < capacity) {
        start[j] = at;
        if (has_count && cnt[i]) acc[(ncols - 1) * capacity + j] += cnt[i];
        at += cnt[i];
      }
    }
    const int used = (int)warp_total[WARPS];
    __syncthreads();

    if (nvals > 0) {
      // 3. each used row's sorted position, and the slot of each position
#pragma unroll
      for (int r = 0; r < PER_THREAD; ++r)
        if (slot[r] >= 0) {
          pos[r] += (int)start[slot[r]];
          sg[pos[r]] = (unsigned short)slot[r];
        }
    }
    __syncthreads();
    for (int j = tid; j < capacity; j += THREADS) start[j] = 0u;  // next tile's counts
    if (nvals == 0) {
      __syncthreads();
      continue;
    }

    // 4. this lane's eight slots and the run heads among them
    const bool active = span0 < used;  // warp-uniform
    unsigned heads = 0u, prev_slot = NONE, next_slot = NONE;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (active) {
      raw = *reinterpret_cast<const uint4*>(sg + p0);
      prev_slot = (warp > 0) ? sg[span0 - 1] : NONE;
      next_slot = (span0 + SPAN < used) ? sg[span0 + SPAN] : NONE;
      const unsigned last = p0 + PER_THREAD - 1 < used ? half(raw, PER_THREAD - 1) : NONE;
      unsigned before = __shfl_up_sync(FULL, last, 1);
      if (lane == 0) before = prev_slot;
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const unsigned s = p0 + i < used ? half(raw, i) : NONE;
        if (s != before) heads |= 1u << i;
        before = s;
      }
    }
    const unsigned h0 = __ballot_sync(FULL, heads & 1u);
    const unsigned flagged = __ballot_sync(FULL, heads != 0u);
    const unsigned below = flagged & (FULL >> (31 - lane));
    const int seg_lo = below ? 31 - __clz(below) : 0;
    const bool tail_ends = lane == 31 || ((h0 >> (lane + 1)) & 1u);
    const int first_end = __ffs(heads & 0xfeu) - 1;  // where the lane's first run ends

    // 5. per value column: scatter into slot order, then add each run once
    for (int c = 0; c < nvals; ++c) {
#pragma unroll
      for (int r = 0; r < PER_THREAD; ++r)
        if (pos[r] >= 0) sv[word_of(pos[r])] = v[r];
      if (c + 1 < nvals) {
        col += n;
#pragma unroll
        for (int r = 0; r < PER_THREAD; ++r)
          v[r] = pos[r] >= 0 ? col[base + r * THREADS + tid] : 0ULL;
      }
      __syncthreads();
      if (active) {
        u64* acc_c = acc + c * capacity;
        u64 x[PER_THREAD];
#pragma unroll
        for (int j = 0; j < PER_THREAD; j += 2) {
          const ulonglong2 pair = *reinterpret_cast<const ulonglong2*>(sv + word_of(p0 + j));
          x[j] = pair.x;
          x[j + 1] = pair.y;
        }
        // runs inside the lane: the first may continue from the lanes
        // before, the last into the lanes after; the others start and end
        // in this lane, so no other warp holds their slots
        u64 run = 0ULL, first = 0ULL;
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
          if (i > 0 && ((heads >> i) & 1u)) {
            if (i == first_end) first = run;
            else acc_c[half(raw, i - 1)] += run;
            run = 0ULL;
          }
          run += x[i];
        }
        // segmented inclusive scan of the lanes' last runs
        u64 scan = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const u64 up = __shfl_up_sync(FULL, scan, off);
          if (lane - off >= seg_lo) scan += up;
        }
        u64 carry = __shfl_up_sync(FULL, scan, 1);
        if (lane == 0 || (heads & 1u)) carry = 0ULL;
        if (heads & 0xfeu) add_run(acc_c, half(raw, 0), carry + first, prev_slot, next_slot);
        if (tail_ends) {
          const unsigned s = p0 + PER_THREAD - 1 < used ? half(raw, PER_THREAD - 1) : NONE;
          add_run(acc_c, s, scan, prev_slot, next_slot);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  for (int j = tid; j < ncols * capacity; j += THREADS) {
    const u64 v = acc[j];
    if (v != 0ULL) {
      const int c = j / capacity;
      const int s = j - c * capacity;
      atomicAdd(&out[(long long)(c0 + c) * capacity + s], v);
    }
  }
}

size_t shared_bytes(int cols_per_block, int capacity) {
  return (size_t)TILE * (sizeof(u64) + sizeof(unsigned short)) +
         (size_t)cols_per_block * capacity * sizeof(u64) +
         (size_t)(capacity + WARPS + 1) * sizeof(unsigned);
}

}  // namespace

// The grid is as many blocks of each column chunk as fit on the card at
// once (at most one per tile); each walks the tiles with a stride.
// Returns a cudaError_t.
extern "C" int grouped_sum_launch(const void* gid, const void* live,
                                  const void* values, long long n, int k,
                                  int capacity, void* out, int cols_per_block,
                                  int sms, void* stream) {
  if (capacity < 1 || capacity > MAX_SLOTS || cols_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = (k + 1 + cols_per_block - 1) / cols_per_block;
  const size_t smem = shared_bytes(cols_per_block, capacity);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grouped_sum_kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (n + TILE - 1) / TILE;
  long long grid_x = (long long)per_sm * sms / chunks;
  grid_x = grid_x > tiles ? tiles : (grid_x < 1 ? 1 : grid_x);
  dim3 grid((unsigned)grid_x, chunks);
  grouped_sum_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)gid, (const uint8_t*)live, (const u64*)values, n, k, capacity,
      cols_per_block, (u64*)out);
  return (int)cudaGetLastError();
}
