// Native exchange hot path: single-pass partition scatter.
//
// Role analogue: the reference's "native" layer is JIT-generated JVM
// bytecode for the data plane's inner loops (SURVEY.md §2.9) — here the
// HOST-side inner loops around the XLA device path are C++. This module
// replaces PartitionedOutputOperator's per-partition boolean-mask passes
// (O(P·N) in numpy) with one O(N) scatter pass over all partitions
// (output/PartitionedOutputOperator.java:191 PagePartitioner — the
// per-partition PositionsAppenders collapsed into one cache-friendly
// sweep).
//
// Build: g++ -O3 -shared -fPIC -o libpagesplit.so pagesplit.cpp
// Loaded via ctypes (trino_tpu/native/__init__.py) with a pure-numpy
// fallback when the toolchain is unavailable.

#include <cstdint>
#include <cstring>

extern "C" {

// Count rows per partition. pids[i] in [0, n_parts) or -1 for dead rows.
void partition_counts(const int32_t* pids, int64_t n_rows, int32_t n_parts,
                      int64_t* counts /* out, size n_parts */) {
    for (int32_t p = 0; p < n_parts; ++p) counts[p] = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        int32_t p = pids[i];
        if (p >= 0 && p < n_parts) counts[p]++;
    }
}

// Scatter one fixed-width column into per-partition output buffers in a
// single pass. outs[p] must hold counts[p]*item_size bytes. `offsets` is
// scratch of size n_parts (zeroed here).
void scatter_column(const uint8_t* data, int64_t item_size,
                    const int32_t* pids, int64_t n_rows, int32_t n_parts,
                    uint8_t** outs, int64_t* offsets /* scratch */) {
    for (int32_t p = 0; p < n_parts; ++p) offsets[p] = 0;
    switch (item_size) {
        case 1:
            for (int64_t i = 0; i < n_rows; ++i) {
                int32_t p = pids[i];
                if (p < 0 || p >= n_parts) continue;
                outs[p][offsets[p]++] = data[i];
            }
            return;
        case 4:
            for (int64_t i = 0; i < n_rows; ++i) {
                int32_t p = pids[i];
                if (p < 0 || p >= n_parts) continue;
                reinterpret_cast<uint32_t*>(outs[p])[offsets[p]++] =
                    reinterpret_cast<const uint32_t*>(data)[i];
            }
            return;
        case 8:
            for (int64_t i = 0; i < n_rows; ++i) {
                int32_t p = pids[i];
                if (p < 0 || p >= n_parts) continue;
                reinterpret_cast<uint64_t*>(outs[p])[offsets[p]++] =
                    reinterpret_cast<const uint64_t*>(data)[i];
            }
            return;
        default:
            for (int64_t i = 0; i < n_rows; ++i) {
                int32_t p = pids[i];
                if (p < 0 || p >= n_parts) continue;
                std::memcpy(outs[p] + offsets[p] * item_size,
                            data + i * item_size, item_size);
                offsets[p]++;
            }
    }
}

// Gather rows selected by a boolean mask into a compact output buffer
// (the Page.compact / live-row extraction inner loop).
int64_t mask_gather(const uint8_t* data, int64_t item_size,
                    const uint8_t* mask, int64_t n_rows, uint8_t* out) {
    int64_t w = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        if (!mask[i]) continue;
        std::memcpy(out + w * item_size, data + i * item_size, item_size);
        ++w;
    }
    return w;
}

}  // extern "C"
