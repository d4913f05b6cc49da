// Host-side COO -> padded-CSR packing kernel.
//
// Copy of predictionio_tpu/native/csr_pack.cpp. It feeds the ALS, fold-in
// and cooccurrence paths: 20M+ interaction triples must become static-shape
// padded blocks before every training run, and the numpy path pays two
// O(n log n) sorts where a row-bucket counting sort is O(n).
//
// Semantics mirror ops/ragged.pack_padded_csr exactly:
//  - entries are grouped by row, ordered by (time asc, input order) when
//    times are given, else by input order (stable);
//  - rows longer than L keep their LAST L entries (most recent);
//  - padding slots keep indices == num_cols, values/mask == 0 (the caller
//    pre-fills the output arrays).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libpio_native.so csr_pack.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of truncated interactions, or -1 on invalid input.
// out_indices must be pre-filled with num_cols, out_values/out_mask with 0.
int64_t pack_padded_csr(
    const int64_t* rows,
    const int64_t* cols,
    const float* vals,
    const double* times,  // nullable; double so float timestamps order
                          // identically to the numpy lexsort path
    int64_t n,
    int64_t num_rows,
    int64_t length,        // padded row capacity L
    int64_t padded_rows,
    int64_t num_cols,
    int32_t* out_indices,  // [padded_rows, length]
    float* out_values,     // [padded_rows, length]
    float* out_mask        // [padded_rows, length]
) {
    if (n < 0 || num_rows <= 0 || length <= 0 || padded_rows < num_rows) {
        return -1;
    }
    // 1) per-row counts
    std::vector<int64_t> counts(static_cast<size_t>(num_rows) + 1, 0);
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = rows[i];
        // reject out-of-range ids (cols too: silently remapping them would
        // diverge from the numpy path) -- caller falls back
        if (r < 0 || r >= num_rows) return -1;
        if (cols[i] < 0 || cols[i] >= num_cols) return -1;
        ++counts[static_cast<size_t>(r)];
    }
    // 2) exclusive prefix sum -> bucket offsets
    std::vector<int64_t> offsets(static_cast<size_t>(num_rows) + 1, 0);
    for (int64_t r = 0; r < num_rows; ++r) {
        offsets[static_cast<size_t>(r) + 1] =
            offsets[static_cast<size_t>(r)] + counts[static_cast<size_t>(r)];
    }
    // 3) stable scatter of entry ids into row buckets (counting sort pass)
    std::vector<int64_t> order(static_cast<size_t>(n));
    {
        std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
        for (int64_t i = 0; i < n; ++i) {
            order[static_cast<size_t>(cursor[static_cast<size_t>(rows[i])]++)] = i;
        }
    }
    // 4) within-row time order (stable: ties keep input order); skipped when
    //    no timestamps were provided, matching the numpy lexsort semantics
    if (times != nullptr) {
        for (int64_t r = 0; r < num_rows; ++r) {
            int64_t lo = offsets[static_cast<size_t>(r)];
            int64_t hi = offsets[static_cast<size_t>(r) + 1];
            if (hi - lo > 1) {
                std::stable_sort(
                    order.begin() + lo, order.begin() + hi,
                    [times](int64_t a, int64_t b) { return times[a] < times[b]; });
            }
        }
    }
    // 5) fill the padded blocks, keeping each row's last `length` entries
    int64_t truncated = 0;
    for (int64_t r = 0; r < num_rows; ++r) {
        int64_t lo = offsets[static_cast<size_t>(r)];
        int64_t hi = offsets[static_cast<size_t>(r) + 1];
        int64_t count = hi - lo;
        int64_t drop = count > length ? count - length : 0;
        truncated += drop;
        int64_t base = r * length;
        for (int64_t k = drop; k < count; ++k) {
            int64_t src = order[static_cast<size_t>(lo + k)];
            int64_t dst = base + (k - drop);
            out_indices[dst] = static_cast<int32_t>(cols[src]);
            out_values[dst] = vals[src];
            out_mask[dst] = 1.0f;
        }
    }
    return truncated;
}

}  // extern "C"
