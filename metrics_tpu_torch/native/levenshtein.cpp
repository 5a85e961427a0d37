// Host Levenshtein (edit distance) library of the text metrics.
//
// Tokens are mapped to int32 ids in Python (words and characters alike); the
// batch entry point walks packed (offsets, data) arrays, so one ctypes call
// scores a whole corpus. The beam variant is tercom's pruned distance, which
// TER scores its shift candidates with.
//
// metrics_tpu_torch/ops/kernels/build.py builds it at first use:
//     g++ -O3 -shared -fPIC levenshtein.cpp -o build/kernels/liblevenshtein-<hash>.so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Edit distance between a[0..n) and b[0..m), two-row DP, O(min(n,m)) memory.
int64_t edit_distance_i32(const int32_t* a, int64_t n, const int32_t* b, int64_t m) {
    if (n == 0) return m;
    if (m == 0) return n;
    if (m > n) { std::swap(a, b); std::swap(n, m); }
    std::vector<int64_t> prev(m + 1), cur(m + 1);
    for (int64_t j = 0; j <= m; ++j) prev[j] = j;
    for (int64_t i = 1; i <= n; ++i) {
        cur[0] = i;
        const int32_t ai = a[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            const int64_t sub = prev[j - 1] + (ai != b[j - 1]);
            cur[j] = std::min(sub, std::min(prev[j], cur[j - 1]) + 1);
        }
        std::swap(prev, cur);
    }
    return prev[m];
}

// Beam-limited edit distance between hypothesis a[0..n) and reference b[0..m),
// replicating tercom's pruning (sacrebleu's lib_ter):
// row i only evaluates columns within `beam` of the pseudo-diagonal
// floor(i * m/n), with the beam widened to ceil(ratio/2 + W) when the length
// ratio m/n exceeds 2W. The last row is evaluated to the end. Cells outside
// the beam stay at "infinity". NOTE: asymmetric (no operand swap) — the beam
// is defined relative to the hypothesis axis, exactly as tercom does it.
int64_t edit_distance_beam_i32(const int32_t* a, int64_t n, const int32_t* b, int64_t m,
                               int64_t beam_width) {
    if (n == 0) return m;
    if (m == 0) return n;
    const double ratio = static_cast<double>(m) / static_cast<double>(n);
    int64_t beam = beam_width;
    if (static_cast<double>(beam_width) < ratio / 2.0) {
        beam = static_cast<int64_t>(std::ceil(ratio / 2.0 + beam_width));
    }
    const int64_t INF = INT64_C(1) << 40;
    std::vector<int64_t> prev(m + 1, INF), cur(m + 1, INF);
    for (int64_t j = 0; j <= m; ++j) prev[j] = j;
    for (int64_t i = 1; i <= n; ++i) {
        std::fill(cur.begin(), cur.end(), INF);
        const int64_t diag = static_cast<int64_t>(std::floor(static_cast<double>(i) * ratio));
        const int64_t lo = std::max(INT64_C(0), diag - beam);
        const int64_t hi = (i == n) ? m + 1 : std::min(m + 1, diag + beam);
        const int32_t ai = a[i - 1];
        for (int64_t j = lo; j < hi; ++j) {
            if (j == 0) {
                cur[0] = prev[0] + 1;
                continue;
            }
            const int64_t sub = prev[j - 1] + (ai != b[j - 1]);
            cur[j] = std::min(sub, std::min(prev[j], cur[j - 1]) + 1);
        }
        std::swap(prev, cur);
    }
    return prev[m];
}

// Batch edit distance over packed sequences.
// a_data/b_data hold all tokens back to back; a_off/b_off are n_pairs+1 offsets.
void edit_distance_batch_i32(const int32_t* a_data, const int64_t* a_off,
                             const int32_t* b_data, const int64_t* b_off,
                             int64_t n_pairs, int64_t* out) {
    for (int64_t i = 0; i < n_pairs; ++i) {
        out[i] = edit_distance_i32(a_data + a_off[i], a_off[i + 1] - a_off[i],
                                   b_data + b_off[i], b_off[i + 1] - b_off[i]);
    }
}

}  // extern "C"
