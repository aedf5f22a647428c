// Copied from csrc/aligner.cc; built by hudiff_tpu_torch/native/__init__.py.
// Native Needleman-Wunsch kernel for consensus-anchored AHo alignment.
//
// Same semantics as hudiff_tpu_torch/numbering/align.py::align_to_aho_python's numpy DP:
// globally embed a query of n residues into m (=149) profile columns, no
// insertions, per-column match scores and skip costs. Exposed via a C ABI
// for ctypes (no pybind11 in this image).
//
// Built at first use by hudiff_tpu_torch/native/__init__.py (c++, -shared).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr float kNegInf = -1e30f;
}

extern "C" {

// Returns 0 on success, -1 if the query cannot be embedded.
// q_idx:    [n]   residue indices into the 20-letter alphabet, -1 for 'X'
// score:    [m*20] per-column profile match scores (row-major by column)
// skip:     [m]   cost of leaving a column empty
// out_cols: [m]   query index occupying each column, -1 if empty
// out_score: best total score
int hd_align(const int32_t* q_idx, int32_t n, const float* score,
             const float* skip, int32_t m, int32_t* out_cols,
             float* out_score) {
  if (n > m) return -1;
  const int W = m + 1;
  std::vector<float> dp(static_cast<size_t>(n + 1) * W, kNegInf);
  std::vector<int8_t> back(static_cast<size_t>(n + 1) * W, 0);

  dp[0] = 0.0f;
  for (int j = 1; j <= m; ++j) {
    dp[j] = dp[j - 1] - skip[j - 1];
    back[j] = 2;
  }
  for (int i = 1; i <= n; ++i) {
    const int32_t q = q_idx[i - 1];
    float* row = dp.data() + static_cast<size_t>(i) * W;
    const float* prev = dp.data() + static_cast<size_t>(i - 1) * W;
    int8_t* brow = back.data() + static_cast<size_t>(i) * W;
    for (int j = i; j <= m; ++j) {
      const float match = (q >= 0) ? score[(j - 1) * 20 + q] : 0.0f;
      const float diag = prev[j - 1] + match;
      const float skp = row[j - 1] - skip[j - 1];
      if (diag >= skp) {
        row[j] = diag;
        brow[j] = 1;
      } else {
        row[j] = skp;
        brow[j] = 2;
      }
    }
  }
  const float best = dp[static_cast<size_t>(n) * W + m];
  if (best <= kNegInf / 2) return -1;
  *out_score = best;
  for (int j = 0; j < m; ++j) out_cols[j] = -1;
  int i = n, j = m;
  while (j > 0) {
    if (back[static_cast<size_t>(i) * W + j] == 1) {
      out_cols[j - 1] = i - 1;
      --i;
    }
    --j;
  }
  return 0;
}

// Batched variant: nb queries, each padded to max_n with -2 terminators.
int hd_align_batch(const int32_t* q_idx, const int32_t* lens, int32_t nb,
                   int32_t max_n, const float* score, const float* skip,
                   int32_t m, int32_t* out_cols, float* out_scores) {
  int rc = 0;
  for (int b = 0; b < nb; ++b) {
    const int r = hd_align(q_idx + static_cast<size_t>(b) * max_n, lens[b],
                           score, skip, m,
                           out_cols + static_cast<size_t>(b) * m,
                           out_scores + b);
    if (r != 0) {
      out_scores[b] = kNegInf;
      rc = r;
    }
  }
  return rc;
}

}  // extern "C"
