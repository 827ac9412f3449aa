// K2: merge of two sorted column-major runs (merge path).
//
// Replaces the Pallas bitonic-merge family in
// kmerind_tpu/ops/pallas_kernels.py: _bitonic_merge_pallas_cols_2op (:877,
// first-stage kernel _make_first_stage2_2op_kernel :701) and
// _merge_stage_loop (:936; kernels _make_global_stage2_db_kernel :566,
// _make_global_stage2_kernel :505, _make_global_stage_kernel :455,
// _make_local_stages_kernel :795), as reached from
// sortops.merge_sorted_runs_cols.  Contract (ops/kernels.py::
// merge_runs_cols_plain is the plain version): runs A [w, na] and B [w, nb]
// ascending, compared lexicographically on w unsigned 32-bit key words,
// each carrying 0-3 int32 payload columns; the output is the merged run of
// n_out = next_pow2(na + nb) rows whose tail rows hold the all-ones
// sentinel key and payload 0.  Ties take A first, so the merge is stable
// (the bitonic network leaves tie order unset; any order is within the
// contract).
//
// What bounds it on the H100: bytes moved.  Every input row is read and
// every output row written once: (na + nb) * 4 * (w + p) bytes in and
// n_out * 4 * (w + p) out (w=2, 2^26 + 2^23 rows: ~1.6 GB, ~0.5 ms at
// 3.35 TB/s).  The bitonic network the TPU runs moves log2(n) times that,
// which Hopper need not pay: it can binary-search.  Design:
//  * merge path: thread t owns outputs [t*kItems, (t+1)*kItems); it binary
//    searches its diagonal d = t*kItems across A and B for the split
//    (i, j = d - i), then merges its kItems outputs sequentially;
//  * any na and nb (the main path's runs are chunk+halo rows, not powers
//    of two); the sentinel tail is written by the same threads;
//  * key width is a template parameter (1..5 words) so the comparison
//    stays in registers; payload columns ride along uncompared.
// The searches read O(log n) rows per thread through the L1/L2 caches and
// the per-thread output segments are strided across a warp; staging tiles
// in shared memory is the known next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;      // outputs per thread
constexpr int kMaxCols = 8;    // 5 key words + 3 payloads

struct Cols {
  const uint32_t* a[kMaxCols];
  const uint32_t* b[kMaxCols];
  uint32_t* out[kMaxCols];
};

// x[i] <= y[j], lexicographic over W unsigned key words
template <int W>
__device__ __forceinline__ bool row_le(const uint32_t* const* x, int64_t i,
                                       const uint32_t* const* y, int64_t j) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const uint32_t p = x[c][i];
    const uint32_t q = y[c][j];
    if (p != q) return p < q;
  }
  return true;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
merge_runs_kernel(Cols cols, int ncols, int64_t na, int64_t nb,
                  int64_t n_out) {
  const int64_t d0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kItems;
  if (d0 >= n_out) return;
  const int64_t total = na + nb;
  int64_t i = 0, j = 0;
  if (d0 < total) {
    // smallest i with A[i] > B[d0-1-i]: the count of A rows among the
    // first d0 outputs when ties take A
    int64_t lo = d0 > nb ? d0 - nb : 0;
    int64_t hi = d0 < na ? d0 : na;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (row_le<W>(cols.a, mid, cols.b, d0 - 1 - mid)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    i = lo;
    j = d0 - lo;
  }
  for (int s = 0; s < kItems; ++s) {
    const int64_t d = d0 + s;
    if (d >= n_out) break;
    if (d >= total) {
      for (int c = 0; c < ncols; ++c) cols.out[c][d] = c < W ? 0xFFFFFFFFu : 0u;
      continue;
    }
    const bool take_a = j >= nb || (i < na && row_le<W>(cols.a, i, cols.b, j));
    if (take_a) {
      for (int c = 0; c < ncols; ++c) cols.out[c][d] = cols.a[c][i];
      ++i;
    } else {
      for (int c = 0; c < ncols; ++c) cols.out[c][d] = cols.b[c][j];
      ++j;
    }
  }
}

}  // namespace

// a_keys [w, na], b_keys [w, nb], out_keys [w, n_out] row-major (one row per
// key word); a_pay/b_pay/out_pay: npay pointers to int32 columns.
extern "C" int kmerind_merge_runs(const uint32_t* a_keys, int64_t na,
                                  const uint32_t* b_keys, int64_t nb, int w,
                                  const int32_t* a_pay0, const int32_t* a_pay1,
                                  const int32_t* a_pay2, const int32_t* b_pay0,
                                  const int32_t* b_pay1, const int32_t* b_pay2,
                                  int npay, uint32_t* out_keys,
                                  int32_t* out_pay0, int32_t* out_pay1,
                                  int32_t* out_pay2, int64_t n_out,
                                  void* stream) {
  if (w < 1 || w > 5 || npay < 0 || npay > 3 || na < 0 || nb < 0 ||
      n_out < na + nb || n_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cols cols = {};
  for (int c = 0; c < w; ++c) {
    cols.a[c] = a_keys + c * na;
    cols.b[c] = b_keys + c * nb;
    cols.out[c] = out_keys + c * n_out;
  }
  const int32_t* ap[3] = {a_pay0, a_pay1, a_pay2};
  const int32_t* bp[3] = {b_pay0, b_pay1, b_pay2};
  int32_t* op[3] = {out_pay0, out_pay1, out_pay2};
  for (int p = 0; p < npay; ++p) {
    cols.a[w + p] = reinterpret_cast<const uint32_t*>(ap[p]);
    cols.b[w + p] = reinterpret_cast<const uint32_t*>(bp[p]);
    cols.out[w + p] = reinterpret_cast<uint32_t*>(op[p]);
  }
  const int ncols = w + npay;
  const int64_t threads = (n_out + kItems - 1) / kItems;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: merge_runs_kernel<1><<<blocks, kThreads, 0, s>>>(cols, ncols, na, nb, n_out); break;
    case 2: merge_runs_kernel<2><<<blocks, kThreads, 0, s>>>(cols, ncols, na, nb, n_out); break;
    case 3: merge_runs_kernel<3><<<blocks, kThreads, 0, s>>>(cols, ncols, na, nb, n_out); break;
    case 4: merge_runs_kernel<4><<<blocks, kThreads, 0, s>>>(cols, ncols, na, nb, n_out); break;
    default: merge_runs_kernel<5><<<blocks, kThreads, 0, s>>>(cols, ncols, na, nb, n_out); break;
  }
  return static_cast<int>(cudaGetLastError());
}
