// K2: merge of two sorted column-major runs (two-level merge path).
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
// n_out >= na + nb rows (the wrapper passes next_pow2(na + nb)) whose tail
// rows hold the all-ones sentinel key and payload 0.  Ties take A first, so
// the merge is stable (the bitonic network leaves tie order unset; any
// order is within the contract).
//
// What bounds it on the H100: bytes moved.  Every input row is read and
// every output row written once: (na + nb) * 4 * (w + p) bytes in and
// n_out * 4 * (w + p) out (w=2, p=0, 2 x 8,388,628 rows: 402,653,504
// bytes, 0.120 ms at 3.35 TB/s).  The bitonic network the TPU runs moves
// log2(n) times that, which Hopper need not pay: it can binary-search.
// Design (merge path in two levels):
//  * partition launch: one thread per tile boundary d = t * kTile binary
//    searches A and B in device memory for the split (i, d - i), the
//    smallest i with A[i] > B[d-1-i] (ties take A), into an int64 scratch
//    of tiles + 1 entries — ~log2(n) dependent loads per tile instead of
//    per 8 outputs.  The searches are latency, not bandwidth, so further
//    CTAs of the same launch write the sentinel tail [na + nb, n_out),
//    which needs no split: all-ones key words and zero payloads, 16-byte
//    stores, no loads;
//  * tile launch: CTA t owns outputs [t * kTile, (t+1) * kTile).  It
//    loads its A range and its B range (kTile rows between them) column
//    by column with coalesced loads into shared memory; each thread binary
//    searches its own split inside the tile in shared memory and merges
//    its kItems outputs sequentially (same tie rule), recording each
//    output's source row; per column, the outputs are gathered through
//    shared memory into blocked order and stored coalesced.  Shared memory
//    is padded one word per 32, so the blocked and striped accesses are
//    free of bank conflicts.  kTile = 128 threads x 8 outputs:
//    tools/sweep_variants.py timed 256 and 512 threads, 16 outputs a
//    thread, register caps and cache hints, none faster.  The staging
//    takes ncols x 4.1 KB (up to 34 KB at w=5 with 3 payloads), set as the
//    launch's dynamic shared memory;
//  * any na and nb (the main path's runs are chunk+halo rows, not powers of
//    two), the key width a template parameter (1..5 words) so comparisons
//    stay in registers; payload columns ride along uncompared.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 8;                   // outputs per thread
constexpr int kTile = kThreads * kItems;    // outputs per CTA
constexpr int kPadTile = kTile + kTile / 32;
constexpr int kMaxCols = 8;                 // 5 key words + 3 payloads
constexpr int kFillVecs = 2048;             // 16-byte stores per fill CTA and column
constexpr int kPartThreads = 128;

struct Cols {
  const uint32_t* a[kMaxCols];
  const uint32_t* b[kMaxCols];
  uint32_t* out[kMaxCols];
};

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

// A[i] <= B[j], lexicographic over W unsigned key words in device memory
template <int W>
__device__ __forceinline__ bool row_le(const Cols& cols, int64_t i, int64_t j) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const uint32_t p = cols.a[c][i];
    const uint32_t q = cols.b[c][j];
    if (p != q) return p < q;
  }
  return true;
}

template <int W>
__device__ __forceinline__ bool key_le(const uint32_t* x, const uint32_t* y) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (x[c] != y[c]) return x[c] < y[c];
  }
  return true;
}

// CTAs [0, part_ctas): parts[t] = the smallest i in [max(0, d - nb),
// min(d, na)] with A[i] > B[d-1-i], d = min(t * kTile, na + nb); CTAs past
// them: the sentinel fill of [na + nb, n_out), per column an unaligned
// head, a 16-byte body and a tail
template <int W>
__global__ void __launch_bounds__(kPartThreads)
merge_partition_kernel(Cols cols, int ncols, int64_t na, int64_t nb,
                       int64_t n_out, int64_t tiles, int64_t part_ctas,
                       int64_t* __restrict__ parts) {
  const int tid = threadIdx.x;
  if (static_cast<int64_t>(blockIdx.x) >= part_ctas) {
    const int64_t f = blockIdx.x - part_ctas;
    const int64_t total = na + nb;
    const int64_t m = n_out - total;
    for (int c = 0; c < ncols; ++c) {
      const uint32_t fill = c < W ? 0xFFFFFFFFu : 0u;
      uint32_t* o = cols.out[c] + total;
      const int64_t mis = (reinterpret_cast<uintptr_t>(o) >> 2) & 3;
      const int64_t head = mis ? (4 - mis < m ? 4 - mis : m) : 0;
      const int64_t vecs = (m - head) >> 2;
      uint4* o4 = reinterpret_cast<uint4*>(o + head);
      const uint4 q = make_uint4(fill, fill, fill, fill);
      for (int64_t v = f * kFillVecs + tid; v < (f + 1) * kFillVecs && v < vecs;
           v += kPartThreads) {
        o4[v] = q;
      }
      if (f == 0 && tid < 4) {
        if (tid < head) o[tid] = fill;
        const int64_t r = head + 4 * vecs + tid;
        if (r < m) o[r] = fill;
      }
    }
    return;
  }
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kPartThreads + tid;
  if (t > tiles) return;
  const int64_t d = t * kTile < na + nb ? t * kTile : na + nb;
  int64_t lo = d > nb ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row_le<W>(cols, mid, d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  parts[t] = lo;
}

// CTA t merges outputs [t * kTile, min((t+1) * kTile, na + nb))
template <int W>
__global__ void __launch_bounds__(kThreads)
merge_tiles_kernel(Cols cols, int ncols, int64_t na, int64_t nb,
                   const int64_t* __restrict__ parts) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int64_t total = na + nb;
  const int64_t t = blockIdx.x;
  const int64_t d0 = t * kTile;
  const int cnt = static_cast<int>((d0 + kTile < total ? d0 + kTile : total) - d0);
  const int64_t a0 = parts[t];
  const int64_t b0 = d0 - a0;
  const int ta = static_cast<int>(parts[t + 1] - a0);   // A rows of the tile
  const int tb = cnt - ta;                                // B rows of the tile

  // stage: A rows at [0, ta), B rows at [ta, cnt), one padded column each
  for (int c = 0; c < ncols; ++c) {
    const uint32_t* a = cols.a[c] + a0;
    const uint32_t* b = cols.b[c] + b0;
    uint32_t* s = smem + c * kPadTile;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int p = k * kThreads + tid;
      if (p < cnt) s[pad(p)] = p < ta ? a[p] : b[p - ta];
    }
  }
  __syncthreads();

  // this thread's split inside the tile, then its kItems outputs
  const int diag = tid * kItems < cnt ? tid * kItems : cnt;
  int lo = diag > tb ? diag - tb : 0;
  int hi = diag < ta ? diag : ta;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int pb = ta + diag - 1 - mid;
    bool le = true;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const uint32_t x = smem[c * kPadTile + pad(mid)];
      const uint32_t y = smem[c * kPadTile + pad(pb)];
      if (x != y) {
        le = x < y;
        break;
      }
    }
    if (le) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = diag - lo;
  uint32_t ak[W], bk[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    ak[c] = i < ta ? smem[c * kPadTile + pad(i)] : 0u;
    bk[c] = j < tb ? smem[c * kPadTile + pad(ta + j)] : 0u;
  }
  int src[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool take_a = j >= tb || (i < ta && key_le<W>(ak, bk));
    src[k] = take_a ? i : ta + j;
    i += take_a;
    j += !take_a;
    // reload the side that advanced, by selects rather than branches
    const int next = take_a ? i : ta + j;
    const bool ok = take_a ? i < ta : j < tb;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const uint32_t x = ok ? smem[c * kPadTile + pad(next)] : 0u;
      ak[c] = take_a ? x : ak[c];
      bk[c] = take_a ? bk[c] : x;
    }
  }

  // per column: gather the sources, put them in blocked order, store
  for (int c = 0; c < ncols; ++c) {
    uint32_t* s = smem + c * kPadTile;
    uint32_t v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) v[k] = diag + k < cnt ? s[pad(src[k])] : 0u;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (diag + k < cnt) s[pad(diag + k)] = v[k];
    }
    __syncthreads();
    uint32_t* o = cols.out[c] + d0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int p = k * kThreads + tid;
      if (p < cnt) o[p] = s[pad(p)];
    }
  }
}

int64_t merge_tiles_of(int64_t na, int64_t nb) {
  return (na + nb + kTile - 1) / kTile;
}

template <int W>
int launch(const Cols& cols, int ncols, int64_t na, int64_t nb,
           int64_t n_out, int64_t* parts, cudaStream_t s) {
  const int64_t tiles = merge_tiles_of(na, nb);
  const int64_t fill = n_out - (na + nb);
  const int64_t part_ctas =
      tiles > 0 ? (tiles + 1 + kPartThreads - 1) / kPartThreads : 0;
  const int64_t fill_ctas = (fill + 4 * kFillVecs - 1) / (4 * kFillVecs);
  merge_partition_kernel<W><<<static_cast<unsigned>(part_ctas + fill_ctas),
                              kPartThreads, 0, s>>>(
      cols, ncols, na, nb, n_out, tiles, part_ctas, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 0) return static_cast<int>(err);
  const int smem = ncols * kPadTile * static_cast<int>(sizeof(uint32_t));
  err = cudaFuncSetAttribute(merge_tiles_kernel<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_tiles_kernel<W><<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(
      cols, ncols, na, nb, parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partition scratch size in int64 entries: one per tile boundary
extern "C" int64_t kmerind_merge_runs_parts(int64_t na, int64_t nb) {
  return merge_tiles_of(na, nb) + 1;
}

// a_keys [w, na], b_keys [w, nb], out_keys [w, n_out] row-major (one row per
// key word); a_pay/b_pay/out_pay: npay pointers to int32 columns; parts:
// kmerind_merge_runs_parts(na, nb) int64 of scratch.
extern "C" int kmerind_merge_runs(const uint32_t* a_keys, int64_t na,
                                  const uint32_t* b_keys, int64_t nb, int w,
                                  const int32_t* a_pay0, const int32_t* a_pay1,
                                  const int32_t* a_pay2, const int32_t* b_pay0,
                                  const int32_t* b_pay1, const int32_t* b_pay2,
                                  int npay, uint32_t* out_keys,
                                  int32_t* out_pay0, int32_t* out_pay1,
                                  int32_t* out_pay2, int64_t n_out,
                                  int64_t* parts, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: return launch<1>(cols, ncols, na, nb, n_out, parts, s);
    case 2: return launch<2>(cols, ncols, na, nb, n_out, parts, s);
    case 3: return launch<3>(cols, ncols, na, nb, n_out, parts, s);
    case 4: return launch<4>(cols, ncols, na, nb, n_out, parts, s);
    default: return launch<5>(cols, ncols, na, nb, n_out, parts, s);
  }
}
