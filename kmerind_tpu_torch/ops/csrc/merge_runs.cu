// K2 / K2′: merge of two sorted runs (two-level merge path), any key width,
// any number of payloads, column-major or row-major keys.
//
// Replaces the Pallas bitonic-merge family in
// kmerind_tpu/ops/pallas_kernels.py: _bitonic_merge_pallas_cols_2op (:877,
// first-stage kernel _make_first_stage2_2op_kernel :701) and
// _merge_stage_loop (:936; kernels _make_global_stage2_db_kernel :566,
// _make_global_stage2_kernel :505, _make_global_stage_kernel :455,
// _make_local_stages_kernel :795), as reached from
// sortops.merge_sorted_runs_cols (K2, column-major keys [w, n]), and
// bitonic_merge_pallas (:832), as reached from sortops.merge_sorted_runs
// (K2′, row-major keys [n, w]).  Contract (ops/kernels.py::
// merge_runs_cols_plain is the plain version): runs A (na rows) and B (nb
// rows) ascending, compared lexicographically on w unsigned 32-bit key
// words, each carrying npay int32 payload columns; the output is the merged
// run of n_out >= na + nb rows (the wrapper passes next_pow2(na + nb))
// whose tail rows hold the all-ones sentinel key and payload 0.  Ties take A
// first, so the merge is stable (the bitonic network leaves tie order
// unset; any order is within the contract).
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
//  * tile launch: CTA t owns outputs [t * kTile, (t+1) * kTile).  It loads
//    its A range and its B range (kTile rows between them) column by column
//    with coalesced cp.async copies into shared memory, every column's in
//    flight at once (loads through registers wait a column at a time:
//    3-31 % slower, tools/sweep_variants.py); each thread binary searches
//    its own split inside the tile in shared memory and merges its kItems
//    outputs sequentially in registers (same tie rule), recording each
//    output's source row; per staged column, the outputs are gathered
//    through shared memory into blocked order and stored coalesced.  Shared
//    memory is padded one word per 32 (and skewed by 32 / P words between
//    key columns, for row-major loads), so the blocked and striped accesses
//    are free of bank conflicts.  kTile = 128 threads x 8 outputs:
//    tools/sweep_variants.py timed 256 and 512 threads, 16 outputs a
//    thread, register caps and cache hints, none faster;
//  * key width: a template parameter for 1..9 words (DNA k <= 128 has at
//    most 8, plus the flag column of full-word keys), so comparisons stay
//    in registers.  Wider keys take the runtime-width instantiation: it
//    stages the first kStaged words and, only where those tie, compares the
//    rest word by word from device memory (the tile's own rows, just
//    loaded, so mostly cache hits);
//  * the shared-memory budget: a tile stages its key words (at most 9) and
//    then payloads, up to kMaxStagedCols columns (12 x 4.2 KB, 51 KB).
//    Staging every column (ncols x 4.2 KB) would pass the 227 KB a CTA can
//    have at ~55 columns (ASCII k = 512 alone has 129 key columns), and a
//    smaller tile would multiply the partition searches.  So the columns
//    past the budget (key words past the staged ones, payloads past the
//    twelfth column) are not staged: they are gathered by source row from
//    device memory (the source rows in shared memory), kGatherBatch
//    columns at a time by cp.async into a buffer, then stored coalesced.
//    A warp's 32 outputs come from two short runs of consecutive rows, so
//    those gathers read whole 32-byte sectors, as coalesced loads would.
//    A tile with nothing to gather is its own instantiation, without that
//    code;
//  * columns without a cap: the key words of a run are one tensor, so a run
//    passes one pointer (column c of row r at c * n + r, or at r * w + c
//    for row-major keys); payloads come as a host table of column pointers.
//    The staged columns' pointers go to the kernel by value (computing them
//    there, base + c * n or a load from a table, measured 19-36 % slower on
//    the main path's shapes); the C entry copies the whole table into the
//    tail of the scratch (one small host-to-device copy) only where some
//    payload is gathered;
//  * layout a template parameter: row-major runs (K2′) load and store each
//    tile's rows as contiguous blocks of rows x w words, their payloads
//    gathered, so K2′ needs no transpose;
//  * any na and nb (the main path's runs are chunk+halo rows, not powers of
//    two).
//
// One bitonic run (kmerind_bitonic_merge): the counterpart of
// bitonic_merge_pallas (:832, row-major [n, w]) and
// bitonic_merge_pallas_cols (:848, column-major [w, n]), both through
// _bitonic_merge_pallas_cols (:859) and _merge_stage_loop (:936), as
// reached from sortops.bitonic_merge / bitonic_merge_cols.  Contract
// (ops/kernels.py::bitonic_merge_rows_plain / bitonic_merge_cols_plain,
// the JAX half-cleaner network, are the plain versions): n rows, an
// ascending prefix then a descending suffix, into exactly n sorted rows,
// payloads carried.  The same merge path with B read backwards from the
// input's own buffer, so nothing is flipped, sliced or copied and the host
// never learns where the prefix ends:
//  * split launch (after a memset of one scratch word): each thread
//    compares row i with row i - 1 (grid-stride, leaving at its first
//    descent), a block maximum of n - i, one atomicMax per block: the word
//    then holds nb, the length of the suffix from the first row smaller
//    than its predecessor (0 for a sorted run).  The partition launch
//    reads nb there; A is rows [0, n - nb), B row j is row n - 1 - j;
//  * the partition and tile launches are the two-run ones on those
//    addresses (template flag kRev, Args::brev, so the two-run merges
//    compile as before): a warp's reversed loads cover the same 128-byte
//    lines as forward ones, so the cp.async staging stays coalesced.
//    na + nb = n rows out: no sentinel fill;
//  * bound: n rows read and n written (w=2, one payload, n = 2^24: 402.7
//    MB, 0.120 ms); the split reads the key words once more up to the
//    first descent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 8;                   // outputs per thread
constexpr int kTile = kThreads * kItems;    // outputs per CTA
constexpr int kPadTile = kTile + kTile / 32;
constexpr int kMaxWidth = 9;                // widest key held in registers
constexpr int kStaged = 8;                  // staged key words, wider keys
constexpr int kMaxStagedCols = 12;          // key words + payloads staged
constexpr int kGatherBatch = 4;             // columns gathered at once
constexpr int kFillVecs = 2048;             // 16-byte stores per fill CTA and column
constexpr int kPartThreads = 128;
constexpr int kSplitThreads = 256;
constexpr int kSplitCtas = 132 * 8;         // 8 per SM, grid-stride

// shared-memory words between staged key columns: a padded tile plus 32 / P,
// so that the P words of 32 / P neighbouring rows (a warp's row-major load)
// fall in distinct banks
template <int P>
__host__ __device__ constexpr int col_stride() {
  return kPadTile + (P > 1 ? 32 / P : 0);
}

// the columns a column-major tile stages, by value: its staged key words,
// then its staged payloads
struct Cols {
  const uint32_t* a[kMaxStagedCols];
  const uint32_t* b[kMaxStagedCols];
  uint32_t* out[kMaxStagedCols];
};

struct Args {
  const uint32_t* a;         // A's key words: [w, lda] or [na, w]
  const uint32_t* b;         // B's key words: [w, ldb] or [.., w]
  uint32_t* out;             // [w, n_out] or [n_out, w]
  Cols cols;                 // column-major: the nstaged staged columns
  // device table of the payload columns (A's npay, B's npay, out's npay),
  // filled where some payload is not staged (npay > nstage)
  const uint32_t* const* pay;
  // where nb lies in device memory (one bitonic run: the split launch's
  // word), else null and nb is the length of B
  const int64_t* nb_dev;
  int64_t na, nb;
  int64_t total;             // na + nb, known to the host
  int64_t n_out;
  int64_t lda, ldb;          // rows of A's / B's buffer (column stride)
  int64_t brev;              // kRev: B row j is buffer row brev - j
  int w, npay;
  int nstage;                // payload columns a column-major tile stages
  int nstaged;               // staged columns: key words, then payloads
};

// B's row j in its buffer: row j, or (kRev: one bitonic run, B its
// suffix) read backwards from row brev
template <bool kRev>
__device__ __forceinline__ int64_t brow(const Args& g, int64_t j) {
  return kRev ? g.brev - j : j;
}

// payload column q of out (the fill of the sentinel tail writes it)
__device__ __forceinline__ uint32_t* pay_out(const Args& g, int q) {
  return q < g.nstage ? g.cols.out[g.nstaged - g.nstage + q]
                      : const_cast<uint32_t*>(g.pay[2 * g.npay + q]);
}

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

// one word from device to shared memory without passing through a
// register (cp.async), so a thread keeps every column's loads in flight;
// complete after cp_async_wait()
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// word c of row r of a run of n rows and w words
template <bool kRow>
__device__ __forceinline__ int64_t at(int64_t r, int c, int64_t n, int w) {
  return kRow ? r * w + c : static_cast<int64_t>(c) * n + r;
}

// A[i] <= B[j] on key words [c0, w) in device memory (W > 0: w == W)
template <int W, bool kRow, bool kRev>
__device__ __forceinline__ bool rows_le(const Args& g, int c0, int64_t i,
                                        int64_t j) {
  const int w = W > 0 ? W : g.w;
#pragma unroll
  for (int c = c0; c < (W > 0 ? W : w); ++c) {
    const uint32_t p = g.a[at<kRow>(i, c, g.lda, w)];
    const uint32_t q = g.b[at<kRow>(brow<kRev>(g, j), c, g.ldb, w)];
    if (p != q) return p < q;
  }
  return true;
}

template <int P>
__device__ __forceinline__ bool key_le(const uint32_t* x, const uint32_t* y) {
#pragma unroll
  for (int c = 0; c < P; ++c) {
    if (x[c] != y[c]) return x[c] < y[c];
  }
  return true;
}

// -1, 0, 1 as x <, ==, > y over P words
template <int P>
__device__ __forceinline__ int key_cmp(const uint32_t* x, const uint32_t* y) {
#pragma unroll
  for (int c = 0; c < P; ++c) {
    if (x[c] != y[c]) return x[c] < y[c] ? -1 : 1;
  }
  return 0;
}

// fill segment s of the sentinel tail: its first word, length and value
template <bool kRow>
__device__ __forceinline__ uint32_t* fill_segment(const Args& g, int s,
                                                  int64_t m, int64_t& len,
                                                  uint32_t& fill) {
  const int64_t total = g.total;
  const int kseg = kRow ? 1 : g.w;
  if (s < kseg) {
    fill = 0xFFFFFFFFu;
    len = kRow ? m * g.w : m;
    return kRow ? g.out + total * g.w : g.out + s * g.n_out + total;
  }
  fill = 0u;
  len = m;
  return pay_out(g, s - kseg) + total;
}

// CTAs [0, part_ctas): parts[t] = the smallest i in [max(0, d - nb),
// min(d, na)] with A[i] > B[d-1-i], d = min(t * kTile, na + nb) (kRev:
// nb from device memory, g.nb_dev, and na = total - nb); CTAs past them
// (none for kRev, whose output has na + nb rows): the sentinel fill of
// [na + nb, n_out), per segment (a key column, the row-major key block, a
// payload column) an unaligned head, a 16-byte body and a tail.  W = 0:
// runtime width.
template <int W, bool kRow, bool kRev>
__global__ void __launch_bounds__(kPartThreads)
merge_partition_kernel(Args g, int64_t tiles, int64_t part_ctas,
                       int64_t* __restrict__ parts) {
  const int tid = threadIdx.x;
  if (!kRev && static_cast<int64_t>(blockIdx.x) >= part_ctas) {
    const int64_t f = blockIdx.x - part_ctas;
    const int64_t m = g.n_out - g.total;
    const int nseg = (kRow ? 1 : g.w) + g.npay;
    for (int s = 0; s < nseg; ++s) {
      int64_t len;
      uint32_t fill;
      uint32_t* o = fill_segment<kRow>(g, s, m, len, fill);
      const int64_t mis = (reinterpret_cast<uintptr_t>(o) >> 2) & 3;
      const int64_t head = mis ? (4 - mis < len ? 4 - mis : len) : 0;
      const int64_t vecs = (len - head) >> 2;
      uint4* o4 = reinterpret_cast<uint4*>(o + head);
      const uint4 q = make_uint4(fill, fill, fill, fill);
      for (int64_t v = f * kFillVecs + tid; v < (f + 1) * kFillVecs && v < vecs;
           v += kPartThreads) {
        o4[v] = q;
      }
      if (f == 0 && tid < 4) {
        if (tid < head) o[tid] = fill;
        const int64_t r = head + 4 * vecs + tid;
        if (r < len) o[r] = fill;
      }
    }
    return;
  }
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kPartThreads + tid;
  if (t > tiles) return;
  const int64_t nb = kRev ? *g.nb_dev : g.nb;
  const int64_t na = g.total - nb;
  const int64_t d = t * kTile < g.total ? t * kTile : g.total;
  int64_t lo = d > nb ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (rows_le<W, kRow, kRev>(g, 0, mid, d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  parts[t] = lo;
}

// CTA t merges outputs [t * kTile, min((t+1) * kTile, na + nb)).  P key
// words are staged and compared in registers; kTail: the key has more
// (g.w > P), compared from device memory where the P staged words tie.
// Column-major tiles also stage g.nstage payload columns.  kGather: some
// column is not staged (row-major keys, key words past P, payloads past
// g.nstage) and is gathered by source row; without it the kernel holds no
// gather code, whose registers would cost occupancy.  kRev: B is read
// backwards (brow).
template <int P, bool kTail, bool kRow, bool kGather, bool kRev>
__global__ void __launch_bounds__(kThreads)
merge_tiles_kernel(Args g, const int64_t* __restrict__ parts) {
  static_assert(kGather || !(kTail || kRow), "those tiles gather");
  constexpr int kCol = col_stride<P>();
  extern __shared__ uint32_t smem[];
  const int nstaged = kRow ? P : g.nstaged;
  int* srcs = reinterpret_cast<int*>(smem + nstaged * kCol);
  const int tid = threadIdx.x;
  const int w = kTail ? g.w : P;
  const int64_t total = g.total;
  const int64_t t = blockIdx.x;
  const int64_t d0 = t * kTile;
  const int cnt = static_cast<int>((d0 + kTile < total ? d0 + kTile : total) - d0);
  const int64_t a0 = parts[t];
  const int64_t b0 = d0 - a0;
  const int ta = static_cast<int>(parts[t + 1] - a0);   // A rows of the tile
  const int tb = cnt - ta;                                // B rows of the tile

  // stage key words [0, P) (and, column-major, payloads [0, g.nstage)):
  // A rows at [0, ta), B rows at [ta, cnt), one padded column each
  if constexpr (!kRow) {
    constexpr int bstep = kRev ? -1 : 1;
    for (int c = 0; c < nstaged; ++c) {
      const uint32_t* a = g.cols.a[c] + a0;
      const uint32_t* b = g.cols.b[c] + brow<kRev>(g, b0);
      uint32_t* s = smem + c * kCol;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int p = k * kThreads + tid;
        if (p < cnt) {
          cp_async4(s + pad(p), p < ta ? a + p : b + bstep * (p - ta));
        }
      }
    }
  } else {
    // the tile's A rows, then its B rows, as one range of cnt * P words
    // (contiguous blocks of ta * w and tb * w words when w == P)
#pragma unroll 8
    for (int k = 0; k < kItems * P; ++k) {
      const int e = k * kThreads + tid;
      if (e < cnt * P) {
        const int p = e / P;
        const int c = e - p * P;
        cp_async4(smem + c * kCol + pad(p),
                  p < ta ? g.a + (a0 + p) * w + c
                         : g.b + brow<kRev>(g, b0 + p - ta) * w + c);
      }
    }
  }
  cp_async_wait();
  __syncthreads();

  // A row i of the tile <= B row j, on the words past the staged ones
  auto tail_le = [&](int i, int j) {
    return rows_le<0, kRow, kRev>(g, P, a0 + i, b0 + j);
  };

  // this thread's split inside the tile, then its kItems outputs
  const int diag = tid * kItems < cnt ? tid * kItems : cnt;
  int lo = diag > tb ? diag - tb : 0;
  int hi = diag < ta ? diag : ta;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int pb = ta + diag - 1 - mid;
    bool le = true, tie = true;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const uint32_t x = smem[c * kCol + pad(mid)];
      const uint32_t y = smem[c * kCol + pad(pb)];
      if (x != y) {
        le = x < y;
        tie = false;
        break;
      }
    }
    if constexpr (kTail) {
      if (tie) le = tail_le(mid, pb - ta);
    }
    if (le) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = diag - lo;
  uint32_t ak[P], bk[P];
#pragma unroll
  for (int c = 0; c < P; ++c) {
    ak[c] = i < ta ? smem[c * kCol + pad(i)] : 0u;
    bk[c] = j < tb ? smem[c * kCol + pad(ta + j)] : 0u;
  }
  int src[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    bool take_a;
    if constexpr (kTail) {
      take_a = j >= tb;
      if (!take_a && i < ta) {
        const int cmp = key_cmp<P>(ak, bk);
        take_a = cmp < 0 || (cmp == 0 && tail_le(i, j));
      }
    } else {
      take_a = j >= tb || (i < ta && key_le<P>(ak, bk));
    }
    src[k] = take_a ? i : ta + j;
    i += take_a;
    j += !take_a;
    // reload the side that advanced, by selects rather than branches
    const int next = take_a ? i : ta + j;
    const bool ok = take_a ? i < ta : j < tb;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const uint32_t x = ok ? smem[c * kCol + pad(next)] : 0u;
      ak[c] = take_a ? x : ak[c];
      bk[c] = take_a ? bk[c] : x;
    }
  }
  if constexpr (kGather) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (diag + k < cnt) srcs[pad(diag + k)] = src[k];
    }
  }
  if constexpr (!kRow) {
    // per staged column: gather the sources, put them in blocked order,
    // store (the first barrier also publishes srcs)
    for (int c = 0; c < nstaged; ++c) {
      uint32_t* s = smem + c * kCol;
      uint32_t v[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) v[k] = diag + k < cnt ? s[pad(src[k])] : 0u;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (diag + k < cnt) s[pad(diag + k)] = v[k];
      }
      __syncthreads();
      uint32_t* o = g.cols.out[c] + d0;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int p = k * kThreads + tid;
        if (p < cnt) o[p] = s[pad(p)];
      }
    }
  } else {
    __syncthreads();
    if constexpr (!kTail) {
      // rows [d0, d0 + cnt) are one block of cnt * P words
      uint32_t* o = g.out + d0 * P;
#pragma unroll 8
      for (int k = 0; k < kItems * P; ++k) {
        const int e = k * kThreads + tid;
        if (e < cnt * P) {
          const int p = e / P;
          const int c = e - p * P;
          o[e] = smem[c * kCol + pad(srcs[pad(p)])];
        }
      }
    } else {
      uint32_t* o = g.out + d0 * w;
      for (int e = tid; e < cnt * w; e += kThreads) {
        const int p = e / w;
        const int c = e - p * w;
        const int s = srcs[pad(p)];
        o[e] = c < P ? smem[c * kCol + pad(s)]
                     : s < ta ? g.a[(a0 + s) * w + c]
                              : g.b[brow<kRev>(g, b0 + s - ta) * w + c];
      }
    }
  }
  if constexpr (kGather) {
    // the columns past the staged ones (column-major key words past P,
    // then payloads past g.nstage), gathered by source row, kGatherBatch
    // at a time: each thread copies its striped outputs' source words into
    // a buffer by cp.async, so a batch's loads are all in flight without
    // holding registers, and stores them once its own copies have landed
    // (no barrier: a thread reads back only what it copied)
    const int nkeys = kRow ? 0 : w - P;
    const int q0 = kRow ? 0 : g.nstage;
    const int ncols = nkeys + g.npay - q0;
    uint32_t* buf = reinterpret_cast<uint32_t*>(srcs + kPadTile);
    for (int c0 = 0; c0 < ncols; c0 += kGatherBatch) {
      const int nc = ncols - c0 < kGatherBatch ? ncols - c0 : kGatherBatch;
      for (int c = 0; c < nc; ++c) {
        const int i = c0 + c;
        const uint32_t* a =
            i < nkeys ? g.a + (P + i) * g.lda : g.pay[q0 + i - nkeys];
        const uint32_t* b =
            i < nkeys ? g.b + (P + i) * g.ldb : g.pay[g.npay + q0 + i - nkeys];
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int p = k * kThreads + tid;
          if (p < cnt) {
            const int s = srcs[pad(p)];
            cp_async4(buf + c * kTile + p,
                      s < ta ? a + a0 + s
                             : b + brow<kRev>(g, b0 + s - ta));
          }
        }
      }
      cp_async_wait();
      for (int c = 0; c < nc; ++c) {
        const int i = c0 + c;
        uint32_t* o = (i < nkeys ? g.out + (P + i) * g.n_out
                                 : const_cast<uint32_t*>(
                                       g.pay[2 * g.npay + q0 + i - nkeys])) +
                      d0;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int p = k * kThreads + tid;
          if (p < cnt) o[p] = buf[c * kTile + p];
        }
      }
    }
  }
}

// *nb = the largest n - i over rows i in [1, n) smaller than row i - 1:
// the length of the suffix from the first descent, 0 where there is none
// (*nb is 0 before).  A thread leaves at its first descent (its later rows
// give smaller n - i); a block's maximum goes out in one atomicMax.
template <int W, bool kRow>
__global__ void __launch_bounds__(kSplitThreads)
bitonic_split_kernel(const uint32_t* __restrict__ keys, int64_t n, int w_rt,
                     unsigned long long* __restrict__ nb) {
  const int w = W > 0 ? W : w_rt;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSplitThreads;
  unsigned long long best = 0;
  for (int64_t i = 1 + static_cast<int64_t>(blockIdx.x) * kSplitThreads +
                   threadIdx.x;
       i < n; i += stride) {
    uint32_t x = keys[at<kRow>(i, 0, n, w)];
    uint32_t y = keys[at<kRow>(i - 1, 0, n, w)];
    for (int c = 1; c < w && x == y; ++c) {
      x = keys[at<kRow>(i, c, n, w)];
      y = keys[at<kRow>(i - 1, c, n, w)];
    }
    if (x < y) {
      best = static_cast<unsigned long long>(n - i);
      break;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long v = __shfl_xor_sync(0xFFFFFFFFu, best, o);
    best = v > best ? v : best;
  }
  __shared__ unsigned long long warp_best[kSplitThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kSplitThreads / 32; ++k) {
      best = warp_best[k] > best ? warp_best[k] : best;
    }
    if (best) atomicMax(nb, best);
  }
}

int64_t merge_tiles_of(int64_t total) {
  return (total + kTile - 1) / kTile;
}

template <int P, bool kTail, bool kRow, bool kGather, bool kRev>
int launch_tiles(const Args& g, int64_t tiles, int64_t* parts,
                 cudaStream_t s) {
  // the staged columns and, where columns are gathered, the source rows
  // and the gather buffer: up to 12 padded columns, one more and 4 tiles,
  // 71 KB
  const int smem = ((kRow ? P : g.nstaged) * col_stride<P>() +
                    (kGather ? kPadTile + kGatherBatch * kTile : 0)) *
                   static_cast<int>(sizeof(uint32_t));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_tiles_kernel<P, kTail, kRow, kGather, kRev>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_tiles_kernel<P, kTail, kRow, kGather, kRev>
      <<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(g, parts);
  return static_cast<int>(cudaGetLastError());
}

template <int P, bool kTail, bool kRow, bool kRev>
int launch(const Args& g, int64_t* parts, cudaStream_t s) {
  if constexpr (kRev) {
    // one bitonic run: nb from the split launch (A and B are one buffer)
    cudaError_t err = cudaMemsetAsync(const_cast<int64_t*>(g.nb_dev), 0,
                                      sizeof(int64_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t rows = g.total - 1;
    const int64_t ctas = (rows + kSplitThreads - 1) / kSplitThreads;
    if (ctas > 0) {
      bitonic_split_kernel<kTail ? 0 : P, kRow>
          <<<static_cast<unsigned>(ctas < kSplitCtas ? ctas : kSplitCtas),
             kSplitThreads, 0, s>>>(
              g.a, g.total, g.w,
              reinterpret_cast<unsigned long long*>(
                  const_cast<int64_t*>(g.nb_dev)));
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const int64_t tiles = merge_tiles_of(g.total);
  const int64_t m = g.n_out - g.total;
  const int64_t longest = kRow ? m * g.w : m;      // longest fill segment
  const int64_t part_ctas =
      tiles > 0 ? (tiles + 1 + kPartThreads - 1) / kPartThreads : 0;
  const int64_t fill_ctas = (longest + 4 * kFillVecs - 1) / (4 * kFillVecs);
  merge_partition_kernel<kTail ? 0 : P, kRow, kRev>
      <<<static_cast<unsigned>(part_ctas + fill_ctas), kPartThreads, 0, s>>>(
          g, tiles, part_ctas, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 0) return static_cast<int>(err);
  if constexpr (kTail || kRow) {
    return launch_tiles<P, kTail, kRow, true, kRev>(g, tiles, parts, s);
  } else {
    return g.npay > g.nstage
               ? launch_tiles<P, kTail, kRow, true, kRev>(g, tiles, parts, s)
               : launch_tiles<P, kTail, kRow, false, kRev>(g, tiles, parts,
                                                           s);
  }
}

template <bool kRow, bool kRev>
int launch_width(const Args& g, int64_t* parts, cudaStream_t s) {
  static_assert(kMaxWidth == 9 && kStaged <= kMaxWidth, "cases below");
  static_assert(kMaxStagedCols >= kMaxWidth, "every key word staged");
  switch (g.w) {
    case 1: return launch<1, false, kRow, kRev>(g, parts, s);
    case 2: return launch<2, false, kRow, kRev>(g, parts, s);
    case 3: return launch<3, false, kRow, kRev>(g, parts, s);
    case 4: return launch<4, false, kRow, kRev>(g, parts, s);
    case 5: return launch<5, false, kRow, kRev>(g, parts, s);
    case 6: return launch<6, false, kRow, kRev>(g, parts, s);
    case 7: return launch<7, false, kRow, kRev>(g, parts, s);
    case 8: return launch<8, false, kRow, kRev>(g, parts, s);
    case 9: return launch<9, false, kRow, kRev>(g, parts, s);
    default: return launch<kStaged, true, kRow, kRev>(g, parts, s);
  }
}

// the staged columns (column-major) and the device payload table of g,
// whose runs, lengths and strides are set, then the launches; pays: host
// table of 3 * npay column pointers (A's, B's, out's), table: room for it
// in the scratch
int run(Args& g, int row_major, const void* const* pays, int64_t* parts,
        int64_t* table, cudaStream_t s) {
  // column-major: the staged key words (all of them up to kMaxWidth, else
  // kStaged), then as many payloads as fit kMaxStagedCols
  const int w = g.w, npay = g.npay;
  const int p = w <= kMaxWidth ? w : kStaged;
  g.nstage = row_major ? 0 : (npay < kMaxStagedCols - p ? npay
                                                        : kMaxStagedCols - p);
  g.nstaged = row_major ? 0 : p + g.nstage;
  for (int c = 0; c < g.nstaged; ++c) {
    const int q = c - p;                 // the payload, past the key words
    g.cols.a[c] = c < p ? g.a + c * g.lda
                        : static_cast<const uint32_t*>(pays[q]);
    g.cols.b[c] = c < p ? g.b + c * g.ldb
                        : static_cast<const uint32_t*>(pays[npay + q]);
    g.cols.out[c] = c < p ? g.out + c * g.n_out
                          : static_cast<uint32_t*>(
                                const_cast<void*>(pays[2 * npay + q]));
  }
  if (npay > g.nstage) {
    // pageable host-to-device: CUDA stages the copy, so `pays` may go
    // once this returns; ordered before the launches on the stream
    const cudaError_t err = cudaMemcpyAsync(
        table, pays, 3 * static_cast<size_t>(npay) * sizeof(void*),
        cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  g.pay = reinterpret_cast<const uint32_t* const*>(table);
  if (g.nb_dev) {
    return row_major ? launch_width<true, true>(g, parts, s)
                     : launch_width<false, true>(g, parts, s);
  }
  return row_major ? launch_width<true, false>(g, parts, s)
                   : launch_width<false, false>(g, parts, s);
}

}  // namespace

// partition scratch size in int64 entries: one per tile boundary (the
// scratch a call takes is this plus 3 * npay, room for the payload table)
extern "C" int64_t kmerind_merge_runs_parts(int64_t na, int64_t nb) {
  return merge_tiles_of(na + nb) + 1;
}

// a_keys [w, na] / b_keys [w, nb] / out_keys [w, n_out] column-major (one
// row per key word), or with row_major [na, w] / [nb, w] / [n_out, w];
// pays: host table of 3 * npay int32 column pointers (A's npay, B's npay,
// out's npay); scratch: kmerind_merge_runs_parts(na, nb) + 3 * npay int64.
extern "C" int kmerind_merge_runs(const uint32_t* a_keys, int64_t na,
                                  const uint32_t* b_keys, int64_t nb, int w,
                                  int row_major, const void* const* pays,
                                  int npay, uint32_t* out_keys, int64_t n_out,
                                  int64_t* scratch, void* stream) {
  if (w < 1 || npay < 0 || na < 0 || nb < 0 || n_out < na + nb ||
      n_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args g = {};
  g.a = a_keys;
  g.b = b_keys;
  g.out = out_keys;
  g.na = na;
  g.nb = nb;
  g.total = na + nb;
  g.n_out = n_out;
  g.lda = na;
  g.ldb = nb;
  g.w = w;
  g.npay = npay;
  return run(g, row_major, pays, scratch,
             scratch + kmerind_merge_runs_parts(na, nb),
             static_cast<cudaStream_t>(stream));
}

// scratch of kmerind_bitonic_merge in int64 entries: the tile boundaries,
// the split word, room for the payload table
extern "C" int64_t kmerind_bitonic_merge_scratch(int64_t n, int npay) {
  return merge_tiles_of(n) + 2 + 3 * static_cast<int64_t>(npay);
}

// one bitonic run (ascending rows, then descending) of n >= 1 rows sorted
// into out_keys: keys / out_keys [w, n] column-major, or with row_major [n,
// w]; pays: host table of 3 * npay int32 column pointers (the inputs, the
// inputs again — B is read from A's buffer —, the outputs); scratch:
// kmerind_bitonic_merge_scratch(n, npay) int64.  Ties take the prefix
// first.
extern "C" int kmerind_bitonic_merge(const uint32_t* keys, int64_t n, int w,
                                     int row_major, const void* const* pays,
                                     int npay, uint32_t* out_keys,
                                     int64_t* scratch, void* stream) {
  if (w < 1 || npay < 0 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = merge_tiles_of(n);
  Args g = {};
  g.a = keys;
  g.b = keys;
  g.out = out_keys;
  g.nb_dev = scratch + tiles + 1;
  g.total = n;
  g.n_out = n;
  g.lda = n;
  g.ldb = n;
  g.brev = n - 1;
  g.w = w;
  g.npay = npay;
  return run(g, row_major, pays, scratch, scratch + tiles + 2,
             static_cast<cudaStream_t>(stream));
}
