// The lookups of a query batch over all runs of a shard: a count index's
// (run_count_lookup_kernel) and a de Bruijn graph's node lookup
// (run_vec_lookup_kernel).
//
// Replace no TPU kernel.  The JAX package looks each run up with XLA ops
// (kmerind_tpu/index/store.py::run_lookup_aux and ::run_vec_lookup: a
// while_loop binary search and gathers), and the port's plain versions
// (ops/kernels.py::run_count_lookup_plain, ::run_vec_lookup_plain: index/
// store.py::run_lookup_aux / ::run_vec_lookup_aux summed over the runs,
// clamped, masked) unroll each run's search on the host: one host read of
// the widest bucket a run, then ~15 elementwise launches a round that move
// [m] int64 bounds and a [w, m] gather through device memory — ~240
// launches a run, ~1,900 a query batch of an index of 8 runs, and the
// card idle between them.  These kernels compute the same answers in one
// launch for up to kMaxRuns runs.
//
// Contract: queries int32 [m, w] row-major (uint32 key words, word 0 most
// significant), valid bool [m]; per run r, ext int32 [w + 1, cap_r]
// column-major (its sorted key columns, then one int32 a row) and bstart
// int32 [2^tbits_r + 1] (the first row whose word 0 has top tbits >= b).
// lo is the lower bound of query i inside its bucket [bstart[b],
// bstart[b + 1]); the run holds the query's key when lo < cap and the key
// at lo equals it (a hit).
// * count: ext's last row holds each row's run total.  out[i] = the sum,
//   wrapping as int32, over the hit runs of the total at lo, then
//   min(sum, saturate) when has_sat; 0 where !valid[i].
// * graph: ext's last row holds each row's key-run length, bsum_r int32
//   [9, cap_r] the inclusive prefix sums of the rows' 9 counter streams
//   and (a quality graph) qcsum_r float64 [cap_r] those of their quality
//   sums.  On a hit, hi = min(lo + length at lo, cap) and counter c gets
//   bsum[c][hi - 1] - (lo > 0 ? bsum[c][lo - 1] : 0).  out int32 [m, 9]
//   row-major: the sums over the runs, wrapping, clamped as above, 0 where
//   !valid[i]; qout[i] the quality differences added in run order from
//   0.0 (the plain version's float64 operations, so its bits).
// More runs than kMaxRuns take further launches: `accumulate` adds to out
// (and qout), and only the last launch (`finish`) clamps and masks.
//
// What bounds them on the H100: random 32-byte reads.  A (query, run) pair
// is a chain of ~log2(live rows / 2^tbits) dependent probes, each one
// sector of word 0 at a random row (a tie on word 0 reads the next word),
// then the row at lo and, on a hit, its total: at the count cell's shape
// (581,632 queries, 8 runs of 16-22M live rows, ~9 probes) ~44M sectors,
// 1.4 GB, 0.42 ms at 3.35 TB/s.  So: one thread per query holds its key
// words in registers (widths 1-8 by template; wider keys read words 8..
// from device memory) and runs the runs' searches in lockstep
// (search_runs, shared by both kernels), each step issuing one
// independent probe for every run still open — up to kMaxRuns loads in
// flight a thread instead of one chain; later words are read, also in
// lockstep, only for the runs tied on the words before.  The bucket
// tables (256 KB a run at tbits 16) stay in L2.  No bound or temporary
// reaches device memory, and a thread stops when its own ranges have
// converged, so no round count is read on the host.  With that many loads
// in flight the rate of random sectors sets the time, not a thread's
// wait: at the count cell's shape the count kernel takes 1.8 ms (H100
// 80GB HBM3, 700 W), and 128 or 512 threads a block, or 2-4 blocks an SM
// forced by __launch_bounds__, move it by under 1 %.  The graph's
// epilogue adds, a hit run, the length row and two random table sectors a
// counter (one when both ends share a sector): the counter loop is
// unrolled and each counter issues every run's two loads before it sums
// any, so up to 2 x kMaxRuns loads are in flight a thread there too.  At
// the graph cell's shape (the same 8 runs, ~6.5 hit runs a query) it
// takes 3.1 ms, 35 % of its sector bound; one counter at a time takes
// 6 % longer, 128 threads a block no less, and 3 or 4 blocks an SM forced
// by __launch_bounds__ spill and take 4-11 % longer (H100 80GB HBM3,
// 700 W).  Positions are uint32: bstart is int32, so a run's rows fit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxRuns = 16;    // runs a launch takes (the parameter table)
constexpr int kRegWords = 8;    // query words held in registers
constexpr int kThreads = 256;

struct RunTable {
  const uint32_t* ext[kMaxRuns];
  const int32_t* bstart[kMaxRuns];
  uint32_t cap[kMaxRuns];       // 0 for the unused entries
  int shift[kMaxRuns];          // 32 - tbits
};

__device__ __forceinline__ int cmp32(uint32_t a, uint32_t b) {
  return a < b ? -1 : (a > b ? 1 : 0);
}

// c[r] = the order of run r's key at row pos[r] against the query (-1
// less, 0 equal, 1 greater), for every run with act[r]; word 0 (k0) is
// already read.  Each word is read, for all runs still tied, in one
// round of independent loads.
template <int W>
__device__ __forceinline__ void compare_rows(
    const RunTable& runs, const uint32_t (&pos)[kMaxRuns],
    const bool (&act)[kMaxRuns], const uint32_t (&k0)[kMaxRuns],
    const uint32_t (&qr)[kRegWords], const uint32_t* __restrict__ qrow,
    int w, int (&c)[kMaxRuns]) {
  bool tie = false;
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r) {
    c[r] = act[r] ? cmp32(k0[r], qr[0]) : 1;
    tie |= c[r] == 0;
  }
  constexpr int kReg = W ? W : kRegWords;
#pragma unroll
  for (int j = 1; j < kReg; ++j) {
    if (!tie) return;
    uint32_t kj[kMaxRuns];
#pragma unroll
    for (int r = 0; r < kMaxRuns; ++r)
      kj[r] = c[r] == 0
          ? __ldg(runs.ext[r] + static_cast<int64_t>(j) * runs.cap[r] + pos[r])
          : 0u;
    tie = false;
#pragma unroll
    for (int r = 0; r < kMaxRuns; ++r) {
      if (c[r] == 0) c[r] = cmp32(kj[r], qr[j]);
      tie |= c[r] == 0;
    }
  }
  if (W == 0) {
    for (int j = kRegWords; j < w && tie; ++j) {
      const uint32_t x = __ldg(qrow + j);
      uint32_t kj[kMaxRuns];
#pragma unroll
      for (int r = 0; r < kMaxRuns; ++r)
        kj[r] = c[r] == 0 ? __ldg(runs.ext[r]
                                  + static_cast<int64_t>(j) * runs.cap[r]
                                  + pos[r])
                          : 0u;
      tie = false;
#pragma unroll
      for (int r = 0; r < kMaxRuns; ++r) {
        if (c[r] == 0) c[r] = cmp32(kj[r], x);
        tie |= c[r] == 0;
      }
    }
  }
}

// Every run's lower bound of the query whose key words are qr (widths
// 1-8; a wider key reads words 8.. from qrow), all runs in lockstep from
// the query's bucket: lo[r] the lower bound in run r; run r holds the
// query's key (a hit) when act[r] && c[r] == 0.  Unused table entries
// (cap 0) never hit.
template <int W>
__device__ __forceinline__ void search_runs(
    const RunTable& runs, const uint32_t (&qr)[kRegWords],
    const uint32_t* __restrict__ qrow, int w, uint32_t (&lo)[kMaxRuns],
    bool (&act)[kMaxRuns], int (&c)[kMaxRuns]) {
  // each run's range: the query's bucket
  uint32_t hi[kMaxRuns];
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r) {
    if (runs.cap[r]) {
      const uint64_t b = static_cast<uint64_t>(qr[0]) >> runs.shift[r];
      lo[r] = static_cast<uint32_t>(__ldg(runs.bstart[r] + b));
      hi[r] = static_cast<uint32_t>(__ldg(runs.bstart[r] + b + 1));
    } else {
      lo[r] = hi[r] = 0;
    }
  }

  // lower bounds, all runs in lockstep: a step probes each open run once
  uint32_t k0[kMaxRuns], mid[kMaxRuns];
  bool open = true;
  while (open) {
#pragma unroll
    for (int r = 0; r < kMaxRuns; ++r) {
      act[r] = lo[r] < hi[r];
      mid[r] = lo[r] + ((hi[r] - lo[r]) >> 1);   // == (lo + hi) >> 1
      k0[r] = act[r] ? __ldg(runs.ext[r] + mid[r]) : 0u;
    }
    compare_rows<W>(runs, mid, act, k0, qr, qrow, w, c);
    open = false;
#pragma unroll
    for (int r = 0; r < kMaxRuns; ++r) {
      if (act[r]) {
        if (c[r] < 0) lo[r] = mid[r] + 1;
        else hi[r] = mid[r];
      }
      open |= lo[r] < hi[r];
    }
  }

  // the row at each lower bound: is it the query's key?
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r) {
    act[r] = lo[r] < runs.cap[r];
    k0[r] = act[r] ? __ldg(runs.ext[r] + lo[r]) : 0u;
  }
  compare_rows<W>(runs, lo, act, k0, qr, qrow, w, c);
}

// the query's first min(w, kRegWords) words (the rest 0)
template <int W>
__device__ __forceinline__ void load_query(const uint32_t* __restrict__ qrow,
                                           uint32_t (&qr)[kRegWords]) {
  constexpr int kReg = W ? W : kRegWords;
#pragma unroll
  for (int j = 0; j < kRegWords; ++j) qr[j] = j < kReg ? __ldg(qrow + j) : 0u;
}

// W: the key width 1-8, or 0 for any w > 8
template <int W>
__global__ void __launch_bounds__(kThreads)
run_count_lookup_kernel(const uint32_t* __restrict__ queries, int64_t m,
                        int w, const uint8_t* __restrict__ valid,
                        const __grid_constant__ RunTable runs,
                        int accumulate, int finish,
                        int has_sat, int64_t saturate,
                        int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  if (!valid[i]) {
    if (finish) out[i] = 0;
    return;
  }
  const uint32_t* qrow = queries + i * w;
  uint32_t qr[kRegWords];
  load_query<W>(qrow, qr);
  uint32_t lo[kMaxRuns];
  bool act[kMaxRuns];
  int c[kMaxRuns];
  search_runs<W>(runs, qr, qrow, w, lo, act, c);

  // the total at each lower bound that holds the query's key
  uint32_t total = accumulate ? static_cast<uint32_t>(out[i]) : 0u;
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r) {
    if (act[r] && c[r] == 0)
      total += static_cast<uint32_t>(__ldg(
          runs.ext[r] + static_cast<int64_t>(w) * runs.cap[r] + lo[r]));
  }
  int32_t t = static_cast<int32_t>(total);
  if (finish && has_sat && static_cast<int64_t>(t) > saturate)
    t = static_cast<int32_t>(saturate);
  out[i] = t;
}

// A graph run's counter tables: int32 [9, cap] inclusive prefix sums of
// the rows' 9 counter contributions, and (a quality graph's) float64
// [cap] inclusive prefix sums of the rows' quality sums.
struct VecTables {
  const int32_t* bsum[kMaxRuns];
  const double* qcsum[kMaxRuns];
};

constexpr int kCounters = 9;

// W as above; Q: the runs carry quality prefix sums (qout is written)
template <int W, bool Q>
__global__ void __launch_bounds__(kThreads)
run_vec_lookup_kernel(const uint32_t* __restrict__ queries, int64_t m, int w,
                      const uint8_t* __restrict__ valid,
                      const __grid_constant__ RunTable runs,
                      const __grid_constant__ VecTables tabs,
                      int accumulate, int finish, int has_sat,
                      int64_t saturate, int32_t* __restrict__ out,
                      double* __restrict__ qout) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  int32_t* orow = out + i * kCounters;
  if (!valid[i]) {
    if (finish) {
#pragma unroll
      for (int j = 0; j < kCounters; ++j) orow[j] = 0;
      if (Q) qout[i] = 0.0;
    }
    return;
  }
  const uint32_t* qrow = queries + i * w;
  uint32_t qr[kRegWords];
  load_query<W>(qrow, qr);
  uint32_t lo[kMaxRuns];
  bool act[kMaxRuns], hit[kMaxRuns];
  int c[kMaxRuns];
  search_runs<W>(runs, qr, qrow, w, lo, act, c);
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r) hit[r] = act[r] && c[r] == 0;

  // each hit's key run [lo, hi): its length is the row after the key words
  uint32_t hi[kMaxRuns];
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r) {
    hi[r] = 0;
    if (hit[r]) {
      const int64_t end = static_cast<int64_t>(lo[r]) + static_cast<int32_t>(
          __ldg(runs.ext[r] + static_cast<int64_t>(w) * runs.cap[r] + lo[r]));
      hi[r] = static_cast<uint32_t>(
          end < 0 ? 0 : (end > runs.cap[r] ? runs.cap[r] : end));
    }
  }

  // a counter's sum over the runs of (prefix at hi - 1) - (prefix at lo -
  // 1), a prefix before row 0 being 0: every run's two loads issued before
  // any is summed
#pragma unroll
  for (int j = 0; j < kCounters; ++j) {
    uint32_t a[kMaxRuns], b[kMaxRuns];
#pragma unroll
    for (int r = 0; r < kMaxRuns; ++r) {
      const int32_t* t = tabs.bsum[r] + static_cast<int64_t>(j) * runs.cap[r];
      a[r] = hit[r] && hi[r] ? static_cast<uint32_t>(__ldg(t + hi[r] - 1))
                             : 0u;
      b[r] = hit[r] && lo[r] ? static_cast<uint32_t>(__ldg(t + lo[r] - 1))
                             : 0u;
    }
    uint32_t sum = accumulate ? static_cast<uint32_t>(orow[j]) : 0u;
#pragma unroll
    for (int r = 0; r < kMaxRuns; ++r) sum += a[r] - b[r];
    int32_t v = static_cast<int32_t>(sum);
    if (finish && has_sat && static_cast<int64_t>(v) > saturate)
      v = static_cast<int32_t>(saturate);
    orow[j] = v;
  }
  if (Q) {
    // in run order from 0.0, one subtraction and one addition a hit run:
    // the plain version's float64 arithmetic, so its bits
    double a[kMaxRuns], b[kMaxRuns];
#pragma unroll
    for (int r = 0; r < kMaxRuns; ++r) {
      a[r] = hit[r] && hi[r] ? __ldg(tabs.qcsum[r] + hi[r] - 1) : 0.0;
      b[r] = hit[r] && lo[r] ? __ldg(tabs.qcsum[r] + lo[r] - 1) : 0.0;
    }
    double sum = accumulate ? qout[i] : 0.0;
#pragma unroll
    for (int r = 0; r < kMaxRuns; ++r)
      if (hit[r]) sum = __dadd_rn(sum, __dsub_rn(a[r], b[r]));
    qout[i] = sum;
  }
}

template <int W>
cudaError_t launch(const uint32_t* q, int64_t m, int w, const uint8_t* valid,
                   const RunTable& runs, int accumulate, int finish,
                   int has_sat, int64_t saturate, int32_t* out,
                   cudaStream_t stream) {
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  run_count_lookup_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(q, m, w, valid, runs, accumulate,
                                         finish, has_sat, saturate, out);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_vec(const uint32_t* q, int64_t m, int w,
                       const uint8_t* valid, const RunTable& runs,
                       const VecTables& tabs, int quality, int accumulate,
                       int finish, int has_sat, int64_t saturate,
                       int32_t* out, double* qout, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  if (quality)
    run_vec_lookup_kernel<W, true><<<blocks, kThreads, 0, stream>>>(
        q, m, w, valid, runs, tabs, accumulate, finish, has_sat, saturate,
        out, qout);
  else
    run_vec_lookup_kernel<W, false><<<blocks, kThreads, 0, stream>>>(
        q, m, w, valid, runs, tabs, accumulate, finish, has_sat, saturate,
        out, qout);
  return cudaGetLastError();
}

// f(std::integral_constant<int, W>) for the template of key width w
template <class F>
cudaError_t by_width(int w, F f) {
  switch (w) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return f(std::integral_constant<int, 0>());
  }
}

// The run table of runs [0, nruns); false for arguments the kernels do not
// take.
bool fill_runs(int64_t m, int w, const void* const* exts,
               const void* const* bstarts, const int64_t* caps,
               const int* tbits, int nruns, RunTable& runs) {
  if (m <= 0 || w < 1 || nruns < 0 || nruns > kMaxRuns ||
      (m + kThreads - 1) / kThreads > 0x7FFFFFFF)
    return false;
  runs = RunTable{};
  for (int r = 0; r < nruns; ++r) {
    if (caps[r] < 0 || caps[r] > 0x7FFFFFFF || tbits[r] < 0 || tbits[r] > 31)
      return false;
    runs.ext[r] = static_cast<const uint32_t*>(exts[r]);
    runs.bstart[r] = static_cast<const int32_t*>(bstarts[r]);
    runs.cap[r] = static_cast<uint32_t>(caps[r]);
    runs.shift[r] = 32 - tbits[r];
  }
  return true;
}

}  // namespace

extern "C" int kmerind_run_count_lookup_max_runs() { return kMaxRuns; }

// One launch over runs [0, nruns) of the tables (nruns <= kMaxRuns):
// exts[r] int32 [w + 1, caps[r]], bstarts[r] int32 [2^tbits[r] + 1].
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int kmerind_run_count_lookup(
    const void* queries, int64_t m, int w, const void* valid,
    const void* const* exts, const void* const* bstarts, const int64_t* caps,
    const int* tbits, int nruns, int accumulate, int finish, int has_sat,
    int64_t saturate, void* out, void* stream) {
  RunTable runs;
  if (!fill_runs(m, w, exts, bstarts, caps, tbits, nruns, runs))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* q = static_cast<const uint32_t*>(queries);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_width(w, [&](auto W) {
    return launch<decltype(W)::value>(q, m, w, v, runs, accumulate, finish,
                                      has_sat, saturate, o, s);
  }));
}

// The graph's node lookup, one launch over runs [0, nruns) as above, exts
// holding each key's run length in the row after its key words; bsums[r]
// int32 [9, caps[r]], and with `quality` qcsums[r] float64 [caps[r]].
// out int32 [m, 9] row-major; qout float64 [m] (only with quality).
extern "C" int kmerind_run_vec_lookup(
    const void* queries, int64_t m, int w, const void* valid,
    const void* const* exts, const void* const* bstarts,
    const void* const* bsums, const void* const* qcsums, const int64_t* caps,
    const int* tbits, int nruns, int quality, int accumulate, int finish,
    int has_sat, int64_t saturate, void* out, void* qout, void* stream) {
  RunTable runs;
  if (!fill_runs(m, w, exts, bstarts, caps, tbits, nruns, runs))
    return static_cast<int>(cudaErrorInvalidValue);
  VecTables tabs = {};
  for (int r = 0; r < nruns; ++r) {
    tabs.bsum[r] = static_cast<const int32_t*>(bsums[r]);
    tabs.qcsum[r] = quality ? static_cast<const double*>(qcsums[r]) : nullptr;
  }
  const uint32_t* q = static_cast<const uint32_t*>(queries);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* o = static_cast<int32_t*>(out);
  double* qo = static_cast<double*>(qout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_width(w, [&](auto W) {
    return launch_vec<decltype(W)::value>(q, m, w, v, runs, tabs, quality,
                                          accumulate, finish, has_sat,
                                          saturate, o, qo, s);
  }));
}
