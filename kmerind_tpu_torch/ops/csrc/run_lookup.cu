// The count lookup of a count index's query batch over all its runs.
//
// Replaces no TPU kernel.  The JAX package looks each run up with XLA ops
// (kmerind_tpu/index/store.py::run_lookup_aux: a while_loop binary search
// and a gather), and the port's plain version (ops/kernels.py::
// run_count_lookup_plain: index/store.py::run_lookup_aux summed over the
// runs, clamped, masked) unrolls each run's search on the host: one host
// read of the widest bucket a run, then ~15 elementwise launches a round
// that move [m] int64 bounds and a [w, m] gather through device memory —
// ~240 launches a run, ~1,900 a query batch of an index of 8 runs, and the
// card idle between them.  This kernel computes the same int32[m] in one
// launch for up to kMaxRuns runs.
//
// Contract: queries int32 [m, w] row-major (uint32 key words, word 0 most
// significant), valid bool [m]; per run r, ext int32 [w + 1, cap_r]
// column-major (its sorted key columns, then each row's run total) and
// bstart int32 [2^tbits_r + 1] (the first row whose word 0 has top tbits
// >= b).  out[i] = the sum, wrapping as int32, over the runs of the total
// at row lo — the lower bound of query i inside its bucket [bstart[b],
// bstart[b + 1]) — when lo < cap and the key at lo equals query i (0
// otherwise), then min(sum, saturate) when has_sat; 0 where !valid[i].
// More runs than kMaxRuns take further launches: `accumulate` adds to out,
// and only the last launch (`finish`) clamps and masks.
//
// What bounds it on the H100: random 32-byte reads.  A (query, run) pair
// is a chain of ~log2(live rows / 2^tbits) dependent probes, each one
// sector of word 0 at a random row (a tie on word 0 reads the next word),
// then the row at lo and, on a hit, its total: at the count cell's shape
// (581,632 queries, 8 runs of 16-22M live rows, ~9 probes) ~44M sectors,
// 1.4 GB, 0.42 ms at 3.35 TB/s.  So: one thread per query holds its key
// words in registers (widths 1-8 by template; wider keys read words 8..
// from device memory) and runs the runs' searches in lockstep, each step
// issuing one independent probe for every run still open — up to
// kMaxRuns loads in flight a thread instead of one chain; later words are
// read, also in lockstep, only for the runs tied on the words before.
// The bucket tables (256 KB a run at tbits 16) stay in L2.  No bound or
// temporary reaches device memory, and a thread stops when its own ranges
// have converged, so no round count is read on the host.  With that many
// loads in flight the rate of random sectors sets the time, not a
// thread's wait: at the cell's shape the kernel takes 1.8 ms (H100 80GB
// HBM3, 700 W), and 128 or 512 threads a block, or 2-4 blocks an SM
// forced by __launch_bounds__, move it by under 1 %.  Positions are
// uint32: bstart is int32, so a run's rows fit.

#include <cuda_runtime.h>
#include <stdint.h>

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
  constexpr int kReg = W ? W : kRegWords;
  uint32_t qr[kRegWords];
#pragma unroll
  for (int j = 0; j < kRegWords; ++j) qr[j] = j < kReg ? __ldg(qrow + j) : 0u;

  // each run's range: the query's bucket
  uint32_t lo[kMaxRuns], hi[kMaxRuns];
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
  bool act[kMaxRuns];
  int c[kMaxRuns];
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

  // the row at each lower bound, and its total where it is the query's key
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r) {
    act[r] = lo[r] < runs.cap[r];
    k0[r] = act[r] ? __ldg(runs.ext[r] + lo[r]) : 0u;
  }
  compare_rows<W>(runs, lo, act, k0, qr, qrow, w, c);
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
  if (m <= 0 || w < 1 || nruns < 0 || nruns > kMaxRuns ||
      (m + kThreads - 1) / kThreads > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  RunTable runs = {};
  for (int r = 0; r < nruns; ++r) {
    if (caps[r] < 0 || caps[r] > 0x7FFFFFFF || tbits[r] < 0 || tbits[r] > 31)
      return static_cast<int>(cudaErrorInvalidValue);
    runs.ext[r] = static_cast<const uint32_t*>(exts[r]);
    runs.bstart[r] = static_cast<const int32_t*>(bstarts[r]);
    runs.cap[r] = static_cast<uint32_t>(caps[r]);
    runs.shift[r] = 32 - tbits[r];
  }
  const uint32_t* q = static_cast<const uint32_t*>(queries);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w) {
    case 1: err = launch<1>(q, m, w, v, runs, accumulate, finish, has_sat, saturate, o, s); break;
    case 2: err = launch<2>(q, m, w, v, runs, accumulate, finish, has_sat, saturate, o, s); break;
    case 3: err = launch<3>(q, m, w, v, runs, accumulate, finish, has_sat, saturate, o, s); break;
    case 4: err = launch<4>(q, m, w, v, runs, accumulate, finish, has_sat, saturate, o, s); break;
    case 5: err = launch<5>(q, m, w, v, runs, accumulate, finish, has_sat, saturate, o, s); break;
    case 6: err = launch<6>(q, m, w, v, runs, accumulate, finish, has_sat, saturate, o, s); break;
    case 7: err = launch<7>(q, m, w, v, runs, accumulate, finish, has_sat, saturate, o, s); break;
    case 8: err = launch<8>(q, m, w, v, runs, accumulate, finish, has_sat, saturate, o, s); break;
    default: err = launch<0>(q, m, w, v, runs, accumulate, finish, has_sat, saturate, o, s);
  }
  return static_cast<int>(err);
}
