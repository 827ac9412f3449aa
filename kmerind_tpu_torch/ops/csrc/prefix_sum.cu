// K3: inclusive int32 prefix sum.
//
// Replaces kmerind_tpu/ops/pallas_kernels.py::prefix_sum_pallas (:1090;
// kernel body _make_ps_kernel :1049), which index/store.py::_cumsum_i32
// dispatches to (run adoption of weighted runs, run_compact).  Contract
// (ops/kernels.py::prefix_sum_i32_plain is the plain version): out[i] =
// x[0] + ... + x[i], wrapping modulo 2^32 like the JAX package's int32 sums
// (the host code guards the 2^31 bound).
//
// What bounds it on the H100: bytes moved.  The minimum is one read and one
// write of n int32 (2^28 values: 2 GB, ~0.6 ms at 3.35 TB/s).  The TPU
// kernel carries the running total across its sequential grid in SMEM;
// CTAs on Hopper run in no order, so this is the three-launch
// reduce-then-scan form instead:
//  1. scan_tiles: each CTA scans a 2048-element tile in shared memory
//     (8 consecutive items per thread, warp shuffles, one pass over the
//     warp totals) and writes the tile-local scan plus the tile total;
//  2. scan_tile_sums: one CTA turns the tile totals into exclusive offsets
//     (n / 2048 values, a few hundred KB at 2^28);
//  3. add_offsets: every element of tile b gets offset b added.
// That moves about 4n words (read, write, read, write) — twice the
// single-pass minimum; a decoupled look-back scan would reach it.
// Arithmetic is uint32, so overflow wraps without undefined behaviour.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kSumThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
scan_tiles(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           int64_t n, uint32_t* __restrict__ tile_sums) {
  __shared__ uint32_t s[kTile];
  __shared__ uint32_t warp_tot[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int t = 0; t < kItems; ++t) {
    const int64_t g = base + t * kThreads + tid;
    s[t * kThreads + tid] = g < n ? x[g] : 0u;
  }
  __syncthreads();
  uint32_t loc[kItems];
  uint32_t acc = 0;
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    acc += s[tid * kItems + t];
    loc[t] = acc;
  }
  const uint32_t incl = warp_inclusive_scan(acc);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < kWarps ? warp_tot[lane] : 0u;
    v = warp_inclusive_scan(v);
    if (lane < kWarps) warp_tot[lane] = v;
  }
  __syncthreads();
  const uint32_t prefix = (incl - acc) + (warp > 0 ? warp_tot[warp - 1] : 0u);
#pragma unroll
  for (int t = 0; t < kItems; ++t) s[tid * kItems + t] = loc[t] + prefix;
  if (tid == kThreads - 1) tile_sums[blockIdx.x] = loc[kItems - 1] + prefix;
  __syncthreads();
  for (int t = 0; t < kItems; ++t) {
    const int64_t g = base + t * kThreads + tid;
    if (g < n) out[g] = s[t * kThreads + tid];
  }
}

// exclusive scan of the tile totals, in place, by one CTA
__global__ void __launch_bounds__(kSumThreads)
scan_tile_sums(uint32_t* __restrict__ sums, int64_t m) {
  __shared__ uint32_t warp_tot[kSumThreads / 32];
  __shared__ uint32_t carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < m; base += kSumThreads) {
    const int64_t g = base + tid;
    const uint32_t v = g < m ? sums[g] : 0u;
    const uint32_t incl = warp_inclusive_scan(v);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      warp_tot[lane] = warp_inclusive_scan(warp_tot[lane]);
    }
    __syncthreads();
    const uint32_t excl = (incl - v) + (warp > 0 ? warp_tot[warp - 1] : 0u) + carry;
    if (g < m) sums[g] = excl;
    __syncthreads();
    if (tid == 0) carry += warp_tot[kSumThreads / 32 - 1];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
add_offsets(uint32_t* __restrict__ out, int64_t n,
            const uint32_t* __restrict__ offsets) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n) return;
  const int64_t tile = g / kTile;
  if (tile > 0) out[g] += offsets[tile];
}

}  // namespace

extern "C" int64_t kmerind_prefix_sum_tiles(int64_t n) {
  return (n + kTile - 1) / kTile;
}

// tile_sums: scratch of kmerind_prefix_sum_tiles(n) int32
extern "C" int kmerind_prefix_sum_i32(const int32_t* x, int32_t* out,
                                      int64_t n, int32_t* tile_sums,
                                      void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  uint32_t* ts = reinterpret_cast<uint32_t*>(tile_sums);
  scan_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      reinterpret_cast<const uint32_t*>(x), o, n, ts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  scan_tile_sums<<<1, kSumThreads, 0, s>>>(ts, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  add_offsets<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(o, n, ts);
  return static_cast<int>(cudaGetLastError());
}
