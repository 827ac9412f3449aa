// K4: run-length weights of sorted keys.
//
// Replaces kmerind_tpu/ops/pallas_kernels.py::run_length_weights_pallas
// (:351; kernel body _make_rl_kernel :267), which ops/sortops.py::
// run_length_counts dispatches to on the sorted index's local ingest
// (index/sorted_dist.py::make_local_ingest_step).  Contract
// (ops/kernels.py::run_length_weights_plain is the plain version): keys are
// w uint32 columns of n rows, sorted lexicographically with the first tv
// rows valid (tv read from device memory, so the host never waits for it);
// out[j] is the length of row j's run of equal keys when j is the run's last
// valid row (the next row differs, or j == tv - 1), else 0.
//
// What bounds it on the H100: bytes moved.  The minimum is one read of the
// w*n key words and one write of n int32 (w = 2 at 8.4M rows: ~100 MB,
// ~0.03 ms at 3.35 TB/s).  The TPU kernel carries the last run start
// across its sequential grid in SMEM; Hopper's CTAs run in no order, so:
//  1. rl_tiles: a CTA stages each key word of a 2048-row tile, plus the row
//     before and the row after it, in shared memory (coalesced loads),
//     marks heads and run ends, max-scans the head indices (8 rows per
//     thread, warp shuffles, one pass over the warp maxima) and writes every
//     run length whose run starts inside the tile, staged through shared
//     memory for coalesced stores.  It records the tile's largest head
//     index and the one run end that can precede the tile's first head (the
//     end of a run that started in an earlier tile).
//  2. rl_carry: one CTA max-scans the tile maxima in tile order and writes
//     the length of each such carried run end.
// Keys are read once and the output written once; the second launch reads
// two int64 per tile.  Row indices are int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kCarryThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int64_t warp_inclusive_max(int64_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = imax(v, y);
  }
  return v;
}

// max over the lanes before this one (-1 for lane 0), given inclusive maxima
__device__ __forceinline__ int64_t warp_exclusive_from(int64_t incl) {
  const int64_t y = __shfl_up_sync(kFull, incl, 1);
  return (threadIdx.x & 31) == 0 ? -1 : y;
}

__global__ void __launch_bounds__(kThreads)
rl_tiles(const uint32_t* __restrict__ keys, int w, int64_t n,
         const int32_t* __restrict__ total_valid, int32_t* __restrict__ out,
         int64_t* __restrict__ tile_max, int64_t* __restrict__ tile_open) {
  __shared__ uint32_t s[kTile + 2];   // s[0]: row base-1, s[1 + r]: row base+r
  __shared__ int64_t warp_max[kWarps];
  __shared__ int64_t open_end;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t tv = total_valid[0];
  unsigned dprev = 0;   // bit i: row tid*kItems+i differs from the row before
  unsigned dnext = 0;   // bit i: ... from the row after
  for (int c = 0; c < w; ++c) {
    const uint32_t* col = keys + static_cast<int64_t>(c) * n;
    for (int t = 0; t < kItems; ++t) {
      const int64_t g = base + t * kThreads + tid;
      s[1 + t * kThreads + tid] = g < n ? col[g] : 0u;
    }
    if (tid == 0) {
      s[0] = base > 0 ? col[base - 1] : 0u;
      s[kTile + 1] = base + kTile < n ? col[base + kTile] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int r = tid * kItems + i;
      const uint32_t x = s[1 + r];
      dprev |= static_cast<unsigned>(x != s[r]) << i;
      dnext |= static_cast<unsigned>(x != s[r + 2]) << i;
    }
    __syncthreads();
  }
  if (tid == 0) open_end = -1;
  int64_t loc[kItems];
  int64_t acc = -1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + tid * kItems + i;
    if (j < tv && (j == 0 || ((dprev >> i) & 1u))) acc = j;
    loc[i] = acc;
  }
  const int64_t incl = warp_inclusive_max(acc);
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t v = lane < kWarps ? warp_max[lane] : -1;
    v = warp_inclusive_max(v);
    if (lane < kWarps) warp_max[lane] = v;
  }
  __syncthreads();
  const int64_t prefix =
      imax(warp_exclusive_from(incl), warp > 0 ? warp_max[warp - 1] : -1);
  int32_t* so = reinterpret_cast<int32_t*>(s);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + tid * kItems + i;
    const bool end = j < tv && (j == tv - 1 || ((dnext >> i) & 1u));
    const int64_t start = imax(loc[i], prefix);
    so[tid * kItems + i] =
        end && start >= 0 ? static_cast<int32_t>(j - start + 1) : 0;
    if (end && start < 0) open_end = j;
  }
  __syncthreads();
  for (int t = 0; t < kItems; ++t) {
    const int64_t g = base + t * kThreads + tid;
    if (g < n) out[g] = so[t * kThreads + tid];
  }
  if (tid == 0) {
    tile_max[blockIdx.x] = warp_max[kWarps - 1];
    tile_open[blockIdx.x] = open_end;
  }
}

// one CTA: carry[b] = max head index of tiles < b; patch each carried end
__global__ void __launch_bounds__(kCarryThreads)
rl_carry(const int64_t* __restrict__ tile_max,
         const int64_t* __restrict__ tile_open, int64_t tiles,
         int32_t* __restrict__ out) {
  __shared__ int64_t warp_max[kCarryThreads / 32];
  __shared__ int64_t carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) carry = -1;
  __syncthreads();
  for (int64_t b0 = 0; b0 < tiles; b0 += kCarryThreads) {
    const int64_t g = b0 + tid;
    const int64_t v = g < tiles ? tile_max[g] : -1;
    const int64_t incl = warp_inclusive_max(v);
    if (lane == 31) warp_max[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_max[lane] = warp_inclusive_max(warp_max[lane]);
    __syncthreads();
    const int64_t excl = imax(
        imax(warp_exclusive_from(incl), warp > 0 ? warp_max[warp - 1] : -1),
        carry);
    if (g < tiles) {
      const int64_t j = tile_open[g];
      if (j >= 0) out[j] = static_cast<int32_t>(j - excl + 1);
    }
    __syncthreads();
    if (tid == 0) carry = imax(carry, warp_max[kCarryThreads / 32 - 1]);
    __syncthreads();
  }
}

}  // namespace

extern "C" int64_t kmerind_run_length_tiles(int64_t n) {
  return (n + kTile - 1) / kTile;
}

// keys: w columns of n uint32 ([w, n], one row per key word); total_valid:
// one int32 in device memory; scratch: 2 * kmerind_run_length_tiles(n) int64
extern "C" int kmerind_run_length_weights(const uint32_t* keys, int w,
                                          int64_t n,
                                          const int32_t* total_valid,
                                          int32_t* out, int64_t* scratch,
                                          void* stream) {
  if (n <= 0 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  rl_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      keys, w, n, total_valid, out, scratch, scratch + tiles);
  cudaError_t err = cudaGetLastError();
  // tile 0 has no carried end: its first valid row is a head
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  rl_carry<<<1, kCarryThreads, 0, s>>>(scratch, scratch + tiles, tiles, out);
  return static_cast<int>(cudaGetLastError());
}
