// K1: canonical k-mer extraction.
//
// Replaces kmerind_tpu/ops/pallas_kernels.py::extract_canonical_pallas
// (:189; kernel body _make_kernel :103, complement _complement_expr :61).
// Same contract as ops/packing.py::extract_canonical (the plain version):
// at every window start i, the k-mer codes[i:i+k] packed big-endian into
// nwords 32-bit words (kmer.py layout), its reverse complement under the
// alphabet's complement table, the lexicographically smaller of the two,
// and was_rc.  Rows past n-k are garbage.
//
// What bounds it on the H100: bytes moved.  It reads n code bytes and
// writes n * (4 * nwords + 1) bytes (k=21 DNA: 9 bytes per window); the
// arithmetic is O(k) shared-memory reads per window, far below what the
// SMs can issue.  Design for that:
//  * one CTA stages its tile of codes plus the (k-1) halo in shared memory
//    once, so every code byte is read from device memory once per tile;
//  * one thread per window; the strand choice compares the forward and
//    reverse-complement CHARACTER sequences up to the first difference
//    (word order equals character order, and most windows differ at the
//    first character), then packs only the chosen strand;
//  * words are written column-major ([nwords, n]): consecutive threads
//    write consecutive addresses of each word column (coalesced);
//  * the complement is a 256-entry table passed by value (kernel
//    parameter space), copied to shared memory: one code path for every
//    alphabet (DNA/RNA, DNA5/6, RNA5/6, DNA16, DNA_IUPAC, ASCII) instead of
//    the Pallas kernel's per-alphabet arithmetic.
// Unlike the TPU kernel, there is no [rows, 128] lane layout and no
// doubling pipeline: a CTA has no sequential grid to amortise, and a
// thread's O(k) loop over shared memory is cheaper than log2(k) passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // windows per CTA
constexpr int kMaxK = 512;      // same bound as the Pallas kernel

struct CompLut {
  uint8_t v[256];
};

__global__ void __launch_bounds__(kThreads)
extract_canonical_kernel(const uint8_t* __restrict__ codes, int64_t n,
                         CompLut lut_in, int k, int bits, int cpw,
                         int nwords, uint32_t* __restrict__ words,
                         bool* __restrict__ was_rc) {
  __shared__ uint8_t tile[kThreads + kMaxK - 1];
  __shared__ uint8_t lut[256];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  for (int t = threadIdx.x; t < 256; t += kThreads) lut[t] = lut_in.v[t];
  const int span = kThreads + k - 1;
  for (int t = threadIdx.x; t < span; t += kThreads) {
    const int64_t g = base + t;
    tile[t] = g < n ? codes[g] : 0;  // zero past the end, like the TPU pad
  }
  __syncthreads();
  const int64_t i = base + threadIdx.x;
  if (i >= n) return;
  const uint8_t* win = tile + threadIdx.x;

  // strand choice: lex_less(revcomp, forward) on the character sequences
  bool use_rc = false;
  for (int j = 0; j < k; ++j) {
    const uint32_t f = win[j];
    const uint32_t r = lut[win[k - 1 - j]];
    if (f != r) {
      use_rc = r < f;
      break;
    }
  }
  for (int w = 0; w < nwords; ++w) {
    const int c0 = w * cpw;
    const int nch = min(cpw, k - c0);
    uint32_t acc = 0;
    for (int j = 0; j < nch; ++j) {
      const int pos = c0 + j;
      const uint32_t c = use_rc ? lut[win[k - 1 - pos]] : win[pos];
      acc = (acc << bits) | c;
    }
    words[static_cast<int64_t>(w) * n + i] = acc;
  }
  was_rc[i] = use_rc;
}

}  // namespace

extern "C" int kmerind_extract_canonical(const uint8_t* codes, int64_t n,
                                         const uint8_t* comp_lut_host,
                                         int k, int bits, int cpw,
                                         int nwords, uint32_t* words,
                                         bool* was_rc, void* stream) {
  if (k < 1 || k > kMaxK || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CompLut lut;
  for (int t = 0; t < 256; ++t) lut.v[t] = comp_lut_host[t];
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  extract_canonical_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      codes, n, lut, k, bits, cpw, nwords, words, was_rc);
  return static_cast<int>(cudaGetLastError());
}
