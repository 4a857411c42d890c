// SimHash codes and collision counts (paper §3.3, Eq. 4-5).
//
// simhash_encode: the sign bits of x @ proj^T packed 32 to a word, bit i of
//   word w = projection 32w+i, each word stored as the int64 value of the
//   reference's uint32 word.
// collision_count: m_bits - popcount(q ^ c) for every (query, code) pair.
// collision_count_rows: the same for each query against the rows
//   codes[ids[q, j]] of a code table, the form the traversal's prefilter
//   takes (it never builds a Q x N matrix).
//
// Replaces src/repro/kernels/simhash/kernel.py::simhash_encode_pallas (an
// MXU product, a VPU sign and a [32]-weight dot that packs the bits) and
// ::collision_count_pallas (XOR + population_count over [bq, bn, W]
// blocks).
//
// Encode.  A block owns a tile of 32 rows and one code word (32
// projections): the depth is walked in 32-wide slices staged in shared
// memory as f64, each of the 8 warps accumulates 4 rows, lane i the
// projection 32w+i, so `__ballot_sync(z >= 0)` is the word in the
// reference's bit order.  The sums are in f64: each f32 x f32 product is
// exact there, so the signs agree with the plain version (an f64 matmul)
// unless an exact dot product lies within an f64 rounding of zero, and
// -0.0 counts as >= 0 on both.  The sums run on the f64 FMA pipe (34
// TFLOP/s on an H100 SXM); the f64 tensor cores (DMMA, 67 TFLOP/s) do
// the same IEEE f64 FMAs and are the card's peak for the type, so the
// bound is taken there: operations, 2*N*m*d f64 flops against 4*N*d
// bytes of rows.
//
// Collisions.  The all-pairs kernel stages 16 query codes in shared
// memory and gives each thread one candidate code: it reads the code's
// words once and writes 16 counts, coalesced along the candidates.  The
// gathered kernel gives each (query, id) pair a thread that clamps its id
// into the table and reads one code row, 16 bytes a load where W is even
// (code_row.cuh).  Both count through `coderow::word_diff` (`__popc` of
// the low 32 bits of each word's XOR).  Bound: bytes (the int32 output of
// the all-pairs form; the ids, outputs and distinct code rows of the
// gathered form).  The gathered kernel's standalone time is its launch:
// the loop beam's trip, where it stood between the prefilter's masks and
// the gather, takes gather_l2.cu's prefilter_gather instead, and it
// serves the sampling cap (rho < 1), which ranks every count.
//
// Plain C interface, bound with ctypes: each entry point returns the
// cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <stdint.h>

#include "code_row.cuh"

namespace {

constexpr int kEncRows = 32;    // rows per encode tile (= bits per word)
constexpr int kEncDepth = 32;   // depth slice staged per iteration
constexpr int kEncWarps = 8;
constexpr int kRowsPerWarp = kEncRows / kEncWarps;
constexpr int kPairThreads = 256;  // candidate codes per all-pairs block
constexpr int kPairQueries = 16;   // query codes per all-pairs block
constexpr int kRowThreads = 256;

__global__ void __launch_bounds__(kEncWarps * 32)
simhash_encode_kernel(const float* __restrict__ x,
                      const float* __restrict__ proj,
                      long long* __restrict__ out, long long n, int d,
                      int words) {
  __shared__ double xs[kEncRows][kEncDepth];
  __shared__ double ps[kEncDepth][32 + 1];  // +1: conflict-free staging

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kEncRows;
  const int w = blockIdx.y;

  double z[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) z[i] = 0.0;

  for (int k0 = 0; k0 < d; k0 += kEncDepth) {
    // one pass stages both operands: kEncRows rows and 32 projections
    for (int e = tid; e < kEncRows * kEncDepth; e += kEncWarps * 32) {
      const int r = e / kEncDepth;
      const int kk = e % kEncDepth;
      const int gk = k0 + kk;
      const long long gr = row0 + r;
      xs[r][kk] = (gr < n && gk < d) ? static_cast<double>(x[gr * d + gk])
                                     : 0.0;
      ps[kk][r] = gk < d ? static_cast<double>(
                               proj[static_cast<long long>(32 * w + r) * d +
                                    gk])
                         : 0.0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kEncDepth; ++kk) {
      const double p = ps[kk][lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        z[i] = fma(xs[warp * kRowsPerWarp + i][kk], p, z[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const unsigned bits = __ballot_sync(0xffffffffu, z[i] >= 0.0);
    const long long gr = row0 + warp * kRowsPerWarp + i;
    if (lane == 0 && gr < n) {
      out[gr * words + w] = static_cast<long long>(bits);
    }
  }
}

__global__ void __launch_bounds__(kPairThreads)
collision_count_kernel(const long long* __restrict__ codes_q,
                       const long long* __restrict__ codes_c,
                       int32_t* __restrict__ out, int n_q, long long n_c,
                       int words, int m_bits) {
  extern __shared__ long long qs[];  // [kPairQueries][words]
  const int q0 = blockIdx.y * kPairQueries;
  const int nq = min(kPairQueries, n_q - q0);
  for (int e = threadIdx.x; e < nq * words; e += kPairThreads) {
    qs[e] = codes_q[static_cast<long long>(q0) * words + e];
  }
  __syncthreads();
  const long long c = static_cast<long long>(blockIdx.x) * kPairThreads +
                      threadIdx.x;
  if (c >= n_c) return;
  int ham[kPairQueries];
#pragma unroll
  for (int j = 0; j < kPairQueries; ++j) ham[j] = 0;
  for (int w = 0; w < words; ++w) {
    const long long cw = codes_c[c * words + w];
#pragma unroll
    for (int j = 0; j < kPairQueries; ++j) {
      if (j < nq) ham[j] += coderow::word_diff(qs[j * words + w], cw);
    }
  }
#pragma unroll
  for (int j = 0; j < kPairQueries; ++j) {
    if (j < nq) out[(q0 + j) * n_c + c] = m_bits - ham[j];
  }
}

__global__ void __launch_bounds__(kRowThreads)
collision_count_rows_kernel(const long long* __restrict__ code_q,
                            const long long* __restrict__ codes,
                            const int32_t* __restrict__ ids,
                            int32_t* __restrict__ out, long long n_pairs,
                            int n, int words, long long n_rows, int m_bits) {
  const long long p = static_cast<long long>(blockIdx.x) * kRowThreads +
                      threadIdx.x;
  if (p >= n_pairs) return;
  const long long q = p / n;
  long long id = ids[p];
  id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
  out[p] = m_bits - coderow::hamming(code_q + q * words, codes + id * words,
                                     words);
}

}  // namespace

extern "C" int simhash_encode_f32(const float* x, const float* proj,
                                  long long* out, long long n, int d,
                                  int words, void* stream) {
  if (n == 0 || words == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kEncRows - 1) / kEncRows),
                  static_cast<unsigned>(words));
  simhash_encode_kernel<<<grid, kEncWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, proj, out, n, d, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int collision_count_i64(const long long* codes_q,
                                   const long long* codes_c, int32_t* out,
                                   int n_q, long long n_c, int words,
                                   int m_bits, void* stream) {
  if (n_q == 0 || n_c == 0) return 0;
  const dim3 grid(
      static_cast<unsigned>((n_c + kPairThreads - 1) / kPairThreads),
      static_cast<unsigned>((n_q + kPairQueries - 1) / kPairQueries));
  const size_t smem = sizeof(long long) * kPairQueries * words;
  collision_count_kernel<<<grid, kPairThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      codes_q, codes_c, out, n_q, n_c, words, m_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int collision_count_rows_i64(const long long* code_q,
                                        const long long* codes,
                                        const int32_t* ids, int32_t* out,
                                        int n_q, int n, int words,
                                        long long n_rows, int m_bits,
                                        void* stream) {
  const long long n_pairs = static_cast<long long>(n_q) * n;
  if (n_pairs == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_pairs + kRowThreads - 1) / kRowThreads);
  collision_count_rows_kernel<<<blocks, kRowThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      code_q, codes, ids, out, n_pairs, n, words, n_rows, m_bits);
  return static_cast<int>(cudaGetLastError());
}
