// gather_l2: fetch table[ids[b, k]] and return its squared L2 distance to
// queries[b], +inf where ids[b, k] < 0.  gather_l2_q8: the same over an
// int8 table with one f32 scale per row, dequantised in registers.
//
// Replaces src/repro/kernels/gather_l2/kernel.py::gather_l2_pallas and
// ::gather_l2_q8_pallas (the scalar-prefetch row DMA + fused distance of
// one (query, candidate) pair per grid step).  On the H100 the pairs run
// in parallel: one warp per (b, k) pair reads the pair's id itself (int32
// in memory, widened here), and the row distance of row_dist.cuh sums it
// (float4 loads of f32 rows, char4 loads of int8 rows, where d % 4 == 0)
// and reduces across the warp with shuffles.  No lane padding: the
// 128-lane pad was a TPU layout constraint.
//
// Bound: bytes.  Each pair moves one row (4d bytes f32, d + 4 bytes int8
// with its scale), its id and one output float; the arithmetic is 3 (4
// with the dequantising product) flops per element.  The rows are
// data-dependent, so TMA (which moves tiles) does not apply; the later
// tool is cp.async / ld.global.nc pipelining of several rows per warp.
//
// Plain C interface, bound with ctypes: each entry point returns the
// cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "row_dist.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_l2_kernel(const float* __restrict__ queries,
                 const float* __restrict__ table,
                 const int32_t* __restrict__ ids, float* __restrict__ out,
                 long long n_pairs, int k, int d, long long n_rows) {
  const long long pair =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // the whole warp leaves together
  const long long id = ids[pair];
  if (id < 0 || id >= n_rows) {
    // an id past the table is a caller bug: NaN makes it visible
    if (lane == 0) out[pair] = id < 0 ? INFINITY : NAN;
    return;
  }
  const float acc = rowdist::l2_f32<kVec4>(
      queries + (pair / k) * static_cast<long long>(d),
      table + id * static_cast<long long>(d), d, lane);
  if (lane == 0) out[pair] = acc;
}

template <bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_l2_q8_kernel(const float* __restrict__ queries,
                    const int8_t* __restrict__ qtable,
                    const float* __restrict__ scales,
                    const int32_t* __restrict__ ids, float* __restrict__ out,
                    long long n_pairs, int k, int d, long long n_rows) {
  const long long pair =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;
  const long long id = ids[pair];
  if (id < 0 || id >= n_rows) {
    if (lane == 0) out[pair] = id < 0 ? INFINITY : NAN;
    return;
  }
  const float acc = rowdist::l2_q8<kVec4>(
      queries + (pair / k) * static_cast<long long>(d),
      qtable + id * static_cast<long long>(d), __ldg(scales + id), d, lane);
  if (lane == 0) out[pair] = acc;
}

dim3 grid_for(long long n_pairs) {
  const long long blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return dim3(static_cast<unsigned>(blocks));
}

}  // namespace

extern "C" int gather_l2_f32(const float* queries, const float* table,
                             const int32_t* ids, float* out, int b, int k,
                             int d, long long n_rows, int vec4,
                             void* stream) {
  const long long n_pairs = static_cast<long long>(b) * k;
  if (n_pairs == 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    gather_l2_kernel<true><<<grid_for(n_pairs), block, 0, s>>>(
        queries, table, ids, out, n_pairs, k, d, n_rows);
  } else {
    gather_l2_kernel<false><<<grid_for(n_pairs), block, 0, s>>>(
        queries, table, ids, out, n_pairs, k, d, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_l2_q8_f32(const float* queries, const int8_t* qtable,
                                const float* scales, const int32_t* ids,
                                float* out, int b, int k, int d,
                                long long n_rows, int vec4, void* stream) {
  const long long n_pairs = static_cast<long long>(b) * k;
  if (n_pairs == 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    gather_l2_q8_kernel<true><<<grid_for(n_pairs), block, 0, s>>>(
        queries, qtable, scales, ids, out, n_pairs, k, d, n_rows);
  } else {
    gather_l2_q8_kernel<false><<<grid_for(n_pairs), block, 0, s>>>(
        queries, qtable, scales, ids, out, n_pairs, k, d, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
