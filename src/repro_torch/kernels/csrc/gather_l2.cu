// gather_l2: fetch table[ids[b, k]] and return its squared L2 distance to
// queries[b], +inf where ids[b, k] < 0.  gather_l2_q8: the same over an
// int8 table with one f32 scale per row, dequantised in registers.
//
// Replaces src/repro/kernels/gather_l2/kernel.py::gather_l2_pallas and
// ::gather_l2_q8_pallas (the scalar-prefetch row DMA + fused distance of
// one (query, candidate) pair per grid step).  No lane padding: the
// 128-lane pad was a TPU layout constraint.
//
// Bound: bytes.  Each pair moves one row (4d bytes f32, d + 4 bytes int8
// with its scale), its id and one output float; the arithmetic is 3 (4
// with the dequantising product) flops per element.  The rows are
// data-dependent, so TMA (which moves tiles) does not apply; what the
// card needs is many rows in flight.
//
// gather_l2_kernel: one warp per (query, chunk of up to 8 ids).  Lanes
// 0..7 load the chunk's ids in one coalesced load and every lane takes
// them by shuffle; the warp reads the query row once (one float4 a lane
// at d = 128, in steps of 128 beyond), issues all 8 rows' loads before
// the first sum (rowdist::l2_f32_rows8, read-only cache), reduces the 8
// sums in one transposing butterfly and stores the chunk's outputs in
// one coalesced store.  Calls of at most 64 pairs (insert phase B's
// [1, 8] and [1, 16]) are latency-bound: one chain of dependent loads is
// the whole launch, and 8 warps with a row each end sooner than one with
// 8, so they take gather_l2_pair_kernel, a warp per pair.  Every sum
// keeps rowdist::l2_f32's order, so the bits equal the plain version's
// and beam.cu's, on either kernel.
//
// gather_l2_q8_kernel: one warp per (query, id) pair; the row distance
// of row_dist.cuh sums it (char4 loads of int8 rows where d % 4 == 0).
//
// What holds them back: latency.  At the main path's shapes a call is a
// launch and one or two chains of dependent loads (id, then row); the
// launch alone is over half of a [1000, 16] call (PERF.md §6).
//
// Plain C interface, bound with ctypes: each entry point returns the
// cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "row_dist.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;  // the kernels of a warp a pair
constexpr long long kPairCalls = 64;  // pairs up to which a call takes one

constexpr int kChunk = 8;         // ids per warp (rowdist::l2_f32_rows8)
constexpr int kGatherWarps = 4;   // warps per block of gather_l2_kernel

template <bool kVec4>
__global__ void __launch_bounds__(kGatherWarps * 32)
gather_l2_kernel(const float* __restrict__ queries,
                 const float* __restrict__ table,
                 const int32_t* __restrict__ ids, float* __restrict__ out,
                 long long n_warps, int k, int chunks, int d,
                 long long n_rows) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kGatherWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= n_warps) return;  // the whole warp leaves together
  const long long b = w / chunks;
  const int k0 = static_cast<int>(w % chunks) * kChunk;
  const int n_valid = min(kChunk, k - k0);
  const long long base = b * k + k0;
  const float* query = queries + b * static_cast<long long>(d);
  const int id = lane < n_valid ? __ldg(ids + base + lane) : -1;
  const float* rows[kChunk];  // a skipped slot reads the query row
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    const int idr = __shfl_sync(0xffffffffu, id, r);
    rows[r] = idr >= 0 && idr < n_rows
                  ? table + static_cast<long long>(idr) * d
                  : query;
  }
  const float acc = rowdist::l2_f32_rows8<kVec4>(query, rows, d, lane);
  const int r = rowdist::row_of_lane(lane);
  const int idr = __shfl_sync(0xffffffffu, id, r);
  // an id past the table is a caller bug: NaN makes it visible
  if ((lane & 3) == 0 && r < n_valid) {
    out[base + r] = idr < 0 ? INFINITY : (idr >= n_rows ? NAN : acc);
  }
}

// One warp per (query, id) pair: the latency-bound small calls (insert
// phase B's per-item connects, [1, 8] and [1, 16]), where a pair's chain
// (id load, row load, butterfly) is the whole launch and 8 warps each
// with one row finish sooner than one warp with 8.  The same sum as the
// chunked kernel's, so the same bits.
template <bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_l2_pair_kernel(const float* __restrict__ queries,
                      const float* __restrict__ table,
                      const int32_t* __restrict__ ids,
                      float* __restrict__ out, long long n_pairs, int k,
                      int d, long long n_rows) {
  const long long pair =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // the whole warp leaves together
  const long long id = __ldg(ids + pair);
  if (id < 0 || id >= n_rows) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pairs <= kPairCalls) {
    const dim3 block(kWarpsPerBlock * 32);
    if (vec4) {
      gather_l2_pair_kernel<true><<<grid_for(n_pairs), block, 0, s>>>(
          queries, table, ids, out, n_pairs, k, d, n_rows);
    } else {
      gather_l2_pair_kernel<false><<<grid_for(n_pairs), block, 0, s>>>(
          queries, table, ids, out, n_pairs, k, d, n_rows);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = (k + kChunk - 1) / kChunk;
  const long long n_warps = static_cast<long long>(b) * chunks;
  const dim3 grid(
      static_cast<unsigned>((n_warps + kGatherWarps - 1) / kGatherWarps));
  const dim3 block(kGatherWarps * 32);
  if (vec4) {
    gather_l2_kernel<true><<<grid, block, 0, s>>>(
        queries, table, ids, out, n_warps, k, chunks, d, n_rows);
  } else {
    gather_l2_kernel<false><<<grid, block, 0, s>>>(
        queries, table, ids, out, n_warps, k, chunks, d, n_rows);
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
