// gather_l2: fetch table[ids[b, k]] and return its squared L2 distance to
// queries[b], +inf where ids[b, k] < 0.  gather_l2_q8: the same over an
// int8 table with one f32 scale per row, dequantised in registers.
// prefilter_gather: the loop beam's whole fetch of one trip, the SimHash
// prefilter (paper Eq. 5-6) and the gather of its survivors in one
// launch: fetch_mask = eligible & (m - hamming(code_q[b], codes[id]) >=
// thr[b]), and the distance of every survivor's row (+inf elsewhere),
// under the tier from the int8 lane for ids not resident.
//
// Replaces src/repro/kernels/gather_l2/kernel.py::gather_l2_pallas and
// ::gather_l2_q8_pallas (the scalar-prefetch row DMA + fused distance of
// one (query, candidate) pair per grid step) and, on the loop beam's
// path, the gathered form of src/repro/kernels/simhash/kernel.py::
// collision_count_pallas.  No lane padding: the 128-lane pad was a TPU
// layout constraint.
//
// Bound: bytes.  Each pair moves one row (4d bytes f32, d + 4 bytes int8
// with its scale), its id and one output float; the prefilter adds the
// eligible byte, the code row (8 W bytes), under the tier the resident
// byte, and the mask byte.  The arithmetic is 3 (4 with the dequantising
// product) flops per element.  The rows are data-dependent, so TMA
// (which moves tiles) does not apply; what the card needs is many rows
// in flight.
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
// fetch_kernel: the same layout with a prefilter round in front; it is
// prefilter_gather (over the f32 rows, or both lanes) and, with the
// prefilter off and every id cold, gather_l2_q8 (all 8 int8 rows in
// flight, rowdist::l2_q8_rows).  Three instances a load width.
//
// What holds them back: latency.  At the main path's shapes a call is a
// launch and one or two chains of dependent loads (id, then row; the
// prefilter adds the code row between them); the launch alone is over
// half of a [1000, 16] call (PERF.md §6).  prefilter_gather's answer is
// to take the launch, the separate count and the masks between them off
// the trip: one launch where the loop beam had eight or more.
//
// Plain C interface, bound with ctypes: each entry point returns the
// cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "code_row.cuh"
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

// What fetch_kernel does with a chunk of 8 (query, id) slots.
enum FetchMode {
  kPrefilterHot = 0,   // prefilter_gather over the f32 rows
  kPrefilterTier = 1,  // prefilter_gather over both lanes (tier)
  kColdOnly = 2,       // gather_l2_q8: no prefilter, every id cold
};

// One warp per (query, chunk of up to 8 ids), gather_l2_kernel's layout.
// Round 1: lanes 0..7 load the chunk's ids (and, under the prefilter,
// eligible bytes) in one coalesced load; each eligible lane counts its
// id's collisions against the query's code (coderow::hamming: one
// 16-byte load of the code row at W = 2) and tests the count against
// thr[q]; under the tier its resident byte and scale load beside the
// code row.  Round 2: a ballot gives the survivors, and the warp issues
// every survivor's row at once (a chunk without one reads no row); a
// skipped slot reads the query row.  The butterfly leaves the 8 sums in
// lanes lane & ~3, stored in one coalesced store, and lanes 0..7 store
// the 8 mask bytes in another.  Every sum keeps row_dist.cuh's order, so
// the bits equal the plain versions' and beam.cu's.
template <bool kVec4, int kMode>
__global__ void __launch_bounds__(kGatherWarps * 32)
fetch_kernel(const float* __restrict__ queries,
             const float* __restrict__ table,
             const int8_t* __restrict__ qtable,
             const float* __restrict__ scales,
             const uint8_t* __restrict__ resident,
             const long long* __restrict__ code_q,
             const long long* __restrict__ codes,
             const int32_t* __restrict__ ids,
             const uint8_t* __restrict__ eligible,
             const float* __restrict__ thr, uint8_t* __restrict__ mask_out,
             float* __restrict__ out, long long n_warps, int k, int chunks,
             int d, int words, int m_bits, long long n_rows,
             long long n_code_rows) {
  constexpr bool kFilter = kMode != kColdOnly;
  constexpr bool kCold = kMode != kPrefilterHot;
  const long long w =
      static_cast<long long>(blockIdx.x) * kGatherWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= n_warps) return;  // the whole warp leaves together
  const long long b = w / chunks;
  const int k0 = static_cast<int>(w % chunks) * kChunk;
  const int n_valid = min(kChunk, k - k0);
  const long long base = b * k + k0;
  const float* query = queries + b * static_cast<long long>(d);

  // -- round 1: one slot a lane --------------------------------------------
  int id = -1;
  bool pass = false, cold = false;
  float scale = 0.f;
  if (lane < n_valid) {
    id = __ldg(ids + base + lane);
    const bool in_table = id >= 0 && id < n_rows;
    if (kFilter) {
      if (__ldg(eligible + base + lane)) {
        // out-of-range ids count against a clamped row, as the plain
        // version's collision count does
        const long long c =
            id < 0 ? 0 : (id >= n_code_rows ? n_code_rows - 1 : id);
        if (kCold && in_table) {
          cold = !__ldg(resident + id);
          scale = __ldg(scales + id);
        }
        const int ham = coderow::hamming(code_q + b * words,
                                         codes + c * words, words);
        pass = static_cast<float>(m_bits - ham) >= __ldg(thr + b);
      }
    } else {
      pass = true;
      cold = in_table;
      if (in_table) scale = __ldg(scales + id);
    }
  }
  const bool fetch = pass && id >= 0 && id < n_rows;
  const unsigned fetch_bits = __ballot_sync(0xffffffffu, fetch);

  // -- round 2: every survivor's row in flight at once ---------------------
  float acc = 0.f;
  if (fetch_bits) {  // warp-uniform
    const unsigned cold_bits =
        kCold ? __ballot_sync(0xffffffffu, fetch && cold) : 0u;
    const float* rows[kChunk];
    const int8_t* qrows[kChunk];
    float sc[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const long long idr = __shfl_sync(0xffffffffu, id, r);
      const bool f = (fetch_bits >> r) & 1u, c = (cold_bits >> r) & 1u;
      rows[r] = f && !c ? table + idr * d : query;
      qrows[r] = f && c ? qtable + idr * d
                        : reinterpret_cast<const int8_t*>(query);
      sc[r] = __shfl_sync(0xffffffffu, scale, r);
    }
    if constexpr (kMode == kPrefilterHot) {
      acc = rowdist::l2_f32_rows8<kVec4>(query, rows, d, lane);
    } else if constexpr (kMode == kColdOnly) {
      float o[1];
      rowdist::l2_q8_rows<kChunk, kVec4>(query, qrows, sc, d, lane, o);
      acc = o[0];
    } else {
      acc = rowdist::l2_mixed_rows8<kVec4>(query, rows, qrows, sc,
                                           cold_bits, d, lane);
    }
  }

  // -- outputs: one store of the 8 distances, one of the 8 mask bytes ------
  const int r = rowdist::row_of_lane(lane);
  const int idr = __shfl_sync(0xffffffffu, id, r);
  const bool pr = __shfl_sync(0xffffffffu, static_cast<int>(pass), r);
  // an id past the table is a caller bug: NaN makes it visible
  if ((lane & 3) == 0 && r < n_valid) {
    out[base + r] = (fetch_bits >> r) & 1u
                        ? acc
                        : (pr && idr >= n_rows ? NAN : INFINITY);
  }
  if (kFilter && lane < n_valid) mask_out[base + lane] = pass;
}

template <int kMode>
int launch_fetch(bool vec4, const float* queries, const float* table,
                 const int8_t* qtable, const float* scales,
                 const uint8_t* resident, const long long* code_q,
                 const long long* codes, const int32_t* ids,
                 const uint8_t* eligible, const float* thr, uint8_t* mask,
                 float* out, int b, int k, int d, int words, int m_bits,
                 long long n_rows, long long n_code_rows, cudaStream_t s) {
  if (static_cast<long long>(b) * k == 0) return 0;
  const int chunks = (k + kChunk - 1) / kChunk;
  const long long n_warps = static_cast<long long>(b) * chunks;
  const dim3 grid(
      static_cast<unsigned>((n_warps + kGatherWarps - 1) / kGatherWarps));
  const dim3 block(kGatherWarps * 32);
  if (vec4) {
    fetch_kernel<true, kMode><<<grid, block, 0, s>>>(
        queries, table, qtable, scales, resident, code_q, codes, ids,
        eligible, thr, mask, out, n_warps, k, chunks, d, words, m_bits,
        n_rows, n_code_rows);
  } else {
    fetch_kernel<false, kMode><<<grid, block, 0, s>>>(
        queries, table, qtable, scales, resident, code_q, codes, ids,
        eligible, thr, mask, out, n_warps, k, chunks, d, words, m_bits,
        n_rows, n_code_rows);
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch_fetch<kColdOnly>(
      vec4 != 0, queries, nullptr, qtable, scales, nullptr, nullptr,
      nullptr, ids, nullptr, nullptr, nullptr, out, b, k, d, 0, 0, n_rows,
      0, static_cast<cudaStream_t>(stream));
}

// prefilter_gather: resident == nullptr takes the f32 rows alone, else
// both lanes (qtable, scales and resident of n_rows rows each).
extern "C" int prefilter_gather_f32(
    const float* queries, const float* table, const long long* code_q,
    const long long* codes, const int32_t* ids, const uint8_t* eligible,
    const float* thr, const uint8_t* resident, const int8_t* qtable,
    const float* scales, uint8_t* mask, float* out, int b, int k, int d,
    int words, int m_bits, long long n_rows, long long n_code_rows, int vec4,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident == nullptr) {
    return launch_fetch<kPrefilterHot>(
        vec4 != 0, queries, table, nullptr, nullptr, nullptr, code_q, codes,
        ids, eligible, thr, mask, out, b, k, d, words, m_bits, n_rows,
        n_code_rows, s);
  }
  return launch_fetch<kPrefilterTier>(
      vec4 != 0, queries, table, qtable, scales, resident, code_q, codes,
      ids, eligible, thr, mask, out, b, k, d, words, m_bits, n_rows,
      n_code_rows, s);
}
