// gather_l2: fetch table[ids[b, k]] and return its squared L2 distance to
// queries[b], +inf where ids[b, k] < 0.
//
// Replaces src/repro/kernels/gather_l2/kernel.py::gather_l2_pallas (the
// scalar-prefetch row DMA + fused distance of one (query, candidate) pair
// per grid step).  On the H100 the pairs run in parallel: one warp per
// (b, k) pair reads the pair's id itself, loads the row with 16-byte
// float4 loads where d % 4 == 0 (scalar loads otherwise), sums squares in
// f32 and reduces across the warp with shuffles.  No lane padding: the
// 128-lane pad was a TPU layout constraint.
//
// Bound: bytes.  Each pair moves one d-float row (plus its id and one
// output float); the arithmetic is 3 flops per element.  The rows are
// data-dependent, so TMA (which moves tiles) does not apply; the later
// tool is cp.async / ld.global.nc pipelining of several rows per warp.
//
// Plain C interface, bound with ctypes: returns the cudaError_t of the
// launch (0 on success).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

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
  const long long id = ids[pair];  // int32 in memory, widened here
  if (id < 0 || id >= n_rows) {
    // an id past the table is a caller bug: NaN makes it visible
    if (lane == 0) out[pair] = id < 0 ? INFINITY : NAN;
    return;
  }
  const float* q = queries + (pair / k) * static_cast<long long>(d);
  const float* row = table + id * static_cast<long long>(d);
  float acc = 0.f;
  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int j = lane; j < d / 4; j += 32) {
      const float4 a = __ldg(q4 + j);
      const float4 c = __ldg(r4 + j);
      const float dx = a.x - c.x, dy = a.y - c.y;
      const float dz = a.z - c.z, dw = a.w - c.w;
      acc += dx * dx;
      acc += dy * dy;
      acc += dz * dz;
      acc += dw * dw;
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float diff = __ldg(q + j) - __ldg(row + j);
      acc += diff * diff;
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[pair] = acc;
}

}  // namespace

extern "C" int gather_l2_f32(const float* queries, const float* table,
                             const int32_t* ids, float* out, int b, int k,
                             int d, long long n_rows, int vec4,
                             void* stream) {
  const long long n_pairs = static_cast<long long>(b) * k;
  if (n_pairs == 0) return 0;
  const long long blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    gather_l2_kernel<true><<<grid, block, 0, s>>>(queries, table, ids, out,
                                                  n_pairs, k, d, n_rows);
  } else {
    gather_l2_kernel<false><<<grid, block, 0, s>>>(queries, table, ids, out,
                                                   n_pairs, k, d, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
