// l2_distance: dense squared L2 distances [Q, N] between query rows and
// candidate rows, max(|q|^2 + |c|^2 - 2 q.c, 0) in f32.
//
// Replaces src/repro/kernels/l2_distance/kernel.py::l2_distance_pallas
// (128x128 MXU tiles of the same decomposition).  Here a block owns a
// 64x64 output tile: the depth is walked in 16-wide slices staged in
// shared memory, each of the 256 threads accumulates a 4x4 register tile
// with FFMA (no TF32: the result stays close to the f32 reference), and
// threads 0..127 accumulate the 64 query and 64 candidate row norms from
// the same staged slices.  Ragged Q, N and d are masked in the kernel
// (zero fill on load, no store past the edge), so the host pads nothing.
//
// Bound: operations.  2*Q*N*d flops against 4*(Q*N + (Q+N)*d) bytes;
// at the bulk-build and ground-truth shapes the f32 FMA rate is the
// limit.  The faster form is a wgmma/TMA pipeline, later.
//
// Plain C interface, bound with ctypes: returns the cudaError_t of the
// launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;   // output rows and columns per block
constexpr int kDepth = 16;  // depth slice staged per iteration
constexpr int kThreads = 256;
constexpr int kMicro = 4;   // each thread owns a 4x4 output tile
constexpr int kPad = 4;     // keeps float4 alignment of the staged rows

__global__ void __launch_bounds__(kThreads)
l2_distance_kernel(const float* __restrict__ q, const float* __restrict__ c,
                   float* __restrict__ out, int n_q, int n_c, int d) {
  __shared__ __align__(16) float qs[kDepth][kTile + kPad];
  __shared__ __align__(16) float cs[kDepth][kTile + kPad];
  __shared__ float q_norm[kTile];
  __shared__ float c_norm[kTile];

  const int tid = threadIdx.x;
  const int tx = tid % (kTile / kMicro);  // column group
  const int ty = tid / (kTile / kMicro);  // row group
  const long long row0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;
  }
  float norm = 0.f;  // tid < 64: |q_row|^2; 64 <= tid < 128: |c_row|^2

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    // stage a [64 x 16] slice of each operand, transposed to [16][64]
    for (int e = tid; e < kTile * kDepth; e += kThreads) {
      const int r = e / kDepth;
      const int kk = e % kDepth;
      const int gk = k0 + kk;
      const long long gq = row0 + r;
      const long long gc = col0 + r;
      qs[kk][r] = (gq < n_q && gk < d) ? q[gq * d + gk] : 0.f;
      cs[kk][r] = (gc < n_c && gk < d) ? c[gc * d + gk] : 0.f;
    }
    __syncthreads();
    if (tid < kTile) {
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) norm += qs[kk][tid] * qs[kk][tid];
    } else if (tid < 2 * kTile) {
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        norm += cs[kk][tid - kTile] * cs[kk][tid - kTile];
      }
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[kk][ty * kMicro]);
      const float4 b = *reinterpret_cast<const float4*>(&cs[kk][tx * kMicro]);
      const float av[kMicro] = {a.x, a.y, a.z, a.w};
      const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }
  if (tid < kTile) {
    q_norm[tid] = norm;
  } else if (tid < 2 * kTile) {
    c_norm[tid - kTile] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int lr = ty * kMicro + i;
    const long long gr = row0 + lr;
    if (gr >= n_q) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int lc = tx * kMicro + j;
      const long long gc = col0 + lc;
      if (gc >= n_c) continue;
      const float v = q_norm[lr] + c_norm[lc] - 2.f * acc[i][j];
      out[gr * n_c + gc] = fmaxf(v, 0.f);
    }
  }
}

}  // namespace

extern "C" int l2_distance_f32(const float* q, const float* c, float* out,
                               int n_q, int n_c, int d, void* stream) {
  if (n_q == 0 || n_c == 0) return 0;
  const dim3 grid((n_c + kTile - 1) / kTile, (n_q + kTile - 1) / kTile);
  l2_distance_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, c, out, n_q, n_c, d);
  return static_cast<int>(cudaGetLastError());
}
