// l2_distance: dense squared L2 distances [Q, N] between query rows and
// candidate rows, max(|q|^2 + |c|^2 - 2 q.c, 0) in f32.  NaN stays NaN,
// as in the plain version (`torch.clamp_min`, the reference's
// `jnp.maximum`): a row of +inf gives inf - inf = NaN there, which the
// sharded flat index maps to +inf (its padding rows).
//
// Replaces src/repro/kernels/l2_distance/kernel.py::l2_distance_pallas
// (128x128 MXU tiles of the same decomposition).
//
// Bound: operations at the ground-truth shape (2*Q*N*d flops against
// 4*(Q*N + (Q+N)*d) bytes), and close to balanced at the bulk build's
// [64, placed] blocks, whose output and candidate bytes need about as
// long as their flops.  The products stay strict f32 on the FMA pipe (no
// TF32: integer-valued data must give the plain version's bits), so the
// design is an FFMA GEMM pipeline:
//
//   * Two tile shapes, one template instance each, chosen per launch:
//     128x256 output tiles with an 8x16 register tile per thread (256
//     threads, one block an SM) where Q > 64, and 64x64 tiles with 8x4
//     per thread (128 threads, four blocks an SM) where Q <= 64: every
//     bulk-build block, a [64, placed] call of placed/64 tiles.  The
//     small tile keeps the build's short calls short: a tile is the
//     latency of a call that fills fewer than all SMs, and the calls
//     above that are decided by the SM's FFMA rate, not the tile size.
//     Tile t is row tile t % row_tiles of column tile t / row_tiles, so
//     the row tiles of one column tile run together and the candidate
//     rows come from device memory once.
//   * Persistent blocks, as many as the card holds at once: block b
//     takes tiles b, b + grid, ..., and its slices run through one ring
//     across its tiles, so a tile's first loads and last stores overlap
//     its neighbours' products.
//   * The depth is walked in 16-wide slices through a two-slot ring in
//     (dynamic) shared memory, one barrier a slice: slice s + 1 is in
//     flight while slice s is multiplied.  Where d % 4 == 0 and the rows
//     are 16-byte aligned the slices arrive by cp.async 16-byte copies
//     (zero-filled past the ragged edges); otherwise by scalar loads,
//     stored as they land.
//   * A staged slice is row-major, 16 depths padded to 20 floats, read
//     as float4 runs of 4 depths (the depth is the fast axis where the
//     outer product reads it).  A thread owns the rows ty + 16i (ty + 8i
//     on the 64-row tile) and the columns tx + 16j, so the 8 threads of
//     a float4 phase read 8 consecutive padded rows, which fall in 8
//     distinct 16-byte bank groups: no conflicts, and a warp's query
//     rows are two broadcasts.  A thread loads all its fragments of 4
//     depths, then runs 4 outer products of independent FFMAs: each
//     LDS.128 feeds about 21 FFMAs on the 8x16 tile and 11 on the 8x4.
//   * Row norms are computed once per row: the query norms (and, for the
//     128-row tile, the candidate norms) by row_norms_kernel before the
//     tiles; the 64-row tile, the only row tile of its launch, sums its
//     candidate norms from the slices it stages anyway.
//
// What holds it back: the rate the card sustains on the FFMA pipe.  At
// the ground-truth shape cuBLAS's own strict-f32 product alone reaches
// about 57 % of the 67 TFLOP/s peak (PERF.md §6); this kernel adds
// the norm pass and the clamped epilogue, and the build's small blocks
// pay a tile's latency and two launches each.
//
// Plain C interface, bound with ctypes: returns the cudaError_t of the
// launches (0 on success).

#include <cuda_runtime.h>

#include <stdint.h>

#include "row_dist.cuh"

namespace {

constexpr int kDepth = 16;            // depth slice staged per stage
constexpr int kRowChunks = kDepth / 4;  // float4 chunks of a staged row
constexpr int kStride = kDepth + 4;   // a staged row, padded (floats)
constexpr int kStages = 2;            // slices in the ring
constexpr int kNormWarps = 8;

template <int BM, int BN, int TM, int TN, int MinBlocks>
struct Tile {
  static constexpr int kM = BM, kN = BN, kTM = TM, kTN = TN;
  static constexpr int kMinBlocks = MinBlocks;  // resident blocks an SM
  static constexpr int kTX = BN / TN;   // threads along the columns
  static constexpr int kTY = BM / TM;   // threads along the rows
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kChunks = (BM + BN) * kRowChunks;  // float4 a slice
  static constexpr int kPerThread = kChunks / kThreads;
  static constexpr int kSmemBytes = kStages * (BM + BN) * kStride * 4;
  // the 64-row tile is its launch's only row tile: it sums its own
  // candidate norms, kParts threads a row, from the slices it stages
  static constexpr bool kOwnNorms = BM == 64;
  static constexpr int kParts = kThreads / BN;
  static_assert(kChunks % kThreads == 0, "whole float4 chunks a thread");
  static_assert(!kOwnNorms || (kParts >= 1 && kRowChunks % kParts == 0 &&
                               kParts * BN == kThreads),
                "whole float4 chunks of a row's depths a thread");
};
// The 8x16 tile needs about 250 registers (one block an SM, 8 warps);
// the 8x4 tile fits 128 (four blocks of 4 warps an SM).  8x8 and 8x12
// tiles, deeper rings, 32-deep slices and 64x128 small tiles were no
// faster on the H100.
using Wide = Tile<128, 256, 8, 16, 1>;
using Flat = Tile<64, 64, 8, 4, 4>;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// |x_r|^2 of rows [0, n_a) of a and [0, n_b) of b into norms[0, n_a) and
// norms[n_a, n_a + n_b): one warp a row, in row_dist.cuh's lane order.
__global__ void __launch_bounds__(kNormWarps * 32)
row_norms_kernel(const float* __restrict__ a, long long n_a,
                 const float* __restrict__ b, long long n_b, int d, int vec,
                 float* __restrict__ norms) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kNormWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= n_a + n_b) return;
  const float* row = r < n_a ? a + r * d : b + (r - n_a) * d;
  float acc = 0.f;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int j = lane; j < d / 4; j += 32) {
      const float4 x = __ldg(r4 + j);
      acc += x.x * x.x;
      acc += x.y * x.y;
      acc += x.z * x.z;
      acc += x.w * x.w;
    }
  } else {  // the same order from scalar loads
    const int w = d % 4 == 0 ? 4 : 1;
    for (int j = lane; j < d / w; j += 32) {
      for (int e = j * w; e < (j + 1) * w; ++e) {
        const float x = __ldg(row + e);
        acc += x * x;
      }
    }
  }
  acc = rowdist::warp_sum(acc);
  if (lane == 0) norms[r] = acc;
}

// acc[i][j] += lane(a[i]) * lane(b[j]) for every i, j
template <int TM, int TN, class Lane>
__device__ __forceinline__ void outer(float (&acc)[TM][TN],
                                      const float4 (&a)[TM],
                                      const float4 (&b)[TN], Lane lane) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = fmaf(lane(a[i]), lane(b[j]), acc[i][j]);
    }
  }
}

template <class T, bool kVec>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
l2_tile_kernel(const float* __restrict__ q, const float* __restrict__ c,
               const float* __restrict__ norms, float* __restrict__ out,
               int n_q, int n_c, int d, int row_tiles, int n_tiles) {
  extern __shared__ __align__(16) float ring[];  // T::kSmemBytes
  __shared__ float c_part[T::kOwnNorms ? T::kParts : 1][T::kN];
  float* const as = ring;                              // [slot][kM rows]
  float* const bs = ring + kStages * T::kM * kStride;  // [slot][kN rows]

  const int tid = threadIdx.x;
  const int tx = tid % T::kTX;
  const int ty = tid / T::kTX;
  const int n_slices = (d + kDepth - 1) / kDepth;
  // this block's tiles are blockIdx.x + t * gridDim.x; its slices run
  // through one ring across them
  const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
                           ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1
                           : 0;
  const long long n_steps = static_cast<long long>(my_tiles) * n_slices;

  // The next step to stage: its tile's first row and column, its slice
  // and its ring slot.  Chunk e of a slice is staged row e / kRowChunks
  // (the query rows, then the candidate rows), depths 4 * (e %
  // kRowChunks) .. +3.  One cp.async group per call, empty past the last
  // step, so the groups count steps.
  long long f_step = 0;
  int f_tile = blockIdx.x, f_slice = 0, f_slot = 0;
  long long f_row0 = static_cast<long long>(f_tile % row_tiles) * T::kM;
  long long f_col0 = static_cast<long long>(f_tile / row_tiles) * T::kN;
  auto fetch = [&]() {
    if (f_step < n_steps) {
      const int k0 = f_slice * kDepth;
#pragma unroll
      for (int p = 0; p < T::kPerThread; ++p) {
        const int e = tid + p * T::kThreads;
        const int r = e / kRowChunks;
        const int gk = k0 + 4 * (e % kRowChunks);
        const bool is_q = r < T::kM;
        const long long g = is_q ? f_row0 + r : f_col0 + (r - T::kM);
        const bool in_rows = g < (is_q ? n_q : n_c);
        // (past the rows' ragged edge nothing is read: the row base)
        const float* src = (is_q ? q : c) + (in_rows ? g * d : 0) +
                           (in_rows && gk < d ? gk : 0);
        float* dst = (is_q ? as + (f_slot * T::kM + r) * kStride
                           : bs + (f_slot * T::kN + r - T::kM) * kStride) +
                     4 * (e % kRowChunks);
        if constexpr (kVec) {
          cp_async16(dst, src, in_rows && gk < d);
        } else {
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] = in_rows && gk + u < d ? __ldg(src + u) : 0.f;
          }
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        }
      }
      if (++f_slice == n_slices) {
        f_slice = 0;
        f_tile += gridDim.x;
        f_row0 = static_cast<long long>(f_tile % row_tiles) * T::kM;
        f_col0 = static_cast<long long>(f_tile / row_tiles) * T::kN;
      }
      if (++f_slot == kStages) f_slot = 0;
      ++f_step;
    }
    if constexpr (kVec) cp_async_commit();
  };

  for (int st = 0; st < kStages - 1; ++st) fetch();
  int slot = 0;
  for (int t = 0; t < my_tiles; ++t) {
    const int tile = blockIdx.x + t * gridDim.x;
    const long long row0 = static_cast<long long>(tile % row_tiles) * T::kM;
    const long long col0 = static_cast<long long>(tile / row_tiles) * T::kN;
    float acc[T::kTM][T::kTN];
#pragma unroll
    for (int i = 0; i < T::kTM; ++i) {
#pragma unroll
      for (int j = 0; j < T::kTN; ++j) acc[i][j] = 0.f;
    }
    float c_norm = 0.f;  // kOwnNorms: row tid % kN, part tid / kN

    for (int s = 0; s < n_slices; ++s) {
      // this step has landed (this thread's copies), then everyone's;
      // and every thread is past the step before, whose slot is refilled
      if constexpr (kVec) cp_async_wait<kStages - 2>();
      __syncthreads();
      fetch();
      const float* A = as + slot * T::kM * kStride;
      const float* B = bs + slot * T::kN * kStride;
      if (++slot == kStages) slot = 0;
      if constexpr (T::kOwnNorms) {
        constexpr int kSpan = kDepth / T::kParts;
        const float* row = B + (tid % T::kN) * kStride + kSpan * (tid / T::kN);
#pragma unroll
        for (int u = 0; u < kSpan / 4; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(row + 4 * u);
          c_norm += x.x * x.x;
          c_norm += x.y * x.y;
          c_norm += x.z * x.z;
          c_norm += x.w * x.w;
        }
      }
#pragma unroll
      for (int k4 = 0; k4 < kDepth / 4; ++k4) {
        // every fragment of 4 depths first, then 4 outer products of
        // TM x TN independent FFMAs each (depth order per output kept)
        float4 a[T::kTM], b[T::kTN];
#pragma unroll
        for (int i = 0; i < T::kTM; ++i) {
          a[i] = *reinterpret_cast<const float4*>(
              A + (ty + T::kTY * i) * kStride + 4 * k4);
        }
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) {
          b[j] = *reinterpret_cast<const float4*>(
              B + (tx + T::kTX * j) * kStride + 4 * k4);
        }
        outer(acc, a, b, [](const float4& v) { return v.x; });
        outer(acc, a, b, [](const float4& v) { return v.y; });
        outer(acc, a, b, [](const float4& v) { return v.z; });
        outer(acc, a, b, [](const float4& v) { return v.w; });
      }
    }

    // the epilogue: norms, the decomposition, the clamp, the stores
    if constexpr (T::kOwnNorms) {
      // (the slice barriers of this tile order these writes after the
      // last tile's reads)
      c_part[tid / T::kN][tid % T::kN] = c_norm;
      __syncthreads();
    }
    float qn[T::kTM], cn[T::kTN];
#pragma unroll
    for (int i = 0; i < T::kTM; ++i) {
      const long long gr = row0 + ty + T::kTY * i;
      qn[i] = gr < n_q ? __ldg(norms + gr) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) {
      const int lc = tx + T::kTX * j;
      const long long gc = col0 + lc;
      if constexpr (T::kOwnNorms) {
        cn[j] = c_part[0][lc];
#pragma unroll
        for (int u = 1; u < T::kParts; ++u) cn[j] += c_part[u][lc];
      } else {
        cn[j] = gc < n_c ? __ldg(norms + n_q + gc) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < T::kTM; ++i) {
      const long long gr = row0 + ty + T::kTY * i;
      if (gr >= n_q) continue;
#pragma unroll
      for (int j = 0; j < T::kTN; ++j) {
        const long long gc = col0 + tx + T::kTX * j;
        if (gc >= n_c) continue;
        const float v = qn[i] + cn[j] - 2.f * acc[i][j];
        // fmaxf would turn NaN into 0; every other value as before
        out[gr * n_c + gc] = isnan(v) ? v : fmaxf(v, 0.f);
      }
    }
  }
}

// The ring's shared memory and the persistent grid (as many blocks as
// the card holds at once) of one instance, set up on its first launch.
template <class T, bool kVec>
struct Setup {
  int err = 0;
  long long blocks = 0;
  Setup() {
    auto kernel = l2_tile_kernel<T, kVec>;
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemBytes);
    if (!err) err = cudaGetDevice(&dev);
    if (!err) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (!err) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, T::kThreads, T::kSmemBytes);
    }
    blocks = static_cast<long long>(sms) * per_sm;
  }
};

template <class T, bool kVec>
int launch_tiles(const float* q, const float* c, const float* norms,
                 float* out, int n_q, int n_c, int d, cudaStream_t s) {
  static const Setup<T, kVec> setup;  // thread-safe, once
  if (setup.err) return setup.err;
  const int row_tiles = (n_q + T::kM - 1) / T::kM;
  const long long n_tiles =
      static_cast<long long>(row_tiles) * ((n_c + T::kN - 1) / T::kN);
  if (n_tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = setup.blocks < n_tiles ? setup.blocks : n_tiles;
  l2_tile_kernel<T, kVec><<<static_cast<unsigned>(grid), T::kThreads,
                            T::kSmemBytes, s>>>(
      q, c, norms, out, n_q, n_c, d, row_tiles, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const float* q, const float* c, float* norms, float* out, int n_q,
           int n_c, int d, int vec, cudaStream_t s) {
  // the 128-row tile reads every norm; the 64-row tile only the queries'
  const long long n_norm_c = T::kOwnNorms ? 0 : n_c;
  const long long norm_blocks = (n_q + n_norm_c + kNormWarps - 1) / kNormWarps;
  row_norms_kernel<<<static_cast<unsigned>(norm_blocks), kNormWarps * 32, 0,
                     s>>>(q, n_q, c, n_norm_c, d, vec, norms);
  return vec ? launch_tiles<T, true>(q, c, norms, out, n_q, n_c, d, s)
             : launch_tiles<T, false>(q, c, norms, out, n_q, n_c, d, s);
}

}  // namespace

// norms: scratch of n_q + n_c floats.  vec: d % 4 == 0 and both operands
// 16-byte aligned.
extern "C" int l2_distance_f32(const float* q, const float* c, float* norms,
                               float* out, int n_q, int n_c, int d, int vec,
                               void* stream) {
  if (n_q == 0 || n_c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_q <= Flat::kM ? launch<Flat>(q, c, norms, out, n_q, n_c, d, vec, s)
                         : launch<Wide>(q, c, norms, out, n_q, n_c, d, vec, s);
}
