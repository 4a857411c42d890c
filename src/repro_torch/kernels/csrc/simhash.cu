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
// Encode.  The sums run on the f64 tensor cores (DMMA, `mma.sync
// .m16n8k8 .f64`, 67 TFLOP/s on an H100 SXM, twice the f64 FMA pipe).
// The f32 rows and projections become f64 on the way into the fragments;
// every f32 x f32 product is exact in f64, so a sign depends on the order
// of the sum only where the exact dot product lies within an f64
// rounding of zero, and the codes agree with the plain version (an f64
// matmul).  An exact zero, -0.0 included, counts as >= 0 on both.
//
// A block owns a tile of rows and every projection.  The projections are
// staged once per block: their f32 rows arrive by 16-byte cp.async (the
// same lines for every block, so few wide requests) and become f64 in
// fragment order (64 KB at m = 64, d = 128), so a lane's B fragment is one
// 16-byte shared load.  A tile's rows arrive once from device memory by
// cp.async (16 bytes where the rows are 16-byte aligned and d % 4 == 0, 4
// otherwise) into a two-slot ring, the next tile's while this one's DMMAs
// run, with a row stride of 4 mod 32 words so the A fragments' loads are
// free of bank conflicts.  Each warp covers one word (32 projections) of
// 16 or 32 rows and reuses each A fragment across its four n-tiles.
// Where a pass of 64 projections or a tile's rows do not fit in shared
// memory, they are staged 128 deep per (tile, pass) instead (`enc_plan`):
// every shape the wrapper takes runs.
//
// Bits come from the accumulators: lane (g, t) of a 16 x 8 C fragment
// holds columns 2t and 2t+1 of rows g and g+8, so n-tile j's signs are
// bits 8j + 2t + {0, 1} of those rows' word; two XOR shuffles across the
// group's four lanes complete the word, and one lane stores it, once.
//
// Two tile shapes.  Where there are at least as many 128-row tiles as
// SMs (the bulk build's 131,072 rows), one persistent block an SM walks
// 128-row tiles with 8 warps of 32 rows x one word.  Otherwise 16-row
// tiles, 8 warps of 16 rows x one word x a quarter of the depth (the four
// partial sums added in a fixed order through shared memory), so a
// search's 1,000 query codes or an insert batch's 1,024 cover 63-64 SMs
// with 8 warps each.  Bound: operations, 2*N*m*d f64 flops on the tensor
// cores, against 4*N*d bytes of rows.  What holds the wide tile back on
// the H100: within an SM a tile's row loads make little progress while
// its DMMAs run, whether issued up front, interleaved with the DMMAs or
// as TMA bulk copies, so each tile costs its DMMAs plus its loads; the
// narrow tile's time is the launch, the projections' staging and one
// tile.
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

constexpr int kK = 8;              // depth of one DMMA (m16n8k8)
constexpr int kPass = 64;          // projections a pass of a tile covers
constexpr int kNt = 4;             // 8-projection n-tiles of a warp: a word
constexpr int kSliceMax = 128;     // depth staged at a time when not resident
constexpr int kPairThreads = 256;  // candidate codes per all-pairs block
constexpr int kPairQueries = 16;   // query codes per all-pairs block
constexpr int kRowThreads = 256;

// A tile of kRows rows: RW x 2 x KW warps, each WM 16-row m-tiles by one
// word of a pass over 1/KW of each slice's depth (the KW partial sums are
// added in a fixed order through shared memory).
template <int WM, int RW, int KW>
struct EncTile {
  static constexpr int kWM = WM, kKW = KW;
  static constexpr int kThreads = RW * 2 * KW * 32;
  static constexpr int kRows = RW * WM * 16;
  // f64 of the partial sums warps kw > 0 hand to warp kw = 0
  static constexpr int kRed = RW * 2 * (KW - 1) * 32 * WM * kNt * 4;
};
// 128 rows, 8 warps of 32 rows x one word, persistent: one block an SM
using EncWide = EncTile<2, 4, 1>;
// 16 rows, 8 warps of 16 rows x one word x a quarter of the depth
using EncNarrow = EncTile<1, 1, 4>;

// acc += a * b on the f64 tensor cores: a 16 x 8 (row), b 8 x 8 (col); lane
// (g, t) = (lane / 4, lane % 4) holds a[g][t], a[g+8][t], a[g][t+4],
// a[g+8][t+4], b[t][g], b[t+4][g] and c[g][2t], c[g][2t+1], c[g+8][2t],
// c[g+8][2t+1].
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// kBytes of src to dst where valid, else kBytes of zeros (nothing read).
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + nrows) x columns [k0, k0 + len) of src (n rows of d
// floats) into buf (row stride rs floats), asynchronously: a warp a row,
// its lanes along the columns, 16 bytes a copy where vec (the rows are
// 16-byte aligned), 4 otherwise.  Rows past n and columns past d are
// zero-filled.
template <class T>
__device__ __forceinline__ void load_block(float* buf, const float* src,
                                           long long n, int d, bool vec,
                                           long long row0, int nrows, int k0,
                                           int len, int rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += T::kThreads / 32) {
    const long long gr = row0 + r;
    const float* row = src + (gr < n ? gr : 0) * d;
    float* dst = buf + r * rs;
    if (vec) {
      for (int c = 4 * lane; c < len; c += 128) {
        const bool ok = gr < n && k0 + c < d;
        cp_async<16>(dst + c, ok ? row + k0 + c : src, ok);
      }
    } else {
      for (int c = lane; c < len; c += 32) {
        const bool ok = gr < n && k0 + c < d;
        cp_async<4>(dst + c, ok ? row + k0 + c : src, ok);
      }
    }
  }
}

// np passes of projections from src (row i of pass p at src[(64 p + i) *
// ld], rows past m_rows and columns past d_cols zero) x depth [k0, k0 +
// len) into bs as f64 in fragment order: slot ((p * len/8 + s) * 8 + j) *
// 32 + lane holds B[k0 + 8s + t][64p + 8j + g] and B[k0 + 8s + t + 4][64p
// + 8j + g], lane (g, t)'s B fragment for n-tile j at step s, so a warp
// reads a fragment as one 16-byte load a lane.  src is the f32 copy in
// shared memory (one pass, staged by load_block) or proj itself; loads
// are batched 32 to a thread.
template <class T>
__device__ __forceinline__ void convert_proj(double* bs, const float* src,
                                             int ld, int m_rows, int d_cols,
                                             int np, int k0, int len) {
  constexpr int kU = 16;
  const int nk = len / kK;
  const int slots = np * nk * 256;
  for (int e0 = threadIdx.x; e0 < slots; e0 += kU * T::kThreads) {
    float v[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T::kThreads;
      const int lane = e & 31, j = (e >> 5) & 7, rest = e >> 8;
      const int pass = np > 1 ? rest / nk : 0;
      const int i = pass * kPass + 8 * j + (lane >> 2);
      const int k = k0 + (rest - pass * nk) * kK + (lane & 3);
      const float* row = src + static_cast<long long>(i) * ld;
      const bool ok = e < slots && i < m_rows;
      v[u][0] = ok && k < d_cols ? row[k] : 0.0f;
      v[u][1] = ok && k + 4 < d_cols ? row[k + 4] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T::kThreads;
      if (e < slots) {
        reinterpret_cast<double2*>(bs)[e] = make_double2(v[u][0], v[u][1]);
      }
    }
  }
}

// acc += the warp's rows (a: its first row at the slice's first column,
// row stride rs) times its n-tiles (b: step 0 of its first n-tile) over
// steps [s0, s1) of 8.
template <class T>
__device__ __forceinline__ void mma_steps(
    double (&acc)[T::kWM][kNt][4], const float* a, int rs,
    const double* b, int s0, int s1) {
  const int lane = threadIdx.x & 31;
  const float* ap = a + (lane >> 2) * rs + (lane & 3);
  const double2* bp = reinterpret_cast<const double2*>(b) + lane;
#pragma unroll 2
  for (int s = s0; s < s1; ++s) {
    double af[T::kWM][4];
#pragma unroll
    for (int mt = 0; mt < T::kWM; ++mt) {
      const float* r = ap + mt * 16 * rs + s * kK;
      af[mt][0] = r[0];
      af[mt][1] = r[8 * rs];
      af[mt][2] = r[4];
      af[mt][3] = r[8 * rs + 4];
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const double2 v = bp[(s * 8 + j) * 32];
      const double bf[2] = {v.x, v.y};
#pragma unroll
      for (int mt = 0; mt < T::kWM; ++mt) dmma(acc[mt][j], af[mt], bf);
    }
  }
}

// The signs of the warp's accumulators as word w of its rows from row0:
// lane (g, t) ORs its bits of each row, two XOR shuffles complete the word
// in the group's four lanes, and the lane t equal to the row's index among
// the lane's rows (mod 4) stores it.
template <class T>
__device__ __forceinline__ void store_word(
    const double (&acc)[T::kWM][kNt][4], long long* out, long long row0,
    long long n, int words, int w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::kWM; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        bits |= static_cast<unsigned>(acc[mt][j][2 * h] >= 0.0)
                << (8 * j + 2 * t);
        bits |= static_cast<unsigned>(acc[mt][j][2 * h + 1] >= 0.0)
                << (8 * j + 2 * t + 1);
      }
      bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
      bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
      const long long row = row0 + mt * 16 + h * 8 + g;
      if ((mt * 2 + h) % 4 == t && row < n) {
        out[row * words + w] = static_cast<long long>(bits);
      }
    }
  }
}

// What is resident in shared memory: rows_res, a tile's rows at full depth
// in a two-slot ring; b_res, every pass's projections at full depth.  What
// is not resident is staged `ksl` deep per (tile, pass, slice).
struct EncPlan {
  int rows_res, b_res, ksl, rs;
  size_t smem;
};

// d rounded up to a whole DMMA step (one step of zeros where d = 0)
__host__ __device__ __forceinline__ int padded_depth(int d) {
  return d > 0 ? (d + kK - 1) / kK * kK : kK;
}

// smallest stride >= len floats that is 4 mod 32 (conflict-free A loads)
int row_stride(int len) { return (len + 27) / 32 * 32 + 4; }

template <class T>
EncPlan enc_plan(int dk, int passes, size_t max_smem) {
  const size_t pass_b = static_cast<size_t>(dk) * kPass * sizeof(double);
  const size_t red = T::kRed * sizeof(double);
  const size_t ring = 2ull * T::kRows * row_stride(dk) * sizeof(float) + red;
  // the f32 copy of a pass of projections, beside the ring when a ring
  // slot cannot hold it
  const size_t stage = T::kRows >= kPass ? 0
      : static_cast<size_t>(kPass) * row_stride(dk) * sizeof(float);
  if (ring + stage + passes * pass_b <= max_smem) {
    return {1, 1, dk, row_stride(dk), ring + stage + passes * pass_b};
  }
  const int ksl = dk < kSliceMax ? dk : kSliceMax;
  const size_t slice_b = static_cast<size_t>(ksl) * kPass * sizeof(double);
  if (ring + slice_b <= max_smem) {
    return {1, 0, ksl, row_stride(dk), ring + slice_b};
  }
  const size_t slot =
      static_cast<size_t>(T::kRows) * row_stride(ksl) * sizeof(float) + red;
  if (slot + passes * pass_b <= max_smem) {
    return {0, 1, ksl, row_stride(ksl), slot + passes * pass_b};
  }
  return {0, 0, ksl, row_stride(ksl), slot + slice_b};
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, 1)
simhash_encode_kernel(const float* __restrict__ x,
                      const float* __restrict__ proj,
                      long long* __restrict__ out, long long n, int d,
                      int words, int vec, int pvec, EncPlan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dk = padded_depth(d);
  const int passes = (words + 1) / 2;
  const int nks = dk / kK;
  const int ksl = plan.ksl, rs = plan.rs;
  const int slices = (dk + ksl - 1) / ksl;
  double* bs = reinterpret_cast<double*>(smem);
  double* red = bs + static_cast<size_t>(plan.b_res ? passes * nks
                                                    : ksl / kK) * 512;
  float* rows = reinterpret_cast<float*>(red + T::kRed);
  const long long tiles = (n + T::kRows - 1) / T::kRows;
  const int warp = threadIdx.x >> 5;
  const int kw = warp % T::kKW;
  const int cw = warp / T::kKW % 2, rw = warp / (T::kKW * 2);
  const int m = 32 * words;

  if (plan.rows_res) {
    load_block<T>(rows, x, n, d, vec, blockIdx.x * T::kRows, T::kRows, 0, dk,
                  rs);
    cp_async_commit();
  }
  if (plan.rows_res && plan.b_res) {
    // each pass's f32 copy lands in one pass of 16-byte copies (in ring
    // slot 1, free until the first prefetch), then becomes f64 fragments
    float* stage = rows + (T::kRows >= kPass ? 1 : 2) * T::kRows * rs;
    for (int p = 0; p < passes; ++p) {
      load_block<T>(stage, proj, m, d, pvec, p * kPass, kPass, 0, dk, rs);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      convert_proj<T>(bs + static_cast<size_t>(p) * nks * 512, stage,
                      rs, kPass, dk, 1, 0, dk);
      __syncthreads();
    }
  } else if (plan.b_res) {
    convert_proj<T>(bs, proj, d, m, d, passes, 0, dk);
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    float* buf = rows + (plan.rows_res ? (it & 1) * T::kRows * rs : 0);
    if (plan.rows_res) {
      const long long next = tile + gridDim.x;
      if (next < tiles) {
        load_block<T>(rows + ((it + 1) & 1) * T::kRows * rs, x, n, d, vec,
                      next * T::kRows, T::kRows, 0, dk, rs);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    const float* a_warp = buf + rw * T::kWM * 16 * rs;
    const long long row0 = tile * T::kRows + rw * T::kWM * 16;
    for (int p = 0; p < passes; ++p) {
      const int w = 2 * p + cw;
      double acc[T::kWM][kNt][4];
#pragma unroll
      for (int mt = 0; mt < T::kWM; ++mt) {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.0;
        }
      }
      for (int sl = 0; sl < slices; ++sl) {
        const int k0 = sl * ksl;
        const int len = dk - k0 < ksl ? dk - k0 : ksl;
        if (!plan.rows_res || !plan.b_res) {
          __syncthreads();
          if (!plan.rows_res) {
            load_block<T>(buf, x, n, d, vec, tile * T::kRows, T::kRows, k0,
                          len, rs);
            cp_async_commit();
          }
          if (!plan.b_res) {
            convert_proj<T>(bs, proj + static_cast<long long>(p) * kPass * d,
                            d, m - p * kPass, d, 1, k0, len);
          }
          if (!plan.rows_res) cp_async_wait<0>();
          __syncthreads();
        }
        if (w < words) {
          const int b_step = plan.b_res ? p * nks + k0 / kK : 0;
          const int nk = len / kK;
          mma_steps<T>(acc, a_warp + (plan.rows_res ? k0 : 0), rs,
                       bs + (b_step * 8 + cw * kNt) * 64,
                       kw * nk / T::kKW, (kw + 1) * nk / T::kKW);
        }
      }
      if constexpr (T::kKW > 1) {
        // warps kw > 0 hand their partial sums to warp kw = 0 (lane-major,
        // conflict-free), which adds them in the order of kw
        constexpr int kAcc = T::kWM * kNt * 4;
        double* mine = red + (rw * 2 + cw) * (T::kKW - 1) * 32 * kAcc +
                       (threadIdx.x & 31);
        double* flat = &acc[0][0][0];
        if (kw > 0) {
#pragma unroll
          for (int i = 0; i < kAcc; ++i) {
            mine[((kw - 1) * kAcc + i) * 32] = flat[i];
          }
        }
        __syncthreads();
        if (kw == 0) {
          for (int q = 0; q < T::kKW - 1; ++q) {
#pragma unroll
            for (int i = 0; i < kAcc; ++i) flat[i] += mine[(q * kAcc + i) * 32];
          }
        }
        __syncthreads();
      }
      if (kw == 0 && w < words) store_word<T>(acc, out, row0, n, words, w);
    }
    if (plan.rows_res) __syncthreads();
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

template <class T>
int launch_encode(const EncPlan& plan, int sms, const float* x,
                  const float* proj, long long* out, long long n, int d,
                  int words, int vec, int pvec, cudaStream_t stream) {
  const auto kernel = simhash_encode_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, T::kThreads, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + T::kRows - 1) / T::kRows;
  const long long resident = static_cast<long long>(sms) *
                             (per_sm > 0 ? per_sm : 1);
  const unsigned grid =
      static_cast<unsigned>(tiles < resident ? tiles : resident);
  kernel<<<grid, T::kThreads, plan.smem, stream>>>(x, proj, out, n, d, words,
                                                    vec, pvec, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int simhash_encode_f32(const float* x, const float* proj,
                                  long long* out, long long n, int d,
                                  int words, void* stream) {
  if (n == 0 || words == 0) return 0;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dk = padded_depth(d);
  const int passes = (words + 1) / 2;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int pvec = d % 4 == 0 && reinterpret_cast<uintptr_t>(proj) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  // the wide tile where it fills every SM and holds everything resident
  if ((n + EncWide::kRows - 1) / EncWide::kRows >= sms) {
    const EncPlan plan = enc_plan<EncWide>(dk, passes, max_smem);
    if (plan.rows_res && plan.b_res) {
      return launch_encode<EncWide>(plan, sms, x, proj, out, n, d, words,
                                    vec, pvec, st);
    }
  }
  return launch_encode<EncNarrow>(enc_plan<EncNarrow>(dk, passes, max_smem),
                                  sms, x, proj, out, n, d, words, vec, pvec,
                                  st);
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
