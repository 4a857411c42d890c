// Squared L2 distance between a query row and one table row, computed by
// one warp.  Shared by gather_l2.cu (the per-hop fetch) and beam.cu (the
// fused beam search), so both routes sum in the same order and return the
// same bits for the same row on the same card.
//
// Each lane sums the squares of a lane-strided share of the row, then a
// butterfly of shuffles leaves the total in every lane.  Where d % 4 == 0
// the share is groups of four consecutive elements, taken in order, on
// both load paths: 16-byte float4 loads of the query and the f32 row (or
// 4-byte char4 loads of an int8 row) where the pointers are aligned for
// them, scalar loads otherwise.  Where d % 4 != 0 it is single elements.
// So the bits of a distance depend on d alone, never on alignment.
//
// The int8 row dequantises as float(c) * scale.  The product is written
// with __fmul_rn so nvcc never contracts `q - c * scale` into one FMA: the
// plain version rounds the product before the difference.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace rowdist {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// q and row are device pointers into global memory (read through the
// read-only cache).  kVec4 needs d % 4 == 0 and 16-byte aligned rows.
template <bool kVec4>
__device__ __forceinline__ float l2_f32(const float* __restrict__ q,
                                        const float* __restrict__ row, int d,
                                        int lane) {
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
    const int w = d % 4 == 0 ? 4 : 1;
    for (int j = lane; j < d / w; j += 32) {
      for (int c = j * w; c < (j + 1) * w; ++c) {
        const float diff = __ldg(q + c) - __ldg(row + c);
        acc += diff * diff;
      }
    }
  }
  return warp_sum(acc);
}

// kVec4 needs d % 4 == 0, a 16-byte aligned query row and a 4-byte
// aligned int8 row.
template <bool kVec4>
__device__ __forceinline__ float l2_q8(const float* __restrict__ q,
                                       const int8_t* __restrict__ row,
                                       float scale, int d, int lane) {
  float acc = 0.f;
  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const char4* r4 = reinterpret_cast<const char4*>(row);
    for (int j = lane; j < d / 4; j += 32) {
      const float4 a = __ldg(q4 + j);
      const char4 c = __ldg(r4 + j);
      const float dx = a.x - __fmul_rn(static_cast<float>(c.x), scale);
      const float dy = a.y - __fmul_rn(static_cast<float>(c.y), scale);
      const float dz = a.z - __fmul_rn(static_cast<float>(c.z), scale);
      const float dw = a.w - __fmul_rn(static_cast<float>(c.w), scale);
      acc += dx * dx;
      acc += dy * dy;
      acc += dz * dz;
      acc += dw * dw;
    }
  } else {
    const int w = d % 4 == 0 ? 4 : 1;
    for (int j = lane; j < d / w; j += 32) {
      for (int c = j * w; c < (j + 1) * w; ++c) {
        const float diff =
            __ldg(q + c) -
            __fmul_rn(static_cast<float>(__ldg(row + c)), scale);
        acc += diff * diff;
      }
    }
  }
  return warp_sum(acc);
}

// The distances from one query row to 8 table rows, by one warp, each
// summed exactly as l2_f32 sums it: the same lane-strided groups in the
// same order, the same contracted multiply-add per element, and the same
// tree across lanes.  That tree is warp_sum's butterfly in transposing
// form: at the levels 16, 8 and 4 a lane keeps half of the rows it still
// holds and adds its partner's partial of them (own + partner, as
// warp_sum adds), so every row combines the same lane pairs at the same
// levels; levels 2 and 1 are a butterfly on the one row left.  9 shuffles
// instead of 40.  Each step issues the rows' loads, unconditionally,
// before the first sum, so a warp keeps every row in flight (a caller
// points a row it skips at any readable row of d elements, and ignores
// its sum).  Returns, in every lane, the total of row row_of_lane(lane):
// each row's total lands in the 4 lanes lane & ~3.  The N-row forms
// (N a multiple of 8) load N rows per step and return row
// 8 * g + row_of_lane(lane) in out[g]; l2_q8_rows is the same for the
// int8 lane, each row summed exactly as l2_q8 sums it.
__device__ __forceinline__ int row_of_lane(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

__device__ __forceinline__ float reduce_rows8(const float (&v)[8], int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  float u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = hi16 ? v[i + 4] : v[i];
    const float give = hi16 ? v[i] : v[i + 4];
    u[i] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
  }
  float t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = hi8 ? u[i + 2] : u[i];
    const float give = hi8 ? u[i] : u[i + 2];
    t[i] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
  }
  float s = (hi4 ? t[1] : t[0]) +
            __shfl_xor_sync(0xffffffffu, hi4 ? t[0] : t[1], 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

template <int N>
__device__ __forceinline__ void reduce_rows(const float (&acc)[N], int lane,
                                            float (&out)[N / 8]) {
#pragma unroll
  for (int g = 0; g < N / 8; ++g) {
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = acc[8 * g + r];
    out[g] = reduce_rows8(v, lane);
  }
}

template <int N, bool kVec4>
__device__ __forceinline__ void l2_f32_rows(const float* __restrict__ q,
                                            const float* const (&rows)[N],
                                            int d, int lane,
                                            float (&out)[N / 8]) {
  static_assert(N % 8 == 0, "rows come in groups of 8");
  float acc[N];
#pragma unroll
  for (int r = 0; r < N; ++r) acc[r] = 0.f;
  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int j = lane; j < d / 4; j += 32) {
      const float4 a = __ldg(q4 + j);
      float4 c[N];
#pragma unroll
      for (int r = 0; r < N; ++r) {
        c[r] = __ldg(reinterpret_cast<const float4*>(rows[r]) + j);
      }
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const float dx = a.x - c[r].x, dy = a.y - c[r].y;
        const float dz = a.z - c[r].z, dw = a.w - c[r].w;
        acc[r] += dx * dx;
        acc[r] += dy * dy;
        acc[r] += dz * dz;
        acc[r] += dw * dw;
      }
    }
  } else {
    const int w = d % 4 == 0 ? 4 : 1;
    for (int j = lane; j < d / w; j += 32) {
      for (int e = j * w; e < (j + 1) * w; ++e) {
        const float qe = __ldg(q + e);
        float c[N];
#pragma unroll
        for (int r = 0; r < N; ++r) c[r] = __ldg(rows[r] + e);
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const float diff = qe - c[r];
          acc[r] += diff * diff;
        }
      }
    }
  }
  reduce_rows<N>(acc, lane, out);
}

template <bool kVec4>
__device__ __forceinline__ float l2_f32_rows8(const float* __restrict__ q,
                                              const float* const (&rows)[8],
                                              int d, int lane) {
  float out[1];
  l2_f32_rows<8, kVec4>(q, rows, d, lane, out);
  return out[0];
}

template <int N, bool kVec4>
__device__ __forceinline__ void l2_q8_rows(const float* __restrict__ q,
                                           const int8_t* const (&rows)[N],
                                           const float (&scale)[N], int d,
                                           int lane, float (&out)[N / 8]) {
  static_assert(N % 8 == 0, "rows come in groups of 8");
  float acc[N];
#pragma unroll
  for (int r = 0; r < N; ++r) acc[r] = 0.f;
  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int j = lane; j < d / 4; j += 32) {
      const float4 a = __ldg(q4 + j);
      char4 c[N];
#pragma unroll
      for (int r = 0; r < N; ++r) {
        c[r] = __ldg(reinterpret_cast<const char4*>(rows[r]) + j);
      }
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const float s = scale[r];
        const float dx = a.x - __fmul_rn(static_cast<float>(c[r].x), s);
        const float dy = a.y - __fmul_rn(static_cast<float>(c[r].y), s);
        const float dz = a.z - __fmul_rn(static_cast<float>(c[r].z), s);
        const float dw = a.w - __fmul_rn(static_cast<float>(c[r].w), s);
        acc[r] += dx * dx;
        acc[r] += dy * dy;
        acc[r] += dz * dz;
        acc[r] += dw * dw;
      }
    }
  } else {
    const int w = d % 4 == 0 ? 4 : 1;
    for (int j = lane; j < d / w; j += 32) {
      for (int e = j * w; e < (j + 1) * w; ++e) {
        const float qe = __ldg(q + e);
        int8_t c[N];
#pragma unroll
        for (int r = 0; r < N; ++r) c[r] = __ldg(rows[r] + e);
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const float diff =
              qe - __fmul_rn(static_cast<float>(c[r]), scale[r]);
          acc[r] += diff * diff;
        }
      }
    }
  }
  reduce_rows<N>(acc, lane, out);
}

// The distances from one query row to 8 rows of both lanes: slot r is an
// int8 row qrows[r] with scale[r] where bit r of `cold` is set, else the
// f32 row rows[r].  Each is summed exactly as l2_f32 or l2_q8 sums it
// (the two share the grouping, the contracted multiply-add and the
// tree), so a slot's bits are those of its own lane's helper.  `cold` is
// the same in every lane of the warp, so each slot issues one load, of
// its own type, before the first sum, with no divergence.  A slot that is
// skipped points both pointers at any readable row of d elements (an
// int8 one needs 4-byte alignment under kVec4), and its sum is ignored.
template <bool kVec4>
__device__ __forceinline__ float l2_mixed_rows8(
    const float* __restrict__ q, const float* const (&rows)[8],
    const int8_t* const (&qrows)[8], const float (&scale)[8], unsigned cold,
    int d, int lane) {
  float acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.f;
  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int j = lane; j < d / 4; j += 32) {
      const float4 a = __ldg(q4 + j);
      float4 c[8];
      char4 v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if ((cold >> r) & 1u) {
          v[r] = __ldg(reinterpret_cast<const char4*>(qrows[r]) + j);
        } else {
          c[r] = __ldg(reinterpret_cast<const float4*>(rows[r]) + j);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float ex, ey, ez, ew;
        if ((cold >> r) & 1u) {
          const float s = scale[r];
          ex = __fmul_rn(static_cast<float>(v[r].x), s);
          ey = __fmul_rn(static_cast<float>(v[r].y), s);
          ez = __fmul_rn(static_cast<float>(v[r].z), s);
          ew = __fmul_rn(static_cast<float>(v[r].w), s);
        } else {
          ex = c[r].x;
          ey = c[r].y;
          ez = c[r].z;
          ew = c[r].w;
        }
        const float dx = a.x - ex, dy = a.y - ey;
        const float dz = a.z - ez, dw = a.w - ew;
        acc[r] += dx * dx;
        acc[r] += dy * dy;
        acc[r] += dz * dz;
        acc[r] += dw * dw;
      }
    }
  } else {
    const int w = d % 4 == 0 ? 4 : 1;
    for (int j = lane; j < d / w; j += 32) {
      for (int e = j * w; e < (j + 1) * w; ++e) {
        const float qe = __ldg(q + e);
        float c[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          c[r] = (cold >> r) & 1u
                     ? __fmul_rn(static_cast<float>(__ldg(qrows[r] + e)),
                                 scale[r])
                     : __ldg(rows[r] + e);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float diff = qe - c[r];
          acc[r] += diff * diff;
        }
      }
    }
  }
  return reduce_rows8(acc, lane);
}

}  // namespace rowdist
