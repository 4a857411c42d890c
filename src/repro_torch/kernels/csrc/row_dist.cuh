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

}  // namespace rowdist
