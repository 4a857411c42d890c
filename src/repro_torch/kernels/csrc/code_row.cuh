// Hamming distance between two SimHash code rows, each of `words` int64
// words holding a uint32 value (paper Eq. 5: collisions = m - hamming).
// Shared by simhash.cu (collision_count_rows) and gather_l2.cu (the fused
// prefilter of prefilter_gather), so both count alike.
//
// Each word counts through __popc of the low 32 bits of its XOR.  Where
// `words` is even and both rows are 16-byte aligned, the rows are read as
// longlong2, two words a load: at the default m = 64 (W = 2) one load a
// row.  The count is an integer, so the load width never changes it.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace coderow {

__device__ __forceinline__ int word_diff(long long a, long long b) {
  return __popc(static_cast<unsigned>(a ^ b));
}

__device__ __forceinline__ int hamming(const long long* __restrict__ a,
                                       const long long* __restrict__ b,
                                       int words) {
  int ham = 0;
  const uintptr_t both = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  if ((words & 1) == 0 && (both & 15) == 0) {
    const longlong2* a2 = reinterpret_cast<const longlong2*>(a);
    const longlong2* b2 = reinterpret_cast<const longlong2*>(b);
    for (int w = 0; w < words / 2; ++w) {
      const longlong2 x = __ldg(a2 + w);
      const longlong2 y = __ldg(b2 + w);
      ham += word_diff(x.x, y.x) + word_diff(x.y, y.y);
    }
  } else {
    for (int w = 0; w < words; ++w) {
      ham += word_diff(__ldg(a + w), __ldg(b + w));
    }
  }
  return ham;
}

}  // namespace coderow
