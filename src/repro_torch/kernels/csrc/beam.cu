// beam: the whole bottom-layer beam search of a query block in one launch,
// one CTA per query.
//
// Replaces src/repro/kernels/beam/kernel.py::beam_search_fused_pallas (one
// grid program per query; heap and visited filter in VMEM; adjacency and
// vector rows by explicit row DMAs).  It computes what the port's
// traversal.beam_search computes over a resolved snapshot (one adjacency
// gather per popped node, one row distance per fetched candidate) and what
// kernels/beam/ref.py computes, with the same trip cap and the same
// decisions, so the ids, distances, IOStats and heat lanes are the same.
//
// Layout on the H100: 128 threads per query.  Shared memory holds the
// ef-slot heap (ids, distances, expanded flags), the B*M candidate block
// of one trip and the visited set; adjacency rows, vector rows, SimHash
// codes and the live / returnable / resident lanes stay in device memory
// and are read through the read-only cache.  The trip loop runs inside the
// launch (at most iter_cap trips, leaving at the first trip whose
// continuation test fails, which is the only place a trip can stop being a
// no-op), so a search costs one launch and no host read.
//
// - Visited: the Pallas kernel keeps bool[cap + 1] in VMEM, 1 MiB per
//   query at cap = 2^20, which does not fit shared memory.  The set only
//   ever holds the entry and the fetched ids, at most 1 + iter_cap * B * M
//   of them, so it is an exact open-addressing hash set of int32 ids in
//   shared memory with at least twice that many slots (4,096 slots, 16 KiB,
//   at ef = 48, M = 16).  Exact: a false positive would change answers.
// - Selection (pop, rho rank, merge of ef + B*M, lazy repack) is
//   rank-by-comparison: rank[i] = #{j: x[j] < x[i]} + #{j < i: x[j] ==
//   x[i]}, the position a stable ascending sort gives (ties to the lower
//   index), as `lax.top_k` and the port's stable sorts do.  With B > 1 a
//   node repeated in the block counts at its first occurrence only.
// - Distances: one warp per fetched candidate, through row_dist.cuh, the
//   same function gather_l2.cu uses, so the fused and the per-hop routes
//   sum in the same order and agree bitwise on the card even on float
//   data.  Under the tier split, resident rows take the f32 row and the
//   others the dequantising int8 row (the min-merge of the two lanes, each
//   +inf where it does not own the row, is the owning lane's value).
// - Decision arithmetic (cos_from_l2, the Hoeffding threshold, ceil(rho *
//   n_eligible)) follows the op order of src/repro_torch/core/simhash.py
//   with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so nvcc contracts
//   nothing, and the arccos is taken in f64 and rounded once to f32, as
//   the port does: one flipped threshold compare would change the ids.
//
// Bound: bytes.  A search moves one adjacency row per expansion (4M bytes)
// and one vector row per fetched candidate (4d bytes, or d + 4 on the cold
// lane); the rest of the work is a few hundred integer compares per trip.
// The latency of dependent row loads, trip after trip, is what sets the
// time; several queries per SM hide part of it.
//
// Plain C interface, bound with ctypes: returns the cudaError_t of the
// launch (0 on success).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "row_dist.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMergePerThread = 4;  // ef + B*M <= 512

struct Params {
  const float* qs;            // f32[bq, d]
  const int32_t* entries;     // int32[bq]
  const float* entry_d;       // f32[bq]
  const int32_t* adjacency;   // int32[cap, M]
  const float* vectors;       // f32[cap, d]
  const long long* codes;     // int64[cap, W], uint32 words
  const long long* code_qs;   // int64[bq, W]
  const uint8_t* live;        // bool[cap]
  const float* q_norms;       // f32[bq]
  const float* mean_norm;     // f32[]
  const uint8_t* returnable;  // bool[cap] (LAZY)
  const uint8_t* resident;    // bool[cap] (TIER)
  const int8_t* qvecs;        // int8[cap, d] (TIER)
  const float* qscale;        // f32[cap] (TIER)
  const uint8_t* active;      // bool[bq]
  int32_t* ids_out;           // int32[bq, ef]
  float* d_out;               // f32[bq, ef]
  int32_t* stats_out;         // int32[bq, 4]
  int32_t* heat_nodes;        // int32[bq, iter_cap * B]
  uint8_t* heat_mask;         // bool[bq, iter_cap * B, M]
  int d, cap, M, W, ef, k, B, iter_cap, max_iters, m_bits, hash_bits;
  float rho, slack;
  int vec4, q8vec4;
};

__device__ __forceinline__ unsigned hash_slot(int key, int bits) {
  return (static_cast<unsigned>(key) * 2654435761u) >> (32 - bits);
}

__device__ __forceinline__ bool hash_contains(const int* table, int bits,
                                              int key) {
  const unsigned mask = (1u << bits) - 1u;
  unsigned s = hash_slot(key, bits);
  while (true) {
    const int v = table[s];
    if (v == key) return true;
    if (v == -1) return false;
    s = (s + 1u) & mask;
  }
}

// The table never fills past half (the wrapper sizes it), so a probe
// always ends.  Two threads inserting the same key meet at the same slot.
__device__ __forceinline__ void hash_insert(int* table, int bits, int key) {
  const unsigned mask = (1u << bits) - 1u;
  unsigned s = hash_slot(key, bits);
  while (true) {
    const int old = atomicCAS(table + s, -1, key);
    if (old == -1 || old == key) return;
    s = (s + 1u) & mask;
  }
}

// The Hoeffding threshold of src/repro_torch/core/simhash.py, op for op:
// cos = clamp(((qn*qn + mn*mn) - delta) / max((2*qn)*mn, 1e-12), -1, 1),
// p = 1 - f32(acos_f64(cos)) / f32(pi), thr = p * m_bits - slack.
__device__ __forceinline__ float hoeffding_threshold(float qn, float mn,
                                                     float delta_sq,
                                                     int m_bits,
                                                     float slack) {
  float denom = __fmul_rn(__fmul_rn(2.0f, qn), mn);
  const float tiny = static_cast<float>(1e-12);
  denom = denom < tiny ? tiny : denom;
  const float num =
      __fsub_rn(__fadd_rn(__fmul_rn(qn, qn), __fmul_rn(mn, mn)), delta_sq);
  float c = __fdiv_rn(num, denom);
  c = fminf(fmaxf(c, -1.0f), 1.0f);
  const float theta = __double2float_rn(acos(static_cast<double>(c)));
  const float pi = static_cast<float>(3.141592653589793);
  const float p = __fsub_rn(1.0f, __fdiv_rn(theta, pi));
  return __fsub_rn(__fmul_rn(p, static_cast<float>(m_bits)), slack);
}

template <bool TIER, bool LAZY, bool RECORD_HEAT, bool FILTER, bool SAMPLE>
__global__ void __launch_bounds__(kThreads) beam_kernel(const Params p) {
  extern __shared__ int smem[];
  const int ef = p.ef, M = p.M, B = p.B, BM = p.B * p.M;
  int* s_ids = smem;                                      // [ef]
  float* s_d = reinterpret_cast<float*>(s_ids + ef);      // [ef]
  int* s_exp = reinterpret_cast<int*>(s_d + ef);          // [ef]
  int* c_row = s_exp + ef;                                // [BM]
  int* c_fetch = c_row + BM;                              // [BM]
  float* c_dist = reinterpret_cast<float*>(c_fetch + BM); // [BM]
  int* c_score = reinterpret_cast<int*>(c_dist + BM);     // [BM]
  int* s_slot = c_score + BM;                             // [B]
  int* s_node = s_slot + B;                               // [B]
  int* s_hash = s_node + B;                               // [1 << hash_bits]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_slots = 1 << p.hash_bits;
  const int heat_len = p.iter_cap * B;
  const float* q = p.qs + static_cast<long long>(b) * p.d;
  const long long* code_q = p.code_qs + static_cast<long long>(b) * p.W;

  // -- init: the entry seeds slot 0; a masked lane never enters ----------
  const bool lane_on = p.active[b] != 0;
  const int entry = lane_on ? p.entries[b] : -1;
  const float entry_d = lane_on ? p.entry_d[b] : INFINITY;
  for (int i = tid; i < ef; i += kThreads) {
    s_ids[i] = i == 0 ? entry : -1;
    s_d[i] = i == 0 ? entry_d : INFINITY;
    s_exp[i] = 0;
  }
  for (int i = tid; i < n_slots; i += kThreads) s_hash[i] = -1;
  int32_t* hn = p.heat_nodes + static_cast<long long>(b) * heat_len;
  uint8_t* hm = p.heat_mask + static_cast<long long>(b) * heat_len * M;
  for (int i = tid; i < heat_len; i += kThreads) hn[i] = -1;
  for (int i = tid; i < heat_len * M; i += kThreads) hm[i] = 0;
  __syncthreads();
  if (tid == 0 && entry >= 0) hash_insert(s_hash, p.hash_bits, entry);
  // IOStats, the same value in every thread
  int n_adj = 0, n_vec = lane_on ? 1 : 0, n_filt = 0, n_hops = 0;
  const int fidx = min(ef, 3 * p.k) - 1;
  const float q_norm = p.q_norms[b];
  const float mean_norm = *p.mean_norm;
  __syncthreads();

  for (int it = 0; it < p.iter_cap; ++it) {
    // -- continuation: budget left and an unexpanded candidate within
    //    the 3k-th best ----------------------------------------------------
    const float thresh = s_d[fidx];
    bool front = false;
    for (int i = tid; i < ef; i += kThreads) {
      const float di = s_d[i];
      front |= !s_exp[i] && isfinite(di) && di <= thresh;
    }
    const bool any_front = __syncthreads_or(front) != 0;
    if (!any_front || n_hops >= p.max_iters) break;

    // -- pop the B closest unexpanded (stable rank select) ----------------
    for (int i = tid; i < ef; i += kThreads) {
      const float fi = s_exp[i] ? INFINITY : s_d[i];
      int r = 0;
      for (int j = 0; j < ef; ++j) {
        const float fj = s_exp[j] ? INFINITY : s_d[j];
        r += (fj < fi) || (fj == fi && j < i);
      }
      if (r < B) s_slot[r] = i;
    }
    __syncthreads();
    bool act = false;
    int slot = 0;
    if (tid < B) {
      slot = s_slot[tid];
      const float sd = s_exp[slot] ? INFINITY : s_d[slot];
      act = isfinite(sd) && sd <= thresh;
      s_node[tid] = act ? s_ids[slot] : -1;
    }
    const int n_act = __syncthreads_count(act);
    if (act) s_exp[slot] = 1;

    // -- the B*M block: snapshot rows, visited, liveness, dedup ----------
    int row = -1;
    bool elig = false;
    if (tid < BM) {
      const int node = s_node[tid / M];
      row = node >= 0
                ? __ldg(p.adjacency + static_cast<long long>(node) * M +
                        tid % M)
                : -1;
      const bool valid = row >= 0 && row <= p.cap - 1;
      elig = valid && p.live[row] && !hash_contains(s_hash, p.hash_bits, row);
      c_row[tid] = row;
    }
    if (B > 1) {
      __syncthreads();
      if (elig) {
        for (int j = 0; j < tid; ++j) {
          if (c_row[j] == row) {
            elig = false;
            break;
          }
        }
      }
    }

    // -- SimHash prefilter (Eq. 5-6) and the sampling cap (Eq. 8) --------
    bool pre = false;
    int cols = 0;
    if (elig) {
      int ham = 0;
      const long long* cu = p.codes + static_cast<long long>(row) * p.W;
      for (int w = 0; w < p.W; ++w) {
        const unsigned long long x =
            static_cast<unsigned long long>(__ldg(code_q + w)) ^
            static_cast<unsigned long long>(__ldg(cu + w));
        ham += __popc(static_cast<unsigned>(x & 0xffffffffull));
      }
      cols = p.m_bits - ham;
      pre = true;
      if (FILTER) {
        const float delta_sq = s_d[p.k - 1];
        pre = !isfinite(delta_sq) ||
              static_cast<float>(cols) >=
                  hoeffding_threshold(q_norm, mean_norm, delta_sq, p.m_bits,
                                      p.slack);
      }
    }
    bool fetch = pre;
    if (SAMPLE) {
      if (tid < BM) c_score[tid] = pre ? cols : -1;
      const int n_pre = __syncthreads_count(pre);
      const int cap_dyn = static_cast<int>(
          ceilf(__fmul_rn(p.rho, static_cast<float>(n_pre))));
      if (pre) {
        const int si = c_score[tid];
        int r = 0;
        for (int j = 0; j < BM; ++j) {
          const int sj = c_score[j];
          r += (sj > si) || (sj == si && j < tid);
        }
        fetch = r < cap_dyn;
      }
    }
    if (tid < BM) c_fetch[tid] = fetch ? row : -1;
    const int n_elig = __syncthreads_count(elig);
    const int n_fetch = __syncthreads_count(fetch);

    // -- visited, stats, heat ----------------------------------------------
    if (fetch) hash_insert(s_hash, p.hash_bits, row);
    n_adj += n_act;
    n_vec += n_fetch;
    n_filt += n_elig - n_fetch;
    n_hops += n_act;
    if (RECORD_HEAT) {
      if (tid < B) hn[it * B + tid] = s_node[tid];
      if (tid < BM) hm[static_cast<long long>(it) * B * M + tid] = fetch;
    }

    // -- one warp per fetched candidate: fused row distance ---------------
    for (int j = warp; j < BM; j += kWarps) {
      const int id = c_fetch[j];
      float dist = INFINITY;
      if (id >= 0) {
        const long long off = static_cast<long long>(id) * p.d;
        if (TIER && !p.resident[id]) {
          const float scale = __ldg(p.qscale + id);
          dist = p.q8vec4 ? rowdist::l2_q8<true>(q, p.qvecs + off, scale,
                                                 p.d, lane)
                          : rowdist::l2_q8<false>(q, p.qvecs + off, scale,
                                                  p.d, lane);
        } else {
          dist = p.vec4 ? rowdist::l2_f32<true>(q, p.vectors + off, p.d, lane)
                        : rowdist::l2_f32<false>(q, p.vectors + off, p.d,
                                                 lane);
        }
      }
      if (lane == 0) c_dist[j] = dist;
    }
    __syncthreads();

    // -- one stable-rank merge of heap and block --------------------------
    const int n_all = ef + BM;
    int m_id[kMaxMergePerThread], m_exp[kMaxMergePerThread];
    float m_d[kMaxMergePerThread];
    int m_rank[kMaxMergePerThread];
#pragma unroll
    for (int r = 0; r < kMaxMergePerThread; ++r) {
      const int i = tid + r * kThreads;
      m_rank[r] = ef;  // not kept
      if (i < n_all) {
        if (i < ef) {
          m_id[r] = s_ids[i];
          m_d[r] = s_d[i];
          m_exp[r] = s_exp[i];
        } else {
          m_id[r] = c_fetch[i - ef];
          m_d[r] = c_dist[i - ef];
          m_exp[r] = m_id[r] < 0;  // unfetched entries count as expanded
        }
        const float di = m_d[r];
        int rank = 0;
        for (int j = 0; j < n_all; ++j) {
          const float dj = j < ef ? s_d[j] : c_dist[j - ef];
          rank += (dj < di) || (dj == di && j < i);
        }
        m_rank[r] = rank;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxMergePerThread; ++r) {
      if (m_rank[r] < ef) {
        s_ids[m_rank[r]] = m_id[r];
        s_d[m_rank[r]] = m_d[r];
        s_exp[m_rank[r]] = m_exp[r];
      }
    }
    __syncthreads();
  }

  // -- lazy delete: tombstones leave the heap, survivors re-pack ----------
  int32_t* ids_out = p.ids_out + static_cast<long long>(b) * ef;
  float* d_out = p.d_out + static_cast<long long>(b) * ef;
  if (LAZY) {
    int r_id[2];
    float r_d[2];
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * kThreads;
      if (i < ef) {
        r_id[r] = s_ids[i];
        const int safe = min(max(r_id[r], 0), p.cap - 1);
        const bool ok = r_id[r] >= 0 && p.returnable[safe];
        r_d[r] = ok ? s_d[i] : INFINITY;
      }
    }
    __syncthreads();
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * kThreads;
      if (i < ef) s_d[i] = r_d[r];
    }
    __syncthreads();
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * kThreads;
      if (i < ef) {
        int rank = 0;
        for (int j = 0; j < ef; ++j) {
          const float dj = s_d[j];
          rank += (dj < r_d[r]) || (dj == r_d[r] && j < i);
        }
        ids_out[rank] = isfinite(r_d[r]) ? r_id[r] : -1;
        d_out[rank] = r_d[r];
      }
    }
  } else {
    for (int i = tid; i < ef; i += kThreads) {
      ids_out[i] = s_ids[i];
      d_out[i] = s_d[i];
    }
  }
  if (tid == 0) {
    int32_t* st = p.stats_out + 4ll * b;
    st[0] = n_adj;
    st[1] = n_vec;
    st[2] = n_filt;
    st[3] = n_hops;
  }
}

template <bool T, bool L, bool H, bool F, bool S>
int launch(const Params& p, int bq, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        beam_kernel<T, L, H, F, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  beam_kernel<T, L, H, F, S><<<bq, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool T, bool L, bool H, bool F>
int pick_sample(const Params& p, int bq, size_t smem, cudaStream_t s,
                bool sample) {
  return sample ? launch<T, L, H, F, true>(p, bq, smem, s)
                : launch<T, L, H, F, false>(p, bq, smem, s);
}

template <bool T, bool L, bool H>
int pick_filter(const Params& p, int bq, size_t smem, cudaStream_t s,
                bool filter, bool sample) {
  return filter ? pick_sample<T, L, H, true>(p, bq, smem, s, sample)
                : pick_sample<T, L, H, false>(p, bq, smem, s, sample);
}

template <bool T, bool L>
int pick_heat(const Params& p, int bq, size_t smem, cudaStream_t s,
              bool heat, bool filter, bool sample) {
  return heat ? pick_filter<T, L, true>(p, bq, smem, s, filter, sample)
              : pick_filter<T, L, false>(p, bq, smem, s, filter, sample);
}

template <bool T>
int pick_lazy(const Params& p, int bq, size_t smem, cudaStream_t s,
              bool lazy, bool heat, bool filter, bool sample) {
  return lazy ? pick_heat<T, true>(p, bq, smem, s, heat, filter, sample)
              : pick_heat<T, false>(p, bq, smem, s, heat, filter, sample);
}

}  // namespace

extern "C" int beam_search_f32(
    const float* qs, const int32_t* entries, const float* entry_d,
    const int32_t* adjacency, const float* vectors, const long long* codes,
    const long long* code_qs, const uint8_t* live, const float* q_norms,
    const float* mean_norm, const uint8_t* returnable,
    const uint8_t* resident, const int8_t* qvecs, const float* qscale,
    const uint8_t* active, int32_t* ids_out, float* d_out,
    int32_t* stats_out, int32_t* heat_nodes, uint8_t* heat_mask, int bq,
    int d, int cap, int M, int W, int ef, int k, int B, int iter_cap,
    int max_iters, int m_bits, int hash_bits, float rho, float slack,
    int vec4, int q8vec4, int tier, int lazy, int record_heat, int filter,
    int sample, void* stream) {
  if (bq == 0) return 0;
  Params p{qs,        entries,    entry_d,   adjacency, vectors,
           codes,     code_qs,    live,      q_norms,   mean_norm,
           returnable, resident,  qvecs,     qscale,    active,
           ids_out,   d_out,      stats_out, heat_nodes, heat_mask,
           d,         cap,        M,         W,         ef,
           k,         B,          iter_cap,  max_iters, m_bits,
           hash_bits, rho,        slack,     vec4,      q8vec4};
  const size_t smem =
      sizeof(int) * (3 * static_cast<size_t>(ef) +
                     4 * static_cast<size_t>(B) * M +
                     2 * static_cast<size_t>(B) + (size_t{1} << hash_bits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tier ? pick_lazy<true>(p, bq, smem, s, lazy, record_heat, filter,
                                sample)
              : pick_lazy<false>(p, bq, smem, s, lazy, record_heat, filter,
                                 sample);
}
