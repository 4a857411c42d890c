// beam: the whole bottom-layer beam search of a query block in one launch,
// one warp per query.
//
// Replaces src/repro/kernels/beam/kernel.py::beam_search_fused_pallas (one
// grid program per query; heap and visited filter in VMEM; adjacency and
// vector rows by explicit row DMAs).  It computes what the port's
// traversal.beam_search computes over a resolved snapshot (one adjacency
// gather per popped node, one row distance per fetched candidate) and what
// kernels/beam/ref.py computes, with the same trip cap and the same
// decisions, so the ids, distances, IOStats and heat lanes are the same.
//
// Bound: bytes.  A search moves one adjacency row per expansion (4M bytes)
// and one vector row per fetched candidate (4d bytes, or d + 4 on the cold
// lane); the rest is a few hundred integer compares per trip.  But the
// 1,000 queries of a search block fill the 132 SMs in one wave, so a
// launch lasts as long as its slowest query's chain of trips, and a trip
// is a chain of dependent loads: the time is latency, trips times the
// length of one trip.  The layout shortens that chain.
//
// Layout on the H100: one warp per query, up to 4 queries per CTA (2 CTAs
// an SM by registers, so 1,056 queries in one wave), and no CTA barrier
// anywhere (warp votes, shuffles and __syncwarp only).  Each query's
// shared memory holds its visited set, its ef-slot heap twice, the B*M
// candidate block and the fetched list.  A trip is three rounds of
// dependent loads: the popped nodes' adjacency rows; then live[row] and
// the SimHash words (and resident[row] under the tier split) of every
// valid candidate at once, beside the visited probes in shared memory;
// then the vector rows of every fetched candidate at once, up to 16 rows
// (8 KiB at d = 128) in flight per warp, through row_dist.cuh's N-row
// forms.  Two paths, chosen by the shapes:
//   - SMALL (B = 1, M <= 32, ef <= 64: every search at the default
//     configuration): candidate j in lane j and heap slots lane and
//     lane + 32 in registers; the pop is two ballots and a shuffle, the
//     merge one pass of shuffles and ballots over the fetched list, and
//     the heap's shared copy only stages the merge's scatter;
//   - the general path: the heap in shared memory (the merge writes the
//     other copy), up to 4 candidates a lane.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), at 1,000 queries, ef =
// 48, B = 1, a trip takes about 3.4 us of the slowest query's 80-85: the
// three load rounds and the pop and merge arithmetic.  Issuing the vector
// rows of every unvisited candidate beside round 2 did not shorten it,
// and an L1 prefetch of the likely next adjacency rows lengthened it.
//
// - Visited: the Pallas kernel keeps bool[cap + 1] in VMEM, 1 MiB per
//   query at cap = 2^20, which does not fit shared memory.  The set only
//   ever holds the entry and the fetched ids, at most 1 + iter_cap * B * M
//   of them, so it is an exact open-addressing hash set of int32 ids in
//   shared memory with at least twice that many slots (4,096 slots, 16 KiB,
//   at ef = 48, M = 16).  Exact: a false positive would change answers.
// - Selection keeps the stable rank of the reference (ties to the lower
//   index, as `lax.top_k` and the port's stable sorts): the heap stays
//   sorted by distance, so the pop is the first B unexpanded slots within
//   the threshold (a ballot and a prefix count), the merge places a heap
//   slot i at i + #{fetched closer} and a fetched candidate at #{heap
//   entries no farther} + its stable rank among the fetched, and the
//   lazy re-pack is a prefix count of the survivors.
//   With B > 1 a node repeated in the block counts at its first
//   occurrence only.
// - Distances: row_dist.cuh's N-row forms sum each row exactly as
//   l2_f32 / l2_q8 (and so gather_l2.cu) sum it, so the fused and the
//   per-hop routes agree bitwise on the card even on float data.  Under
//   the tier split, resident rows take the f32 row and the others the
//   dequantising int8 row.
// - Decision arithmetic (cos_from_l2, the Hoeffding threshold, ceil(rho *
//   n_eligible)) follows the op order of src/repro_torch/core/simhash.py
//   with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so nvcc contracts
//   nothing, and the arccos is taken in f64 and rounded once to f32, as
//   the port does: one flipped threshold compare would change the ids.
//   The threshold is recomputed only when the k-th distance changed.
//
// Plain C interface, bound with ctypes: returns the cudaError_t of the
// launch (0 on success).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "row_dist.cuh"

namespace {

constexpr int kWarpsPerCta = 4;
constexpr int kMaxCpl = 4;             // B*M <= 128: candidates per lane
constexpr int kRows = 16;              // vector rows in flight per warp
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;    // 227 KiB of dynamic shared memory

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
  int vec4, q8vec4, lazy;
};

// One query's shared memory, in ints: the visited set first (16-byte
// aligned: it is cleared with int4 stores), then the two heap copies
// (ids, distances, expanded flags), the popped nodes, the candidate block
// (rows for the B > 1 dedup, sampling scores) and the fetched list (ids,
// distances, and under the tier split the positions of its hot and cold
// rows).  Rounded up to 4 ints so every query's set stays aligned.
inline int warp_ints(int ef, int B, int BM, int hash_bits) {
  const int n = (1 << hash_bits) + 6 * ef + B + 6 * BM;
  return (n + 3) & ~3;
}

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
// always ends.  Two lanes inserting the same key meet at the same slot.
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
  // clamp to [-1, 1] keeping NaN, as torch.clamp does (fminf/fmaxf would
  // turn it into -1): a table with a row of +inf has an infinite mean
  // norm, a NaN cosine and a NaN threshold, which no count passes
  c = c < -1.0f ? -1.0f : (c > 1.0f ? 1.0f : c);
  const float theta = __double2float_rn(acos(static_cast<double>(c)));
  const float pi = static_cast<float>(3.141592653589793);
  const float p = __fsub_rn(1.0f, __fdiv_rn(theta, pi));
  return __fsub_rn(__fmul_rn(p, static_cast<float>(m_bits)), slack);
}

// Distances of the fetched rows listed (as positions into f_id) in
// `list[0, n)`, written to f_d at those positions: kRows rows per round,
// all of a round's loads issued before its first sum.  A skipped row
// points at a readable row (the query, or the int8 lane's first row).
template <bool COLD>
__device__ __forceinline__ void fetch_distances(const Params& p,
                                                const float* q,
                                                const int* f_id, float* f_d,
                                                const int* list, int n,
                                                int lane) {
  for (int s = 0; s < n; s += kRows) {
    const int m = min(kRows, n - s);
    float out[kRows / 8];
    if (COLD) {
      const int8_t* rows[kRows];
      float scale[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int id = r < m ? f_id[list ? list[s + r] : s + r] : -1;
        rows[r] = id >= 0 ? p.qvecs + static_cast<long long>(id) * p.d
                          : p.qvecs;
        scale[r] = id >= 0 ? __ldg(p.qscale + id) : 0.f;
      }
      if (p.q8vec4) {
        rowdist::l2_q8_rows<kRows, true>(q, rows, scale, p.d, lane, out);
      } else {
        rowdist::l2_q8_rows<kRows, false>(q, rows, scale, p.d, lane, out);
      }
    } else if (m <= 8) {
      const float* rows[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        rows[r] = r < m ? p.vectors + static_cast<long long>(
                                          f_id[list ? list[s + r] : s + r]) *
                                          p.d
                        : q;
      }
      out[0] = p.vec4 ? rowdist::l2_f32_rows8<true>(q, rows, p.d, lane)
                      : rowdist::l2_f32_rows8<false>(q, rows, p.d, lane);
    } else {
      const float* rows[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        rows[r] = r < m ? p.vectors + static_cast<long long>(
                                          f_id[list ? list[s + r] : s + r]) *
                                          p.d
                        : q;
      }
      if (p.vec4) {
        rowdist::l2_f32_rows<kRows, true>(q, rows, p.d, lane, out);
      } else {
        rowdist::l2_f32_rows<kRows, false>(q, rows, p.d, lane, out);
      }
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int g = 0; g < kRows / 8; ++g) {
        const int r = 8 * g + rowdist::row_of_lane(lane);
        if (r < m) {
          f_d[list ? list[s + r] : s + r] = out[g];
        }
      }
    }
  }
}

template <bool TIER, bool SMALL, bool RECORD_HEAT, bool FILTER, bool SAMPLE>
__global__ void __launch_bounds__(32 * kWarpsPerCta, 2)
    beam_kernel(const Params p, int bq, int per_warp) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= bq) return;  // the warp's own exit: no CTA barrier follows
  const unsigned lt = (1u << lane) - 1u;
  const int ef = p.ef, M = p.M, B = p.B, BM = p.B * p.M;
  const int n_slots = 1 << p.hash_bits;
  int* hash = smem + static_cast<long long>(warp) * per_warp;
  // heap copy c: ids heap[c*ef, ...), distances heap[(2 + c)*ef, ...),
  // expanded flags heap[(4 + c)*ef, ...)
  int* heap = hash + n_slots;
  int* s_node = heap + 6 * ef;          // [B]
  int* c_row = s_node + B;              // [BM]
  int* c_score = c_row + BM;            // [BM]
  int* f_id = c_score + BM;             // [BM]
  float* f_d = reinterpret_cast<float*>(f_id + BM);  // [BM]
  int* f_hot = reinterpret_cast<int*>(f_d + BM);     // [BM] (TIER)
  int* f_cold = f_hot + BM;                          // [BM] (TIER)

  const int heat_len = p.iter_cap * B;
  const float* q = p.qs + static_cast<long long>(b) * p.d;
  const long long* code_q = p.code_qs + static_cast<long long>(b) * p.W;
  const int32_t* adj = p.adjacency;

  // -- init: the entry seeds slot 0; a masked lane never enters ----------
  const bool lane_on = p.active[b] != 0;
  const int entry = lane_on ? p.entries[b] : -1;
  const float entry_d = lane_on ? p.entry_d[b] : INFINITY;
  int4* hash4 = reinterpret_cast<int4*>(hash);
  for (int i = lane; i < n_slots / 4; i += 32) {
    hash4[i] = make_int4(-1, -1, -1, -1);
  }
  for (int i = lane; i < ef; i += 32) {
    heap[i] = i == 0 ? entry : -1;
    reinterpret_cast<float*>(heap + 2 * ef)[i] = i == 0 ? entry_d : INFINITY;
    heap[4 * ef + i] = 0;
  }
  __syncwarp();
  if (lane == 0 && entry >= 0) hash_insert(hash, p.hash_bits, entry);
  int32_t* hn = p.heat_nodes + static_cast<long long>(b) * heat_len;
  uint8_t* hm = p.heat_mask + static_cast<long long>(b) * heat_len * M;
  // IOStats, the same value in every lane
  int n_adj = 0, n_vec = lane_on ? 1 : 0, n_filt = 0, n_hops = 0;
  const int fidx = min(ef, 3 * p.k) - 1;
  const float q_norm = p.q_norms[b];
  const float mean_norm = *p.mean_norm;
  const int cpl = (BM + 31) >> 5;
  float thr = 0.f, thr_delta = NAN;  // threshold, for this k-th distance
  int cur = 0;
  int it = 0;

  if (SMALL) {
    // B = 1, M <= 32, ef <= 64: candidate j in lane j, heap slots lane and
    // lane + 32 in registers; the pop is two ballots, the merge a pass of
    // shuffles and ballots over the fetched list, and the heap's shared
    // copy 0 only stages the merge's scatter
    int id0 = lane == 0 ? entry : -1, id1 = -1;
    float d0 = lane == 0 ? entry_d : INFINITY, d1 = INFINITY;
    bool x0 = false, x1 = false;  // expanded
    const bool in0 = lane < ef, in1 = lane + 32 < ef;
    int* s_id = heap;
    float* s_d = reinterpret_cast<float*>(heap + 2 * ef);
    int* s_exp = heap + 4 * ef;
    for (; it < p.iter_cap && n_hops < p.max_iters; ++it) {
      // -- continuation and pop --------------------------------------
      const float thresh =
          __shfl_sync(kFull, fidx < 32 ? d0 : d1, fidx & 31);
      const unsigned m0 = __ballot_sync(
          kFull, in0 && !x0 && isfinite(d0) && d0 <= thresh);
      const unsigned m1 = __ballot_sync(
          kFull, in1 && !x1 && isfinite(d1) && d1 <= thresh);
      if ((m0 | m1) == 0) break;
      const int slot = m0 ? __ffs(m0) - 1 : 31 + __ffs(m1);
      const int node = __shfl_sync(kFull, slot < 32 ? id0 : id1, slot & 31);
      if (lane == (slot & 31)) {
        x0 = x0 || slot < 32;
        x1 = x1 || slot >= 32;
      }

      // -- round 1: the popped node's row, one candidate a lane ---------
      const int row = lane < M ? __ldg(adj + static_cast<long long>(node) * M +
                                       lane)
                               : -1;
      const int kth = p.k - 1;
      const float delta_sq = __shfl_sync(kFull, kth < 32 ? d0 : d1, kth & 31);
      if (FILTER && isfinite(delta_sq) && delta_sq != thr_delta) {
        thr = hoeffding_threshold(q_norm, mean_norm, delta_sq, p.m_bits,
                                  p.slack);
        thr_delta = delta_sq;
      }
      if (RECORD_HEAT && lane == 0) hn[it] = node;

      // -- round 2: liveness, SimHash words, visited --------------------
      bool elig = false, hot = true;
      int cols = 0;
      if (row >= 0 && row <= p.cap - 1) {
        const long long r = row;
        const uint8_t lv = __ldg(p.live + r);
        uint8_t res = 1;
        if (TIER) res = __ldg(p.resident + r);
        const long long* cu = p.codes + r * p.W;
        int ham = 0;
#pragma unroll 2
        for (int w = 0; w < p.W; ++w) {
          const unsigned long long x =
              static_cast<unsigned long long>(__ldg(code_q + w)) ^
              static_cast<unsigned long long>(__ldg(cu + w));
          ham += __popc(static_cast<unsigned>(x & 0xffffffffull));
        }
        const bool seen = hash_contains(hash, p.hash_bits, row);
        elig = lv && !seen;
        hot = res != 0;
        cols = p.m_bits - ham;
      }

      // -- SimHash prefilter (Eq. 5-6) and the sampling cap (Eq. 8) ----
      bool fetch = elig;
      if (FILTER && fetch) {
        fetch = !isfinite(delta_sq) || static_cast<float>(cols) >= thr;
      }
      if (SAMPLE) {
        const int n_pre = __popc(__ballot_sync(kFull, fetch));
        const int cap_dyn = static_cast<int>(
            ceilf(__fmul_rn(p.rho, static_cast<float>(n_pre))));
        const int si = fetch ? cols : -1;
        int r = 0;
        for (int jj = 0; jj < M; ++jj) {
          const int sj = __shfl_sync(kFull, si, jj);
          r += (sj > si) || (sj == si && jj < lane);
        }
        fetch = fetch && r < cap_dyn;
      }

      // -- visited, stats, heat, and the fetched list in block order ---
      const unsigned me = __ballot_sync(kFull, elig);
      const unsigned mf = __ballot_sync(kFull, fetch);
      const int n_fetch = __popc(mf);
      if (RECORD_HEAT && lane < M) {
        hm[static_cast<long long>(it) * M + lane] = fetch;
      }
      n_adj += 1;
      n_vec += n_fetch;
      n_filt += __popc(me) - n_fetch;
      n_hops += 1;
      if (n_fetch == 0) continue;  // nothing to merge: the heap stands
      const unsigned mh = TIER ? __ballot_sync(kFull, fetch && hot) : 0u;
      if (fetch) {
        const int pos = __popc(mf & lt);
        f_id[pos] = row;
        hash_insert(hash, p.hash_bits, row);
        if (TIER) {
          if (hot) {
            f_hot[__popc(mh & lt)] = pos;
          } else {
            f_cold[__popc(mf & ~mh & lt)] = pos;
          }
        }
      }
      __syncwarp();

      // -- round 3: every fetched row's distance ------------------------
      if (TIER) {
        fetch_distances<false>(p, q, f_id, f_d, f_hot, __popc(mh), lane);
        fetch_distances<true>(p, q, f_id, f_d, f_cold, n_fetch - __popc(mh),
                              lane);
      } else {
        fetch_distances<false>(p, q, f_id, f_d, nullptr, n_fetch, lane);
      }
      __syncwarp();

      // -- merge: fetched x (in lane x) goes to #{heap slots no farther}
      //    + its stable rank among the fetched, slot i to i + #{fetched
      //    closer}; one pass over the fetched list counts all three -----
      const float fd = lane < n_fetch ? f_d[lane] : INFINITY;
      const int fid = lane < n_fetch ? f_id[lane] : -1;
      int c0 = 0, c1 = 0, le = 0, rank = 0;
      for (int y = 0; y < n_fetch; ++y) {
        const float dy = __shfl_sync(kFull, fd, y);
        c0 += dy < d0;
        c1 += dy < d1;
        const int l = __popc(__ballot_sync(kFull, in0 && d0 <= dy)) +
                      __popc(__ballot_sync(kFull, in1 && d1 <= dy));
        if (lane == y) le = l;
        rank += (dy < fd) || (dy == fd && y < lane);
      }
      if (in0 && lane + c0 < ef) {
        s_id[lane + c0] = id0;
        s_d[lane + c0] = d0;
        s_exp[lane + c0] = x0;
      }
      if (in1 && lane + 32 + c1 < ef) {
        s_id[lane + 32 + c1] = id1;
        s_d[lane + 32 + c1] = d1;
        s_exp[lane + 32 + c1] = x1;
      }
      if (lane < n_fetch && le + rank < ef) {
        s_id[le + rank] = fid;
        s_d[le + rank] = fd;
        s_exp[le + rank] = 0;
      }
      __syncwarp();
      if (in0) {
        id0 = s_id[lane];
        d0 = s_d[lane];
        x0 = s_exp[lane] != 0;
      }
      if (in1) {
        id1 = s_id[lane + 32];
        d1 = s_d[lane + 32];
        x1 = s_exp[lane + 32] != 0;
      }
      __syncwarp();  // read before the next merge writes
    }
  } else {
    for (; it < p.iter_cap && n_hops < p.max_iters; ++it) {
      // the last trip's merge, visited inserts and block are written
      __syncwarp();
      const int* hid = heap + cur * ef;
      const float* hd = reinterpret_cast<const float*>(heap + (2 + cur) * ef);
      int* hexp = heap + (4 + cur) * ef;

      // -- continuation and pop: the first B unexpanded slots within the
      //    3k-th best (the heap is sorted, so these are the B closest
      //    unexpanded, ties to the lower slot) ---------------------------
      const float thresh = hd[fidx];
      int n_front = 0;
      for (int r0 = 0; r0 < ef; r0 += 32) {
        const int i = r0 + lane;
        bool cand = false;
        if (i < ef) {
          const float di = hd[i];
          cand = !hexp[i] && isfinite(di) && di <= thresh;
        }
        const unsigned m = __ballot_sync(kFull, cand);
        if (cand) {
          const int rank = n_front + __popc(m & lt);
          if (rank < B) {
            s_node[rank] = hid[i];
            hexp[i] = 1;
          }
        }
        n_front += __popc(m);
      }
      if (n_front == 0) break;
      const int n_act = min(B, n_front);
      __syncwarp();

      // -- the B*M block, round 1: the snapshot rows ------------------------
      int row[kMaxCpl];
      bool valid[kMaxCpl];
  #pragma unroll
      for (int c = 0; c < kMaxCpl; ++c) {
        const int j = lane + 32 * c;
        row[c] = -1;
        if (c < cpl && j < BM) {
          const int bb = j / M;
          if (bb < n_act) {
            row[c] = __ldg(adj + static_cast<long long>(s_node[bb]) * M +
                           (j - bb * M));
          }
        }
        valid[c] = row[c] >= 0 && row[c] <= p.cap - 1;
      }
      if (RECORD_HEAT) {
        for (int bb = lane; bb < B; bb += 32) {
          hn[it * B + bb] = bb < n_act ? s_node[bb] : -1;
        }
      }
      // the Hoeffding threshold of this trip's k-th distance, computed
      // while the rows are in flight
      const float delta_sq = hd[p.k - 1];
      if (FILTER && isfinite(delta_sq) && delta_sq != thr_delta) {
        thr = hoeffding_threshold(q_norm, mean_norm, delta_sq, p.m_bits,
                                  p.slack);
        thr_delta = delta_sq;
      }

      // -- round 2: liveness, SimHash words (and the tier lane) of every
      //    valid candidate at once; visited probes in shared memory -------
      bool elig[kMaxCpl], hot[kMaxCpl];
      int cols[kMaxCpl];
  #pragma unroll
      for (int c = 0; c < kMaxCpl; ++c) {
        elig[c] = false;
        hot[c] = true;
        cols[c] = 0;
        if (valid[c]) {
          const long long r = row[c];
          const uint8_t lv = __ldg(p.live + r);
          uint8_t res = 1;
          if (TIER) res = __ldg(p.resident + r);
          const long long* cu = p.codes + r * p.W;
          int ham = 0;
  #pragma unroll 2
          for (int w = 0; w < p.W; ++w) {
            const unsigned long long x =
                static_cast<unsigned long long>(__ldg(code_q + w)) ^
                static_cast<unsigned long long>(__ldg(cu + w));
            ham += __popc(static_cast<unsigned>(x & 0xffffffffull));
          }
          const bool seen = hash_contains(hash, p.hash_bits, row[c]);
          elig[c] = lv && !seen;
          hot[c] = res != 0;
          cols[c] = p.m_bits - ham;
        }
      }
      if (B > 1) {
        // a node repeated across the B rows counts at its first occurrence
  #pragma unroll
        for (int c = 0; c < kMaxCpl; ++c) {
          const int j = lane + 32 * c;
          if (c < cpl && j < BM) c_row[j] = row[c];
        }
        __syncwarp();
  #pragma unroll
        for (int c = 0; c < kMaxCpl; ++c) {
          if (elig[c]) {
            const int j = lane + 32 * c;
            for (int jj = 0; jj < j; ++jj) {
              if (c_row[jj] == row[c]) {
                elig[c] = false;
                break;
              }
            }
          }
        }
      }

      // -- SimHash prefilter (Eq. 5-6) and the sampling cap (Eq. 8) --------
      bool fetch[kMaxCpl];
  #pragma unroll
      for (int c = 0; c < kMaxCpl; ++c) {
        bool pre = elig[c];
        if (FILTER && pre) {
          pre = !isfinite(delta_sq) || static_cast<float>(cols[c]) >= thr;
        }
        fetch[c] = pre;
      }
      if (SAMPLE) {
        int n_pre = 0;
  #pragma unroll
        for (int c = 0; c < kMaxCpl; ++c) {
          const int j = lane + 32 * c;
          n_pre += __popc(__ballot_sync(kFull, fetch[c]));
          if (c < cpl && j < BM) c_score[j] = fetch[c] ? cols[c] : -1;
        }
        __syncwarp();
        const int cap_dyn = static_cast<int>(
            ceilf(__fmul_rn(p.rho, static_cast<float>(n_pre))));
  #pragma unroll
        for (int c = 0; c < kMaxCpl; ++c) {
          if (fetch[c]) {
            const int j = lane + 32 * c;
            const int si = c_score[j];
            int r = 0;
            for (int jj = 0; jj < BM; ++jj) {
              const int sj = c_score[jj];
              r += (sj > si) || (sj == si && jj < j);
            }
            fetch[c] = r < cap_dyn;
          }
        }
      }

      // -- visited, stats, heat, and the fetched list in block order -------
      int n_elig = 0, n_fetch = 0, n_hot = 0, n_cold = 0;
  #pragma unroll
      for (int c = 0; c < kMaxCpl; ++c) {
        const int j = lane + 32 * c;
        const unsigned me = __ballot_sync(kFull, elig[c]);
        const unsigned mf = __ballot_sync(kFull, fetch[c]);
        const unsigned mh = TIER ? __ballot_sync(kFull, fetch[c] && hot[c])
                                 : 0u;
        if (fetch[c]) {
          const int pos = n_fetch + __popc(mf & lt);
          f_id[pos] = row[c];
          hash_insert(hash, p.hash_bits, row[c]);
          if (TIER) {
            if (hot[c]) {
              f_hot[n_hot + __popc(mh & lt)] = pos;
            } else {
              f_cold[n_cold + __popc(mf & ~mh & lt)] = pos;
            }
          }
        }
        if (RECORD_HEAT && c < cpl && j < BM) {
          hm[static_cast<long long>(it) * BM + j] = fetch[c];
        }
        n_elig += __popc(me);
        n_fetch += __popc(mf);
        n_hot += __popc(mh);
        n_cold += __popc(mf & ~mh);
      }
      n_adj += n_act;
      n_vec += n_fetch;
      n_filt += n_elig - n_fetch;
      n_hops += n_act;
      if (n_fetch == 0) continue;  // nothing to merge: the heap stands
      __syncwarp();

      // -- round 3: every fetched row's distance ---------------------------
      if (TIER) {
        fetch_distances<false>(p, q, f_id, f_d, f_hot, n_hot, lane);
        fetch_distances<true>(p, q, f_id, f_d, f_cold, n_cold, lane);
      } else {
        fetch_distances<false>(p, q, f_id, f_d, nullptr, n_fetch, lane);
      }
      __syncwarp();

      // -- merge into the other heap copy: slot i moves to i + #{fetched
      //    closer}; fetched x goes to #{heap no farther} + its stable rank
      //    among the fetched; whatever lands at ef or beyond drops out -----
      int* nid = heap + (cur ^ 1) * ef;
      float* nd = reinterpret_cast<float*>(heap + (3 - cur) * ef);
      int* nexp = heap + (5 - cur) * ef;
      for (int i = lane; i < ef; i += 32) {
        const float di = hd[i];
        int cnt = 0;
        for (int x = 0; x < n_fetch; ++x) cnt += f_d[x] < di;
        const int np = i + cnt;
        if (np < ef) {
          nid[np] = hid[i];
          nd[np] = di;
          nexp[np] = hexp[i];
        }
      }
      for (int x = lane; x < n_fetch; x += 32) {
        const float dx = f_d[x];
        int lo = 0, hi = ef;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (hd[mid] <= dx) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        int pos = lo;
        for (int y = 0; y < n_fetch; ++y) {
          const float dy = f_d[y];
          pos += (dy < dx) || (dy == dx && y < x);
        }
        if (pos < ef) {
          nid[pos] = f_id[x];
          nd[pos] = dx;
          nexp[pos] = 0;
        }
      }
      cur ^= 1;
    }
    __syncwarp();
  }
  __syncwarp();

  // -- heat rows of the trips not taken (every row without heat) ----------
  const int from = RECORD_HEAT ? it : 0;
  for (int i = from * B + lane; i < heat_len; i += 32) hn[i] = -1;
  for (long long i = static_cast<long long>(from) * BM + lane;
       i < static_cast<long long>(heat_len) * M; i += 32) {
    hm[i] = 0;
  }

  // -- lazy delete: tombstones leave the heap, survivors re-pack ----------
  const int* hid = heap + cur * ef;
  const float* hd = reinterpret_cast<const float*>(heap + (2 + cur) * ef);
  int32_t* ids_out = p.ids_out + static_cast<long long>(b) * ef;
  float* d_out = p.d_out + static_cast<long long>(b) * ef;
  if (p.lazy) {
    // the heap is sorted, so a survivor's rank is the number of finite
    // survivors before it; every other slot comes out as (-1, +inf)
    int n_ok = 0;
    for (int r0 = 0; r0 < ef; r0 += 32) {
      const int i = r0 + lane;
      bool ok = false;
      int id = -1;
      float di = INFINITY;
      if (i < ef) {
        id = hid[i];
        di = hd[i];
        const int safe = min(max(id, 0), p.cap - 1);
        ok = id >= 0 && isfinite(di) && p.returnable[safe];
      }
      const unsigned m = __ballot_sync(kFull, ok);
      if (ok) {
        const int rank = n_ok + __popc(m & lt);
        ids_out[rank] = id;
        d_out[rank] = di;
      }
      n_ok += __popc(m);
    }
    for (int i = n_ok + lane; i < ef; i += 32) {
      ids_out[i] = -1;
      d_out[i] = INFINITY;
    }
  } else {
    for (int i = lane; i < ef; i += 32) {
      ids_out[i] = hid[i];
      d_out[i] = hd[i];
    }
  }
  if (lane == 0) {
    int32_t* st = p.stats_out + 4ll * b;
    st[0] = n_adj;
    st[1] = n_vec;
    st[2] = n_filt;
    st[3] = n_hops;
  }
}

template <bool T, bool L, bool H, bool F, bool S>
int launch(const Params& p, int bq, int per_warp, int warps, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        beam_kernel<T, L, H, F, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (bq + warps - 1) / warps;
  beam_kernel<T, L, H, F, S><<<grid, 32 * warps, smem, stream>>>(p, bq,
                                                                 per_warp);
  return static_cast<int>(cudaGetLastError());
}

template <bool T, bool L, bool H, bool F>
int pick_sample(const Params& p, int bq, int pw, int w, size_t smem,
                cudaStream_t s, bool sample) {
  return sample ? launch<T, L, H, F, true>(p, bq, pw, w, smem, s)
                : launch<T, L, H, F, false>(p, bq, pw, w, smem, s);
}

template <bool T, bool L, bool H>
int pick_filter(const Params& p, int bq, int pw, int w, size_t smem,
                cudaStream_t s, bool filter, bool sample) {
  return filter ? pick_sample<T, L, H, true>(p, bq, pw, w, smem, s, sample)
                : pick_sample<T, L, H, false>(p, bq, pw, w, smem, s, sample);
}

template <bool T, bool L>
int pick_heat(const Params& p, int bq, int pw, int w, size_t smem,
              cudaStream_t s, bool heat, bool filter, bool sample) {
  return heat ? pick_filter<T, L, true>(p, bq, pw, w, smem, s, filter,
                                        sample)
              : pick_filter<T, L, false>(p, bq, pw, w, smem, s, filter,
                                         sample);
}

template <bool T>
int pick_small(const Params& p, int bq, int pw, int w, size_t smem,
               cudaStream_t s, bool small, bool heat, bool filter,
               bool sample) {
  return small ? pick_heat<T, true>(p, bq, pw, w, smem, s, heat, filter,
                                    sample)
               : pick_heat<T, false>(p, bq, pw, w, smem, s, heat, filter,
                                     sample);
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
  if (B * M > 32 * kMaxCpl || hash_bits < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{qs,        entries,    entry_d,   adjacency, vectors,
           codes,     code_qs,    live,      q_norms,   mean_norm,
           returnable, resident,  qvecs,     qscale,    active,
           ids_out,   d_out,      stats_out, heat_nodes, heat_mask,
           d,         cap,        M,         W,         ef,
           k,         B,          iter_cap,  max_iters, m_bits,
           hash_bits, rho,        slack,     vec4,      q8vec4,
           lazy};
  const int per_warp = warp_ints(ef, B, B * M, hash_bits);
  const size_t warp_bytes = sizeof(int) * static_cast<size_t>(per_warp);
  if (warp_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int warps = static_cast<int>(kMaxSmem / warp_bytes);
  warps = warps < kWarpsPerCta ? warps : kWarpsPerCta;
  const size_t smem = warp_bytes * static_cast<size_t>(warps);
  // one candidate a lane and the heap in two registers a lane
  const bool small = B == 1 && M <= 32 && ef <= 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tier ? pick_small<true>(p, bq, per_warp, warps, smem, s, small,
                                 record_heat, filter, sample)
              : pick_small<false>(p, bq, per_warp, warps, smem, s, small,
                                  record_heat, filter, sample);
}
