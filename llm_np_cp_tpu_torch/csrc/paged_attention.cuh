// The float32 prefill tiles of the unified tick's block-table attention
// kernel (ragged_paged_attention.cu), on CUDA cores: float32 products
// keep the float32 serve path's tokens equal to the offline path's (the
// bf16 tiles run on the tensor cores there).
//
// One thread block attends `nq` consecutive queries x G query heads (a
// block's share, at most 4, of ONE kv head's) against K/V read straight
// from the paged pool ([NB, BS, K, D] per layer) through one row of the
// block table.  Query row r = qi * G + g; query qi sees the logical kv
// slots [lo[qi], hi[qi]] (inclusive; lo > hi = nothing).  The block walks
// the logical slots [s_begin, s_end) — its split of the union of what its
// queries can see, so slots outside every query's band are never read —
// in tiles of TS slots; each slot s of a tile lives in pool block
// table[s / BS] at offset s % BS.  It writes the normalised output, or,
// under split-KV, the split's float32 partials (acc, m, l) for
// split_kv.cuh's combine.
//
// Softmax: the classic online recurrence (running max m, rescale
// alpha = exp(m_prev - m_new)), not the TPU kernels' AMLA ln2-grid max
// with an exponent-add rescale.  Both compute the same function; they
// differ only in where p = exp(s - m) is rounded to the storage type
// before the PV product.  Masked slots are re-zeroed after the exp (a
// query with nothing visible yet has m = NEG_INF and would get p = 1),
// and a query with nothing visible at all writes zeros (or l = 0) — the
// TPU kernels' _finalize rule.
//
// Layout per tile: K/V staged as float32 in shared memory (K rows
// padded by one float: conflict-free column reads), loads coalesced
// along D (one pool slot's head row is D contiguous elements, slots K*D
// apart), scores rows x TS by scalar FMAs, one warp
// per query row for the max/sum, p rounded to T, then acc = acc*alpha +
// P V with each thread owning up to kMaxOut (row, dim) outputs.
#pragma once

#include "common.cuh"

namespace paged {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 32;  // outputs per thread: nq*G*D <= kThreads*kMaxOut

template <int D> struct Tile { static constexpr int TS = 64; };
template <> struct Tile<256> { static constexpr int TS = 32; };

// Dynamic shared memory of one block with `rows` = nq*G query rows.
template <int D>
inline size_t smem_bytes(int rows) {
  constexpr int TS = Tile<D>::TS;
  return sizeof(float) * (TS * (D + 1) + TS * D + rows * D + rows * TS + 3 * rows) +
         sizeof(int) * TS;
}

__device__ __forceinline__ bool visible(int s, int qi, const int* lo, const int* hi) {
  return s >= lo[qi] && s <= hi[qi];
}

// q / out: query 0 of this block's first head, queries `qstride`
// elements apart, heads D apart.  table: this row's block ids.  pacc /
// pm / pl (null: write `out`): the split's partials, row r at (r / G) *
// gfull + g0 + r % G (a tile's [8, gfull] rows, this block's heads from
// g0 on).
template <typename T, bool INT8, int D>
__device__ void attend(const T* __restrict__ q, T* __restrict__ out, size_t qstride,
                       const void* __restrict__ kp, const void* __restrict__ vp,
                       const float* __restrict__ ks, const float* __restrict__ vs,
                       const int* __restrict__ table, int BS, int K, int kh, int G, int nq,
                       const int* lo, const int* hi, int s_begin, int s_end, float scale,
                       float softcap, float* __restrict__ pacc, float* __restrict__ pm,
                       float* __restrict__ pl, int gfull, int g0) {
  constexpr int TS = Tile<D>::TS;
  constexpr int LD = D + 1;
  const int rows = nq * G;
  extern __shared__ float smem[];
  float* sK = smem;            // [TS][LD]
  float* sV = sK + TS * LD;    // [TS][D]
  float* sQ = sV + TS * D;     // [rows][D]
  float* sP = sQ + rows * D;   // [rows][TS] scores, then p
  float* sM = sP + rows * TS;  // [rows] running max
  float* sL = sM + rows;       // [rows] running sum
  float* sA = sL + rows;       // [rows] this tile's rescale
  int* sBlk = (int*)(sA + rows);  // [TS] pool block of each tile slot

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sQ[i] = to_f32(q[(r / G) * qstride + (r % G) * D + d]);
  }
  for (int r = tid; r < rows; r += kThreads) { sM[r] = LLM_NEG_INF; sL[r] = 0.f; }

  float acc[kMaxOut];
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) acc[u] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += TS) {
    for (int c = tid; c < TS; c += kThreads)
      sBlk[c] = (s0 + c < s_end) ? table[(s0 + c) / BS] : 0;
    __syncthreads();  // also orders the sQ/sM/sL init before first use
    for (int idx = tid; idx < TS * D; idx += kThreads) {
      const int c = idx / D, d = idx % D, s = s0 + c;
      float kv = 0.f, vv = 0.f;
      if (s < s_end) {
        const size_t soff = ((size_t)sBlk[c] * BS + s % BS) * K + kh;
        kv = load_kv<T, INT8>(kp, ks, soff * D + d, soff);
        vv = load_kv<T, INT8>(vp, vs, soff * D + d, soff);
      }
      sK[c * LD + d] = kv;
      sV[c * D + d] = vv;
    }
    __syncthreads();

    for (int idx = tid; idx < rows * TS; idx += kThreads) {
      const int r = idx / TS, c = idx % TS, s = s0 + c;
      float val = LLM_NEG_INF;
      if (s < s_end && visible(s, r / G, lo, hi)) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(sQ[r * D + d], sK[c * LD + d], dot);
        val = softcap_f(dot * scale, softcap);
      }
      sP[idx] = val;
    }
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      const int qi = r / G;
      float tmax = LLM_NEG_INF;
      for (int c = lane; c < TS; c += 32) tmax = fmaxf(tmax, sP[r * TS + c]);
      tmax = warp_max(tmax);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, tmax);
      float psum = 0.f;
      for (int c = lane; c < TS; c += 32) {
        const int s = s0 + c;
        const float p =
            (s < s_end && visible(s, qi, lo, hi)) ? expf(sP[r * TS + c] - m_new) : 0.f;
        psum += p;
        sP[r * TS + c] = round_to<T>(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < kMaxOut; ++u) {
      const int o = tid + u * kThreads;
      if (o < rows * D) {
        const int r = o / D, d = o % D;
        float pv = 0.f;
#pragma unroll 8
        for (int c = 0; c < TS; ++c) pv = fmaf(sP[r * TS + c], sV[c * D + d], pv);
        acc[u] = acc[u] * sA[r] + pv;
      }
    }
    __syncthreads();  // sBlk/sK/sV/sP are rewritten by the next tile
  }
  __syncthreads();  // no tile at all: sL init must land before the reads

#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) {
    const int o = tid + u * kThreads;
    if (o < rows * D) {
      const int r = o / D, d = o % D;
      const float l = sL[r];
      if (pacc == nullptr) {
        out[(r / G) * qstride + (r % G) * D + d] = from_f32<T>(acc[u] / (l == 0.f ? 1.f : l));
      } else {
        const int pr = (r / G) * gfull + g0 + r % G;
        pacc[(size_t)pr * D + d] = acc[u];
        if (d == 0) {
          pm[pr] = sM[r];
          pl[pr] = l;
        }
      }
    }
  }
}

}  // namespace paged
