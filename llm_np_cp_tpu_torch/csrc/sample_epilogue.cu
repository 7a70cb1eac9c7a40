// Fused sampling epilogue: final RMSNorm -> lm_head -> greedy argmax.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/sample_epilogue.py:
// sample_epilogue (_epilogue_kernel), tied and untied, for float heads
// and for int8 heads (quantized=True: the int8 payload converted to
// float, the float32 dot times the column's float32 scale, then the
// softcap and the mask — an int8 value is exact in bf16, so converting
// straight to float32 gives the TPU kernel's `.astype(xn.dtype)` product).
//
// What bounds it on the H100: bytes.  A decode step reads the whole
// lm-head weight (V*H elements: 525 MB for Llama-3.2-1B in bf16, 263 MB
// in int8 plus 0.5 MB of scales) for 2*N*H*V FLOPs, about N FLOPs per
// byte (2N in int8), far below the tensor cores' ridge: float32 FMAs on
// CUDA cores keep up, and keep the float32 path exact.  What the design
// does about it: the weight is read exactly once per call, in 16-byte
// (int8: 8-byte) vectors with several in flight per thread, spread over
// hundreds of blocks so every SM streams it; each vector, once converted,
// feeds the FMAs of every row, and each read of a normed row from shared
// memory feeds several columns.  The [N, V] logits are never written to
// device memory — each block keeps only one (best value, first index)
// pair per row.
//
// Design (the TPU kernel's single sequential vocab grid would use one SM):
// kernel 1 splits the vocab into tiles of 256 columns, one block each.
// Every block recomputes the final norm of all N rows (N x H is tiny and
// sits in L2): float32 sum of squares, rsqrt, weight (+1 under unit
// offset), rounded to the activation type exactly as the TPU kernel's
// `.astype(xn.dtype)`.  Rows go in passes of R = 4 or 8 (a template
// bucket; a short pass computes zero rows and drops them).
// - Tied [V,H]: a warp takes 4 columns at a time; each lane loads the 4
//   weight rows' 16-byte vectors along H, two steps ahead (8 loads in
//   flight), converts them once and reads each chunk of the normed rows
//   once for all 4 columns.  The normed rows sit in shared memory as
//   float32, permuted so that the 32 lanes' chunks lie side by side (no
//   bank conflicts, no conversion per read) — as T, converted per read,
//   where float32 rows would leave one block an SM (8 rows of
//   Gemma-2-27B's H = 4608: 144 KiB).  A column group's 4 x R sums
//   are folded over the warp in 31 shuffles (16 at 4 rows), after which
//   each lane owns one (row, column) and keeps its row's best.
// - Untied [H,V]: a lane owns 8 consecutive columns (one 16-byte vector
//   of bf16, two of float32, one 8-byte vector of int8: a warp's load is
//   256-512 contiguous bytes of a head row); the block's 8 warps split H
//   into contiguous slices and stream them 4 rows a step (int8: 8), one
//   read of 4 consecutive elements of a normed row (the same address for
//   the whole warp) feeding 4 x 8 FMAs into acc[R][8]; the warps' partial
//   dots are summed through
//   shared memory once per tile in a fixed order.  A head whose rows are
//   not 16-byte aligned (V * sizeof(W) % 16 != 0) takes the same loop
//   with scalar loads (VEC = false).
// Then the int8 scale of the column, the softcap, the `col < V` mask and
// one partial (value, index) per row.  Kernel 2 combines the partials of
// each row.  The rule everywhere: greater value wins, and on equal values
// the lower index wins — jnp.argmax's first-occurrence rule.
#include <limits.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileV = 256;      // vocab columns per block
constexpr int kMaxRows = 8;      // rows per pass at most (one warp normalises one row)
constexpr int kCols = kTileV / 32;  // untied: consecutive columns per lane
constexpr int kTiedCols = 4;     // tied: columns a warp takes at once

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(v2, i2, v, i)) { v = v2; i = i2; }
  }
}

// 16-byte vector of T
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// C consecutive elements of T (C * sizeof(T) a multiple of 16 bytes,
// p 16-byte aligned) as float, in 16-byte loads
template <typename T, int C>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  static_assert((C * sizeof(T)) % 16 == 0, "whole 16-byte vectors");
#pragma unroll
  for (int j = 0; j < C / Vec<T>::N; ++j) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[j];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i) out[j * Vec<T>::N + i] = to_f32(e[i]);
  }
}

// 4 consecutive elements of T (p 4-element aligned) as float: one float4
// or one 8-byte read of shared memory
template <typename T> __device__ __forceinline__ void load4(const T* p, float* out);
template <> __device__ __forceinline__ void load4<float>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <> __device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(v.x << 16); out[1] = __uint_as_float(v.x & 0xffff0000u);
  out[2] = __uint_as_float(v.y << 16); out[3] = __uint_as_float(v.y & 0xffff0000u);
}

// K consecutive elements of T (p K-element aligned) as float: whole
// 16-byte reads, or one 8-byte read of 4 bf16
template <typename T, int K>
__device__ __forceinline__ void load_k(const T* p, float* out) {
  if constexpr ((K * sizeof(T)) % 16 == 0) load_vec<T, K>(p, out);
  else load4<T>(p, out);
}

// One 32-bit word of packed W elements as float.  int8: each byte biased
// by 128 (xor 0x80), byte-permuted into 0x4B0000xx = 2^23 + (x + 128),
// minus 2^23 + 128 — exact, an integer op and a float add per element in
// place of the quarter-rate I2F.
template <typename W> __device__ __forceinline__ void word_f32(uint32_t u, float* out);
template <> __device__ __forceinline__ void word_f32<float>(uint32_t u, float* out) {
  out[0] = __uint_as_float(u);
}
template <> __device__ __forceinline__ void word_f32<__nv_bfloat16>(uint32_t u, float* out) {
  out[0] = __uint_as_float(u << 16);
  out[1] = __uint_as_float(u & 0xffff0000u);
}
template <> __device__ __forceinline__ void word_f32<int8_t>(uint32_t u, float* out) {
  u ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
}

// NW words of packed W elements as float
template <typename W, int NW>
__device__ __forceinline__ void words_f32(const uint32_t* u, float* out) {
#pragma unroll
  for (int k = 0; k < NW; ++k) word_f32<W>(u[k], out + k * (4 / sizeof(W)));
}

template <int B> struct UintOf;
template <> struct UintOf<1> { using type = uint8_t; };
template <> struct UintOf<2> { using type = uint16_t; };
template <> struct UintOf<4> { using type = uint32_t; };

// The raw bits of kCols consecutive columns of one head row
template <typename W> struct Cols {
  static constexpr int kWords = kCols * sizeof(W) / 4;
  uint32_t u[kWords];
};

// Columns col0 .. col0 + kCols - 1 of the head row `row`; columns at or
// past V read as 0.  VEC: 16-byte pieces (int8: one 8-byte piece), each
// wholly inside or wholly past V because V * sizeof(W) % 16 == 0; else
// one load per element.
template <typename W, bool VEC>
__device__ __forceinline__ Cols<W> load_cols(const W* row, int col0, int V) {
  Cols<W> c;
  if constexpr (VEC) {
    constexpr int kPieceWords = Cols<W>::kWords < 4 ? Cols<W>::kWords : 4;
    constexpr int kPieceCols = kPieceWords * 4 / sizeof(W);
#pragma unroll
    for (int j = 0; j < Cols<W>::kWords / kPieceWords; ++j) {
      const bool in = col0 + (j + 1) * kPieceCols <= V;
      if constexpr (kPieceWords == 4) {
        const uint4 v = in ? *reinterpret_cast<const uint4*>(row + col0 + j * kPieceCols)
                           : make_uint4(0u, 0u, 0u, 0u);
        c.u[4 * j] = v.x; c.u[4 * j + 1] = v.y; c.u[4 * j + 2] = v.z; c.u[4 * j + 3] = v.w;
      } else {
        static_assert(kPieceWords == 2, "8-byte pieces");
        const uint2 v = in ? *reinterpret_cast<const uint2*>(row + col0 + j * kPieceCols)
                           : make_uint2(0u, 0u);
        c.u[2 * j] = v.x; c.u[2 * j + 1] = v.y;
      }
    }
  } else {
    using U = typename UintOf<sizeof(W)>::type;
    constexpr int kPerWord = 4 / sizeof(W);
#pragma unroll
    for (int k = 0; k < Cols<W>::kWords; ++k) c.u[k] = 0u;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const uint32_t bits = col0 + e < V ? (uint32_t)reinterpret_cast<const U*>(row)[col0 + e] : 0u;
      c.u[e / kPerWord] |= bits << (8 * sizeof(W) * (e % kPerWord));
    }
  }
  return c;
}

// Sums N values per lane over the warp in log2(32) shuffle steps, halving
// the values a lane holds at each step (the upper lane of each pair keeps
// the upper half): N - 1 shuffles in place of 5 N.  A lane ends with the
// sum of value lane >> (5 - log2 N) in v[0]; the order is fixed.
template <int N, int O>
__device__ __forceinline__ void fold(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int M = N / 2;
      const bool upper = lane & O;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float send = upper ? v[i] : v[i + M];
        const float keep = upper ? v[i + M] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      fold<M, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      fold<1, O / 2>(v, lane);
    }
  }
}

// The normed rows' stride in shared memory.  Tied: H rounded up to whole
// steps of the warp's 16-byte weight vectors (32 * VN elements), since a
// row is stored permuted so that the K elements every lane reads for one
// chunk lie side by side (conflict-free reads; see tied_slot).
template <typename W, bool TIED>
__host__ __device__ __forceinline__ int x_stride(int H) {
  constexpr int step = 32 * (16 / sizeof(W));
  return TIED ? (H + step - 1) / step * step : H;
}

// Tied: the shared slot of element h of a normed row.  Element h sits in
// the weight vector of lane `ln` at step `blk`, chunk `j`, position `e`;
// the slot puts each chunk's 32 lanes next to each other.  The identity
// when a vector is one chunk (VN == K).
template <int VN, int K>
__device__ __forceinline__ int tied_slot(int h) {
  const int blk = h / (32 * VN), within = h % (32 * VN);
  const int ln = within / VN, j = (within % VN) / K, e = within % K;
  return blk * 32 * VN + (j * 32 + ln) * K + e;
}

// T: activation type (x, gamma); W: weight type (T, or int8_t with a
// float32 scale per vocab column in `wscale`); R: rows per pass; VEC:
// untied rows 16-byte aligned (the tied loop always is); FROWS: tied
// rows kept as float32 (else as T)
template <typename T, typename W, bool TIED, int R, bool VEC, bool FROWS>
__global__ void __launch_bounds__(kThreads, 2)
epilogue_tile_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     const W* __restrict__ w, const float* __restrict__ wscale,
                     float* __restrict__ part_val, int* __restrict__ part_idx, int N,
                     int H, int V, float eps, int unit_offset, float softcap) {
  static_assert(R <= kMaxRows && R <= kWarps, "one warp normalises one row");
  constexpr bool kScaled = std::is_same<W, int8_t>::value;
  constexpr int VN = Vec<W>::N;  // weight elements per 16-byte vector
  // tied: the normed rows as float32 (each rounded to T first) or T,
  // read K at a time; untied: as T, read 4 at a time by the whole warp
  // (broadcast)
  constexpr int K = sizeof(W) == 1 || VN < 8 ? 4 : 8;
  using XS = typename std::conditional<TIED && FROWS, float, T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  XS* sX = reinterpret_cast<XS*>(smem_raw);  // [R][Hs] normed rows
  __shared__ float sBestV[kWarps][kMaxRows];
  __shared__ int sBestI[kWarps][kMaxRows];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, nt = gridDim.x;
  const int v0 = tile * kTileV;
  const int Hs = x_stride<W, TIED>(H);

  for (int n0 = 0; n0 < N; n0 += R) {
    const int nr = min(R, N - n0);
    __syncthreads();  // previous pass's sX / sBest reads are done
    if (warp < nr) {
      const T* xr = x + (size_t)(n0 + warp) * H;
      float ss = 0.f;
      for (int hh = lane; hh < H; hh += 32) {
        const float xf = to_f32(xr[hh]);
        ss = fmaf(xf, xf, ss);
      }
      ss = warp_sum(ss);
      const float inv = rsqrtf(ss / (float)H + eps);
      for (int hh = lane; hh < H; hh += 32) {
        float g = to_f32(gamma[hh]);
        if (unit_offset) g += 1.f;
        const float xn = to_f32(xr[hh]) * inv * g;
        if constexpr (TIED) sX[warp * Hs + tied_slot<VN, K>(hh)] = from_f32<XS>(round_to<T>(xn));
        else sX[warp * Hs + hh] = from_f32<T>(xn);
      }
    } else if (warp < R) {
      // a short pass's spare rows: zeros, computed and dropped
      for (int hh = lane; hh < Hs; hh += 32) sX[warp * Hs + hh] = from_f32<XS>(0.f);
    }
    __syncthreads();

    if constexpr (TIED) {
      // w [V, H]: warp `warp` takes columns v0 + warp*32 .. +31, kTiedCols
      // at a time (past V: the last column again, masked below); lane `lane`
      // the 16-byte vectors at h = hb + s*32*VN + lane*VN, two steps (s) of
      // kTiedCols loads in flight.  Each vector is converted in chunks of K
      // elements, and each chunk of a normed row is read once for all
      // kTiedCols columns.  int8 takes chunks of 4: 8 would spill at 8 rows.
      constexpr int KW = K * sizeof(W) / 4;  // words per chunk
      constexpr int NV = kTiedCols * R;      // sums a column group ends with
      static_assert(NV == 16 || NV == 32, "one or two lanes a sum");
      constexpr int S = NV == 32 ? 0 : 1;    // a lane's sum: index lane >> S
      const int mine = lane >> S, myc = mine / R, myr = mine % R;
      float my_v = -INFINITY;  // the best of this lane's row over its columns
      int my_i = INT_MAX;
      for (int cg = 0; cg < kTileV / kWarps; cg += kTiedCols) {
        const int colb = v0 + warp * (kTileV / kWarps) + cg;
        const W* wr[kTiedCols];
#pragma unroll
        for (int c = 0; c < kTiedCols; ++c) wr[c] = w + (size_t)min(colb + c, V - 1) * H;
        float acc[kTiedCols * R];
#pragma unroll
        for (int i = 0; i < kTiedCols * R; ++i) acc[i] = 0.f;
        for (int hb = 0; hb < H; hb += 2 * 32 * VN) {
          uint4 raw[2][kTiedCols];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int h = hb + s * 32 * VN + lane * VN;
#pragma unroll
            for (int c = 0; c < kTiedCols; ++c)
              raw[s][c] = h < H ? *reinterpret_cast<const uint4*>(wr[c] + h)
                                : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int hs = hb + s * 32 * VN;  // the step's first element
            if (hs + lane * VN < H) {
#pragma unroll
              for (int j = 0; j < VN / K; ++j) {
                float wf[kTiedCols][K];
#pragma unroll
                for (int c = 0; c < kTiedCols; ++c)
                  words_f32<W, KW>(reinterpret_cast<const uint32_t*>(&raw[s][c]) + j * KW, wf[c]);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                  float xv[K];
                  load_k<XS, K>(sX + r * Hs + hs + (j * 32 + lane) * K, xv);
#pragma unroll
                  for (int c = 0; c < kTiedCols; ++c)
#pragma unroll
                    for (int i = 0; i < K; ++i)
                      acc[c * R + r] = fmaf(xv[i], wf[c][i], acc[c * R + r]);
                }
              }
            }
          }
        }
        fold<NV, 16>(acc, lane);
        const int col = colb + myc;
        float s = acc[0];
        if (kScaled) s *= wscale[min(col, V - 1)];
        s = softcap_f(s, softcap);
        if (col < V && better(s, col, my_v, my_i)) { my_v = s; my_i = col; }
      }
      // the lanes of one row: the best over the lane bits that are not
      // the row's, written by the lowest of them
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        if (((R - 1) << S) & o) continue;
        const float v2 = __shfl_xor_sync(0xffffffffu, my_v, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, my_i, o);
        if (better(v2, i2, my_v, my_i)) { my_v = v2; my_i = i2; }
      }
      if ((lane & ~((R - 1) << S)) == 0 && myr < nr) {
        sBestV[warp][myr] = my_v;
        sBestI[warp][myr] = my_i;
      }
    } else {
      // w [H, V]: every warp takes the tile's kTileV columns, lane `lane`
      // the kCols from col0; warp `warp` the rows [h_lo, h_hi), U rows a
      // step (vector loads: U * kCols * sizeof(W) >= 64 bytes in flight per
      // lane).  H is a multiple of U: the launcher holds H to whole 16-byte
      // rows.
      constexpr int U = sizeof(W) == 1 && VEC ? 8 : 4;
      __shared__ __align__(16) float sPart[kWarps][kTileV];
      const int col0 = v0 + lane * kCols;
      const int slice = (H + kWarps * U - 1) / (kWarps * U) * U;
      const int h_lo = warp * slice, h_hi = min(H, h_lo + slice);
      float acc[R][kCols];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
      for (int hh = h_lo; hh < h_hi; hh += U) {
        Cols<W> raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u) raw[u] = load_cols<W, VEC>(w + (size_t)(hh + u) * V, col0, V);
#pragma unroll
        for (int q = 0; q < U; q += 4) {
          float wf[4][kCols];
#pragma unroll
          for (int k = 0; k < 4; ++k) words_f32<W, Cols<W>::kWords>(raw[q + k].u, wf[k]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float xv[4];
            load4<T>(sX + r * H + hh + q, xv);
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(xv[k], wf[k][c], acc[r][c]);
          }
        }
      }
      // the warps' partial dots, summed per column in warp order; thread
      // `tid` then owns column v0 + tid
      float best_v[R];
      int best_i[R];
      const int col = v0 + tid;
      const float cs = kScaled && col < V ? wscale[col] : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        best_v[r] = -INFINITY;
        best_i[r] = INT_MAX;
        if (r < nr) {
          __syncthreads();  // the previous row's reads of sPart are done
          float4* dst = reinterpret_cast<float4*>(&sPart[warp][lane * kCols]);
#pragma unroll
          for (int c = 0; c < kCols; c += 4)
            dst[c / 4] = make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
          __syncthreads();
          if (col < V) {
            float s = 0.f;
#pragma unroll
            for (int wi = 0; wi < kWarps; ++wi) s += sPart[wi][tid];
            if (kScaled) s *= cs;
            best_v[r] = softcap_f(s, softcap);
            best_i[r] = col;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          warp_argmax(best_v[r], best_i[r]);
          if (lane == 0) { sBestV[warp][r] = best_v[r]; sBestI[warp][r] = best_i[r]; }
        }
      }
    }

    __syncthreads();
    if (tid < nr) {
      float bv = sBestV[0][tid];
      int bi = sBestI[0][tid];
      for (int wi = 1; wi < kWarps; ++wi)
        if (better(sBestV[wi][tid], sBestI[wi][tid], bv, bi)) { bv = sBestV[wi][tid]; bi = sBestI[wi][tid]; }
      part_val[(size_t)(n0 + tid) * nt + tile] = bv;
      part_idx[(size_t)(n0 + tid) * nt + tile] = bi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
epilogue_combine_kernel(const float* __restrict__ part_val,
                        const int* __restrict__ part_idx, int* __restrict__ out, int nt) {
  __shared__ float sV[kWarps];
  __shared__ int sI[kWarps];
  const int n = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int t = tid; t < nt; t += kThreads) {
    const float v = part_val[(size_t)n * nt + t];
    const int i = part_idx[(size_t)n * nt + t];
    if (better(v, i, bv, bi)) { bv = v; bi = i; }
  }
  warp_argmax(bv, bi);
  if (lane == 0) { sV[warp] = bv; sI[warp] = bi; }
  __syncthreads();
  if (tid == 0) {
    for (int wi = 1; wi < kWarps; ++wi)
      if (better(sV[wi], sI[wi], sV[0], sI[0])) { sV[0] = sV[wi]; sI[0] = sI[wi]; }
    out[n] = sI[0];
  }
}

// the normed rows' bytes in shared memory
template <typename T, typename W, bool TIED, int R, bool FROWS>
size_t rows_smem(int H) {
  return (TIED && FROWS ? sizeof(float) : sizeof(T)) * (size_t)R * x_stride<W, TIED>(H);
}

template <typename T, typename W, bool TIED, int R, bool VEC, bool FROWS = true>
cudaError_t launch(const void* x, const void* gamma, const void* w, const float* ws,
                   float* pv, int* pi, int* out, int N, int H, int V, float eps,
                   int unit_offset, float softcap, cudaStream_t stream) {
  const int nt = (V + kTileV - 1) / kTileV;
  const size_t smem = rows_smem<T, W, TIED, R, FROWS>(H);
  static size_t configured = 0;
  cudaError_t e = ensure_smem(epilogue_tile_kernel<T, W, TIED, R, VEC, FROWS>, smem, &configured);
  if (e != cudaSuccess) return e;
  epilogue_tile_kernel<T, W, TIED, R, VEC, FROWS><<<nt, kThreads, smem, stream>>>(
      (const T*)x, (const T*)gamma, (const W*)w, ws, pv, pi, N, H, V, eps, unit_offset,
      softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  epilogue_combine_kernel<<<N, kThreads, 0, stream>>>(pv, pi, out, nt);
  return cudaGetLastError();
}

// Tied: whether float32 rows still let two blocks share an SM, as the
// launch bounds plan for (asked of the occupancy calculator once per H)
template <typename T, typename W, int R>
cudaError_t float_rows_fit(int H, bool* fit) {
  static int known_h = -1;
  static bool known_fit = true;
  static size_t configured = 0;
  if (H != known_h) {
    const auto kernel = epilogue_tile_kernel<T, W, true, R, true, true>;
    const size_t smem = rows_smem<T, W, true, R, true>(H);
    cudaError_t e = ensure_smem(kernel, smem, &configured);
    int blocks = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    if (e != cudaSuccess) return e;
    known_fit = blocks >= 2;
    known_h = H;
  }
  *fit = known_fit;
  return cudaSuccess;
}

// the row bucket (4 or 8 rows a pass); tied, float32 or T rows; untied,
// the vector or scalar loads
template <typename T, typename W, int R>
cudaError_t launch_rows(int tied, const void* x, const void* gamma, const void* w,
                        const float* ws, float* pv, int* pi, int* out, int N, int H, int V,
                        float eps, int unit_offset, float softcap, cudaStream_t st) {
  if (tied) {
    if constexpr (!std::is_same<T, float>::value) {
      bool fit = true;
      const cudaError_t e = float_rows_fit<T, W, R>(H, &fit);
      if (e != cudaSuccess) return e;
      if (!fit)
        return launch<T, W, true, R, true, false>(x, gamma, w, ws, pv, pi, out, N, H, V, eps, unit_offset, softcap, st);
    }
    return launch<T, W, true, R, true>(x, gamma, w, ws, pv, pi, out, N, H, V, eps, unit_offset, softcap, st);
  }
  const bool vec = ((size_t)V * sizeof(W)) % 16 == 0 && (uintptr_t)w % 16 == 0;
  return vec ? launch<T, W, false, R, true>(x, gamma, w, ws, pv, pi, out, N, H, V, eps, unit_offset, softcap, st)
             : launch<T, W, false, R, false>(x, gamma, w, ws, pv, pi, out, N, H, V, eps, unit_offset, softcap, st);
}

template <typename T, typename W>
cudaError_t launch_layout(int tied, const void* x, const void* gamma, const void* w,
                          const float* ws, float* pv, int* pi, int* out, int N, int H, int V,
                          float eps, int unit_offset, float softcap, cudaStream_t st) {
  // 16-byte rows of both the weight and the normed activations
  if (H % Vec<W>::N != 0 || H % Vec<T>::N != 0) return cudaErrorInvalidValue;
  return N > 4 ? launch_rows<T, W, 8>(tied, x, gamma, w, ws, pv, pi, out, N, H, V, eps, unit_offset, softcap, st)
               : launch_rows<T, W, 4>(tied, x, gamma, w, ws, pv, pi, out, N, H, V, eps, unit_offset, softcap, st);
}

}  // namespace

extern "C" int sample_epilogue_num_tiles(int V) { return (V + kTileV - 1) / kTileV; }

// x [N,H], gamma [H] of `dtype`; w [V,H] (tied) or [H,V] (untied), of
// `dtype`, or int8 when w_scale (float32 [V], one scale per vocab column)
// is not null; part_val/part_idx [N, num_tiles(V)] scratch; out [N] int32.
extern "C" int sample_epilogue_launch(const void* x, const void* gamma, const void* w,
                                      const void* w_scale, void* part_val, void* part_idx,
                                      void* out, int N, int H, int V, int tied, float eps,
                                      int unit_offset, float softcap, int dtype, void* stream) {
  if (N <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  float* pv = (float*)part_val;
  int* pi = (int*)part_idx;
  int* o = (int*)out;
  const float* ws = (const float*)w_scale;
  if (dtype == 0)
    return ws ? launch_layout<float, int8_t>(tied, x, gamma, w, ws, pv, pi, o, N, H, V, eps, unit_offset, softcap, st)
              : launch_layout<float, float>(tied, x, gamma, w, ws, pv, pi, o, N, H, V, eps, unit_offset, softcap, st);
  if (dtype == 1)
    return ws ? launch_layout<__nv_bfloat16, int8_t>(tied, x, gamma, w, ws, pv, pi, o, N, H, V, eps, unit_offset, softcap, st)
              : launch_layout<__nv_bfloat16, __nv_bfloat16>(tied, x, gamma, w, ws, pv, pi, o, N, H, V, eps, unit_offset, softcap, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* llm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
