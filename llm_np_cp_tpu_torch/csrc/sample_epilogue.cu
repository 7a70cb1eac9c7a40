// Fused sampling epilogue: final RMSNorm -> lm_head -> greedy argmax.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/sample_epilogue.py:
// sample_epilogue (_epilogue_kernel), float heads, tied and untied.
//
// What bounds it on the H100: bytes.  A decode step reads the whole
// lm-head weight (V*H elements: 525 MB for Llama-3.2-1B in bf16) for
// 2*N*H*V FLOPs, about N FLOPs per byte.  What the design does about it:
// the weight is read exactly once per call, spread over hundreds of
// blocks so every SM streams it, and the [N, V] logits are never written
// to device memory — each block keeps only one (best value, first index)
// pair per row.
//
// Design (the TPU kernel's single sequential vocab grid would use one SM):
// kernel 1 splits the vocab into tiles of 256 columns, one block each.
// Every block recomputes the final norm of all N rows (N x H is tiny and
// sits in L2): float32 sum of squares, rsqrt, weight (+1 under unit
// offset), rounded to the activation type exactly as the TPU kernel's
// `.astype(xn.dtype)`.  Then it computes its tile's logits for all rows
// in float32 (tied [V,H]: one warp per column, 16-byte loads along H;
// untied [H,V]: one thread per column, coalesced along V), applies the
// softcap and the `col < V` mask, and writes one partial (value, index)
// per row.  Kernel 2 combines the partials of each row.  The rule
// everywhere: greater value wins, and on equal values the lower index
// wins — jnp.argmax's first-occurrence rule.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileV = 256;  // vocab columns per block
constexpr int kRows = 8;     // rows per pass (one warp normalises one row)

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

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f32(e[i]);
}

template <typename T, bool TIED>
__global__ void __launch_bounds__(kThreads)
epilogue_tile_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ w, float* __restrict__ part_val,
                     int* __restrict__ part_idx, int N, int H, int V, float eps,
                     int unit_offset, float softcap) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sX = reinterpret_cast<T*>(smem_raw);  // [kRows][H] normed rows
  __shared__ float sBestV[kWarps][kRows];
  __shared__ int sBestI[kWarps][kRows];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, nt = gridDim.x;
  const int v0 = tile * kTileV;

  for (int n0 = 0; n0 < N; n0 += kRows) {
    const int nr = min(kRows, N - n0);
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
        sX[warp * H + hh] = from_f32<T>(to_f32(xr[hh]) * inv * g);
      }
    }
    __syncthreads();

    float best_v[kRows];
    int best_i[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) { best_v[r] = -INFINITY; best_i[r] = INT_MAX; }

    if (TIED) {
      // w [V, H]: warp `warp` takes columns v0 + warp*32 .. +31 in order
      for (int cc = 0; cc < kTileV / kWarps; ++cc) {
        const int col = v0 + warp * (kTileV / kWarps) + cc;
        if (col >= V) break;
        const T* wr = w + (size_t)col * H;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        for (int h0 = lane * VN; h0 < H; h0 += 32 * VN) {
          float wv[VN];
          load_vec<T>(wr + h0, wv);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nr) {
              float xv[VN];
              load_vec<T>(sX + r * H + h0, xv);
#pragma unroll
              for (int i = 0; i < VN; ++i) acc[r] = fmaf(xv[i], wv[i], acc[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float s = softcap_f(warp_sum(acc[r]), softcap);
          if (better(s, col, best_v[r], best_i[r])) { best_v[r] = s; best_i[r] = col; }
        }
      }
    } else {
      // w [H, V]: thread `tid` takes column v0 + tid
      const int col = v0 + tid;
      if (col < V) {
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int hh = 0; hh < H; ++hh) {
          const float wv = to_f32(w[(size_t)hh * V + col]);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r < nr) acc[r] = fmaf(to_f32(sX[r * H + hh]), wv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          best_v[r] = softcap_f(acc[r], softcap);
          best_i[r] = col;
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      warp_argmax(best_v[r], best_i[r]);
      if (lane == 0) { sBestV[warp][r] = best_v[r]; sBestI[warp][r] = best_i[r]; }
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

template <typename T, bool TIED>
cudaError_t launch(const void* x, const void* gamma, const void* w, float* pv, int* pi,
                   int* out, int N, int H, int V, float eps, int unit_offset,
                   float softcap, cudaStream_t stream) {
  if (H % Vec<T>::N != 0) return cudaErrorInvalidValue;  // 16-byte rows
  const int nt = (V + kTileV - 1) / kTileV;
  const size_t smem = sizeof(T) * (size_t)kRows * H;
  static size_t configured = 0;
  cudaError_t e = ensure_smem(epilogue_tile_kernel<T, TIED>, smem, &configured);
  if (e != cudaSuccess) return e;
  epilogue_tile_kernel<T, TIED><<<nt, kThreads, smem, stream>>>(
      (const T*)x, (const T*)gamma, (const T*)w, pv, pi, N, H, V, eps, unit_offset, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  epilogue_combine_kernel<<<N, kThreads, 0, stream>>>(pv, pi, out, nt);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sample_epilogue_num_tiles(int V) { return (V + kTileV - 1) / kTileV; }

// x [N,H], gamma [H], w [V,H] (tied) or [H,V] (untied), all of `dtype`;
// part_val/part_idx [N, num_tiles(V)] scratch; out [N] int32.
extern "C" int sample_epilogue_launch(const void* x, const void* gamma, const void* w,
                                      void* part_val, void* part_idx, void* out, int N,
                                      int H, int V, int tied, float eps, int unit_offset,
                                      float softcap, int dtype, void* stream) {
  if (N <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  float* pv = (float*)part_val;
  int* pi = (int*)part_idx;
  int* o = (int*)out;
  if (dtype == 0)
    return tied ? launch<float, true>(x, gamma, w, pv, pi, o, N, H, V, eps, unit_offset, softcap, st)
                : launch<float, false>(x, gamma, w, pv, pi, o, N, H, V, eps, unit_offset, softcap, st);
  if (dtype == 1)
    return tied ? launch<__nv_bfloat16, true>(x, gamma, w, pv, pi, o, N, H, V, eps, unit_offset, softcap, st)
                : launch<__nv_bfloat16, false>(x, gamma, w, pv, pi, o, N, H, V, eps, unit_offset, softcap, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* llm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
