// One-token GQA decode attention over the static KV cache slab.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/decode_attention.py:
// decode_attention (_decode_kernel, bounds from _block_bounds).
//
// What bounds it on the H100: bytes.  Each step reads every visible K/V
// slot once (2*S*K*D elements per row) for 4*H*D FLOPs per slot — about
// G FLOPs per byte, far below the card's ridge.  What the design does
// about it: it reads only the kv blocks inside the row's visible range
// [first, last] of the mask (the TPU kernel's block skip), each K/V
// element once per (row, kv head) — the G query heads of a kv head share
// every loaded tile — and an int8 cache streams 1-byte values plus
// float32 scales, dequantised in shared memory.
//
// Design: one block of 256 threads per (kv head, row b).  The block first
// reduces its mask row to the first/last visible slot, then loops over
// the kv blocks in between (the TPU kernel's sequential grid axis).  Per
// block: stage K/V as float32 in shared memory (padded K rows:
// conflict-free column reads), score G x BS (q.k * scale, softcap, mask),
// online softmax per query head by one warp, masked p re-zeroed, p
// rounded to the storage type, then acc = acc*alpha + P V with each
// thread owning (head, dim) outputs.  A row with nothing visible writes
// zeros.  At B=4, K=8 this is 32 blocks on 132 SMs: one block per SM
// streams its slab serially, so long caches leave the card mostly idle
// (split-KV is later work).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 8;  // outputs per thread: G*D <= kThreads*kMaxOut

template <int D> struct DecodeTile { static constexpr int BS = 64; };
template <> struct DecodeTile<256> { static constexpr int BS = 32; };

template <typename T, bool INT8, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const void* __restrict__ k,
              const void* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const uint8_t* __restrict__ mask,
              T* __restrict__ out, int S, int H, int K, float scale, float softcap) {
  constexpr int BS = DecodeTile<D>::BS;
  constexpr int LD = D + 1;
  const int G = H / K;
  extern __shared__ float smem[];
  float* sK = smem;              // [BS][LD]
  float* sV = sK + BS * LD;      // [BS][D]
  float* sQ = sV + BS * D;       // [G][D]
  float* sP = sQ + G * D;        // [G][BS] scores, then p
  float* sM = sP + G * BS;       // [G] running max
  float* sL = sM + G;            // [G] running sum
  float* sA = sL + G;            // [G] this block's rescale
  uint8_t* sMask = (uint8_t*)(sA + G);  // [BS]
  __shared__ int s_first, s_last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const uint8_t* mrow = mask + (size_t)b * S;

  if (tid == 0) { s_first = S; s_last = -1; }
  for (int i = tid; i < G * D; i += kThreads)
    sQ[i] = to_f32(q[((size_t)b * H + kh * G) * D + i]);
  for (int g = tid; g < G; g += kThreads) { sM[g] = LLM_NEG_INF; sL[g] = 0.f; }
  __syncthreads();
  int first = S, last = -1;
  for (int i = tid; i < S; i += kThreads)
    if (mrow[i]) { first = min(first, i); last = max(last, i); }
  if (first < S) { atomicMin(&s_first, first); atomicMax(&s_last, last); }
  __syncthreads();
  first = s_first;
  last = s_last;

  float acc[kMaxOut];
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) acc[u] = 0.f;

  const int start = last >= 0 ? first / BS : 0;
  const int nb = last >= 0 ? last / BS + 1 : 0;  // nothing visible: no block
  for (int jb = start; jb < nb; ++jb) {
    const int s0 = jb * BS;
    for (int idx = tid; idx < BS * D; idx += kThreads) {
      const int c = idx / D, d = idx % D, slot = s0 + c;
      float kv = 0.f, vv = 0.f;
      if (slot < S) {
        const size_t soff = ((size_t)b * S + slot) * K + kh;
        kv = load_kv<T, INT8>(k, ks, soff * D + d, soff);
        vv = load_kv<T, INT8>(v, vs, soff * D + d, soff);
      }
      sK[c * LD + d] = kv;
      sV[c * D + d] = vv;
    }
    for (int c = tid; c < BS; c += kThreads) sMask[c] = (s0 + c < S) ? mrow[s0 + c] : 0;
    __syncthreads();

    for (int idx = tid; idx < G * BS; idx += kThreads) {
      const int g = idx / BS, c = idx % BS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[g * D + d], sK[c * LD + d], dot);
      const float s = softcap_f(dot * scale, softcap);
      sP[idx] = sMask[c] ? s : LLM_NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float tmax = LLM_NEG_INF;
      for (int c = lane; c < BS; c += 32) tmax = fmaxf(tmax, sP[g * BS + c]);
      tmax = warp_max(tmax);
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, tmax);
      float psum = 0.f;
      for (int c = lane; c < BS; c += 32) {
        // re-zero masked slots: with nothing visible yet m_new is
        // NEG_INF and exp(NEG_INF - NEG_INF) would be 1
        const float p = sMask[c] ? expf(sP[g * BS + c] - m_new) : 0.f;
        psum += p;
        sP[g * BS + c] = round_to<T>(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[g] = alpha;
        sL[g] = sL[g] * alpha + psum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < kMaxOut; ++u) {
      const int o = tid + u * kThreads;
      if (o < G * D) {
        const int g = o / D, d = o % D;
        float pv = 0.f;
#pragma unroll 8
        for (int c = 0; c < BS; ++c) pv = fmaf(sP[g * BS + c], sV[c * D + d], pv);
        acc[u] = acc[u] * sA[g] + pv;
      }
    }
    __syncthreads();  // sK/sV/sP are rewritten by the next block
  }

#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) {
    const int o = tid + u * kThreads;
    if (o < G * D) {
      const int g = o / D;
      const float l = sL[g];
      out[((size_t)b * H + kh * G) * D + o] = from_f32<T>(acc[u] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, bool INT8, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const uint8_t* mask, void* out, int B, int S,
                   int H, int K, float scale, float softcap, cudaStream_t stream) {
  constexpr int BS = DecodeTile<D>::BS;
  const int G = H / K;
  if (G * D > kThreads * kMaxOut) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (BS * (D + 1) + BS * D + G * D + G * BS + 3 * G) + BS;
  static size_t configured = 0;
  cudaError_t e = ensure_smem(decode_kernel<T, INT8, D>, smem, &configured);
  if (e != cudaSuccess) return e;
  decode_kernel<T, INT8, D><<<dim3(K, B), kThreads, smem, stream>>>(
      (const T*)q, k, v, ks, vs, mask, (T*)out, S, H, K, scale, softcap);
  return cudaGetLastError();
}

template <typename T, bool INT8>
cudaError_t launch_d(const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, const uint8_t* mask, void* out, int B, int S,
                     int H, int K, int D, float scale, float softcap, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, INT8, 64>(q, k, v, ks, vs, mask, out, B, S, H, K, scale, softcap, st);
    case 128: return launch<T, INT8, 128>(q, k, v, ks, vs, mask, out, B, S, H, K, scale, softcap, st);
    case 256: return launch<T, INT8, 256>(q, k, v, ks, vs, mask, out, B, S, H, K, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,1,H,D] (dtype), k/v [B,S,K,D] (dtype, or int8 with k_scale/v_scale
// [B,S,K] float32), mask [B,S] bool bytes, out [B,1,H,D]; all contiguous.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* mask, void* out, int B, int S,
                                       int H, int K, int D, float scale, float softcap,
                                       int dtype, int int8_cache, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const uint8_t* m = (const uint8_t*)mask;
  if (dtype == 0 && !int8_cache)
    return launch_d<float, false>(q, k, v, ks, vs, m, out, B, S, H, K, D, scale, softcap, st);
  if (dtype == 0 && int8_cache)
    return launch_d<float, true>(q, k, v, ks, vs, m, out, B, S, H, K, D, scale, softcap, st);
  if (dtype == 1 && !int8_cache)
    return launch_d<__nv_bfloat16, false>(q, k, v, ks, vs, m, out, B, S, H, K, D, scale, softcap, st);
  if (dtype == 1 && int8_cache)
    return launch_d<__nv_bfloat16, true>(q, k, v, ks, vs, m, out, B, S, H, K, D, scale, softcap, st);
  return cudaErrorInvalidValue;
}
