// Mixed prefill + decode GQA attention off the paged KV pool: the
// serving engine's unified tick.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/decode_attention.py:
// ragged_paged_attention (_ragged_kernel; tile bounds as the wrapper
// computes them before its pallas_call).
//
// The packed token axis holds each engine row's segment (a prefill-chunk
// slice, or a decode row's one token) at RAGGED_Q_TILE = 8 aligned
// positions, so every q tile belongs to one row.  Token i of tile t sits
// at cache slot qpos0[t] + i and sees slots
// [max(pad, slot - window + 1), slot] of its row (window = 1 << 30 on a
// global layer); lanes i >= qlen[t] and dead tiles (qlen = 0) give zeros.
//
// What bounds it on the H100: bytes for decode-heavy ticks (each visible
// K/V slot of a tile's band is read once for 8*G query rows), operations
// only for long prefill slices.  What the design does about it: a tile
// reads only the slots of its band — from its first token's window start
// to its last live token — through the block table, never a gathered
// view; the K/V tile is shared by the 8 tokens x G heads of the kv head;
// an int8 pool streams 1-byte values plus scale pages.
//
// Design: one block of 256 threads per (kv head, q tile); the shared core
// is paged_attention.cuh (classic online softmax — see there for the
// choice against the TPU kernel's AMLA rescale).  A decode row's tile
// wastes 7 of its 8 query lanes, as on the TPU.
#include "paged_attention.cuh"

namespace {

constexpr int kQTile = 8;  // RAGGED_Q_TILE

template <typename T, bool INT8, int D>
__global__ void __launch_bounds__(paged::kThreads)
ragged_kernel(const T* __restrict__ q, const void* __restrict__ kp,
              const void* __restrict__ vp, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ tables,
              const int* __restrict__ tile_row, const int* __restrict__ tile_qpos0,
              const int* __restrict__ tile_qlen, const int* __restrict__ pads,
              T* __restrict__ out, int MB, int BS, int H, int K, int window, float scale,
              float softcap) {
  __shared__ int s_lo[kQTile], s_hi[kQTile];
  const int kh = blockIdx.x, t = blockIdx.y, G = H / K;
  const int row = tile_row[t], qpos0 = tile_qpos0[t], qlen = tile_qlen[t];
  const int pad = pads[row];
  // band of the whole tile: window start of its first token through its
  // last live token (64-bit: window may be near INT_MAX)
  const long long first = max((long long)pad, (long long)qpos0 - window + 1);
  const int s_begin = (int)max(first, 0LL);
  const int s_end = qlen > 0 ? min(qpos0 + qlen, MB * BS) : 0;  // exclusive
  if (threadIdx.x < kQTile) {
    const int i = threadIdx.x, slot = qpos0 + i;
    const long long l = max((long long)pad, (long long)slot - window + 1);
    s_lo[i] = i < qlen ? (int)max(l, 0LL) : 1;
    s_hi[i] = i < qlen ? slot : 0;
  }
  __syncthreads();
  const size_t q0 = ((size_t)t * kQTile * H + (size_t)kh * G) * D;
  paged::attend<T, INT8, D>(q + q0, out + q0, (size_t)H * D, kp, vp, ks, vs,
                            tables + (size_t)row * MB, BS, K, kh, G, kQTile, s_lo, s_hi,
                            s_begin, max(s_end, s_begin), scale, softcap);
}

template <typename T, bool INT8, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* tables, const int* tile_row,
                   const int* tile_qpos0, const int* tile_qlen, const int* pads, void* out,
                   int NT, int MB, int BS, int H, int K, int window, float scale,
                   float softcap, cudaStream_t stream) {
  static size_t configured = 0;
  return paged::launch<D>(ragged_kernel<T, INT8, D>, &configured, dim3(K, NT),
                          kQTile * (H / K), stream, (const T*)q, kp, vp, ks, vs, tables,
                          tile_row, tile_qpos0, tile_qlen, pads, (T*)out, MB, BS, H, K,
                          window, scale, softcap);
}

template <typename T, bool INT8>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp, const float* ks,
                     const float* vs, const int* tables, const int* tile_row,
                     const int* tile_qpos0, const int* tile_qlen, const int* pads, void* out,
                     int NT, int MB, int BS, int H, int K, int window, float scale,
                     float softcap, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, INT8, 64>(q, kp, vp, ks, vs, tables, tile_row, tile_qpos0, tile_qlen,
                                 pads, out, NT, MB, BS, H, K, window, scale, softcap, st);
    case 128:
      return launch<T, INT8, 128>(q, kp, vp, ks, vs, tables, tile_row, tile_qpos0, tile_qlen,
                                  pads, out, NT, MB, BS, H, K, window, scale, softcap, st);
    case 256:
      return launch<T, INT8, 256>(q, kp, vp, ks, vs, tables, tile_row, tile_qpos0, tile_qlen,
                                  pads, out, NT, MB, BS, H, K, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [T,H,D] (dtype, T = NT * 8), k/v pages [NB,BS,K,D] (dtype, or int8
// with scale pages [NB,BS,K] float32), tables [R,MB] int32, tile_row /
// tile_qpos0 / tile_qlen [NT] int32, pads [R] int32, out [T,H,D]; all
// contiguous.  window: this layer's sliding window (1 << 30 = global).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* tables, const void* tile_row, const void* tile_qpos0,
    const void* tile_qlen, const void* pads, void* out, int NT, int MB, int BS, int H, int K,
    int D, int window, float scale, float softcap, int dtype, int int8_pages, void* stream) {
  if (NT <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int* tb = (const int*)tables;
  const int* tr = (const int*)tile_row;
  const int* tp = (const int*)tile_qpos0;
  const int* tl = (const int*)tile_qlen;
  const int* pd = (const int*)pads;
  if (dtype == 0 && !int8_pages)
    return launch_d<float, false>(D, q, k_pages, v_pages, ks, vs, tb, tr, tp, tl, pd, out, NT,
                                  MB, BS, H, K, window, scale, softcap, st);
  if (dtype == 0 && int8_pages)
    return launch_d<float, true>(D, q, k_pages, v_pages, ks, vs, tb, tr, tp, tl, pd, out, NT,
                                 MB, BS, H, K, window, scale, softcap, st);
  if (dtype == 1 && !int8_pages)
    return launch_d<__nv_bfloat16, false>(D, q, k_pages, v_pages, ks, vs, tb, tr, tp, tl, pd,
                                          out, NT, MB, BS, H, K, window, scale, softcap, st);
  if (dtype == 1 && int8_pages)
    return launch_d<__nv_bfloat16, true>(D, q, k_pages, v_pages, ks, vs, tb, tr, tp, tl, pd,
                                         out, NT, MB, BS, H, K, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
