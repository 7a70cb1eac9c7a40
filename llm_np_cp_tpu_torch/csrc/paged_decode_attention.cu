// One-token GQA decode attention straight off the paged KV pool.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/decode_attention.py:
// paged_decode_attention (_paged_kernel): the serving engine's phase-split
// decode, which reads each row's K/V through its block table instead of
// gathering a contiguous [B, S_max, K, D] view.
//
// What bounds it on the H100: bytes.  Each call reads every visible K/V
// slot of every row once (2*K*D elements per slot, plus two float32
// scales per slot and head in int8 mode) for 4*H*D FLOPs per slot — about
// G FLOPs per byte, far below the card's ridge.  What the design does
// about it: row b sees logical slots [pads[b], lengths[b]) and only those
// slots are read (the TPU kernel's block skip, here at slot granularity);
// each K/V element is read once per (row, kv head), shared by the G query
// heads of the group; an int8 pool streams 1-byte values plus scales.
//
// Design: one block of 256 threads per (kv head, row b); the shared core
// is paged_attention.cuh (classic online softmax — see there for the
// choice against the TPU kernel's AMLA rescale).  B*K blocks: at the
// serve engine's B=8, K=8 that is 64 blocks on 132 SMs, so long rows are
// streamed by one SM each (split-KV is later work).
#include "paged_attention.cuh"

namespace {

template <typename T, bool INT8, int D>
__global__ void __launch_bounds__(paged::kThreads)
paged_decode_kernel(const T* __restrict__ q, const void* __restrict__ kp,
                    const void* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ tables,
                    const int* __restrict__ lengths, const int* __restrict__ pads,
                    T* __restrict__ out, int MB, int BS, int H, int K, float scale,
                    float softcap) {
  __shared__ int s_lo[1], s_hi[1];
  const int kh = blockIdx.x, b = blockIdx.y, G = H / K;
  const int lo = max(pads[b], 0);
  const int end = min(lengths[b], MB * BS);  // exclusive
  if (threadIdx.x == 0) { s_lo[0] = lo; s_hi[0] = end - 1; }
  __syncthreads();
  const size_t q0 = ((size_t)b * H + (size_t)kh * G) * D;
  paged::attend<T, INT8, D>(q + q0, out + q0, 0, kp, vp, ks, vs, tables + (size_t)b * MB, BS,
                            K, kh, G, 1, s_lo, s_hi, lo, max(end, lo), scale, softcap);
}

template <typename T, bool INT8, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* tables, const int* lengths, const int* pads,
                   void* out, int B, int MB, int BS, int H, int K, float scale, float softcap,
                   cudaStream_t stream) {
  static size_t configured = 0;
  return paged::launch<D>(paged_decode_kernel<T, INT8, D>, &configured, dim3(K, B), H / K,
                          stream, (const T*)q, kp, vp, ks, vs, tables, lengths, pads, (T*)out,
                          MB, BS, H, K, scale, softcap);
}

template <typename T, bool INT8>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp, const float* ks,
                     const float* vs, const int* tables, const int* lengths, const int* pads,
                     void* out, int B, int MB, int BS, int H, int K, float scale,
                     float softcap, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, INT8, 64>(q, kp, vp, ks, vs, tables, lengths, pads, out, B, MB, BS, H,
                                 K, scale, softcap, st);
    case 128:
      return launch<T, INT8, 128>(q, kp, vp, ks, vs, tables, lengths, pads, out, B, MB, BS,
                                  H, K, scale, softcap, st);
    case 256:
      return launch<T, INT8, 256>(q, kp, vp, ks, vs, tables, lengths, pads, out, B, MB, BS,
                                  H, K, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,1,H,D] (dtype), k/v pages [NB,BS,K,D] (dtype, or int8 with scale
// pages [NB,BS,K] float32), tables [B,MB] int32, lengths/pads [B] int32,
// out [B,1,H,D]; all contiguous.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pages,
                                             const void* v_pages, const void* k_scale,
                                             const void* v_scale, const void* tables,
                                             const void* lengths, const void* pads,
                                             void* out, int B, int MB, int BS, int H, int K,
                                             int D, float scale, float softcap, int dtype,
                                             int int8_pages, void* stream) {
  if (B <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int* tb = (const int*)tables;
  const int* ln = (const int*)lengths;
  const int* pd = (const int*)pads;
  if (dtype == 0 && !int8_pages)
    return launch_d<float, false>(D, q, k_pages, v_pages, ks, vs, tb, ln, pd, out, B, MB, BS,
                                  H, K, scale, softcap, st);
  if (dtype == 0 && int8_pages)
    return launch_d<float, true>(D, q, k_pages, v_pages, ks, vs, tb, ln, pd, out, B, MB, BS,
                                 H, K, scale, softcap, st);
  if (dtype == 1 && !int8_pages)
    return launch_d<__nv_bfloat16, false>(D, q, k_pages, v_pages, ks, vs, tb, ln, pd, out, B,
                                          MB, BS, H, K, scale, softcap, st);
  if (dtype == 1 && int8_pages)
    return launch_d<__nv_bfloat16, true>(D, q, k_pages, v_pages, ks, vs, tb, ln, pd, out, B,
                                         MB, BS, H, K, scale, softcap, st);
  return cudaErrorInvalidValue;
}
