// One-token GQA decode attention over the static KV cache slab, split-KV.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/decode_attention.py:
// decode_attention (_decode_kernel, bounds from _block_bounds).
//
// The kv loop, its bound (bytes) and what the design does about it are
// split_decode.cuh's, shared with the paged kernel.  What is the slab's
// own: one block per (kv head, 4 query heads, row, split) reduces its
// mask row to the visible band [first, last] (the TPU kernel's block
// skip), so only the kv tiles between a row's first and last visible
// slot are read, and a slot inside the band is visible where its mask
// byte is set (cache validity, causality, sliding window, ragged pads).
// One block per (kv head, row) is only K*B blocks (32 at Llama-3.2-1B's
// K=8, B=4, on 132 SMs), each streaming its whole band serially; split_plan
// in ops/cuda/decode_attention.py picks NSPLIT (two blocks per SM, the
// most that fit at once, at least two tiles a split).
#include "split_decode.cuh"
#include "split_kv.cuh"

namespace {

using namespace split_decode;

// First and last nonzero byte of mask row [0, S), this thread's share;
// 16-byte loads over the aligned middle of the row.
__device__ __forceinline__ void mask_bounds(const uint8_t* __restrict__ mrow, int S, int tid,
                                            int& first, int& last) {
  int head = (int)((16 - ((uintptr_t)mrow & 15)) & 15);
  head = min(head, S);
  const int nvec = (S - head) / 16;
  const int tail = head + nvec * 16;
  for (int i = tid; i < head; i += kThreads)
    if (mrow[i]) { first = min(first, i); last = max(last, i); }
  for (int i = tail + tid; i < S; i += kThreads)
    if (mrow[i]) { first = min(first, i); last = max(last, i); }
  const uint4* mv = reinterpret_cast<const uint4*>(mrow + head);
  for (int i = tid; i < nvec; i += kThreads) {
    const uint4 x = __ldg(mv + i);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (w[e]) {
        const int base = head + i * 16 + e * 4;
        first = min(first, base + (__ffs(w[e]) - 1) / 8);
        last = max(last, base + (31 - __clz(w[e])) / 8);
      }
    }
  }
}

// The slab's slots: row b's [S, K] slice of the cache, visible where the
// mask byte is set; every slot of the band is staged at once.
struct SlabSlots {
  const uint8_t* mrow;
  size_t row0;  // slot 0's (b, kh) row
  int K;
  __device__ __forceinline__ int stage(int, int hi) const { return hi; }
  __device__ __forceinline__ size_t row(int s) const { return (size_t)s * K; }
  __device__ __forceinline__ bool visible(int s) const { return mrow[s] != 0; }
};

// out != nullptr: NSPLIT == 1, write the normalised output; else write
// this split's partials at [b*K + kh, split] of part_acc/part_m/part_l.
template <typename T, bool INT8, int D>
__global__ void __launch_bounds__(kThreads, 2)
decode_kernel(const T* __restrict__ q, const void* __restrict__ k,
              const void* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const uint8_t* __restrict__ mask,
              T* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_m,
              float* __restrict__ part_l, int S, int H, int K, int nsplit, float scale,
              float softcap) {
  __shared__ int s_first, s_last;
  const Heads hd = block_heads(H, K);
  const int b = blockIdx.y, tid = threadIdx.x;
  const uint8_t* mrow = mask + (size_t)b * S;

  if (tid == 0) { s_first = S; s_last = -1; }
  float qr[kGC][kEPL];
  load_q<T, D>(q, b, H, hd, qr);
  __syncthreads();
  int first = S, last = -1;
  mask_bounds(mrow, S, tid, first, last);
  if (first < S) { atomicMin(&s_first, first); atomicMax(&s_last, last); }
  __syncthreads();

  SlabSlots src{mrow, (size_t)b * S * K + hd.kh, K};
  attend<T, INT8, D>(src, qr, hd, row_dest(b, K, hd), s_first, s_last, k, v, ks, vs, out,
                     part_acc, part_m, part_l, nsplit, scale, softcap);
}

// out == nullptr: the partials only (no combine).
template <typename T, bool INT8, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const uint8_t* mask, void* out, float* acc, float* m,
                   float* l, int B, int S, int H, int K, int nsplit, float scale, float softcap,
                   cudaStream_t stream, int* launched) {
  const int G = H / K;
  if (G * D > 2048 || nsplit < 1 || nsplit > 65535 || B > 65535) return cudaErrorInvalidValue;
  const bool direct = out != nullptr && nsplit == 1;
  if (!direct && (acc == nullptr || m == nullptr || l == nullptr)) return cudaErrorInvalidValue;
  const int blocks_x = K * ((G + kGC - 1) / kGC);
  const size_t smem = smem_bytes<T, INT8, D>();
  // the cap covers the static __shared__ variables too (under 1 KB)
  static size_t configured = 0;
  cudaError_t e = ensure_smem(decode_kernel<T, INT8, D>, smem + 1024, &configured);
  if (e != cudaSuccess) return e;
  decode_kernel<T, INT8, D><<<dim3(blocks_x, B, nsplit), kThreads, smem, stream>>>(
      (const T*)q, k, v, ks, vs, mask, direct ? (T*)out : nullptr, acc, m, l, S, H, K, nsplit,
      scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  *launched = 1;
  if (direct || out == nullptr) return e;
  e = split_kv::combine<T>(acc, m, l, (T*)out, B * K, nsplit, G, D, stream);
  if (e == cudaSuccess) *launched = 2;
  return e;
}

template <typename T, bool INT8>
cudaError_t launch_d(const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, const uint8_t* mask, void* out, float* acc, float* m,
                     float* l, int B, int S, int H, int K, int D, int nsplit, float scale,
                     float softcap, cudaStream_t st, int* launched) {
  switch (D) {
    case 64:
      return launch<T, INT8, 64>(q, k, v, ks, vs, mask, out, acc, m, l, B, S, H, K, nsplit, scale,
                                 softcap, st, launched);
    case 128:
      return launch<T, INT8, 128>(q, k, v, ks, vs, mask, out, acc, m, l, B, S, H, K, nsplit,
                                  scale, softcap, st, launched);
    case 256:
      return launch<T, INT8, 256>(q, k, v, ks, vs, mask, out, acc, m, l, B, S, H, K, nsplit,
                                  scale, softcap, st, launched);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,1,H,D] (dtype), k/v [B,S,K,D] (dtype, or int8 with k_scale/v_scale
// [B,S,K] float32; 16-byte aligned), mask [B,S] bool bytes, out [B,1,H,D]
// or null (then only the partials are written); part_acc [B,K,NSPLIT,G,D],
// part_m / part_l [B,K,NSPLIT,G] float32 scratch (unused when NSPLIT == 1
// and out is set); all contiguous.  Launches the split kernel and, when
// NSPLIT > 1 and out is set, the combine; *launched reports how many of
// the two it launched.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* mask, void* out, void* part_acc,
                                       void* part_m, void* part_l, int B, int S, int H, int K,
                                       int D, int nsplit, float scale, float softcap,
                                       int dtype, int int8_cache, void* stream,
                                       int* launched) {
  *launched = 0;
  if (B <= 0 || S <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const uint8_t* mk = (const uint8_t*)mask;
  float* acc = (float*)part_acc;
  float* m = (float*)part_m;
  float* l = (float*)part_l;
  if (dtype == 0 && !int8_cache)
    return launch_d<float, false>(q, k, v, ks, vs, mk, out, acc, m, l, B, S, H, K, D, nsplit,
                                  scale, softcap, st, launched);
  if (dtype == 0 && int8_cache)
    return launch_d<float, true>(q, k, v, ks, vs, mk, out, acc, m, l, B, S, H, K, D, nsplit,
                                 scale, softcap, st, launched);
  if (dtype == 1 && !int8_cache)
    return launch_d<__nv_bfloat16, false>(q, k, v, ks, vs, mk, out, acc, m, l, B, S, H, K, D,
                                          nsplit, scale, softcap, st, launched);
  if (dtype == 1 && int8_cache)
    return launch_d<__nv_bfloat16, true>(q, k, v, ks, vs, mk, out, acc, m, l, B, S, H, K, D,
                                         nsplit, scale, softcap, st, launched);
  return cudaErrorInvalidValue;
}

// The combine alone: acc [R, NSPLIT, rows, D], m / l [R, NSPLIT, rows]
// float32 → out [R, rows, D] (dtype); all contiguous.
extern "C" int split_kv_combine_launch(const void* acc, const void* m, const void* l, void* out,
                                       int R, int nsplit, int rows, int D, int dtype,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* a = (const float*)acc;
  const float* mm = (const float*)m;
  const float* ll = (const float*)l;
  if (dtype == 0) return split_kv::combine<float>(a, mm, ll, (float*)out, R, nsplit, rows, D, st);
  if (dtype == 1)
    return split_kv::combine<__nv_bfloat16>(a, mm, ll, (__nv_bfloat16*)out, R, nsplit, rows, D,
                                            st);
  return cudaErrorInvalidValue;
}
