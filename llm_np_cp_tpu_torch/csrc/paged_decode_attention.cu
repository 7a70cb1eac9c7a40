// One-token GQA decode attention straight off the paged KV pool, split-KV.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/decode_attention.py:
// paged_decode_attention (_paged_kernel): the serving engine's phase-split
// decode, which reads each row's K/V through its block table instead of
// gathering a contiguous [B, S_max, K, D] view.
//
// The kv loop, its bound (bytes: every visible K/V slot read once, plus
// two float32 scales per slot and head in int8 mode, for ~G FLOPs per
// byte) and what the design does about it are split_decode.cuh's, shared
// with the slab kernel: grid (K * ceil(G/4), B, NSPLIT), lane groups
// streaming slots through a cp.async ring, float32 partials merged by
// split_kv.cuh's combine when NSPLIT > 1.  What is the paged kernel's own:
//
// - The band.  Row b sees logical slots [pads[b], lengths[b]); the block
//   takes [max(pads, 0), min(lengths, MB*BS)) as its band with no mask to
//   scan (the TPU kernel's block skip, at slot granularity), and every
//   slot inside it is visible.  The split ranges are whole DecodeTile
//   tiles of that band, cut as in the slab kernel, so the plain version
//   reproduces them from the mask pads <= pos < lengths.  NSPLIT is
//   planned on the host over the table width MB*BS (lengths live on the
//   card), so it is fixed for a given table shape.
// - The block table.  Slot s lives at pool row (table[s / BS] * BS +
//   s % BS) * K + kh.  Loading table[s / BS] inside the copy would make
//   every cp.async wait on a dependent global load and leave the ring
//   nothing to overlap, so the block stages its split's slice of the
//   row's table in shared memory before the loop: kTableCap entries at a
//   time, refilled between chunks when a split spans more blocks (NSPLIT
//   == 1 over a very wide table).  BS is a runtime value; a power of two
//   (16 in the engine) is divided by a shift.
#include "split_decode.cuh"
#include "split_kv.cuh"

namespace {

using namespace split_decode;

template <typename T, bool INT8, int D>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const T* __restrict__ q, const void* __restrict__ kp,
                    const void* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ tables,
                    const int* __restrict__ lengths, const int* __restrict__ pads,
                    T* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l, int MB, int BS,
                    int shift, int H, int K, int nsplit, float scale, float softcap) {
  __shared__ int s_table[kTableCap];
  const Heads hd = block_heads(H, K);
  const int b = blockIdx.y;
  float qr[kGC][kEPL];
  load_q<T, D>(q, b, H, hd, qr);
  const int first = max(pads[b], 0);
  const int last = min(lengths[b], MB * BS) - 1;
  PagedSlots src{tables + (size_t)b * MB, s_table, (size_t)hd.kh, BS, shift, K, 0};
  attend<T, INT8, D>(src, qr, hd, row_dest(b, K, hd), first, last, kp, vp, ks, vs, out,
                     part_acc, part_m, part_l, nsplit, scale, softcap);
}

// out == nullptr: the partials only (no combine).
template <typename T, bool INT8, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* tables, const int* lengths, const int* pads,
                   void* out, float* acc, float* m, float* l, int B, int MB, int BS, int H,
                   int K, int nsplit, float scale, float softcap, cudaStream_t stream,
                   int* launched) {
  const int G = H / K;
  if (BS < 1 || nsplit < 1 || nsplit > 65535 || B > 65535) return cudaErrorInvalidValue;
  const bool direct = out != nullptr && nsplit == 1;
  if (!direct && (acc == nullptr || m == nullptr || l == nullptr)) return cudaErrorInvalidValue;
  const int shift = (BS & (BS - 1)) == 0 ? __builtin_ctz(BS) : -1;
  const int blocks_x = K * ((G + kGC - 1) / kGC);
  const size_t smem = smem_bytes<T, INT8, D>();
  // the cap covers the static __shared__ variables too (the staged table
  // and the merge's maxima and sums, under 3 KB)
  static size_t configured = 0;
  cudaError_t e = ensure_smem(paged_decode_kernel<T, INT8, D>, smem + 3072, &configured);
  if (e != cudaSuccess) return e;
  paged_decode_kernel<T, INT8, D><<<dim3(blocks_x, B, nsplit), kThreads, smem, stream>>>(
      (const T*)q, kp, vp, ks, vs, tables, lengths, pads, direct ? (T*)out : nullptr, acc, m, l,
      MB, BS, shift, H, K, nsplit, scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  *launched = 1;
  if (direct || out == nullptr) return e;
  e = split_kv::combine<T>(acc, m, l, (T*)out, B * K, nsplit, G, D, stream);
  if (e == cudaSuccess) *launched = 2;
  return e;
}

template <typename T, bool INT8>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp, const float* ks,
                     const float* vs, const int* tables, const int* lengths, const int* pads,
                     void* out, float* acc, float* m, float* l, int B, int MB, int BS, int H,
                     int K, int nsplit, float scale, float softcap, cudaStream_t st,
                     int* launched) {
  switch (D) {
    case 64:
      return launch<T, INT8, 64>(q, kp, vp, ks, vs, tables, lengths, pads, out, acc, m, l, B,
                                 MB, BS, H, K, nsplit, scale, softcap, st, launched);
    case 128:
      return launch<T, INT8, 128>(q, kp, vp, ks, vs, tables, lengths, pads, out, acc, m, l, B,
                                  MB, BS, H, K, nsplit, scale, softcap, st, launched);
    case 256:
      return launch<T, INT8, 256>(q, kp, vp, ks, vs, tables, lengths, pads, out, acc, m, l, B,
                                  MB, BS, H, K, nsplit, scale, softcap, st, launched);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,1,H,D] (dtype), k/v pages [NB,BS,K,D] (dtype, or int8 with scale
// pages [NB,BS,K] float32; 16-byte aligned), tables [B,MB] int32,
// lengths/pads [B] int32, out [B,1,H,D] or null (then only the partials
// are written); part_acc [B,K,NSPLIT,G,D], part_m / part_l [B,K,NSPLIT,G]
// float32 scratch (unused when NSPLIT == 1 and out is set); all
// contiguous.  Launches the split kernel and, when NSPLIT > 1 and out is
// set, the combine; *launched reports how many of the two it launched.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pages,
                                             const void* v_pages, const void* k_scale,
                                             const void* v_scale, const void* tables,
                                             const void* lengths, const void* pads,
                                             void* out, void* part_acc, void* part_m,
                                             void* part_l, int B, int MB, int BS, int H, int K,
                                             int D, int nsplit, float scale, float softcap,
                                             int dtype, int int8_pages, void* stream,
                                             int* launched) {
  *launched = 0;
  if (B <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int* tb = (const int*)tables;
  const int* ln = (const int*)lengths;
  const int* pd = (const int*)pads;
  float* acc = (float*)part_acc;
  float* m = (float*)part_m;
  float* l = (float*)part_l;
  if (dtype == 0 && !int8_pages)
    return launch_d<float, false>(D, q, k_pages, v_pages, ks, vs, tb, ln, pd, out, acc, m, l, B,
                                  MB, BS, H, K, nsplit, scale, softcap, st, launched);
  if (dtype == 0 && int8_pages)
    return launch_d<float, true>(D, q, k_pages, v_pages, ks, vs, tb, ln, pd, out, acc, m, l, B,
                                 MB, BS, H, K, nsplit, scale, softcap, st, launched);
  if (dtype == 1 && !int8_pages)
    return launch_d<__nv_bfloat16, false>(D, q, k_pages, v_pages, ks, vs, tb, ln, pd, out, acc,
                                          m, l, B, MB, BS, H, K, nsplit, scale, softcap, st,
                                          launched);
  if (dtype == 1 && int8_pages)
    return launch_d<__nv_bfloat16, true>(D, q, k_pages, v_pages, ks, vs, tb, ln, pd, out, acc,
                                         m, l, B, MB, BS, H, K, nsplit, scale, softcap, st,
                                         launched);
  return cudaErrorInvalidValue;
}
