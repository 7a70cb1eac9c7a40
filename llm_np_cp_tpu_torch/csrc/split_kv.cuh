// Split-KV combine: merge the partial softmax results of NSPLIT blocks
// that each attended one contiguous range of a row's kv band.
//
// The TPU kernels run their kv axis in order on one core and carry
// (m, l, acc) in scratch from one grid step to the next
// (llm_np_cp_tpu/ops/pallas/decode_attention.py: _decode_kernel,
// _paged_kernel).  On Hopper that axis is spread over blocks to fill the
// card, and this pass takes the place of the TPU kernels' _finalize.
//
// Partials, float32 and never rounded to T, for R independent
// (row, kv head) pairs of `rows` query rows each:
//   acc [R, NSPLIT, rows, D]  unnormalised sum of p*V over the split
//   m   [R, NSPLIT, rows]     the split's running max (NEG_INF if empty)
//   l   [R, NSPLIT, rows]     the split's sum of p (0 if nothing visible)
// out in T:
//   M = max m_i over the splits with l_i > 0,  w_i = exp(m_i - M) or 0
//   out = sum_i w_i acc_i / sum_i w_i l_i, zeros where the sum is 0
// (a split with l_i == 0 never enters: exp(NEG_INF - NEG_INF) would be 1;
// a row no split saw is zeros and its acc is not read).  The output is
// [R, rows, D] for the decode kernels; the ragged kernel's R = NT x K
// (tile, kv head) pairs of rows = 8 x G (lane, head) go to the packed
// [NT, 8, K, G, D] (kv = K, g = G; PACKED).
//
// Bound by bytes: each partial is read once.  One block per r: the
// block loads its NSPLIT x rows maxima at once, one warp per row turns
// them into weights and the denominator, then each thread owns (row, d)
// outputs (the ragged rows: four consecutive ones, in 16-byte loads, where
// they are wide enough to give every thread four) and streams the splits'
// acc.
#pragma once

#include "common.cuh"

namespace split_kv {

constexpr int kCombineThreads = 256;

// PACKED: the ragged kernel's layout (kv, g) and rows that may have seen
// nothing; else the decode kernels' [R, rows, D], every row's acc written.
template <typename T, bool PACKED>
__global__ void __launch_bounds__(kCombineThreads)
combine_splits_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                      const float* __restrict__ l, T* __restrict__ out, int nsplit, int rows,
                      int D, int kv, int g) {
  extern __shared__ float split_kv_smem[];
  float* sW = split_kv_smem;         // [nsplit][rows]: the maxima, then the weights
  float* sDen = sW + nsplit * rows;  // [rows] sum_i w_i l_i
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t r = blockIdx.x;
  const int np = nsplit * rows;
  const float* mr = m + r * np;
  const float* lr = l + r * np;

  for (int i = tid; i < np; i += kCombineThreads) sW[i] = lr[i] > 0.f ? mr[i] : LLM_NEG_INF;
  __syncthreads();
  for (int row = warp; row < rows; row += kCombineThreads / 32) {
    float mx = LLM_NEG_INF;
    for (int i = lane; i < nsplit; i += 32) mx = fmaxf(mx, sW[i * rows + row]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int i = lane; i < nsplit; i += 32) {
      const float li = lr[i * rows + row];
      const float w = li > 0.f ? expf(sW[i * rows + row] - mx) : 0.f;
      sW[i * rows + row] = w;
      den = fmaf(w, li, den);
    }
    den = warp_sum(den);
    if (lane == 0) sDen[row] = den;
  }
  __syncthreads();

  const int n = rows * D;
  const float* ar = acc + r * nsplit * n;
  if constexpr (!PACKED) {
    for (int o = tid; o < n; o += kCombineThreads) {
      const int row = o / D;
      float num = 0.f;
#pragma unroll 4
      for (int i = 0; i < nsplit; ++i)
        num = fmaf(sW[i * rows + row], __ldg(ar + (size_t)i * n + o), num);
      const float den = sDen[row];
      out[r * n + o] = from_f32<T>(den > 0.f ? num / den : 0.f);
    }
  } else {
    // (r, row) → out: tile r / kv, lane row / g, kv head r % kv, head
    // row % g.  A row that saw nothing (den 0: a dead lane) is zeros, and
    // its acc may be unwritten; every split of any other row wrote its acc.
    T* orow = out + ((r / kv) * (rows / g) * kv + r % kv) * (size_t)g * D;
    if (n >= 4 * kCombineThreads) {
      // wide rows: four consecutive outputs a thread in 16-byte loads
      // (narrower ones would leave threads idle)
      const float4* a4 = reinterpret_cast<const float4*>(ar);
      for (int o = tid; o < n / 4; o += kCombineThreads) {
        const int row = 4 * o / D;
        const float den = sDen[row];
        float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
        if (den > 0.f) {
#pragma unroll 4
          for (int i = 0; i < nsplit; ++i) {
            const float w = sW[i * rows + row];
            const float4 a = __ldg(a4 + (size_t)i * (n / 4) + o);
            num = make_float4(fmaf(w, a.x, num.x), fmaf(w, a.y, num.y), fmaf(w, a.z, num.z),
                              fmaf(w, a.w, num.w));
          }
        }
        const float inv = den > 0.f ? 1.f / den : 0.f;
        T* dst = orow + ((size_t)(row / g) * kv * g + row % g) * D + 4 * o % D;
        dst[0] = from_f32<T>(num.x * inv);
        dst[1] = from_f32<T>(num.y * inv);
        dst[2] = from_f32<T>(num.z * inv);
        dst[3] = from_f32<T>(num.w * inv);
      }
    } else {
      for (int o = tid; o < n; o += kCombineThreads) {
        const int row = o / D;
        const float den = sDen[row];
        float num = 0.f;
        if (den > 0.f) {
#pragma unroll 4
          for (int i = 0; i < nsplit; ++i)
            num = fmaf(sW[i * rows + row], __ldg(ar + (size_t)i * n + o), num);
        }
        orow[((size_t)(row / g) * kv * g + row % g) * D + o % D] =
            from_f32<T>(den > 0.f ? num / den : 0.f);
      }
    }
  }
}

inline size_t combine_smem_bytes(int nsplit, int rows) {
  return sizeof(float) * ((size_t)nsplit * rows + rows);
}

template <typename T, bool PACKED>
cudaError_t launch_combine(const float* acc, const float* m, const float* l, T* out, int R,
                           int nsplit, int rows, int D, int kv, int g, cudaStream_t stream) {
  const size_t smem = combine_smem_bytes(nsplit, rows);
  static size_t configured = 0;
  cudaError_t e = ensure_smem(combine_splits_kernel<T, PACKED>, smem, &configured);
  if (e != cudaSuccess) return e;
  combine_splits_kernel<T, PACKED><<<R, kCombineThreads, smem, stream>>>(acc, m, l, out, nsplit,
                                                                          rows, D, kv, g);
  return cudaGetLastError();
}

// Launch the combine on `stream`; returns cudaGetLastError().  kv, g > 0:
// the ragged kernel's packed output ([R / kv, rows / g, kv, g, D]);
// otherwise [R, rows, D].
template <typename T>
cudaError_t combine(const float* acc, const float* m, const float* l, T* out, int R, int nsplit,
                    int rows, int D, cudaStream_t stream, int kv = 0, int g = 0) {
  if (R <= 0) return cudaSuccess;
  if (nsplit < 1 || rows < 1 || D < 1) return cudaErrorInvalidValue;
  if (g == 0) return launch_combine<T, false>(acc, m, l, out, R, nsplit, rows, D, 1, rows, stream);
  if (kv < 1 || rows % g || R % kv || D % 4) return cudaErrorInvalidValue;
  return launch_combine<T, true>(acc, m, l, out, R, nsplit, rows, D, kv, g, stream);
}

}  // namespace split_kv
