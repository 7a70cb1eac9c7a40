// Causal GQA flash attention for prefill.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/flash_attention.py:
// flash_attention (_flash_kernel, band arithmetic _kv_block_bounds).
//
// What bounds it on the H100: operations.  Prefill attention does
// 4*S*S/2*D multiply-adds per head against S*D*2 bytes per head, far above
// the card's ~295 FLOP/byte ridge.  This first version runs the two inner
// products as scalar float32 FMAs out of shared memory (67 TFLOP/s peak,
// not the tensor cores' 989), so it is expected to sit well above the
// bound; wgmma/mma tiles are later work.  What the design does about the
// bound: it never materialises the [S, S] score matrix (online softmax,
// state in registers), and it never loads a kv tile outside the causal /
// sliding-window band of the q tile, the same skip the TPU kernel does.
//
// Design: one block of 256 threads per (batch*head, q tile of 64 rows).
// The TPU kernel's sequential kv-block grid axis becomes a loop inside the
// block.  Thread (ty, tx) = (tid/16, tid%16) owns q rows ty*4..ty*4+3 and
// kv columns tx+16*c of each tile, and output dims tx+16*j.  The 16
// threads of one row group are one half-warp, so row max/sum are
// half-warp shuffles.  K/V tiles are staged as float32 in shared memory
// with a padded row stride (conflict-free column reads).  P is rounded to
// the storage type before the PV product, as the TPU kernel does.  The
// ragged tail (S not a multiple of the tile) is masked in the kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;

template <int D> struct FlashTile { static constexpr int BKV = 64; };
template <> struct FlashTile<256> { static constexpr int BKV = 32; };

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             int S, int H, int K, float scale, float softcap, int window) {
  constexpr int BKV = FlashTile<D>::BKV;
  constexpr int NC = BKV / 16;  // kv columns per thread
  constexpr int ND = D / 16;    // output dims per thread
  constexpr int LD = D + 1;     // padded smem row stride
  extern __shared__ float smem[];
  float* sQ = smem;             // [kBQ][LD]
  float* sK = sQ + kBQ * LD;    // [BKV][LD]
  float* sV = sK + BKV * LD;    // [BKV][D]
  float* sP = sV + BKV * D;     // [kBQ][BKV + 1]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // heaviest q tiles (most visible kv tiles) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, row = q0 + r;
    sQ[r * LD + d] = row < S ? to_f32(q[((size_t)(b * S + row) * H + h) * D + d]) : 0.f;
  }

  // visible kv-tile band [jmin, jmax] of this q tile (_kv_block_bounds)
  const int q_last = min(q0 + kBQ - 1, S - 1);
  const int jmax = q_last / BKV;
  const int jmin = window > 0 ? max(floordiv(q0 - window - BKV + 1, BKV) + 1, 0) : 0;

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = LLM_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[r][j] = 0.f;
  }

  for (int jt = jmin; jt <= jmax; ++jt) {
    const int kv0 = jt * BKV;
    __syncthreads();  // previous tile's sK/sV/sP reads are done
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int c = idx / D, d = idx % D, col = kv0 + c;
      float kval = 0.f, vval = 0.f;
      if (col < S) {
        const size_t off = ((size_t)(b * S + col) * K + kh) * D + d;
        kval = to_f32(k[off]);
        vval = to_f32(v[off]);
      }
      sK[c * LD + d] = kval;
      sV[c * D + d] = vval;
    }
    __syncthreads();

    float s[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(ty * 4 + r) * LD + d];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sK[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      bool vis[NC];
      float tmax = LLM_NEG_INF;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = kv0 + tx + 16 * c;
        vis[c] = col <= row && col < S && (window <= 0 || row - col < window);
        const float sc = softcap_f(s[r][c] * scale, softcap);
        s[r][c] = vis[c] ? sc : LLM_NEG_INF;
        tmax = fmaxf(tmax, s[r][c]);
      }
      for (int o = 8; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[r], tmax);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        // masked slots are zeroed explicitly: a row with nothing visible
        // yet keeps l == 0 and acc == 0 instead of averaging garbage
        const float p = vis[c] ? expf(s[r][c] - m_new) : 0.f;
        psum += p;
        sP[(ty * 4 + r) * (BKV + 1) + tx + 16 * c] = round_to<T>(p);
      }
      for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[4], vv[ND];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sP[(ty * 4 + r) * (BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= S) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      out[((size_t)(b * S + row) * H + h) * D + tx + 16 * j] = from_f32<T>(acc[r][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int H, int K, float scale, float softcap, int window,
                   cudaStream_t stream) {
  constexpr int BKV = FlashTile<D>::BKV;
  const size_t smem = sizeof(float) *
      (kBQ * (D + 1) + BKV * (D + 1) + BKV * D + kBQ * (BKV + 1));
  static size_t configured = 0;
  cudaError_t e = ensure_smem(flash_kernel<T, D>, smem, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, K, scale, softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int B,
                     int S, int H, int K, int D, float scale, float softcap,
                     int window, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, K, scale, softcap, window, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, K, scale, softcap, window, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, S, H, K, scale, softcap, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,S,H,D], k/v [B,S,K,D], out [B,S,H,D], all contiguous.
// softcap <= 0 and window <= 0 switch those features off.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int H, int K, int D,
                                      float scale, float softcap, int window,
                                      int dtype, void* stream) {
  if (S <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, S, H, K, D, scale, softcap, window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, S, H, K, D, scale, softcap, window, st);
  return cudaErrorInvalidValue;
}
