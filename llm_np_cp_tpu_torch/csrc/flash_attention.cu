// Causal GQA flash attention for prefill.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/flash_attention.py:
// flash_attention (_flash_kernel, band arithmetic _kv_block_bounds).
//
// What bounds it on the H100: operations.  Prefill attention does
// 4*S*S/2*D FLOPs per head against S*D*2 bytes per head, far above the
// card's ~295 FLOP/byte ridge from S ~ 2048 on.  What the design does
// about the bound: it never materialises the [S, S] score matrix (online
// softmax, state in registers), never loads a kv tile outside the causal /
// sliding-window band of the q tile (the TPU kernel's skip), and, in
// bfloat16, runs both products on the tensor cores.
//
// Two kernels, chosen by the element type:
//
// bfloat16 (flash_kernel_mma), the FlashAttention-2 shape on mma.sync:
// one block of WARPS warps per (batch*head, q tile of BQ rows); each warp
// owns BQ / WARPS q rows, MT = 1 or 2 m tiles of 16 (two m tiles share
// every K and V fragment).  S = Q K^T and O += P V are
// mma.sync.m16n8k16 bf16 products with float32 accumulators in
// registers, fragments loaded with ldmatrix (.trans for V).  Q's
// fragments are loaded once per block (kept in registers up to D=128; at
// D=256 the 64x256 float32 output accumulator alone takes 128 registers a
// thread, so Q is re-read from shared memory per tile).  K/V tiles of BKV
// rows arrive by 16-byte cp.async into two bf16 buffers: tile j+1 is in
// flight while tile j is computed.  Shared-memory rows are XOR-swizzled
// in 16-byte chunks (chunk ^ row % 8), so every ldmatrix and cp.async is
// free of bank conflicts.  The softmax runs in the log2 domain (scale *
// log2(e) folded into one FMA before ex2.approx); row max and sum reduce
// over the 4 lanes that share a row, and the sum once at the end.  P is
// rounded to bf16 in registers and used directly as the A operand of the
// PV product (the TPU kernel's p.astype(v.dtype)): it never goes through
// shared memory.  Each warp classifies each kv tile against its rows
// (tile_class): tiles that it sees nothing of are skipped, fully visible
// ones run without the element mask, and only tiles that cross the
// diagonal, the window's lower edge or S are masked.  The softcap (an
// accurate tanhf: an approximate one at cap 50 moves a logit by ~0.02) is
// a template parameter, so the uncapped loop carries none of it.  The
// output goes through the warp's own Q rows in shared memory and out in
// 16-byte stores.  Tiles (flash_plan, from the sweeps in PERF.md): D=64
// BQ 128 x BKV 64, 4 warps of 32 rows; D=128 BQ 64 x BKV 64, 4 warps of
// 16 rows, two blocks an SM; D=256 BQ 64 x BKV 32, 4 warps of 16 rows.
//
// float32 (flash_kernel), the scalar kernel: both products are float32
// FMAs out of shared memory on the CUDA cores (TF32 tensor cores would
// break the float32 path's exactness).  One block of 256 threads per (q
// tile of 64 rows, batch*head); thread (ty, tx) = (tid/16, tid%16) owns q
// rows ty*4..ty*4+3, kv columns tx+16*c of each tile and output dims
// tx+16*j; row max/sum are half-warp shuffles.  K/V tiles are staged as
// float32 with a padded row stride.
//
// Both launch the heaviest q tiles (most visible kv tiles) first, give
// masked slots p = 0 exactly (a row with nothing visible yet keeps l == 0
// and acc == 0) and mask the ragged tail (S not a multiple of the tile) in
// the kernel.  The tile sizes come from the caller's plan (flash_plan in
// ops/cuda/flash_attention.py), which the launcher checks against the
// instantiated kernels.
#include <math.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

// ----------------------------------------------------------------------
// float32: the scalar kernel
// ----------------------------------------------------------------------

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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B,
                       int S, int H, int K, float scale, float softcap, int window,
                       int bq, int bkv, int warps, size_t smem, cudaStream_t stream) {
  constexpr int BKV = FlashTile<D>::BKV;
  constexpr size_t kSmem = sizeof(float) *
      (kBQ * (D + 1) + BKV * (D + 1) + BKV * D + kBQ * (BKV + 1));
  if (bq != kBQ || bkv != BKV || warps * 32 != kThreads || smem != kSmem)
    return cudaErrorInvalidValue;
  static size_t configured = 0;
  cudaError_t e = ensure_smem(flash_kernel<float, D>, kSmem, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_kernel<float, D><<<grid, kThreads, kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, H, K, scale,
      softcap, window);
  return cudaGetLastError();
}

// ----------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ----------------------------------------------------------------------

using namespace tc;

// What rows [r0, r0 + nrows) see of kv columns [kv0, kv0 + bkv) under the
// causal + window mask over positions 0..S-1 (rows >= S are never
// written, so they do not count): 0 nothing (skip the tile), 1 part of
// it (apply the element mask), 2 all of it (no mask).  Mirrored by
// tile_class in ops/cuda/flash_attention.py, which the CPU tests hold
// against a brute-force mask.
__device__ __forceinline__ int tile_class(int r0, int nrows, int kv0, int bkv, int S,
                                          int window) {
  if (r0 >= S) return 0;
  const int r_hi = min(r0 + nrows - 1, S - 1);
  const int c_hi = min(kv0 + bkv - 1, S - 1);
  if (kv0 > r_hi || (window > 0 && r0 - c_hi >= window)) return 0;
  if (kv0 + bkv - 1 <= r0 && kv0 + bkv <= S && (window <= 0 || r_hi - kv0 < window)) return 2;
  return 1;
}

template <int D, int BQ, int BKV, int WARPS>
struct MmaTile {
  static_assert(BQ % (16 * WARPS) == 0, "a warp owns a whole number of 16-row m tiles");
  static_assert(BKV % 16 == 0 && D % 16 == 0, "mma tiles are 16 deep");
  static constexpr int kThreads = WARPS * 32;
  static constexpr int MT = BQ / (16 * WARPS);  // 16-row m tiles a warp
  static constexpr int CH = D / 8;              // 16-byte chunks a row
  // Q's fragments stay in registers up to D=128
  static constexpr bool Q_REGS = D <= 128;
  // blocks an SM that ptxas must fit: a cap of 65536 / (kMinBlocks *
  // kThreads) registers a thread
  static constexpr int kMinBlocks = D <= 128 && MT == 1 ? 2 : 1;
  // Q, then K and V in two buffers each
  static constexpr size_t kSmem = sizeof(bf16) * (BQ * D + 4 * BKV * D);
  static_assert((BQ * CH) % kThreads == 0 && (BKV * CH) % kThreads == 0, "whole copy rounds");
};

// CAP: the softcap is on (softcap > 0), a template parameter so that the
// scores' loop carries no tanh when it is off
template <int D, int BQ, int BKV, int WARPS, bool CAP>
__global__ void __launch_bounds__(WARPS * 32, (MmaTile<D, BQ, BKV, WARPS>::kMinBlocks))
flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H, int K,
                 float scale, float softcap, int window) {
  using Tile = MmaTile<D, BQ, BKV, WARPS>;
  constexpr int kThreads = Tile::kThreads;
  constexpr int CH = Tile::CH;
  constexpr int MT = Tile::MT;
  constexpr int WR = 16 * MT;   // q rows a warp
  constexpr int NT = BKV / 8;   // 8-column n tiles of S
  constexpr int DT = D / 8;     // 8-column n tiles of O
  constexpr int KD = D / 16;    // k steps of Q K^T
  constexpr int KV = BKV / 16;  // k steps of P V
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][D]
  bf16* sK = sQ + BQ * D;                        // [2][BKV][D]
  bf16* sV = sK + 2 * BKV * D;                   // [2][BKV][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  // heaviest q tiles (most visible kv tiles) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int w0 = q0 + warp * WR;  // this warp's first q row

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const bf16* qb = q + ((size_t)b * S * H + h) * D;
  const bf16* kb = k + ((size_t)b * S * K + kh) * D;
  const bf16* vb = v + ((size_t)b * S * K + kh) * D;

  // visible kv-tile band [jmin, jmax] of this q tile (_kv_block_bounds)
  const int jmax = min(q0 + BQ - 1, S - 1) / BKV;
  const int jmin = window > 0 ? max(floordiv(q0 - window - BKV + 1, BKV) + 1, 0) : 0;

#pragma unroll
  for (int it = 0; it < BQ * CH / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / CH, c = i % CH, row = q0 + r;
    cp_async16(smem_addr(sQ + swz<D>(r, c)), qb + min(row, S - 1) * q_stride + c * 8, row < S);
  }
  auto load_kv = [&](int jt, int buf) {
    const int kv0 = jt * BKV;
#pragma unroll
    for (int it = 0; it < BKV * CH / kThreads; ++it) {
      const int i = tid + it * kThreads, r = i / CH, c = i % CH, row = kv0 + r;
      const size_t off = min(row, S - 1) * kv_stride + c * 8;
      const int o = buf * BKV * D + swz<D>(r, c);
      cp_async16(smem_addr(sK + o), kb + off, row < S);
      cp_async16(smem_addr(sV + o), vb + off, row < S);
    }
  };
  load_kv(jmin, 0);
  cp_async_commit();

  // scores in the log2 domain, x * unit: x = s and unit = scale * log2(e),
  // or with a softcap x = tanh(s * scale / cap) * cap * log2(e), unit 1
  const float pre = scale / softcap, post = softcap * kLog2e;
  const float unit = CAP ? 1.f : scale * kLog2e;

  float o[MT][DT][4];
  float m[MT][2], l[MT][2];  // rows g and g + 8 of each m tile: running
                             // max (log2 domain), this lane's share of the sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
  }
  uint32_t qf[Tile::Q_REGS ? MT : 1][Tile::Q_REGS ? KD : 1][4];

  // ldmatrix lane addresses: A (Q) and B (V, transposed) rows lane % 16,
  // chunk + lane / 16; B (K) rows lane % 8 + 8 * (lane / 16), chunk +
  // lane / 8 % 2
  const int a_row = lane & 15, a_ch = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_ch = (lane >> 3) & 1;
  const uint32_t sQ_addr = smem_addr(sQ);
  auto load_q = [&](int mt, int kk, uint32_t (&a)[4]) {
    ldsm_x4(sQ_addr + 2 * swz<D>(warp * WR + mt * 16 + a_row, 2 * kk + a_ch), a);
  };

  for (int jt = jmin; jt <= jmax; ++jt) {
    const int buf = (jt - jmin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile jt landed; every warp is done with tile jt - 1
    if (jt < jmax) {
      load_kv(jt + 1, buf ^ 1);
      cp_async_commit();
    }
    if constexpr (Tile::Q_REGS) {
      if (jt == jmin) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) load_q(mt, kk, qf[mt][kk]);
      }
    }
    const int kv0 = jt * BKV;
    const int cls = tile_class(w0, WR, kv0, BKV, S, window);
    if (cls == 0) continue;
    const bf16* cK = sK + buf * BKV * D;
    const bf16* cV = sV + buf * BKV * D;

    // S = Q K^T: each K fragment feeds the warp's MT m tiles
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (Tile::Q_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kk][e];
        } else {
          load_q(mt, kk, a[mt]);
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(smem_addr(cK + swz<D>(np * 16 + k_row, 2 * kk + k_ch)), bk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // online softmax; element e of n tile n of m tile mt: row
    // w0 + 16 * mt + g + 8 * (e / 2), column kv0 + 8 * n + 2 * t + e % 2.
    // Masked slots are -inf: p = 2^(-inf) = 0, so a row with nothing
    // visible yet keeps l == 0 and acc == 0
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (CAP) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = tanhf(s[mt][n][e] * pre) * post;
      }
      if (cls == 1) {  // warp-uniform: only tiles the mask cuts
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = w0 + 16 * mt + g + 8 * (e >> 1);
            const int col = kv0 + 8 * n + 2 * t + (e & 1);
            if (!(col <= row && col < S && (window <= 0 || row - col < window)))
              s[mt][n][e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
      float alpha[2], base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r] * unit);
        // nothing visible yet (m_new = -inf): keep alpha 1 and base 0
        alpha[r] = m_new == -INFINITY ? 1.f : exp2_ftz(m[mt][r] - m_new);
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        m[mt][r] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = exp2_ftz(fmaf(s[mt][n][e], unit, -base[e >> 1]));
          psum[e >> 1] += s[mt][n][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[r] + psum[r];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[mt][j][0] *= alpha[0];
        o[mt][j][1] *= alpha[0];
        o[mt][j][2] *= alpha[1];
        o[mt][j][3] *= alpha[1];
      }
    }

    // O += P V, P rounded to bf16 in registers as the A operand; each V
    // fragment feeds the warp's MT m tiles
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(smem_addr(cV + swz<D>(kk * 16 + a_row, 2 * dp + a_ch)), bv);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], a[mt], bv[0], bv[1]);
          mma_bf16(o[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
  }

  // the output goes through this warp's own Q rows (no other warp reads
  // them), then out in 16-byte row chunks.  Rows past S (and only they)
  // end with l == 0: guard the division
  bf16* sO = sQ + warp * WR * D;
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      inv[r] = 1.f / (lr == 0.f ? 1.f : lr);
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(sO + swz<D>(16 * mt + g, j) + 2 * t) =
          pack_bf16(o[mt][j][0] * inv[0], o[mt][j][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(sO + swz<D>(16 * mt + g + 8, j) + 2 * t) =
          pack_bf16(o[mt][j][2] * inv[1], o[mt][j][3] * inv[1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < WR * CH / 32; ++it) {
    const int i = lane + it * 32, r = i / CH, c = i % CH, row = w0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(out + ((size_t)b * S + row) * q_stride + (size_t)h * D + c * 8) =
          *reinterpret_cast<const uint4*>(sO + swz<D>(r, c));
  }
}

template <int D, int BQ, int BKV, int WARPS, bool CAP>
cudaError_t launch_mma_cap(const void* q, const void* k, const void* v, void* out, int B,
                           int S, int H, int K, float scale, float softcap, int window,
                           cudaStream_t stream) {
  using Tile = MmaTile<D, BQ, BKV, WARPS>;
  static size_t configured = 0;
  cudaError_t e =
      ensure_smem(flash_kernel_mma<D, BQ, BKV, WARPS, CAP>, Tile::kSmem, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_kernel_mma<D, BQ, BKV, WARPS, CAP><<<grid, Tile::kThreads, Tile::kSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, H, K, scale, softcap,
      window);
  return cudaGetLastError();
}

template <int D, int BQ, int BKV, int WARPS>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S,
                       int H, int K, float scale, float softcap, int window, size_t smem,
                       cudaStream_t stream) {
  if (smem != MmaTile<D, BQ, BKV, WARPS>::kSmem) return cudaErrorInvalidValue;
  return softcap > 0.f
      ? launch_mma_cap<D, BQ, BKV, WARPS, true>(q, k, v, out, B, S, H, K, scale, softcap,
                                                window, stream)
      : launch_mma_cap<D, BQ, BKV, WARPS, false>(q, k, v, out, B, S, H, K, scale, softcap,
                                                 window, stream);
}

}  // namespace

// q [B,S,H,D], k/v [B,S,K,D], out [B,S,H,D], all contiguous (bf16: 16-byte
// aligned).  softcap <= 0 and window <= 0 switch those features off.
// (bq, bkv, warps, smem) is the caller's tile plan; a plan that names no
// instantiated kernel is refused with cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int H, int K, int D,
                                      float scale, float softcap, int window, int dtype,
                                      int bq, int bkv, int warps, size_t smem, void* stream) {
  if (S <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (D) {
      case 64: return launch_f32<64>(q, k, v, out, B, S, H, K, scale, softcap, window, bq, bkv, warps, smem, st);
      case 128: return launch_f32<128>(q, k, v, out, B, S, H, K, scale, softcap, window, bq, bkv, warps, smem, st);
      case 256: return launch_f32<256>(q, k, v, out, B, S, H, K, scale, softcap, window, bq, bkv, warps, smem, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    if (D == 64 && bq == 128 && bkv == 64 && warps == 4)
      return launch_mma<64, 128, 64, 4>(q, k, v, out, B, S, H, K, scale, softcap, window, smem, st);
    if (D == 128 && bq == 64 && bkv == 64 && warps == 4)
      return launch_mma<128, 64, 64, 4>(q, k, v, out, B, S, H, K, scale, softcap, window, smem, st);
    if (D == 256 && bq == 64 && bkv == 32 && warps == 4)
      return launch_mma<256, 64, 32, 4>(q, k, v, out, B, S, H, K, scale, softcap, window, smem, st);
  }
  return cudaErrorInvalidValue;
}
