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
// The tile's band runs from its first token's window start to its last
// live token.
//
// What bounds it on the H100: bytes for decode-heavy ticks (each visible
// K/V slot of a tile's band read once for the tile's 8 x G query rows),
// operations only for long prefill slices.  What the design does about
// it:
//
// - Grid (K * ceil(G/4), NT, NSPLIT): a block takes up to 4 query heads
//   of one kv head for one tile, and split `z` of the tile's band, cut
//   into NSPLIT ranges of whole DecodeTile tiles as the decode kernels
//   cut theirs (split_decode.cuh).  Each split writes float32 partials
//   and split_kv.cuh's combine merges them into the packed output; with
//   NSPLIT == 1 the block writes the output itself.  NSPLIT comes from a
//   plan on the shapes alone (ragged_split_plan in
//   ops/cuda/decode_attention.py: at least 4 kv tiles a split, below
//   which the combine costs more than the split saves): the lengths stay
//   on the card.
// - Each block takes its path from its tile's qlen (block-uniform):
//   * dead (qlen 0): its rows are zeros (or empty partials: l = 0);
//   * decode (qlen 1): split_decode.cuh's kv loop over the paged slots,
//     the paged decode kernel's own (a cp.async ring of each lane's next
//     slots, K/V rows in 16-byte pieces), for lane 0's band; lanes 1-7
//     cost nothing but their zeros;
//   * prefill (qlen 2-8), bf16 (a bf16 pool, or an int8 one: its values
//     round_to<bf16>(q * round_to<bf16>(scale)) are exact in bf16):
//     QK^T and PV on mma.sync.m16n8k16 (tensor_core.cuh), float32
//     accumulators.  The block's rows, r = lane * gn + head (8 x gn <= 32:
//     RT = 1 or 2 row tiles of 16; G = 7 pads 28 rows to 32), against kv
//     tiles of DecodeTile<D>::BS slots (64, 32 at D=256) brought by
//     16-byte cp.async from the pool through the block table into two
//     swizzled bf16 buffers (an int8 pool is loaded to registers and
//     dequantised into them).  Warp w takes row tile mt, the 16-slot
//     chunk c of every kv tile and the D/DP output columns dp:
//     RT x (BKV/16) x DP = 8 warps, so every warp has work whatever the
//     group width; a warp recomputes the scores of its (mt, c) for each
//     of the DP column parts (DP > 1 only with one row tile or D=256).
//     Each warp keeps its own online softmax (log2 domain, scale folded
//     into one FMA before ex2.approx, as flash_attention.cu), P rounded to
//     bf16 in registers as the PV product's A operand, and the warps of
//     one (mt, dp) merge through shared memory at the end.  Q is re-read
//     from shared memory by ldmatrix for every kv tile.  A long band is
//     re-read through L2 once per tile and kv head; what holds these
//     tiles back is each warp's serial chain per kv tile (PERF.md §6: a
//     deeper ring, 128-slot kv tiles and blocks of 4 tiles sharing each
//     K/V tile each moved the long mixed tick by 4 % or less).
//   * prefill, float32: paged_attention.cuh's scalar core (float32
//     products keep the float32 serve legs token-identical to offline).
// - The two paths share the block (256 threads, two an SM) and its
//   dynamic shared memory, the larger of the two.
#include "paged_attention.cuh"
#include "split_decode.cuh"
#include "split_kv.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kQTile = 8;  // RAGGED_Q_TILE
constexpr int kThreads = split_decode::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = kQTile * split_decode::kGC;  // 32 query rows a block
constexpr float kLn2 = 0.6931471805599453f;

static_assert(paged::kThreads == kThreads, "one block size for every path");

// the bf16 prefill tiles' geometry for head dim D and RT row tiles
template <int D, int RT>
struct Prefill {
  static constexpr int BKV = split_decode::DecodeTile<D>::BS;  // slots a kv tile
  static constexpr int NC = BKV / 16;                          // 16-slot chunks a kv tile
  static constexpr int DP = kWarps / (RT * NC);                // output column parts
  static constexpr int DW = D / DP;                            // columns a warp
  static constexpr int CH = D / 8;                             // 16-byte chunks a head row
  static_assert(RT * NC * DP == kWarps && DW % 16 == 0, "8 warps, 16-column pairs");
};

// sQ [32][D], sK / sV [2][BKV][D] bf16; after the loop the same bytes hold
// the warps' merge state: sO [8][16][DW], sM / sL [8][16] float32
template <int D>
constexpr size_t prefill_smem_bytes() {
  constexpr int BKV = split_decode::DecodeTile<D>::BS;
  constexpr int DW1 = Prefill<D, 1>::DW, DW2 = Prefill<D, 2>::DW;
  constexpr int DW = DW1 > DW2 ? DW1 : DW2;
  constexpr size_t tiles = sizeof(tc::bf16) * (kMaxRows * D + 4 * BKV * D);
  constexpr size_t merge = sizeof(float) * (kWarps * 16 * DW + 2 * kWarps * 16);
  return tiles > merge ? tiles : merge;
}

template <typename T, bool INT8, int D>
inline size_t smem_bytes() {
  const size_t dec = split_decode::smem_bytes<T, INT8, D>();
  const size_t pre = std::is_same_v<T, float> ? paged::smem_bytes<D>(kMaxRows)
                                              : prefill_smem_bytes<D>();
  return dec > pre ? dec : pre;
}

struct Tile {
  int t, row, qpos0, qlen, pad, window;
  // this block's heads: kv head kh, heads [g0, g0 + gn) of G
  split_decode::Heads hd;
  // the tile's band [first, last] (last < first: nothing) and this
  // block's split of it, [lo, hi)
  int first, last, lo, hi;
};

// Zeros (NSPLIT == 1) or empty partials (m = NEG_INF, l = 0; acc is not
// read by the combine) for lanes [i0, 8) of the block's heads.
template <typename T, int D>
__device__ void empty_lanes(const Tile& tl, int i0, int H, int K, T* __restrict__ out,
                            float* __restrict__ part_m, float* __restrict__ part_l,
                            int nsplit) {
  const int gn = tl.hd.gn, G = tl.hd.G;
  const int n = (kQTile - i0) * gn;
  if (out != nullptr) {
    for (int o = threadIdx.x; o < n * D; o += kThreads) {
      const int r = o / D, i = i0 + r / gn, g = r % gn;
      out[((size_t)(tl.t * kQTile + i) * H + tl.hd.kh * G + tl.hd.g0 + g) * D + o % D] =
          from_f32<T>(0.f);
    }
  } else {
    const size_t part = ((size_t)tl.t * K + tl.hd.kh) * nsplit + blockIdx.z;
    for (int r = threadIdx.x; r < n; r += kThreads) {
      const size_t pr = part * kQTile * G + (size_t)(i0 + r / gn) * G + tl.hd.g0 + r % gn;
      part_m[pr] = LLM_NEG_INF;
      part_l[pr] = 0.f;
    }
  }
}

// ----------------------------------------------------------------------
// bf16 prefill tiles on the tensor cores
// ----------------------------------------------------------------------

template <bool INT8, int D, int RT>
__device__ void prefill_mma(const Tile& tl, const tc::bf16* __restrict__ q,
                            const void* __restrict__ kp, const void* __restrict__ vp,
                            const float* __restrict__ ks, const float* __restrict__ vs,
                            const int* __restrict__ table, tc::bf16* __restrict__ out,
                            float* __restrict__ part_acc, float* __restrict__ part_m,
                            float* __restrict__ part_l, int BS, int shift, int H, int K,
                            int nsplit, float scale, float softcap) {
  using namespace tc;
  using P = Prefill<D, RT>;
  constexpr int BKV = P::BKV, NC = P::NC, DP = P::DP, DW = P::DW, CH = P::CH;
  constexpr int KD = D / 16;                       // k steps of Q K^T
  constexpr int CPT = BKV * CH / kThreads;         // 16-byte chunks a thread a kv tile
  static_assert(CPT * kThreads == BKV * CH, "whole copy rounds");
  extern __shared__ __align__(128) unsigned char ragged_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(ragged_smem);  // [32][D]
  bf16* sK = sQ + kMaxRows * D;                     // [2][BKV][D]
  bf16* sV = sK + 2 * BKV * D;                      // [2][BKV][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int mt = warp / (NC * DP), c = (warp / DP) % NC, dp = warp % DP;
  const int gn = tl.hd.gn, G = tl.hd.G, kh = tl.hd.kh;
  const int rows = kQTile * gn;

  // Q rows r = lane * gn + head; rows past the tile's live lanes are 0
  for (int i = tid; i < RT * 16 * CH; i += kThreads) {
    const int r = i / CH, ch = i % CH, qi = r / gn;
    const bool ok = r < rows && qi < tl.qlen;
    const bf16* src = q + ((size_t)(tl.t * kQTile + (ok ? qi : 0)) * H + kh * G + tl.hd.g0 +
                           (ok ? r % gn : 0)) * D + ch * 8;
    cp_async16(smem_addr(sQ + swz<D>(r, ch)), src, ok);
  }

  const int j0 = tl.lo / BKV, j1 = tl.hi > tl.lo ? (tl.hi - 1) / BKV : j0 - 1;
  // where chunk `it` of this thread lands in a kv tile, and the pool
  // element offset of the slot's head row (or -1: outside the split)
  auto chunk_src = [&](int j, int it, int& r, int& ch) -> long long {
    const int i = tid + it * kThreads;
    r = i / CH;
    ch = i % CH;
    const int s = j * BKV + r;
    if (s < tl.lo || s >= tl.hi) return -1;
    const int blk = shift >= 0 ? s >> shift : s / BS;
    return ((long long)table[blk] * BS + (s - blk * BS)) * K + kh;
  };
  // bf16 pool: cp.async straight into the buffer (zeros outside the split)
  auto copy_kv = [&](int j, int buf) {
#pragma unroll
    for (int it = 0; it < CPT; ++it) {
      int r, ch;
      const long long prow = chunk_src(j, it, r, ch);
      const size_t off = prow < 0 ? 0 : (size_t)prow * D + ch * 8;
      const int o = buf * BKV * D + swz<D>(r, ch);
      cp_async16(smem_addr(sK + o), (const bf16*)kp + off, prow >= 0);
      cp_async16(smem_addr(sV + o), (const bf16*)vp + off, prow >= 0);
    }
  };
  // int8 pool: 8 values and the slot's scale a chunk into registers, then
  // dequantised into the buffer, the kernel's rounding
  uint2 rk[CPT], rv[CPT];
  float sk[CPT], sv[CPT];
  auto fetch_int8 = [&](int j) {
#pragma unroll
    for (int it = 0; it < CPT; ++it) {
      int r, ch;
      const long long prow = chunk_src(j, it, r, ch);
      rk[it] = rv[it] = make_uint2(0, 0);
      sk[it] = sv[it] = 0.f;
      if (prow >= 0) {
        rk[it] = __ldg(reinterpret_cast<const uint2*>((const int8_t*)kp + prow * D + ch * 8));
        rv[it] = __ldg(reinterpret_cast<const uint2*>((const int8_t*)vp + prow * D + ch * 8));
        sk[it] = __ldg(ks + prow);
        sv[it] = __ldg(vs + prow);
      }
    }
  };
  auto dequant = [](uint2 w, float scale_) {
    const float s = round_to<bf16>(scale_);
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = round_to<bf16>((float)(int8_t)((e < 4 ? w.x : w.y) >> (8 * (e % 4))) * s);
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
  };
  auto store_int8 = [&](int buf) {
#pragma unroll
    for (int it = 0; it < CPT; ++it) {
      const int i = tid + it * kThreads, o = buf * BKV * D + swz<D>(i / CH, i % CH);
      *reinterpret_cast<uint4*>(sK + o) = dequant(rk[it], sk[it]);
      *reinterpret_cast<uint4*>(sV + o) = dequant(rv[it], sv[it]);
    }
  };

  if (j1 >= j0) {
    if constexpr (INT8) {
      fetch_int8(j0);
      store_int8(0);
    } else {
      copy_kv(j0, 0);
    }
  }
  cp_async_commit();

  // this thread's two rows (g8 and g8 + 8 of row tile mt): what they see
  // of the split, [vlo, vhi] (vhi < vlo: nothing)
  int vlo[2], vhi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mt * 16 + g8 + 8 * h, qi = r / gn;
    const int slot = tl.qpos0 + qi;
    const long long w0 = max((long long)tl.pad, (long long)slot - tl.window + 1);
    vlo[h] = (int)max(w0, (long long)tl.lo);
    vhi[h] = min(slot, tl.hi - 1);
    if (r >= rows || qi >= tl.qlen) vhi[h] = vlo[h] - 1;
  }

  // scores in the log2 domain, x * unit: x = s and unit = scale * log2(e),
  // or with a softcap x = tanh(s * scale / cap) * cap * log2(e), unit 1
  const bool cap = softcap > 0.f;
  const float pre = cap ? scale / softcap : 0.f, post = softcap * kLog2e;
  const float unit = cap ? 1.f : scale * kLog2e;

  float o[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // ldmatrix lane addresses (flash_attention.cu's)
  const int a_row = lane & 15, a_ch = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_ch = (lane >> 3) & 1;

  for (int j = j0; j <= j1; ++j) {
    const int buf = (j - j0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    const bool next = j < j1;
    if (next) {
      if constexpr (INT8) fetch_int8(j + 1);
      else copy_kv(j + 1, buf ^ 1);
    }
    cp_async_commit();
    const bf16* cK = sK + buf * BKV * D;
    const bf16* cV = sV + buf * BKV * D;
    const int col0 = j * BKV + c * 16;

    // S = Q K^T over this warp's 16 slots
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(smem_addr(sQ + swz<D>(mt * 16 + a_row, 2 * kk + a_ch)), a);
      ldsm_x4(smem_addr(cK + swz<D>(c * 16 + k_row, 2 * kk + k_ch)), bk);
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }
    // element e of n tile n: row g8 + 8 * (e / 2), slot col0 + 8n + 2 t4 + e % 2
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = col0 + 8 * n + 2 * t4 + (e & 1);
        float x = cap ? tanhf(s[n][e] * pre) * post : s[n][e];
        s[n][e] = col >= vlo[h] && col <= vhi[h] ? x : -INFINITY;
      }
    float alpha[2], base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * unit);
      // nothing visible yet (m_new = -inf): keep alpha 1 and base 0
      alpha[h] = m_new == -INFINITY ? 1.f : exp2_ftz(m[h] - m_new);
      base[h] = m_new == -INFINITY ? 0.f : m_new;
      m[h] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_ftz(fmaf(s[n][e], unit, -base[e >> 1]));
        psum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + psum[h];
#pragma unroll
    for (int jj = 0; jj < DW / 8; ++jj) {
      o[jj][0] *= alpha[0];
      o[jj][1] *= alpha[0];
      o[jj][2] *= alpha[1];
      o[jj][3] *= alpha[1];
    }
    // O += P V over the warp's DW columns, P rounded to bf16 in registers
    uint32_t a[4];
    a[0] = pack_bf16(s[0][0], s[0][1]);
    a[1] = pack_bf16(s[0][2], s[0][3]);
    a[2] = pack_bf16(s[1][0], s[1][1]);
    a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int dd = 0; dd < DW / 16; ++dd) {
      uint32_t bv[4];
      ldsm_x4_trans(smem_addr(cV + swz<D>(c * 16 + a_row, dp * (DW / 8) + 2 * dd + a_ch)), bv);
      mma_bf16(o[2 * dd], a, bv[0], bv[1]);
      mma_bf16(o[2 * dd + 1], a, bv[2], bv[3]);
    }
    if constexpr (INT8) {
      if (next) store_int8(buf ^ 1);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with sQ / sK / sV

  // merge the NC warps of each (mt, dp) through shared memory
  float* sO = reinterpret_cast<float*>(ragged_smem);  // [8][16][DW]
  float* sM = sO + kWarps * 16 * DW;                   // [8][16]
  float* sL = sM + kWarps * 16;                        // [8][16]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    if (t4 == 0) {
      sM[warp * 16 + g8 + 8 * h] = m[h];
      sL[warp * 16 + g8 + 8 * h] = lr;
    }
  }
#pragma unroll
  for (int jj = 0; jj < DW / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sO[(warp * 16 + g8 + 8 * (e >> 1)) * DW + 8 * jj + 2 * t4 + (e & 1)] = o[jj][e];
  __syncthreads();

  const size_t part = ((size_t)tl.t * K + kh) * nsplit + blockIdx.z;
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int rt = r / 16, rr = r % 16, dpart = d / DW, dc = d % DW;
    float mx = -INFINITY;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int w = (rt * NC + cc) * DP + dpart;
      if (sL[w * 16 + rr] > 0.f) mx = fmaxf(mx, sM[w * 16 + rr]);
    }
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int w = (rt * NC + cc) * DP + dpart;
      const float lw = sL[w * 16 + rr];
      if (lw > 0.f) {
        const float ww = exp2_ftz(sM[w * 16 + rr] - mx);
        num = fmaf(ww, sO[(w * 16 + rr) * DW + dc], num);
        den = fmaf(ww, lw, den);
      }
    }
    const int qi = r / gn, g = tl.hd.g0 + r % gn;
    if (out != nullptr) {
      out[((size_t)(tl.t * kQTile + qi) * H + kh * G + g) * D + d] =
          __float2bfloat16(den > 0.f ? num / den : 0.f);
    } else {
      const size_t pr = part * kQTile * G + (size_t)qi * G + g;
      part_acc[pr * D + d] = num;
      if (d == 0) {
        part_m[pr] = den > 0.f ? mx * kLn2 : LLM_NEG_INF;  // the combine's natural log
        part_l[pr] = den;
      }
    }
  }
}

// ----------------------------------------------------------------------
// the kernel
// ----------------------------------------------------------------------

// out != nullptr: NSPLIT == 1, write the output; else the partials.
template <typename T, bool INT8, int D>
__global__ void __launch_bounds__(kThreads, 2)
ragged_kernel(const T* __restrict__ q, const void* __restrict__ kp,
              const void* __restrict__ vp, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ tables,
              const int* __restrict__ tile_row, const int* __restrict__ tile_qpos0,
              const int* __restrict__ tile_qlen, const int* __restrict__ pads,
              T* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_m,
              float* __restrict__ part_l, int MB, int BS, int shift, int H, int K, int window,
              int nsplit, float scale, float softcap) {
  Tile tl;
  tl.hd = split_decode::block_heads(H, K);
  tl.t = blockIdx.y;
  tl.qlen = tile_qlen[tl.t];
  if (tl.qlen <= 0) {
    empty_lanes<T, D>(tl, 0, H, K, out, part_m, part_l, nsplit);
    return;
  }
  tl.row = tile_row[tl.t];
  tl.qpos0 = tile_qpos0[tl.t];
  tl.pad = pads[tl.row];
  tl.window = window;
  // the tile's band (64-bit: window may be near INT_MAX), and this split
  // of its DecodeTile tiles, clipped to it (split_decode::attend's cut)
  const long long w0 = max((long long)tl.pad, (long long)tl.qpos0 - window + 1);
  tl.first = (int)max(w0, 0LL);
  tl.last = min(tl.qpos0 + tl.qlen, MB * BS) - 1;
  const int* table = tables + (size_t)tl.row * MB;

  if (tl.qlen == 1) {
    using namespace split_decode;
    __shared__ int s_table[kTableCap];
    float qr[kGC][kEPL];
    load_q<T, D>(q, tl.t * kQTile, H, tl.hd, qr);
    PagedSlots src{table, s_table, (size_t)tl.hd.kh, BS, shift, K, 0};
    const Dest dst{(size_t)tl.t * kQTile * K + tl.hd.kh, (size_t)tl.t * K + tl.hd.kh,
                   kQTile * tl.hd.G};
    attend<T, INT8, D>(src, qr, tl.hd, dst, tl.first, tl.last, kp, vp, ks, vs, out, part_acc,
                       part_m, part_l, nsplit, scale, softcap);
    empty_lanes<T, D>(tl, 1, H, K, out, part_m, part_l, nsplit);
    return;
  }

  constexpr int BKV = split_decode::DecodeTile<D>::BS;
  tl.lo = tl.hi = 0;
  if (tl.last >= tl.first) {
    const int t0 = tl.first / BKV, n = tl.last / BKV - t0 + 1;
    tl.lo = max((t0 + (int)((long long)blockIdx.z * n / nsplit)) * BKV, tl.first);
    tl.hi = min((t0 + (int)((long long)(blockIdx.z + 1) * n / nsplit)) * BKV, tl.last + 1);
  }
  if constexpr (std::is_same_v<T, float>) {
    __shared__ int s_lo[kQTile], s_hi[kQTile];
    if (threadIdx.x < kQTile) {
      const int i = threadIdx.x, slot = tl.qpos0 + i;
      const long long lo = max((long long)tl.pad, (long long)slot - window + 1);
      s_lo[i] = i < tl.qlen ? (int)max(lo, 0LL) : 1;
      s_hi[i] = i < tl.qlen ? slot : 0;
    }
    __syncthreads();
    const int G = tl.hd.G, gn = tl.hd.gn, h0 = tl.hd.kh * G + tl.hd.g0;
    const size_t q0 = ((size_t)tl.t * kQTile * H + h0) * D;
    const size_t part = ((size_t)tl.t * K + tl.hd.kh) * nsplit + blockIdx.z;
    const bool direct = out != nullptr;
    paged::attend<T, INT8, D>(
        q + q0, direct ? out + q0 : nullptr, (size_t)H * D, kp, vp, ks, vs, table, BS, K,
        tl.hd.kh, gn, kQTile, s_lo, s_hi, tl.lo, max(tl.hi, tl.lo), scale, softcap,
        direct ? nullptr : part_acc + part * kQTile * G * D,
        direct ? nullptr : part_m + part * kQTile * G,
        direct ? nullptr : part_l + part * kQTile * G, G, tl.hd.g0);
  } else if (tl.hd.gn <= 2) {
    prefill_mma<INT8, D, 1>(tl, q, kp, vp, ks, vs, table, out, part_acc, part_m, part_l, BS,
                            shift, H, K, nsplit, scale, softcap);
  } else {
    prefill_mma<INT8, D, 2>(tl, q, kp, vp, ks, vs, table, out, part_acc, part_m, part_l, BS,
                            shift, H, K, nsplit, scale, softcap);
  }
}

// out == nullptr: the partials only (no combine).
template <typename T, bool INT8, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* tables, const int* tile_row,
                   const int* tile_qpos0, const int* tile_qlen, const int* pads, void* out,
                   float* acc, float* m, float* l, int NT, int MB, int BS, int H, int K,
                   int window, int nsplit, float scale, float softcap, cudaStream_t stream,
                   int* launched) {
  const int G = H / K;
  if (BS < 1 || nsplit < 1 || nsplit > 65535 || NT > 65535) return cudaErrorInvalidValue;
  const bool direct = out != nullptr && nsplit == 1;
  if (!direct && (acc == nullptr || m == nullptr || l == nullptr)) return cudaErrorInvalidValue;
  const int shift = (BS & (BS - 1)) == 0 ? __builtin_ctz(BS) : -1;
  const int blocks_x = K * ((G + split_decode::kGC - 1) / split_decode::kGC);
  const size_t smem = smem_bytes<T, INT8, D>();
  // the cap covers the static __shared__ variables too (the staged table,
  // the decode loop's maxima and sums, the float32 tiles' bands: under 3 KB)
  static size_t configured = 0;
  cudaError_t e = ensure_smem(ragged_kernel<T, INT8, D>, smem + 3072, &configured);
  if (e != cudaSuccess) return e;
  ragged_kernel<T, INT8, D><<<dim3(blocks_x, NT, nsplit), kThreads, smem, stream>>>(
      (const T*)q, kp, vp, ks, vs, tables, tile_row, tile_qpos0, tile_qlen, pads,
      direct ? (T*)out : nullptr, acc, m, l, MB, BS, shift, H, K, window, nsplit, scale,
      softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  *launched = 1;
  if (direct || out == nullptr) return e;
  e = split_kv::combine<T>(acc, m, l, (T*)out, NT * K, nsplit, kQTile * G, D, stream, K, G);
  if (e == cudaSuccess) *launched = 2;
  return e;
}

template <typename T, bool INT8>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp, const float* ks,
                     const float* vs, const int* tables, const int* tile_row,
                     const int* tile_qpos0, const int* tile_qlen, const int* pads, void* out,
                     float* acc, float* m, float* l, int NT, int MB, int BS, int H, int K,
                     int window, int nsplit, float scale, float softcap, cudaStream_t st,
                     int* launched) {
  switch (D) {
    case 64:
      return launch<T, INT8, 64>(q, kp, vp, ks, vs, tables, tile_row, tile_qpos0, tile_qlen,
                                 pads, out, acc, m, l, NT, MB, BS, H, K, window, nsplit, scale,
                                 softcap, st, launched);
    case 128:
      return launch<T, INT8, 128>(q, kp, vp, ks, vs, tables, tile_row, tile_qpos0, tile_qlen,
                                  pads, out, acc, m, l, NT, MB, BS, H, K, window, nsplit, scale,
                                  softcap, st, launched);
    case 256:
      return launch<T, INT8, 256>(q, kp, vp, ks, vs, tables, tile_row, tile_qpos0, tile_qlen,
                                  pads, out, acc, m, l, NT, MB, BS, H, K, window, nsplit, scale,
                                  softcap, st, launched);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [T,H,D] (dtype, T = NT * 8), k/v pages [NB,BS,K,D] (dtype, or int8
// with scale pages [NB,BS,K] float32; 16-byte aligned), tables [R,MB]
// int32, tile_row / tile_qpos0 / tile_qlen [NT] int32, pads [R] int32,
// out [T,H,D] or null (then only the partials are written); part_acc
// [NT,K,NSPLIT,8*G,D], part_m / part_l [NT,K,NSPLIT,8*G] float32 scratch
// (unused when NSPLIT == 1 and out is set); all contiguous.  window: this
// layer's sliding window (1 << 30 = global).  Launches the kernel and,
// when NSPLIT > 1 and out is set, the combine; *launched reports how many
// of the two it launched.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* tables, const void* tile_row, const void* tile_qpos0,
    const void* tile_qlen, const void* pads, void* out, void* part_acc, void* part_m,
    void* part_l, int NT, int MB, int BS, int H, int K, int D, int window, int nsplit,
    float scale, float softcap, int dtype, int int8_pages, void* stream, int* launched) {
  *launched = 0;
  if (NT <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int* tb = (const int*)tables;
  const int* tr = (const int*)tile_row;
  const int* tp = (const int*)tile_qpos0;
  const int* tl = (const int*)tile_qlen;
  const int* pd = (const int*)pads;
  float* acc = (float*)part_acc;
  float* m = (float*)part_m;
  float* l = (float*)part_l;
  if (dtype == 0 && !int8_pages)
    return launch_d<float, false>(D, q, k_pages, v_pages, ks, vs, tb, tr, tp, tl, pd, out, acc,
                                  m, l, NT, MB, BS, H, K, window, nsplit, scale, softcap, st,
                                  launched);
  if (dtype == 0 && int8_pages)
    return launch_d<float, true>(D, q, k_pages, v_pages, ks, vs, tb, tr, tp, tl, pd, out, acc,
                                 m, l, NT, MB, BS, H, K, window, nsplit, scale, softcap, st,
                                 launched);
  if (dtype == 1 && !int8_pages)
    return launch_d<__nv_bfloat16, false>(D, q, k_pages, v_pages, ks, vs, tb, tr, tp, tl, pd,
                                          out, acc, m, l, NT, MB, BS, H, K, window, nsplit,
                                          scale, softcap, st, launched);
  if (dtype == 1 && int8_pages)
    return launch_d<__nv_bfloat16, true>(D, q, k_pages, v_pages, ks, vs, tb, tr, tp, tl, pd,
                                         out, acc, m, l, NT, MB, BS, H, K, window, nsplit,
                                         scale, softcap, st, launched);
  return cudaErrorInvalidValue;
}
