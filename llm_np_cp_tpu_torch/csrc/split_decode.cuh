// Split-KV one-token GQA decode attention: the kv loop shared by the slab
// kernel (decode_attention.cu) and the paged kernel
// (paged_decode_attention.cu).
//
// What bounds both on the H100: bytes.  A step reads every visible K/V
// slot once (2*K*D elements per slot) for 4*H*D FLOPs per slot — about
// G FLOPs per byte (G = 4 query heads per kv head), far below the card's
// ridge of ~295.  The tensor cores (wgmma) and TMA are not the tool: with
// G query rows there is no 64-row tile to feed, and the limit is how many
// bytes are in flight, not arithmetic.  What the design does about it:
//
// - Split-KV.  The TPU kernels walk a row's kv blocks in order on one
//   core.  Here the grid is (K * ceil(G/4), B, NSPLIT): the kernel hands
//   `attend` its row's visible band [first, last]; the block takes the
//   n = last/BS - first/BS + 1 tiles (DecodeTile) of that band and
//   attends the split's contiguous 1/NSPLIT of them.  The ranges follow
//   the row's own band, so a short fill in a long cache still spreads
//   over every split.  Each split writes float32 partials (acc, m, l),
//   and split_kv.cuh's combine merges them (the TPU kernels' _finalize);
//   with NSPLIT == 1 the block writes the output itself.
// - No shared-memory tiles and no barrier in the kv loop.  CPR = D/8
//   consecutive lanes own one slot's head row, 8 elements each (16 bytes
//   of bf16, two 16-byte copies of float32, 8 bytes of int8: one layout
//   for every type), so the block streams 256/CPR slots at a time.  Each
//   lane copies its own K/V elements of its next kStages-1 slots with
//   cp.async into its own entries of a shared-memory ring and reads back
//   only those: the bytes in flight cost no registers and need no
//   barrier.  A lane keeps its 8 elements of the block's (up to) 4 query
//   heads in registers; a score is 8 FMAs and a butterfly over the CPR
//   lanes.  Each lane group runs its own online softmax (running max m,
//   sum l, acc of p rounded to the storage type times V) over the slots
//   it sees, and the groups merge at the end, by shuffles inside a warp
//   and through shared memory across warps — the same merge as the
//   combine.
// - Each K/V element is read once per (row, kv head, 4 query heads): the
//   G query heads of a kv head share every load (G > 4 takes ceil(G/4)
//   blocks).  An int8 cache streams 1-byte values plus float32 scales,
//   dequantised as JAX does, round_to<T>(q * round_to<T>(scale)).
//
// Where a slot lives is the kernel's business, through a slot source:
//   int stage(int c0, int hi)  block-uniform: make slots [c0, c1) ready
//                              and return c1 (c0 < c1 <= hi); it may
//                              __syncthreads (every thread calls it)
//   size_t row0                the block's fixed row, added once to the
//                              K/V and scale pointers
//   size_t row(int s)          slot s's (kv head) row past row0: its
//                              element offset / D in K/V, its index in
//                              the scales
//   bool visible(int s)        whether s is visible (inside the band)
//
// Invisible slots never enter (no exp of NEG_INF - NEG_INF); a row or
// split with nothing visible has l = 0 and writes zeros.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace split_decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGC = 4;       // query heads per block
constexpr int kEPL = 8;      // elements of a head row per lane
constexpr int kStages = 4;   // ring depth: a lane's slots in flight + the one it reads

// Tile of the split plan (slots): the kv band is cut into NSPLIT ranges
// of whole tiles, as split_plan and the plain version count them.
template <int D> struct DecodeTile { static constexpr int BS = 64; };
template <> struct DecodeTile<256> { static constexpr int BS = 32; };

// One lane's 8 elements of a head row: one 16-byte chunk of bf16, two of
// float32, one 8-byte chunk of int8.
template <typename T, bool INT8>
struct Lane8 {
  using Chunk = std::conditional_t<INT8, uint2, uint4>;
  static constexpr int NCH = (INT8 ? kEPL : (int)sizeof(T) * kEPL) / (int)sizeof(Chunk);
  static constexpr int WORDS = NCH * (int)sizeof(Chunk) / 4;
  uint32_t w[WORDS];

  // this lane's chunks in the ring: chunk c at ring[c * kThreads]
  __device__ __forceinline__ void read(const Chunk* ring) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const Chunk t = ring[c * kThreads];
      if constexpr (INT8) {
        w[2 * c] = t.x; w[2 * c + 1] = t.y;
      } else {
        w[4 * c] = t.x; w[4 * c + 1] = t.y; w[4 * c + 2] = t.z; w[4 * c + 3] = t.w;
      }
    }
  }

  // to float; an int8 value times its slot's scale, both rounded to T
  __device__ __forceinline__ void unpack(float sc, float* f) const {
    if constexpr (INT8) {
      const float s = round_to<T>(sc);
#pragma unroll
      for (int e = 0; e < kEPL; ++e)
        f[e] = round_to<T>((float)(int8_t)(w[e / 4] >> (8 * (e % 4))) * s);
    } else if constexpr (std::is_same_v<T, float>) {
#pragma unroll
      for (int e = 0; e < kEPL; ++e) f[e] = __uint_as_float(w[e]);
    } else {  // bf16: the high 16 bits of a float32
#pragma unroll
      for (int e = 0; e < kEPL / 2; ++e) {
        f[2 * e] = __uint_as_float(w[e] << 16);
        f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  }
};

// cp.async of one chunk (16 bytes bypass L1, 8 bytes through it), the
// group commit, and the wait for all but the newest N groups
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem),
                 "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Merge softmax state (m, l, acc) with another's: the larger max wins,
// each side scaled by exp(its max - the larger); a side with l == 0 (it
// saw nothing) has weight 0.
__device__ __forceinline__ void merge_state(float& m, float& l, float* acc, float mo, float lo,
                                            const float* ao) {
  const float mx = fmaxf(m, mo);
  const float w = l > 0.f ? expf(m - mx) : 0.f;
  const float wo = lo > 0.f ? expf(mo - mx) : 0.f;
  l = l * w + lo * wo;
#pragma unroll
  for (int e = 0; e < kEPL; ++e) acc[e] = acc[e] * w + ao[e] * wo;
  m = mx;
}

// Dynamic shared memory of one block: the ring, [kStages][K, V][NCH]
// [kThreads] chunks, then the warps' merged acc, [kWarps][kGC][D] floats.
template <typename T, bool INT8, int D>
constexpr size_t smem_bytes() {
  return (size_t)kStages * 2 * kThreads * (INT8 ? kEPL : sizeof(T) * kEPL) +
         sizeof(float) * kWarps * kGC * D;
}

// This block's query heads: kv head kh, its heads [g0, g0 + gn) of G.
struct Heads {
  int kh, g0, gn, G;
};

__device__ __forceinline__ Heads block_heads(int H, int K) {
  const int G = H / K, nch = (G + kGC - 1) / kGC;
  const int g0 = (int)(blockIdx.x % nch) * kGC;
  return Heads{(int)blockIdx.x / nch, g0, min(kGC, G - g0), G};
}

// This lane's 8 elements of each query head of row b (zeros past the G
// heads); q is [B, H, D].
template <typename T, int D>
__device__ __forceinline__ void load_q(const T* __restrict__ q, int b, int H, const Heads& hd,
                                       float (&qr)[kGC][kEPL]) {
  const int j = threadIdx.x % (D / kEPL);
  const T* qb = q + ((size_t)b * H + hd.kh * hd.G + hd.g0) * D + j * kEPL;
#pragma unroll
  for (int g = 0; g < kGC; ++g)
#pragma unroll
    for (int e = 0; e < kEPL; ++e) qr[g][e] = g < hd.gn ? to_f32(qb[g * D + e]) : 0.f;
}

// Where a block's results go: the normalised output of head g0 + g at
// out + (out_row * G + g0 + g) * D, or the split's partials at part =
// part_row * NSPLIT + split, `prow` rows a part (G; the ragged kernel's
// tiles 8 * G), this block's at rows g0 + g.
struct Dest {
  size_t out_row, part_row;
  int prow;
};

// The slab and paged kernels' destination: row b's [G, D] of [B, H, D],
// its partials at [b*K + kh, split].
__device__ __forceinline__ Dest row_dest(int b, int K, const Heads& hd) {
  const size_t r = (size_t)b * K + hd.kh;
  return Dest{r, r, hd.G};
}

// Attend the band [first, last] (last < first: nothing visible), this
// block's split of it.  out != nullptr: NSPLIT == 1, write the normalised
// output; else this split's partials (``Dest``).
template <typename T, bool INT8, int D, typename Src>
__device__ __forceinline__ void attend(Src& src, const float (&qr)[kGC][kEPL], const Heads& hd,
                                       const Dest& dst, int first, int last,
                                       const void* __restrict__ k,
                                       const void* __restrict__ v,
                                       const float* __restrict__ ks,
                                       const float* __restrict__ vs, T* __restrict__ out,
                                       float* __restrict__ part_acc, float* __restrict__ part_m,
                                       float* __restrict__ part_l, int nsplit, float scale,
                                       float softcap) {
  using E = std::conditional_t<INT8, int8_t, T>;
  constexpr int BS = DecodeTile<D>::BS;
  constexpr int CPR = D / kEPL;         // lanes per slot's head row: 8, 16 or 32
  constexpr int NG = kThreads / CPR;    // slots the block streams at a time
  __shared__ float sM[kWarps][kGC], sL[kWarps][kGC];

  const int split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j = tid % CPR, grp = tid / CPR;

  // this split's slots [lo, hi): its tiles of the band, clipped to the band
  int lo = 0, hi = 0;
  if (last >= first) {
    const int t0 = first / BS, n = last / BS - t0 + 1;
    lo = max((t0 + (int)((long long)split * n / nsplit)) * BS, first);
    hi = min((t0 + (int)((long long)(split + 1) * n / nsplit)) * BS, last + 1);
  }

  using L8 = Lane8<T, INT8>;
  using Chunk = typename L8::Chunk;
  constexpr int RS = 2 * L8::NCH * kThreads;  // chunks per ring stage
  extern __shared__ float4 decode_smem[];
  Chunk* ring = reinterpret_cast<Chunk*>(decode_smem) + tid;
  float* sAcc = reinterpret_cast<float*>(reinterpret_cast<Chunk*>(decode_smem) + kStages * RS);

  const char* kb = (const char*)((const E*)k + src.row0 * D + j * kEPL);
  const char* vb = (const char*)((const E*)v + src.row0 * D + j * kEPL);
  if constexpr (INT8) {
    ks += src.row0;
    vs += src.row0;
  }
  int vis[kStages];
  float ksr[kStages], vsr[kStages];
  int end = hi;  // the staged chunk's end
  // start the copy of `slot` into ring stage u (nothing past the chunk)
  auto start_copy = [&](int u, int slot) {
    vis[u] = 0;
    if (slot < end) {
      const size_t row = src.row(slot);
      const Chunk* gk = reinterpret_cast<const Chunk*>(kb + row * D * sizeof(E));
      const Chunk* gv = reinterpret_cast<const Chunk*>(vb + row * D * sizeof(E));
#pragma unroll
      for (int c = 0; c < L8::NCH; ++c) {
        cp_async<sizeof(Chunk)>(ring + u * RS + c * kThreads, gk + c);
        cp_async<sizeof(Chunk)>(ring + u * RS + (L8::NCH + c) * kThreads, gv + c);
      }
      vis[u] = src.visible(slot);
      if constexpr (INT8) {
        ksr[u] = __ldg(ks + row);
        vsr[u] = __ldg(vs + row);
      }
    }
    cp_async_commit();
  };

  float m[kGC], l[kGC], acc[kGC][kEPL];
#pragma unroll
  for (int g = 0; g < kGC; ++g) {
    m[g] = LLM_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEPL; ++e) acc[g][e] = 0.f;
  }

  // one slot of this lane group from ring stage u: scores by 8 FMAs + a
  // butterfly over the group's lanes (every lane runs it: the trip count
  // is the block's), then the online softmax update where it is visible
  auto attend_slot = [&](int u) {
    L8 kx;
    kx.read(ring + u * RS);
    float kf[kEPL], s[kGC];
    kx.unpack(INT8 ? ksr[u] : 0.f, kf);
#pragma unroll
    for (int g = 0; g < kGC; ++g) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < kEPL; ++e) a = fmaf(qr[g][e], kf[e], a);
      s[g] = a;
    }
#pragma unroll
    for (int off = CPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < kGC; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    if (!vis[u]) return;
    L8 vx;
    vx.read(ring + u * RS + L8::NCH * kThreads);
    float vf[kEPL];
    vx.unpack(INT8 ? vsr[u] : 0.f, vf);
#pragma unroll
    for (int g = 0; g < kGC; ++g) {
      const float sg = softcap_f(s[g] * scale, softcap);
      if (sg > m[g]) {
        const float alpha = expf(m[g] - sg);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < kEPL; ++e) acc[g][e] *= alpha;
        m[g] = sg;
      }
      const float p = expf(sg - m[g]);
      l[g] += p;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int e = 0; e < kEPL; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
    }
  };

  // chunk by chunk as the source stages them; in a chunk, step t reads
  // stage t % kStages, and the copy for step t + kStages - 1 is started
  // first, into the stage step t - 1 read
  for (int c0 = lo; c0 < hi; c0 = end) {
    end = src.stage(c0, hi);
    const int nsteps = (end - c0 + NG - 1) / NG;  // the same for every lane
#pragma unroll
    for (int u = 0; u < kStages - 1; ++u) start_copy(u, c0 + grp + u * NG);
    for (int step = 0; step < nsteps; step += kStages) {
#pragma unroll
      for (int u = 0; u < kStages; ++u) {
        if (step + u < nsteps) {
          start_copy((u + kStages - 1) % kStages, c0 + grp + (step + u + kStages - 1) * NG);
          cp_async_wait<kStages - 1>();
          attend_slot(u);
        }
      }
    }
    cp_async_wait<0>();
  }

  // merge the lane groups: inside a warp by shuffles (lanes CPR apart
  // hold the same elements), then the warps through shared memory
#pragma unroll
  for (int off = CPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kGC; ++g) {
      float ao[kEPL];
#pragma unroll
      for (int e = 0; e < kEPL; ++e) ao[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      merge_state(m[g], l[g], acc[g], mo, lo_, ao);
    }
  }
  if (lane < CPR) {
#pragma unroll
    for (int g = 0; g < kGC; ++g) {
#pragma unroll
      for (int e = 0; e < kEPL; ++e) sAcc[(warp * kGC + g) * D + j * kEPL + e] = acc[g][e];
      if (lane == 0) { sM[warp][g] = m[g]; sL[warp][g] = l[g]; }
    }
  }
  __syncthreads();

  const size_t part = dst.part_row * nsplit + split;
  for (int o = tid; o < hd.gn * D; o += kThreads) {
    const int g = o / D, d = o % D;
    float mx = LLM_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (sL[w][g] > 0.f) mx = fmaxf(mx, sM[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = sL[w][g];
      const float ww = lw > 0.f ? expf(sM[w][g] - mx) : 0.f;
      num = fmaf(ww, sAcc[(w * kGC + g) * D + d], num);
      den = fmaf(ww, lw, den);
    }
    const size_t row = (size_t)(hd.g0 + g) * D + d;  // within this (b, kh)'s G x D
    if (out != nullptr) {
      out[dst.out_row * hd.G * D + row] = from_f32<T>(den > 0.f ? num / den : 0.f);
    } else {
      part_acc[part * dst.prow * D + row] = num;
      if (d == 0) {
        part_m[part * dst.prow + hd.g0 + g] = mx;
        part_l[part * dst.prow + hd.g0 + g] = den;
      }
    }
  }
}

// The paged pool's slots (paged_decode_attention.cu, and the decode tiles
// of ragged_paged_attention.cu): one row's block table, staged into
// shared memory kTableCap entries at a time.
constexpr int kTableCap = 512;  // table entries staged at a time

struct PagedSlots {
  const int* table;               // the row's [MB] block ids
  int* s_table;                   // [kTableCap] staged entries
  size_t row0;                    // the kv head kh
  int BS, shift, K;               // shift = log2(BS), or -1
  int base;                       // the table index of s_table[0]

  __device__ __forceinline__ int block_of(int s) const { return shift >= 0 ? s >> shift : s / BS; }

  __device__ __forceinline__ int stage(int c0, int hi) {
    const int b0 = block_of(c0);
    const int c1 = min(hi, (b0 + kTableCap) * BS);
    const int nb = block_of(c1 - 1) - b0 + 1;
    __syncthreads();  // every reader of the previous chunk is done
    for (int i = threadIdx.x; i < nb; i += kThreads) s_table[i] = table[b0 + i];
    __syncthreads();
    base = b0;
    return c1;
  }

  __device__ __forceinline__ size_t row(int s) const {
    const int blk = block_of(s);
    return ((size_t)s_table[blk - base] * BS + (s - blk * BS)) * K;
  }

  __device__ __forceinline__ bool visible(int) const { return true; }
};

}  // namespace split_decode
