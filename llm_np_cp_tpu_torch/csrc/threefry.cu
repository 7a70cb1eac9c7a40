// threefry2x32 draws: jax.random's default generator, bit for bit.
//
// Replaces no pl.pallas_call: the JAX package draws with jax.random,
// which XLA lowers to a fused threefry2x32 loop (jax/_src/prng.py,
// _threefry2x32_lowering) inside each jitted step.  Added so that every
// sampled path of the port draws the JAX package's own stream and the
// draw is a function of device operands (a captured step can take it).
//
// In jax's partitionable mode element i of a draw over a shape hashes the
// 64-bit counter i, split into (hi, lo) words, under the key (k0, k1);
// a 32-bit word is bits1 ^ bits2.  A uniform takes its top 23 bits as the
// mantissa of a float in [1, 2), minus 1, then `* (max - min) + min` (one
// FMA, as XLA fuses it) and `max(min, .)`; a gumbel is
// -log(-log(uniform(tiny, 1))).
//
// - threefry2x32_kernel: elementwise, one thread a counter (grid-stride).
//   Writes the word pair (keys: split, fold_in), the xor word, or a
//   uniform.
// - categorical: the Gumbel-max draw over float32 logits [N, V].  Pass 1
//   gives each block a chunk of kChunk columns of one row (grid [chunks,
//   N]), so 8 rows of 128256 fill 504 blocks, not 8; each thread hashes,
//   draws and adds its columns, keeping its best (value, index), and the
//   block reduces them.  Pass 2 reduces each row's chunks, one warp a row.
//   Ties go to the lower index (jnp.argmax), NaN above all.
//
// What bounds it on the H100: integer issue.  An element costs 20 rounds
// of (add, rotate, xor), 5 key injections of two adds, the counter and
// the word's xor, shift and or: ~77 int32 operations, on 64 INT32 lanes an
// SM, against 4 bytes of logits read; two logf run beside them on the
// float pipe.  What the design does about it: the key schedule is made
// once a thread, rotations are funnel shifts by constants (fully
// unrolled), and the logits are read once, coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435e-38f;  // float32's smallest normal
constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // ops/cuda/threefry.py's CATEGORICAL_CHUNK

enum Mode { kPair = 0, kBits = 1, kUniform = 2 };

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);  // rotate left by r
  x1 ^= x0;
}

template <int ODD>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  if constexpr (ODD) {
    mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  } else {
    mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  }
}

struct Key {
  uint32_t k0, k1, k2;
  __device__ __forceinline__ Key(uint32_t a, uint32_t b) : k0(a), k1(b), k2(a ^ b ^ kParity) {}
};

// threefry2x32 of the counter words (x0, x1) in place: jax's unrolled lowering
__device__ __forceinline__ void hash(const Key& k, uint32_t& x0, uint32_t& x1) {
  x0 += k.k0; x1 += k.k1;
  four_rounds<0>(x0, x1); x0 += k.k1; x1 += k.k2 + 1u;
  four_rounds<1>(x0, x1); x0 += k.k2; x1 += k.k0 + 2u;
  four_rounds<0>(x0, x1); x0 += k.k0; x1 += k.k1 + 3u;
  four_rounds<1>(x0, x1); x0 += k.k1; x1 += k.k2 + 4u;
  four_rounds<0>(x0, x1); x0 += k.k2; x1 += k.k0 + 5u;
}

// f * scale + lo rounded once, as XLA's fused multiply-add
__device__ __forceinline__ float uniform_from_bits(uint32_t bits, float lo, float scale) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(lo, __fmaf_rn(f, scale, lo));
}

__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  return -logf(-logf(uniform_from_bits(bits, kTiny, 1.0f)));
}

__device__ __forceinline__ Key load_key(const int* keys, long long row) {
  return Key((uint32_t)keys[2 * row], (uint32_t)keys[2 * row + 1]);
}

__global__ void __launch_bounds__(kThreads)
threefry2x32_kernel(const int* __restrict__ keys, int per_row, const int* __restrict__ data,
                    void* __restrict__ out, long long n, int cols, int mode, float lo,
                    float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < n; m += stride) {
    const long long row = m / cols;
    const Key k = load_key(keys, per_row ? row : 0);
    const uint64_t c = data ? (uint64_t)(uint32_t)data[m]
                            : (uint64_t)(per_row ? m - row * cols : m);
    uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
    hash(k, x0, x1);
    if (mode == kPair) {
      ((int2*)out)[m] = make_int2((int)x0, (int)x1);
    } else if (mode == kBits) {
      ((uint32_t*)out)[m] = x0 ^ x1;
    } else {
      ((float*)out)[m] = uniform_from_bits(x0 ^ x1, lo, scale);
    }
  }
}

// (a, ia) beats (b, ib): larger, NaN above everything, the lower index
// among equals
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(v2, i2, v, i)) { v = v2; i = i2; }
  }
}

__global__ void __launch_bounds__(kThreads)
categorical_chunks(const int* __restrict__ keys, int per_row, const float* __restrict__ logits,
                   float* __restrict__ part_val, int* __restrict__ part_idx, int V, int splits,
                   long long row0) {
  const int n = blockIdx.y, s = blockIdx.x;
  const Key k = load_key(keys, per_row ? n : 0);
  // one key: row n of these logits is row row0 + n of the whole draw
  const uint64_t base = per_row ? 0ull : (uint64_t)(row0 + n) * (uint64_t)V;
  const float* row = logits + (size_t)n * V;
  const int end = min(V, (s + 1) * kChunk);
  float best = -INFINITY;
  int bi = INT32_MAX;
  for (int v = s * kChunk + threadIdx.x; v < end; v += kThreads) {
    const uint64_t c = base + (uint64_t)v;
    uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
    hash(k, x0, x1);
    const float val = gumbel_from_bits(x0 ^ x1) + row[v];
    if (better(val, v, best, bi)) { best = val; bi = v; }
  }
  warp_best(best, bi);
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { sv[warp] = best; si[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? sv[lane] : -INFINITY;
    bi = lane < kThreads / 32 ? si[lane] : INT32_MAX;
    warp_best(best, bi);
    if (lane == 0) {
      part_val[(size_t)n * splits + s] = best;
      part_idx[(size_t)n * splits + s] = bi;
    }
  }
}

__global__ void categorical_rows(const float* __restrict__ part_val,
                                 const int* __restrict__ part_idx, int* __restrict__ out,
                                 int splits) {
  const int n = blockIdx.x, lane = threadIdx.x;
  float best = -INFINITY;
  int bi = INT32_MAX;
  for (int s = lane; s < splits; s += 32) {
    const float v = part_val[(size_t)n * splits + s];
    const int i = part_idx[(size_t)n * splits + s];
    if (better(v, i, best, bi)) { best = v; bi = i; }
  }
  warp_best(best, bi);
  if (lane == 0) out[n] = bi;
}

}  // namespace

extern "C" int threefry2x32_launch(const void* keys, int per_row, const void* data, void* out,
                                   long long n, int cols, int mode, float lo, float scale,
                                   void* stream) {
  if (n <= 0) return cudaSuccess;
  if (cols <= 0 || mode < kPair || mode > kUniform) return cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  threefry2x32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, per_row, (const int*)data, out, n, cols, mode, lo, scale);
  return cudaGetLastError();
}

extern "C" int categorical_launch(const void* keys, int per_row, const void* logits,
                                  void* part_val, void* part_idx, void* out, int N, int V,
                                  int splits, long long row0, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (V <= 0 || splits != (V + kChunk - 1) / kChunk || N > 65535 || row0 < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  categorical_chunks<<<dim3(splits, N), kThreads, 0, st>>>(
      (const int*)keys, per_row, (const float*)logits, (float*)part_val, (int*)part_idx, V,
      splits, row0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  categorical_rows<<<N, 32, 0, st>>>((const float*)part_val, (const int*)part_idx, (int*)out,
                                     splits);
  return cudaGetLastError();
}
