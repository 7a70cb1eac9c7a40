// Softmax over the last axis: max-subtracted, float32 inside, the output
// in the input type.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/softmax.py: softmax
// (_softmax_kernel), which holds 8 whole rows in VMEM per grid step.
//
// What bounds it on the H100: bytes (each element read once, written
// once; a few operations per element).  What the design does about it:
// every row is read from memory once, held in registers between the
// reductions and the write, with 16-byte loads and stores, and enough
// blocks are in flight to fill the card.
//
// - Short rows (at most kShortVecs 16-byte vectors: 2048 bf16, 1024
//   float32 elements): L lanes of a warp own a row (L = the row's vectors
//   rounded up to a power of two, at most 32), each lane V vectors of it,
//   so a [16384, 128] bf16 batch is a half-warp a row, one vector a lane.
//   The row max and the sum of exp reduce over the L lanes by shuffles.
// - Long rows (vocab rows): a row is split over a thread-block cluster of
//   C blocks (C from the row count against the SM count, at most
//   kMaxCluster = 8, the portable size).  Each block holds its chunk in registers, reduces its
//   threads' running (max, sum) pairs, and the C blocks merge their pairs
//   through distributed shared memory; each then writes its chunk.  So 8
//   rows of 128256 fill 64 SMs, not 8.
// - A row too long for its cluster's registers (more than kClusterThreads
//   x 8 vectors a block) takes the two-read stream inside the same
//   kernel: an online (max, sum) pass over the chunk, the same cluster
//   merge, and a second read that writes.
//
// exp(x - max) is exp2f((x - max) * log2(e)): subtracting first keeps the
// float32 output within 1e-6 of the plain version (folding log2(e) into
// one FMA, x * log2e - max * log2e, rounds the product max * log2e and
// moves an output near 1 by up to ~7e-7 at |max| ~ 15).  A fully -inf row
// gives NaN, as the plain version and jax.nn.softmax do.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kShortThreads = 256;
constexpr int kShortVecs = 256;     // a short row: at most 32 lanes x 8 vectors
constexpr int kClusterThreads = 512;
constexpr int kMaxCluster = 8;      // blocks a row: the portable cluster size
constexpr int kMaxVecs = 8;         // vectors a thread holds in registers

__device__ __forceinline__ float exp_shifted(float x, float m) {
  return exp2f((x - m) * tc::kLog2e);
}

// combine two running (m, s) pairs into (m, s): s is the sum of exp(x - m)
__device__ __forceinline__ void online_merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * exp_shifted(m, mm)) +
      (m2 == -INFINITY ? 0.f : s2 * exp_shifted(m2, mm));
  m = mm;
}

// fold value x into the running (m, s)
__device__ __forceinline__ void online_add(float x, float& m, float& s) {
  if (x > m) {
    s = s * exp_shifted(m, x) + 1.f;  // m == -inf: s is 0 and stays 0 * 0
    m = x;
  } else if (m != -INFINITY) {
    s += exp_shifted(x, m);
  }
}

template <int WIDTH>
__device__ __forceinline__ void group_merge(float& m, float& s) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    online_merge(m, s, m2, s2);
  }
}

// E elements of T in one 16-byte vector
template <typename T> struct Vec { static constexpr int E = 16 / (int)sizeof(T); };

// elements [i, i + E) of row r into f (-inf past n); a vector load when
// `vec` (n a multiple of E and the row 16-byte aligned), else scalars
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ r, int i, int n, bool vec,
                                         float* f) {
  constexpr int E = Vec<T>::E;
  if (vec && i < n) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(r + i));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (E == 8) {  // bf16: the high 16 bits of a float32
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[2 * e] = __uint_as_float(w[e] << 16);
        f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(w[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = i + e < n ? to_f32(r[i + e]) : -INFINITY;
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ r, int i, int n, bool vec,
                                          const float* f) {
  constexpr int E = Vec<T>::E;
  if (vec) {
    if (i >= n) return;
    uint4 u;
    if constexpr (E == 8) {
      u.x = tc::pack_bf16(f[0], f[1]); u.y = tc::pack_bf16(f[2], f[3]);
      u.z = tc::pack_bf16(f[4], f[5]); u.w = tc::pack_bf16(f[6], f[7]);
    } else {
      u = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                     __float_as_uint(f[3]));
    }
    *reinterpret_cast<uint4*>(r + i) = u;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (i + e < n) r[i + e] = from_f32<T>(f[e]);
  }
}

// ----------------------------------------------------------------------
// short rows: L lanes a row, V vectors a lane
// ----------------------------------------------------------------------

template <typename T, int L, int V>
__global__ void __launch_bounds__(kShortThreads)
softmax_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int n, int vec) {
  constexpr int E = Vec<T>::E;
  const int lane = threadIdx.x % L;
  const long long row = (long long)blockIdx.x * (kShortThreads / L) + threadIdx.x / L;
  // a lane group past the last row still takes part in the shuffles
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * (long long)n;
  float v[V][E];
#pragma unroll
  for (int j = 0; j < V; ++j) load_vec(xr, (j * L + lane) * E, live ? n : 0, vec, v[j]);
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) m = fmaxf(m, v[j][e]);
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[j][e] = exp_shifted(v[j][e], m);  // padding: exp(-inf) = 0; a -inf row: NaN
      s += v[j][e];
    }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (!live) return;
  const float inv = 1.f / s;
  T* orow = out + row * (long long)n;
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[j][e] *= inv;
    store_vec(orow, (j * L + lane) * E, n, vec, v[j]);
  }
}

// ----------------------------------------------------------------------
// long rows: a cluster of C blocks a row
// ----------------------------------------------------------------------

// merge the block's threads' (m, s) pairs, then the cluster's blocks'
// pairs through distributed shared memory; every thread gets the row's
__device__ __forceinline__ void cluster_merge(float& m, float& s,
                                              const cg::cluster_group& cluster) {
  __shared__ float sM[kClusterThreads / 32], sS[kClusterThreads / 32];
  __shared__ float2 sBlock;  // this block's pair, read by the cluster's blocks
  __shared__ float2 sRow;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  group_merge<32>(m, s);
  if (lane == 0) { sM[warp] = m; sS[warp] = s; }
  __syncthreads();
  if (warp == 0) {
    m = lane < kClusterThreads / 32 ? sM[lane] : -INFINITY;
    s = lane < kClusterThreads / 32 ? sS[lane] : 0.f;
    group_merge<32>(m, s);
    if (lane == 0) sBlock = make_float2(m, s);
  }
  cluster.sync();  // every block's pair is in place
  if (warp == 0) {
    const int nb = (int)cluster.num_blocks();
    float2 p = make_float2(-INFINITY, 0.f);
    if (lane < nb) p = *cluster.map_shared_rank(&sBlock, lane);
    m = p.x;
    s = p.y;
    group_merge<32>(m, s);
    if (lane == 0) sRow = make_float2(m, s);
  }
  cluster.sync();  // the pairs are read before any block moves on or exits
  m = sRow.x;
  s = sRow.y;
}

// grid (C, row blocks), cluster (C, 1, 1): block `rank` of a row owns its
// elements [rank * chunk, (rank + 1) * chunk), chunk a multiple of E
template <typename T, int V>
__global__ void __launch_bounds__(kClusterThreads)
softmax_cluster_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int n, int chunk,
                       int vec) {
  constexpr int E = Vec<T>::E;
  const cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int c0 = (int)cluster.block_rank() * chunk;
  const int c1 = min(n, c0 + chunk);
  const bool resident = chunk <= kClusterThreads * V * E;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* xr = x + row * n;
    T* orow = out + row * n;
    float m = -INFINITY, s = 0.f;
    if (resident) {
      float v[V][E];
#pragma unroll
      for (int j = 0; j < V; ++j)
        load_vec(xr, c0 + (j * kClusterThreads + tid) * E, c1, vec, v[j]);
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) m = fmaxf(m, v[j][e]);
      if (m != -INFINITY) {
#pragma unroll
        for (int j = 0; j < V; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) s += exp_shifted(v[j][e], m);
      }
      cluster_merge(m, s, cluster);
      const float inv = 1.f / s;
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) v[j][e] = exp_shifted(v[j][e], m) * inv;
        store_vec(orow, c0 + (j * kClusterThreads + tid) * E, c1, vec, v[j]);
      }
    } else {  // the two-read stream
      float f[E];
      for (int i = c0 + tid * E; i < c1; i += kClusterThreads * E) {
        load_vec(xr, i, c1, vec, f);
#pragma unroll
        for (int e = 0; e < E; ++e) online_add(f[e], m, s);
      }
      cluster_merge(m, s, cluster);
      const float inv = 1.f / s;
      for (int i = c0 + tid * E; i < c1; i += kClusterThreads * E) {
        load_vec(xr, i, c1, vec, f);
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = exp_shifted(f[e], m) * inv;
        store_vec(orow, i, c1, vec, f);
      }
    }
  }
}

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename T, int L, int V>
cudaError_t launch_rows(const void* x, void* out, int rows, int n, int vec, cudaStream_t st) {
  const int per_block = kShortThreads / L;
  const long long blocks = ((long long)rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  softmax_rows_kernel<T, L, V><<<(unsigned)blocks, kShortThreads, 0, st>>>(
      (const T*)x, (T*)out, rows, n, vec);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_rows_v(int V, const void* x, void* out, int rows, int n, int vec,
                          cudaStream_t st) {
  switch (V) {
    case 1: return launch_rows<T, L, 1>(x, out, rows, n, vec, st);
    case 2: return launch_rows<T, L, 2>(x, out, rows, n, vec, st);
    case 4: return launch_rows<T, L, 4>(x, out, rows, n, vec, st);
    default: return launch_rows<T, L, 8>(x, out, rows, n, vec, st);
  }
}

template <typename T, int V>
cudaError_t launch_cluster(const void* x, void* out, int rows, int n, int chunk, int vec, int C,
                           cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, std::min(rows, 65535));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, softmax_cluster_kernel<T, V>, (const T*)x, (T*)out,
                                     rows, n, chunk, vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* out, int rows, int n, cudaStream_t st) {
  constexpr int E = Vec<T>::E;
  const int vec = n % E == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int nv = (n + E - 1) / E;  // vectors a row
  if (nv <= kShortVecs) {
    const int L = std::min(32, pow2_ceil(nv));
    const int V = pow2_ceil((nv + L - 1) / L);
    switch (L) {
      case 1: return launch_rows_v<T, 1>(V, x, out, rows, n, vec, st);
      case 2: return launch_rows_v<T, 2>(V, x, out, rows, n, vec, st);
      case 4: return launch_rows_v<T, 4>(V, x, out, rows, n, vec, st);
      case 8: return launch_rows_v<T, 8>(V, x, out, rows, n, vec, st);
      case 16: return launch_rows_v<T, 16>(V, x, out, rows, n, vec, st);
      default: return launch_rows_v<T, 32>(V, x, out, rows, n, vec, st);
    }
  }
  // the cluster: enough blocks to fill the card, each at least a vector a thread
  const int fill = pow2_ceil((sm_count() + rows - 1) / rows);
  int C = std::min(kMaxCluster, fill);
  while (C > 1 && (nv + C - 1) / C < kClusterThreads) C >>= 1;
  const int chunk = ((nv + C - 1) / C) * E;
  const int per_thread = (chunk / E + kClusterThreads - 1) / kClusterThreads;
  switch (per_thread <= kMaxVecs ? pow2_ceil(per_thread) : kMaxVecs) {
    case 1: return launch_cluster<T, 1>(x, out, rows, n, chunk, vec, C, st);
    case 2: return launch_cluster<T, 2>(x, out, rows, n, chunk, vec, C, st);
    case 4: return launch_cluster<T, 4>(x, out, rows, n, chunk, vec, C, st);
    default: return launch_cluster<T, 8>(x, out, rows, n, chunk, vec, C, st);
  }
}

}  // namespace

// x, out [rows, n] contiguous, of `dtype`; softmax over n.
extern "C" int softmax_launch(const void* x, void* out, int rows, int n, int dtype,
                              void* stream) {
  if (rows <= 0 || n <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, out, rows, n, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, rows, n, st);
  return cudaErrorInvalidValue;
}
