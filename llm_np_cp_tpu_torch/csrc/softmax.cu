// Softmax over the last axis: max-subtracted, float32 inside, the output
// in the input type.
//
// Replaces the TPU kernel llm_np_cp_tpu/ops/pallas/softmax.py: softmax
// (_softmax_kernel), which holds 8 whole rows in VMEM per grid step.
//
// What bounds it on the H100: bytes (each element read once, written
// once; a few operations per element).  What the design does about it:
// a row is never held in shared memory (a 128256-wide float32 row is
// 513 KB).  Pass 1 streams the row once with an online max and sum
// (each thread keeps its running max m and sum s of exp(x - m), rescaled
// when m grows), the threads' (m, s) pairs are combined, and pass 2
// reads the row again (from L2 at these sizes) and writes exp(x - m) / s.
// Short rows (n <= kWarpRowMax) take one warp each, eight rows a block;
// long rows take a block of 1024 threads each.  Fully -inf rows give NaN,
// as the plain version and jax.nn.softmax do.
#include "common.cuh"

namespace {

constexpr int kWarpRowMax = 1024;
constexpr int kShortThreads = 256;  // 8 rows (one per warp) per block
constexpr int kLongThreads = 1024;

// fold value x into the running (m, s)
__device__ __forceinline__ void online_add(float x, float& m, float& s) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;  // m == -inf: s is 0 and stays 0 * 0
    m = x;
  } else if (m != -INFINITY) {
    s += expf(x - m);
  }
}

// combine two running (m, s) pairs into (m, s)
__device__ __forceinline__ void online_merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - mm)) + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mm));
  m = mm;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    online_merge(m, s, m2, s2);
  }
}

// THREADS threads own one row: a warp (32) or the whole block
template <typename T, int THREADS>
__device__ __forceinline__ void softmax_row(const T* __restrict__ xr, T* __restrict__ outr,
                                            int n, int t) {
  float m = -INFINITY, s = 0.f;
  for (int i = t; i < n; i += THREADS) online_add(to_f32(xr[i]), m, s);
  warp_merge(m, s);
  if constexpr (THREADS > 32) {
    __shared__ float sM[THREADS / 32], sS[THREADS / 32];
    const int lane = t % 32, warp = t / 32;
    if (lane == 0) { sM[warp] = m; sS[warp] = s; }
    __syncthreads();
    if (warp == 0) {
      m = lane < THREADS / 32 ? sM[lane] : -INFINITY;
      s = lane < THREADS / 32 ? sS[lane] : 0.f;
      warp_merge(m, s);
      if (lane == 0) { sM[0] = m; sS[0] = s; }
    }
    __syncthreads();
    m = sM[0];
    s = sS[0];
  }
  const float inv = 1.f / s;
  for (int i = t; i < n; i += THREADS) outr[i] = from_f32<T>(expf(to_f32(xr[i]) - m) * inv);
}

template <typename T>
__global__ void __launch_bounds__(kShortThreads)
softmax_warp_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int n) {
  const int row = blockIdx.x * (kShortThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  softmax_row<T, 32>(x + (size_t)row * n, out + (size_t)row * n, n, threadIdx.x % 32);
}

template <typename T>
__global__ void __launch_bounds__(kLongThreads)
softmax_block_kernel(const T* __restrict__ x, T* __restrict__ out, int n) {
  const size_t row = blockIdx.x;
  softmax_row<T, kLongThreads>(x + row * n, out + row * n, n, threadIdx.x);
}

template <typename T>
cudaError_t launch(const void* x, void* out, int rows, int n, cudaStream_t st) {
  if (n <= kWarpRowMax) {
    const int per_block = kShortThreads / 32;
    softmax_warp_kernel<T><<<(rows + per_block - 1) / per_block, kShortThreads, 0, st>>>(
        (const T*)x, (T*)out, rows, n);
  } else {
    softmax_block_kernel<T><<<rows, kLongThreads, 0, st>>>((const T*)x, (T*)out, n);
  }
  return cudaGetLastError();
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
