// Shared helpers for the port's hand-written Hopper kernels.
//
// Element types: float (dtype code 0) and __nv_bfloat16 (dtype code 1).
// Every kernel computes in float32 and rounds to the storage type exactly
// where the Pallas kernel it replaces calls .astype(dtype).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// float32's most negative finite value: the JAX kernels' NEG_INF.
#define LLM_NEG_INF (-3.4028234663852886e38f)

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to T's precision, returned as float (`.astype(T)` in the kernels).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float softcap_f(float s, float cap) {
  return cap > 0.f ? tanhf(s / cap) * cap : s;
}

// Python's floor division for ints (C's `/` truncates toward zero).
__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raise the kernel's dynamic shared-memory cap once it needs more than 48 KB.
template <typename K>
__host__ cudaError_t ensure_smem(K kernel, size_t bytes, size_t* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *configured = bytes;
  return e;
}
