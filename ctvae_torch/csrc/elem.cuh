// Element types of the kernels: float32 and bfloat16 (the JAX package's
// two compute dtypes). Each kernel is a template over the type E of the
// tensors that JAX holds in the compute dtype; it reads and writes E in
// device memory, widens every value to float as it loads it, computes and
// accumulates in float, and rounds to nearest even once where it stores
// an E. Shared-memory tiles hold floats in either instantiation, so a
// layout's shared memory, and its blocks per SM, are those of float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ldf(float v) { return v; }
__device__ __forceinline__ float ldf(bf16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E stf(float v);
template <>
__device__ __forceinline__ float stf<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 stf<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// whether 4 consecutive elements at p can be moved as one vector (16
// bytes of float32, 8 of bfloat16)
template <typename E>
__device__ __forceinline__ bool vec4_aligned(const E* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(E) - 1)) == 0;
}

// 4 consecutive elements from device memory into 4 floats of shared
// memory: float32 by a 16-byte cp.async that holds no register (the
// caller waits with cp.async.wait_all), bfloat16 by one 8-byte load
// widened in registers and stored at once
__device__ __forceinline__ void copy4_to_smem(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#endif
}

__device__ __forceinline__ void copy4_to_smem(float* dst, const bf16* src) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  *reinterpret_cast<float4*>(dst) = make_float4(lo.x, lo.y, hi.x, hi.y);
}

// one element into one float of shared memory: float32 by a 4-byte
// cp.async, bfloat16 through a register
__device__ __forceinline__ void copy1_to_smem(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#endif
}

__device__ __forceinline__ void copy1_to_smem(float* dst, const bf16* src) {
  *dst = __bfloat162float(*src);
}

__device__ __forceinline__ void copy_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}
