// Device helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // as the TPU kernels
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory of one block

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 2^x on the special-function unit, flushing denormals (no range fix-up)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte cp.async copy from device to shared memory (through L2 only);
// zero-filled if !live.  Copies land once a commit group that holds them
// is waited for.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// K and V are read with 16-byte vectors: rows must be whole vectors and
// the base pointers 16-byte aligned.
template <typename T>
inline bool vector_loads_ok(const void* k_pages, const void* v_pages, int D) {
  return (D * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
}

}  // namespace repro_torch
