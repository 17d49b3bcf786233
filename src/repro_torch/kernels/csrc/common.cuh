// Device helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // as the TPU kernels
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory of one block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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
// Stage the K and V rows of `tile` tokens into shared memory as float:
// token tt lands at k_dst[tt * k_stride] and v_dst[tt * D].
// row_offset(tt) gives the element offset of token tt's D-vector in
// k_src and v_src, or -1 for a token past the live range, which is
// written as zeros.
//
// Each thread moves 16-byte vectors and issues kUnroll loads of K and of
// V before it stores any, so that 2 * kUnroll loads per thread are in
// flight at once: a staged tile costs about one trip to device memory,
// not one per element.  Requires D * sizeof(T) % 16 == 0 and 16-byte
// aligned sources (checked by the launchers).
template <typename T, int kThreads, typename RowOffset>
__device__ __forceinline__ void stage_rows(const T* __restrict__ k_src,
                                           const T* __restrict__ v_src,
                                           float* k_dst, int k_stride,
                                           float* v_dst, int tile, int D,
                                           RowOffset row_offset) {
  constexpr int kUnroll = 4;
  constexpr int kPerVec = 16 / sizeof(T);
  const int vec_per_row = D / kPerVec;
  const int n_vec = tile * vec_per_row;
  for (int base = 0; base < n_vec; base += kThreads * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int vi = base + u * kThreads + threadIdx.x;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      if (vi < n_vec) {
        const int tt = vi / vec_per_row, c = vi - tt * vec_per_row;
        const long long row = row_offset(tt);
        if (row >= 0) {
          const size_t off = (size_t)row + (size_t)c * kPerVec;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(k_src + off));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(v_src + off));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int vi = base + u * kThreads + threadIdx.x;
      if (vi < n_vec) {
        const int tt = vi / vec_per_row, c = vi - tt * vec_per_row;
        const T* ke = reinterpret_cast<const T*>(&kr[u]);
        const T* ve = reinterpret_cast<const T*>(&vr[u]);
        float* kd = k_dst + tt * k_stride + c * kPerVec;
        float* vd = v_dst + tt * D + c * kPerVec;
#pragma unroll
        for (int j = 0; j < kPerVec; ++j) {
          kd[j] = to_f32(ke[j]);
          vd[j] = to_f32(ve[j]);
        }
      }
    }
  }
}

// Stage the K and V rows of one KV head for `tile` consecutive tokens of
// a paged sequence, starting at page index p0 of its block table.
// page_ids holds the sequence's block table (in shared memory); tokens
// in pages at or past npages are written as zeros.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_kv_tile(
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    float* k_dst, int k_stride, float* v_dst, const int* page_ids, int p0,
    int npages, int page, int tile, int Hkv, int hk, int D) {
  stage_rows<T, kThreads>(
      k_pages, v_pages, k_dst, k_stride, v_dst, tile, D,
      [&](int tt) -> long long {
        const int i = p0 + tt / page;
        if (i >= npages) return -1;
        return (((long long)page_ids[i] * page + tt % page) * Hkv + hk) * D;
      });
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
