// Device helpers shared by the paged attention kernels.
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

// Stage the K and V rows of one KV head for `tile` consecutive tokens of
// a sequence, starting at page index p0 of its block table, into shared
// memory as float: token tt lands at k_dst[tt * k_stride] and
// v_dst[tt * D].  page_ids holds the sequence's block table (in shared
// memory); tokens in pages at or past npages are written as zeros.
//
// Each thread moves 16-byte vectors and issues kUnroll loads of K and of
// V before it stores any, so that 2 * kUnroll loads per thread are in
// flight at once: a staged tile costs about one trip to device memory,
// not one per element.  Requires D * sizeof(T) % 16 == 0 and 16-byte
// aligned page pools (checked by the launchers).
template <typename T, int kThreads>
__device__ __forceinline__ void stage_kv_tile(
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    float* k_dst, int k_stride, float* v_dst, const int* page_ids, int p0,
    int npages, int page, int tile, int Hkv, int hk, int D) {
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
        const int i = p0 + tt / page;
        if (i < npages) {
          const size_t off =
              (((size_t)page_ids[i] * page + tt % page) * Hkv + hk) * D +
              (size_t)c * kPerVec;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(k_pages + off));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(v_pages + off));
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

// The pools are read with 16-byte vectors: rows must be whole vectors and
// the base pointers 16-byte aligned.
template <typename T>
inline bool vector_loads_ok(const void* k_pages, const void* v_pages, int D) {
  return (D * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
}

}  // namespace repro_torch
