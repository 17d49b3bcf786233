// The elementwise work between the paged step's GEMMs, one kernel a gap,
// written for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses these chains into the
// products around them.  Run as PyTorch operations, each chain is 5 to
// 15 kernels that each read and write the whole token batch in float32
// (about 1.1 GB of device memory traffic a layer of deepseek-coder-6.7b
// at 2,112 rows), and each launch costs the host several microseconds.
// Three kernels, one pass each:
//
// - add_rms_norm_kernel: the residual add of a sublayer's output and
//   the RMSNorm that follows it.  One block a row.  x + delta is rounded
//   to the activation dtype and stored, and the norm is taken of the
//   stored value, as the unfused chain does; the sum of squares is
//   reduced in float32; h = x * rsqrt(mean + eps) * (1 + scale) in
//   float32, rounded once.  Without delta it is a plain RMSNorm.
// - rope_write_kv_kernel: RoPE of q, in place, over every row; RoPE of
//   k and the copy of v straight into their page slots for the valid
//   rows only (no write for a padding row, the scratch page included).
//   Blocks [0, T) take a row of q each, blocks [T, T + N) a valid row's
//   K/V.  Split halves, as layers.apply_rope: (x1, x2) -> (x1 cos - x2
//   sin, x1 sin + x2 cos) in float32 with each product and sum rounded
//   as the unfused chain rounds it (no fused multiply-add), from the
//   step's float32 (sin, cos) table.
// - gated_act_kernel: act(gate) * up (silu, or gelu with the tanh
//   approximation, PyTorch's formula) in float32, rounded once.
//
// What bounds them: memory.  Each does a few operations an element
// against 4 to 12 bytes.  Loads and stores are 16 bytes a thread where
// the widths and pointers allow (the wrapper says so in `vec`), else an
// element at a time.  At the serving shape (T 2,112, d 4,096, F 11,008,
// bf16) a layer moves ~69 MB through each add_rms_norm, 35 MB of q and up
// to 69 MB of K/V (the valid rows) through rope_write_kv, and ~140 MB
// through gated_act.
#include <algorithm>

#include "common.cuh"

namespace repro_torch {
namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N elements of T, loaded and stored as one access (two above 16 bytes)
template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&f)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_f32(pk.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&f)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) pk.v[i] = from_f32<T>(f[i]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

// the sum over the block, in every thread
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  __shared__ float total;
  v = warp_sum(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x / 32) ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

// x, delta, x_out, h (rows, d); scale (d,).  With delta null x_out is not
// written and the norm is x's.  Dynamic shared memory: the row in float32.
template <typename T, int N>
__global__ void add_rms_norm_kernel(const T* __restrict__ x,
                                    const T* __restrict__ delta,
                                    const T* __restrict__ scale,
                                    T* __restrict__ x_out,
                                    T* __restrict__ h, int d, float eps) {
  extern __shared__ float row[];
  const size_t base = (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x * N; i < d; i += blockDim.x * N) {
    float a[N];
    load<T, N>(x + base + i, a);
    if (delta) {
      float b[N];
      load<T, N>(delta + base + i, b);
#pragma unroll
      for (int j = 0; j < N; ++j) a[j] = to_f32(from_f32<T>(a[j] + b[j]));
      store<T, N>(x_out + base + i, a);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      row[i + j] = a[j];
      ss += __fmul_rn(a[j], a[j]);
    }
  }
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss), 1.f / d), eps));
  // each thread reads back the elements it wrote
  for (int i = threadIdx.x * N; i < d; i += blockDim.x * N) {
    float a[N], s[N];
    load<T, N>(scale + i, s);
#pragma unroll
    for (int j = 0; j < N; ++j)
      a[j] = __fmul_rn(__fmul_rn(row[i + j], inv), __fadd_rn(1.f, s[j]));
    store<T, N>(h + base + i, a);
  }
}

// Rotates one row of `heads` heads from src into dst (which may be src):
// sin/cos are the row's D / 2 angles.
template <typename T, int N>
__device__ __forceinline__ void rope_row(const T* src, T* dst,
                                         const float* sin, const float* cos,
                                         int heads, int D) {
  const int half = D / 2;
  for (int e = threadIdx.x * N; e < heads * half; e += blockDim.x * N) {
    const int off = (e / half) * D + e % half, j = e % half;
    float x1[N], x2[N], s[N], c[N], o1[N], o2[N];
    load<T, N>(src + off, x1);
    load<T, N>(src + off + half, x2);
    load<float, N>(sin + j, s);
    load<float, N>(cos + j, c);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      o1[i] = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
      o2[i] = __fadd_rn(__fmul_rn(x1[i], s[i]), __fmul_rn(x2[i], c[i]));
    }
    store<T, N>(dst + off, o1);
    store<T, N>(dst + off + half, o2);
  }
}

// q (T, H, D), roped in place; k, v (T, Hkv, D); sin, cos (T, D / 2)
// float32; pages (P, page, Hkv, D); rows, pidx, slot (N,) int64: valid
// row rows[r] goes to slot slot[r] of page pidx[r].
template <typename T, int N>
__global__ void rope_write_kv_kernel(T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const float* __restrict__ sin,
                                     const float* __restrict__ cos,
                                     T* __restrict__ k_pages,
                                     T* __restrict__ v_pages,
                                     const int64_t* __restrict__ rows,
                                     const int64_t* __restrict__ pidx,
                                     const int64_t* __restrict__ slot,
                                     int n_rows, int H, int Hkv, int D,
                                     int page) {
  const int half = D / 2;
  if ((int)blockIdx.x < n_rows) {
    const int64_t t = blockIdx.x;
    T* row = q + t * H * D;
    rope_row<T, N>(row, row, sin + t * half, cos + t * half, H, D);
    return;
  }
  const int r = blockIdx.x - n_rows;
  const int64_t t = rows[r];
  const int64_t dst = (pidx[r] * page + slot[r]) * Hkv * D;
  rope_row<T, N>(k + t * Hkv * D, k_pages + dst, sin + t * half,
                 cos + t * half, Hkv, D);
  const T* vs = v + t * Hkv * D;
  for (int e = threadIdx.x * N; e < Hkv * D; e += blockDim.x * N)
    *reinterpret_cast<Pack<T, N>*>(v_pages + dst + e) =
        *reinterpret_cast<const Pack<T, N>*>(vs + e);
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.f + expf(-x));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// out = act(gate) * up over n elements (n a multiple of N)
template <typename T, int N, bool GELU>
__global__ void gated_act_kernel(const T* __restrict__ gate,
                                 const T* __restrict__ up,
                                 T* __restrict__ out, int64_t n) {
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * N;
       i < n; i += (int64_t)gridDim.x * blockDim.x * N) {
    float g[N], u[N];
    load<T, N>(gate + i, g);
    load<T, N>(up + i, u);
#pragma unroll
    for (int j = 0; j < N; ++j)
      g[j] = __fmul_rn(GELU ? gelu_tanh(g[j]) : silu(g[j]), u[j]);
    store<T, N>(out + i, g);
  }
}

// threads for `work` items of N elements: whole warps, at most `most`
template <int N>
int threads_for(int64_t work, int most) {
  const int64_t items = (work + N - 1) / N;
  return (int)std::min<int64_t>(most,
                                std::max<int64_t>(32, (items + 31) / 32 * 32));
}

template <typename T, int N>
int launch_norm(const void* x, const void* delta, const void* scale,
                void* x_out, void* h, int rows, int d, float eps,
                cudaStream_t s) {
  const auto kernel = add_rms_norm_kernel<T, N>;
  const size_t smem = sizeof(float) * (size_t)d;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<rows, threads_for<N>(d, 1024), smem, s>>>(
      (const T*)x, (const T*)delta, (const T*)scale, (T*)x_out, (T*)h, d,
      eps);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_rope(void* q, const void* k, const void* v, const void* sin,
                const void* cos, void* k_pages, void* v_pages,
                const void* rows, const void* pidx, const void* slot,
                int n_rows, int n_valid, int H, int Hkv, int D, int page,
                cudaStream_t s) {
  rope_write_kv_kernel<T, N>
      <<<n_rows + n_valid, threads_for<N>((int64_t)H * D / 2, 256), 0, s>>>(
          (T*)q, (const T*)k, (const T*)v, (const float*)sin,
          (const float*)cos, (T*)k_pages, (T*)v_pages, (const int64_t*)rows,
          (const int64_t*)pidx, (const int64_t*)slot, n_rows, H, Hkv, D,
          page);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_act(const void* gate, const void* up, void* out, int64_t n,
               int gelu, cudaStream_t s) {
  constexpr int kThreads = 256;
  const int64_t blocks =
      std::min<int64_t>((n / N + kThreads - 1) / kThreads, 132 * 64);
  if (gelu)
    gated_act_kernel<T, N, true><<<(int)blocks, kThreads, 0, s>>>(
        (const T*)gate, (const T*)up, (T*)out, n);
  else
    gated_act_kernel<T, N, false><<<(int)blocks, kThreads, 0, s>>>(
        (const T*)gate, (const T*)up, (T*)out, n);
  return (int)cudaGetLastError();
}

// The element type and the vector width: 16 bytes where `vec`, else one
// element.
template <template <typename, int> class F, typename... Args>
int dispatch(int dtype, int vec, Args... args) {
  if (dtype == 0)
    return vec ? F<float, 4>::run(args...) : F<float, 1>::run(args...);
  if (dtype == 1)
    return vec ? F<__nv_bfloat16, 8>::run(args...)
               : F<__nv_bfloat16, 1>::run(args...);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int N>
struct Norm {
  template <typename... A>
  static int run(A... a) { return launch_norm<T, N>(a...); }
};
template <typename T, int N>
struct Rope {
  template <typename... A>
  static int run(A... a) { return launch_rope<T, N>(a...); }
};
template <typename T, int N>
struct Act {
  template <typename... A>
  static int run(A... a) { return launch_act<T, N>(a...); }
};

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// x, delta, x_out, h (rows, d) contiguous; scale (d,); delta may be null
// (x_out then unused).  vec: d a multiple of 16 bytes and every pointer
// 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t.
extern "C" int add_rms_norm_launch(const void* x, const void* delta,
                                   const void* scale, void* x_out, void* h,
                                   int rows, int d, float eps, int dtype,
                                   int vec, void* stream) {
  if (rows == 0) return 0;
  return dispatch<Norm>(dtype, vec, x, delta, scale, x_out, h, rows, d, eps,
                        (cudaStream_t)stream);
}

// q (n_rows, H, D), roped in place; k, v (n_rows, Hkv, D); sin, cos
// (n_rows, D / 2) float32; k_pages, v_pages (P, page, Hkv, D); rows,
// pidx, slot (n_valid,) int64.  All contiguous.  vec: D / 2 a multiple of
// 16 bytes and every pointer 16-byte aligned.  Returns a cudaError_t.
extern "C" int rope_write_kv_launch(void* q, const void* k, const void* v,
                                    const void* sin, const void* cos,
                                    void* k_pages, void* v_pages,
                                    const void* rows, const void* pidx,
                                    const void* slot, int n_rows,
                                    int n_valid, int H, int Hkv, int D,
                                    int page, int dtype, int vec,
                                    void* stream) {
  if (n_rows + n_valid == 0) return 0;
  return dispatch<Rope>(dtype, vec, q, k, v, sin, cos, k_pages, v_pages,
                        rows, pidx, slot, n_rows, n_valid, H, Hkv, D, page,
                        (cudaStream_t)stream);
}

// out = act(gate) * up over n contiguous elements; gelu: 1 for gelu
// (tanh), 0 for silu.  vec: n a multiple of 16 bytes' elements and every
// pointer 16-byte aligned.  Returns a cudaError_t.
extern "C" int gated_act_launch(const void* gate, const void* up, void* out,
                                long long n, int gelu, int dtype, int vec,
                                void* stream) {
  if (n == 0) return 0;
  return dispatch<Act>(dtype, vec, gate, up, out, (int64_t)n, gelu,
                       (cudaStream_t)stream);
}
