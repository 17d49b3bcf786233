// Decode attention over a paged KV cache, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (`_kernel`, wrapper
// `paged_attention`).  One query token per sequence attends over the K/V
// pages named by its block table; keys at positions >= lengths[b] are
// masked; a length-0 row writes zeros.
//
// What bounds it: memory.  Each live K/V byte is read once and used for
// G = H / Hkv dot products of length D, far below the ~20 FLOP/byte
// (float32, CUDA cores) or ~295 FLOP/byte (bf16, tensor cores) at which
// the H100 stops waiting on its 3.35 TB/s.  The least time is therefore
//     bytes of live K/V read (+ q and out) / 3.35 TB/s.
//
// Design: one block per (sequence, KV head).  The TPU kernel walks the
// pages as a sequential grid dimension with its accumulator in VMEM
// scratch; here a loop inside the block takes that place.  The block
// visits only the sequence's live pages (ceil(length / page)), so dead
// block-table entries are never read.  Each iteration stages a tile of
// several pages of this KV head into shared memory, converted to float,
// with 16-byte loads that are all in flight together (stage_kv_tile), and
// all G query heads of the group use it: K/V are read from device memory
// once per group, not once per query head.  The online softmax (running
// max m, sum l, accumulator acc) stays in float32 in shared memory.
// Scores take one thread per (query head, key); K rows are padded to
// D + 1 floats so that those threads hit distinct banks.  What this
// version does not do yet: overlap the next tile's loads with compute,
// split long sequences across blocks (flash-decoding) when B * Hkv is
// below the 132 SMs, or use tensor cores.
#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;

size_t smem_bytes(int G, int D, int tile, int NB) {
  // q, acc: G*D; K tile: tile*(D+1); V tile: tile*D; scores: G*tile;
  // m, l, alpha: G; page ids: NB
  return sizeof(float) * (2 * (size_t)G * D + (size_t)tile * (D + 1) +
                          (size_t)tile * D + (size_t)G * tile + 3 * G) +
         sizeof(int) * (size_t)NB;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ lengths,
                           T* __restrict__ out, int H, int Hkv, int D,
                           int page, int NB, int tile_pages, float scale) {
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = H / Hkv;
  const int tile = tile_pages * page, KS = D + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;              // (G, D), pre-scaled
  float* acc = q_s + G * D;       // (G, D)
  float* k_s = acc + G * D;       // (tile, D + 1)
  float* v_s = k_s + tile * KS;   // (tile, D)
  float* p_s = v_s + tile * D;    // (G, tile) scores, then probabilities
  float* m_s = p_s + G * tile;    // (G,)
  float* l_s = m_s + G;           // (G,)
  float* a_s = l_s + G;           // (G,) rescale factor of this tile
  int* pid_s = reinterpret_cast<int*>(a_s + G);  // (NB,) page ids

  const int len = lengths[b];
  const int npages = min((len + page - 1) / page, NB);
  const T* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    q_s[e] = to_f32(qb[e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  for (int i = tid; i < npages; i += kThreads)
    pid_s[i] = block_tables[(size_t)b * NB + i];

  for (int p0 = 0; p0 < npages; p0 += tile_pages) {
    const int start = p0 * page;  // absolute position of the tile's token 0
    __syncthreads();              // previous tile consumed, init visible
    stage_kv_tile<T, kThreads>(k_pages, v_pages, k_s, KS, v_s, pid_s, p0,
                               npages, page, tile, Hkv, hk, D);
    __syncthreads();
    // scores: one thread per (query head, key)
    for (int e = tid; e < G * tile; e += kThreads) {
      const int g = e / tile, tt = e - g * tile;
      float s = kNegInf;
      if (start + tt < len) {
        const float* qg = q_s + g * D;
        const float* kt = k_s + tt * KS;
        s = 0.f;
        for (int d = 0; d < D; ++d) s += qg[d] * kt[d];
      }
      p_s[e] = s;
    }
    __syncthreads();
    // online softmax: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * tile;
      float mc = kNegInf;
      for (int tt = lane; tt < tile; tt += 32) mc = fmaxf(mc, pg[tt]);
      mc = warp_max(mc);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.f;
      for (int tt = lane; tt < tile; tt += 32) {
        const float p = (start + tt < len) ? expf(pg[tt] - m_new) : 0.f;
        pg[tt] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V: one thread per (query head, d)
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e - g * D;
      const float* pg = p_s + g * tile;
      float a = acc[e] * a_s[g];
      for (int tt = 0; tt < tile; ++tt) a += pg[tt] * v_s[tt * D + d];
      acc[e] = a;
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)hk * G) * D;
  for (int e = tid; e < G * D; e += kThreads)
    ob[e] = from_f32<T>(acc[e] / fmaxf(l_s[e / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* lens, void* out, int B, int H, int Hkv, int D,
           int page, int NB, float scale, cudaStream_t stream) {
  if (!vector_loads_ok<T>(k, v, D)) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  int tile_pages = kTileTokens / page > 0 ? kTileTokens / page : 1;
  while (tile_pages > 1 &&
         smem_bytes(G, D, tile_pages * page, NB) > kMaxSmem)
    tile_pages /= 2;
  const size_t smem = smem_bytes(G, D, tile_pages * page, NB);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_kernel<T><<<dim3(B, Hkv), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)bt,
      (const int*)lens, (T*)out, H, Hkv, D, page, NB, tile_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D); k_pages, v_pages (P, page, Hkv, D); block_tables (B, NB)
// int32; lengths (B,) int32; out (B, H, D).  All contiguous, on the
// device; D * sizeof(dtype) a multiple of 16.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* lengths, void* out, int B,
                                      int H, int Hkv, int D, int page, int NB,
                                      float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B,
                         H, Hkv, D, page, NB, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                                 out, B, H, Hkv, D, page, NB, scale, s);
  return (int)cudaErrorInvalidValue;
}
