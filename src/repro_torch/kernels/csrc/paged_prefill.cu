// Chunked-prefill attention straight over a paged KV cache, written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_prefill` in
// src/repro/kernels/paged_prefill.py (`_kernel`, `_live_page`, wrapper
// `paged_prefill`).  Query row j of request b sits at absolute position
// ctx_lens[b] + j and sees keys causally across the whole paged history,
// the chunk's own K/V included (they are in the pages already).  Rows
// j >= chunk_lens[b] are padding and write zeros.
//
// What bounds it: per KV head, R = G * chunk query rows meet K live keys:
// 4 * R * K * D FLOPs (QK^T and PV) against 2 * K * D elements of K/V,
// i.e. 2 * R / (bytes per element) FLOP per byte.  At the serving shapes
// (chunk 64, G 2, bf16) that is 128 FLOP/byte, below the ~295 at which
// the tensor cores outrun the 3.35 TB/s, so the least time is set by the
// bytes; this version computes on CUDA cores, where the operations
// take longer than the bytes.
//
// Design: one block per (KV head, tile of QT chunk rows, request).  The
// TPU kernel walks page pairs as a sequential grid dimension with a VMEM
// accumulator; here a loop inside the block walks tiles of pages from
// page 0 to the last page that the tile's causal limit allows
// (ctx + last valid row), so pages past the diagonal or past the live
// context are never read, and a tile of padding rows only writes zeros.
// GQA is folded into the rows, as on the TPU: the G query heads of the
// KV group share each staged K/V tile (R = G * QT rows).  K is staged
// with a padded row stride (D + 1) so that the threads of a warp, which
// take consecutive keys, hit distinct shared-memory banks.  The online
// softmax runs in float32 in shared memory.  K/V tiles are staged with
// 16-byte loads that are all in flight together (stage_kv_tile).  The
// score and PV products run on CUDA cores in 4 x 4 register micro-tiles,
// so that each value read from shared memory feeds four FMAs: on the
// first version, which read two shared-memory values per FMA, those
// loops and not the loads set the kernel's time.  No tensor cores
// (wgmma) or TMA yet.
#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;
constexpr int kTargetRows = 64;

size_t smem_bytes(int rows, int D, int tile, int NB) {
  // rows is padded to a multiple of 4.  q: rows*(D+1); acc: rows*D;
  // K tile: tile*(D+1); V tile: tile*D; scores: rows*(tile+1); m, l,
  // alpha: rows; page ids: NB
  return sizeof(float) * ((size_t)rows * (D + 1) + (size_t)rows * D +
                          (size_t)tile * (D + 1) + (size_t)tile * D +
                          (size_t)rows * (tile + 1) + 3 * rows) +
         sizeof(int) * (size_t)NB;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                         const T* __restrict__ v_pages,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ ctx_lens,
                         const int* __restrict__ chunk_lens,
                         T* __restrict__ out, int S, int H, int Hkv, int D,
                         int page, int NB, int QT, int tile_pages,
                         float scale) {
  const int hk = blockIdx.x, q0 = blockIdx.y * QT, b = blockIdx.z;
  const int G = H / Hkv, R = G * QT, tile = tile_pages * page;
  const int RP = (R + 3) / 4 * 4;  // rows padded to whole micro-tiles
  // row strides of q, K and the scores, padded by one float so that
  // neighbouring rows start in different shared-memory banks
  const int QS = D + 1, KD = D + 1, PS = tile + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int ctx = ctx_lens[b];
  const int total = ctx + chunk_lens[b];
  const int nrows = min(QT, S - q0);  // rows of this tile that exist
  const int nvalid = max(0, min(nrows, chunk_lens[b] - q0));
  // element (b, s, h, d) of q and out
  auto at = [&](int j, int g, int d) {
    return (((size_t)b * S + q0 + j) * H + (size_t)hk * G + g) * D + d;
  };
  // may row r (= g * QT + j) see the key at absolute position kpos?
  auto visible = [&](int r, int kpos) {
    const int j = r % QT;
    return r < R && j < nvalid && kpos <= ctx + q0 + j && kpos < total;
  };

  if (nvalid == 0) {  // the whole tile is chunk padding
    for (int e = tid; e < R * D; e += kThreads) {
      const int r = e / D, g = r / QT, j = r - g * QT;
      if (j < nrows) out[at(j, g, e - r * D)] = from_f32<T>(0.f);
    }
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;              // (RP, QS), row r = g * QT + j, scaled
  float* acc = q_s + RP * QS;     // (RP, D)
  float* k_s = acc + RP * D;      // (tile, KD)
  float* v_s = k_s + tile * KD;   // (tile, D)
  float* p_s = v_s + tile * D;    // (RP, PS)
  float* m_s = p_s + RP * PS;     // (RP,)
  float* l_s = m_s + RP;          // (RP,)
  float* a_s = l_s + RP;          // (RP,)
  int* pid_s = reinterpret_cast<int*>(a_s + RP);  // (NB,) page ids

  for (int e = tid; e < RP * D; e += kThreads) {
    const int r = e / D, d = e - r * D, g = r / QT, j = r - g * QT;
    q_s[r * QS + d] =
        r < R && j < nrows ? to_f32(q[at(j, g, d)]) * scale : 0.f;
    acc[e] = 0.f;
  }
  for (int r = tid; r < RP; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  // keys past the tile's last valid query position are never needed
  const int kmax = ctx + q0 + nvalid;
  const int npages = min((kmax + page - 1) / page, NB);
  for (int i = tid; i < npages; i += kThreads)
    pid_s[i] = block_tables[(size_t)b * NB + i];

  // micro-tiles of 4 x 4: thread (rb, cb) owns rows rb + i * RP/4 and
  // columns cb + c * width/4 (keys, or d), i, c < 4.  Neighbouring threads take
  // neighbouring columns (distinct banks); each shared-memory value a
  // thread loads feeds four FMAs.
  const int rstep = RP / 4, kstep = tile / 4, dstep = D / 4;
  for (int p0 = 0; p0 < npages; p0 += tile_pages) {
    const int start = p0 * page;
    __syncthreads();
    stage_kv_tile<T, kThreads>(k_pages, v_pages, k_s, KD, v_s, pid_s, p0,
                               npages, page, tile, Hkv, hk, D);
    __syncthreads();
    // scores S = Q K^T over the tile
    for (int mt = tid; mt < rstep * kstep; mt += kThreads) {
      const int rb = mt / kstep, kb = mt - rb * kstep;
      float s[4][4] = {};
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q_s[(rb + i * rstep) * QS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = k_s[(kb + c * kstep) * KD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] += qv[i] * kv[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb + i * rstep;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int tt = kb + c * kstep;
          p_s[r * PS + tt] = visible(r, start + tt) ? s[i][c] : kNegInf;
        }
      }
    }
    __syncthreads();
    // online softmax: one warp per row
    for (int r = warp; r < RP; r += kWarps) {
      float* pr = p_s + r * PS;
      float mc = kNegInf;
      for (int tt = lane; tt < tile; tt += 32) mc = fmaxf(mc, pr[tt]);
      mc = warp_max(mc);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.f;
      for (int tt = lane; tt < tile; tt += 32) {
        const float p = visible(r, start + tt) ? expf(pr[tt] - m_new) : 0.f;
        pr[tt] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V
    for (int mt = tid; mt < rstep * dstep; mt += kThreads) {
      const int rb = mt / dstep, db = mt - rb * dstep;
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb + i * rstep;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[i][c] = acc[r * D + db + c * dstep] * a_s[r];
      }
      for (int tt = 0; tt < tile; ++tt) {
        float pv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = p_s[(rb + i * rstep) * PS + tt];
#pragma unroll
        for (int c = 0; c < 4; ++c) vv[c] = v_s[tt * D + db + c * dstep];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][c] += pv[i] * vv[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[(rb + i * rstep) * D + db + c * dstep] = o[i][c];
    }
  }
  __syncthreads();
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, g = r / QT, j = r - g * QT;
    if (j >= nrows) continue;
    const float o = j < nvalid ? acc[e] / fmaxf(l_s[r], 1e-30f) : 0.f;
    out[at(j, g, e - r * D)] = from_f32<T>(o);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* ctx, const void* chunk, void* out, int B, int S, int H,
           int Hkv, int D, int page, int NB, float scale,
           cudaStream_t stream) {
  if (!vector_loads_ok<T>(k, v, D)) return (int)cudaErrorInvalidValue;
  if (page % 4) return (int)cudaErrorInvalidValue;  // whole micro-tiles
  const int G = H / Hkv;
  int qt = kTargetRows / G > 0 ? kTargetRows / G : 1;
  if (qt > S) qt = S;
  int tile_pages = kTileTokens / page > 0 ? kTileTokens / page : 1;
  while (tile_pages > 1 &&
         smem_bytes((G * qt + 3) / 4 * 4, D, tile_pages * page, NB) > kMaxSmem)
    tile_pages /= 2;
  while (qt > 1 &&
         smem_bytes((G * qt + 3) / 4 * 4, D, tile_pages * page, NB) > kMaxSmem)
    qt /= 2;
  const size_t smem =
      smem_bytes((G * qt + 3) / 4 * 4, D, tile_pages * page, NB);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(Hkv, (S + qt - 1) / qt, B);
  paged_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)bt, (const int*)ctx,
      (const int*)chunk, (T*)out, S, H, Hkv, D, page, NB, qt, tile_pages,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, D); k_pages, v_pages (P, page, Hkv, D); block_tables
// (B, NB) int32; ctx_lens, chunk_lens (B,) int32; out (B, S, H, D).  All
// contiguous, on the device; D * sizeof(dtype) a multiple of 16.  dtype:
// 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int paged_prefill_launch(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const void* block_tables,
                                    const void* ctx_lens,
                                    const void* chunk_lens, void* out, int B,
                                    int S, int H, int Hkv, int D, int page,
                                    int NB, float scale, int dtype,
                                    void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, ctx_lens,
                         chunk_lens, out, B, S, H, Hkv, D, page, NB, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, ctx_lens,
                                 chunk_lens, out, B, S, H, Hkv, D, page, NB,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}
