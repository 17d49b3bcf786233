// Decode attention over a paged KV cache, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (`_kernel`, wrapper
// `paged_attention`).  One query token per sequence attends over the K/V
// pages named by its block table; keys at positions >= lengths[b] are
// masked; a length-0 row writes zeros.
//
// What bounds it: memory.  Each live K/V byte is read once and used for
// G = H / Hkv dot products (2G FLOP per bf16 byte, G per float32 byte),
// far below the ~295 FLOP/byte at which the tensor cores, or the ~20 at
// which the CUDA cores in float32, stop waiting on the 3.35 TB/s.  The
// least time is therefore
//     bytes of live K/V read (+ q and out) / 3.35 TB/s.
// The CUDA cores do 4 * D FLOP a key a query head, so in bf16 they need
// G / 2 * 6.7 TFLOP/s to keep up with 3.35 TB/s: ~54 TFLOP/s at G 16
// (glm4-9b), close to their 67.  Products on the tensor cores (mma.sync)
// for large groups are a later step.
//
// Design (flash-decoding with the combine in the same launch):
// - Split over pages.  The grid is (B, Hkv, S); split s of row b covers
//   pages [s * pps, (s + 1) * pps) of its block table.  A host planner
//   (`split_plan` in paged_attention.py) picks pps and S from the shapes
//   and the SM count, aiming at about two blocks an SM; a block whose
//   first page lies past the row's live pages returns at once (the live
//   split count comes from lengths, on the device).  At the serving
//   shapes B * Hkv = 64 blocks would leave half of the 132 SMs idle.
// - A cp.async ring.  Each block streams its split's K and V rows of its
//   KV head through kStages stages of shared memory in the stored dtype
//   (not widened), 16-byte cp.async.cg copies, one commit group a stage:
//   while stage i is computed, stages i + 1 .. i + kStages - 1 are in
//   flight.  A stage is T tokens (8 KB of K and 8 KB of V; a part of a
//   page, or several pages), and each row's page id is read from
//   block_tables one stage ahead of its copies, so shared memory depends
//   on (D, dtype) only, not on the table's width.  One __syncthreads a
//   stage hands buffers over.  cp.async and not TMA: a head's rows are
//   D * esize bytes apart by Hkv * D * esize, one page at a time, which
//   a 3-D tensor map could name, but the plain copies keep one code path
//   for every page size, including stages that span pages.
// - Scores and PV in registers.  Lanes split a key's D in 16-byte
//   vectors (LK lanes a key, 32 / LK keys a warp at once, two keys a
//   lane group a pass, so that two dot products and their shuffles are
//   in flight together) and reduce the dot products with shuffles; q of
//   the warp's query heads sits in registers, pre-scaled by
//   scale * log2(e).  Warps split the keys of a stage and, for G > 4,
//   the query heads (at most 4 a warp): such blocks have 8 warps, held
//   to 128 registers a thread so that two fit an SM, since their keys
//   cost more instructions than bytes.  Each lane group keeps its own
//   online softmax (running max m, sum l and accumulator, float32): the
//   max is rescaled only when it grows.  At the end of the split the
//   lane groups merge by shuffles, the warps through shared memory, each
//   in a fixed order.
// - The combine, deterministic.  With more than one live split, each
//   split writes its (acc, m, l) in float32 to a workspace
//   (B, Hkv, S, G, D + 2), fences, and takes a ticket on its row's
//   counter; the block that takes the last ticket merges the partials in
//   split order (loads through L2), writes out and resets the counter
//   to 0.  Which block arrives last changes nothing in the result.  A
//   row with one live split writes out directly and touches neither.
//
// float32 and bf16; D * sizeof(dtype) a multiple of 16 and at most 256
// elements; G at most 16; any page size and table width.
#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kStages = 4;
constexpr int kStageBytes = 8192;    // of K (and of V) in one stage
constexpr int kMaxCopies = 4;        // K vectors a thread copies a stage
constexpr int kMaxHeadsPerWarp = 4;  // query heads in one warp's registers
constexpr int kGroupMax = 16;        // query heads a KV head
constexpr int kWarpsMax = 8;
constexpr int kMaxSplits = 128;      // 4 a lane in the combine (MAX_SPLITS)
constexpr int kKeysPerLane = 2;      // keys a lane group takes a pass
constexpr float kLog2e = 1.4426950408889634f;

// One 16-byte vector of T as floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f);
template <>
__device__ __forceinline__ void load_vec<float>(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(
    const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of a float32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The VPL 16-byte vectors c, c + LK, ... of a row of T as floats; zeros
// past the row's NV vectors.
template <typename T, int VPL>
__device__ __forceinline__ void load_row(const T* row, float* f, int c,
                                         int LK, int NV) {
  constexpr int VE = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int vi = c + v * LK;
    if (vi < NV) {
      load_vec<T>(row + vi * VE, f + v * VE);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) f[v * VE + e] = 0.f;
    }
  }
}

// Template arguments: T the stored dtype; VPL the 16-byte vectors of a
// key row one lane holds (1, or 2 for float32 rows over 32 vectors); GW
// the query heads of one warp; NW the warps of the block.  E = the
// floats of a row one lane holds.
template <typename T, int VPL, int GW, int NW>
__global__ void __launch_bounds__(NW * 32, NW == 8 ? 2 : 1)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ lengths,
                           T* __restrict__ out, float* __restrict__ ws,
                           int* __restrict__ counters, int H, int Hkv,
                           int D, int page, int page_shift, int NB, int pps,
                           int S, int T_tok, int LK, int WH, float scale) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int E = VPL * VE;
  constexpr int kThreads = NW * 32;
  const int b = blockIdx.x, hk = blockIdx.y, s = blockIdx.z;
  const int G = H / Hkv, NV = D / VE, KPW = 32 / LK, WK = NW / WH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = b * Hkv + hk;

  const int len = max(min(lengths[b], NB * page), 0);
  const int npages = (len + page - 1) / page;
  const int n_live = (npages + pps - 1) / pps;
  T* ob = out + ((size_t)b * H + (size_t)hk * G) * D;
  if (s >= n_live) {
    if (s == 0)  // a length-0 row: zeros
      for (int e = tid; e < G * D; e += kThreads) ob[e] = from_f32<T>(0.f);
    return;
  }
  const int tok0 = s * pps * page;
  const int tok_end = min(tok0 + pps * page, len);
  const int n_st = (tok_end - tok0 + T_tok - 1) / T_tok;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // kStages x (K, V) x T_tok x D
  __shared__ int last_s;
  __shared__ float head_w[kWarpsMax * kGroupMax], head_inv_l[kGroupMax];

  // ---- the copies: thread tid moves vectors tid + j * kThreads of K
  // and of V of each stage (row = vector / NV, column = vector % NV)
  const int n_vec = T_tok * NV;
  int crow[kMaxCopies], ccol[kMaxCopies];
#pragma unroll
  for (int j = 0; j < kMaxCopies; ++j) {
    const int vi = tid + j * kThreads;
    crow[j] = vi < n_vec ? vi / NV : T_tok;  // T_tok: no copy
    ccol[j] = vi < n_vec ? vi - crow[j] * NV : 0;
  }
  const int* bt = block_tables + (size_t)b * NB;
  const uint32_t ring_s = smem_u32(ring);
  const size_t head_off = (size_t)hk * D;
  // The page ids of a stage's rows are loaded one stage before its
  // copies are issued, so the copies never wait on block_tables.
  int pid[kMaxCopies];
  auto fetch_ids = [&](int st) {
#pragma unroll
    for (int j = 0; j < kMaxCopies; ++j) {
      const int tok = tok0 + st * T_tok + crow[j];
      pid[j] = -1;
      if (st < n_st && crow[j] < T_tok && tok < tok_end)
        pid[j] = __ldg(bt + (page_shift >= 0 ? tok >> page_shift
                                             : tok / page));
    }
  };
  auto issue = [&](int st) {
    if (st < n_st) {
      const int t_base = tok0 + st * T_tok;
      const uint32_t kbuf =
          ring_s + (uint32_t)((st % kStages) * 2 * T_tok * D * sizeof(T));
      const uint32_t vbuf = kbuf + (uint32_t)(T_tok * D * sizeof(T));
#pragma unroll
      for (int j = 0; j < kMaxCopies; ++j) {
        if (pid[j] >= 0) {
          const int tok = t_base + crow[j];
          const int r = page_shift >= 0 ? tok & (page - 1) : tok % page;
          const size_t off = ((size_t)pid[j] * page + r) * Hkv * D +
                             head_off + (size_t)ccol[j] * VE;
          const uint32_t at =
              (uint32_t)((crow[j] * D + ccol[j] * VE) * sizeof(T));
          cp_async16(kbuf + at, k_pages + off, true);
          cp_async16(vbuf + at, v_pages + off, true);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // ---- this warp's query heads and this lane's columns
  const int hs = warp % WH, kw = warp / WH;
  const int h0 = hs * GW;
  const int ng = min(GW, G - h0);  // <= 0: a warp with no head
  const int grp = lane / LK, c = lane % LK;
  float qf[GW][E], acc[GW][E], m[GW], l[GW];
  const T* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  const float qscale = scale * kLog2e;
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int vi = c + v * LK;
      if (g < ng && vi < NV) {
        load_vec<T>(qb + (size_t)(h0 + g) * D + vi * VE, &qf[g][v * VE]);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) qf[g][v * VE + e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        qf[g][v * VE + e] *= qscale;
        acc[g][v * VE + e] = 0.f;
      }
    }
  }

  // ---- the ring: pass `it` issues stage it and computes stage
  // it - (kStages - 1); the first kStages - 1 passes only issue.  One
  // call site each keeps the copy code inlined.
  fetch_ids(0);
  for (int it = 0; it < n_st + kStages - 1; ++it) {
    const int st = it - (kStages - 1);
    if (st >= 0) {
      cp_async_wait<kStages - 2>();  // this thread's copies of stage st
      __syncthreads();  // everyone's; and stage st - 1 is consumed
    }
    issue(it);
    fetch_ids(it + 1);
    if (st < 0) continue;
    const T* ks = ring + (size_t)(st % kStages) * 2 * T_tok * D;
    const T* vs = ks + (size_t)T_tok * D;
    const int n_tok = min(T_tok, tok_end - tok0 - st * T_tok);
    // each lane group takes kKeysPerLane keys a pass: independent dot
    // products and shuffles in flight together, one rescale check
    for (int kb = kw * KPW; kb < n_tok; kb += kKeysPerLane * WK * KPW) {
      bool live[kKeysPerLane];
      float sc[kKeysPerLane][GW];
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        const int key = kb + u * WK * KPW + grp;
        live[u] = key < n_tok;
        float kf[E];
        if (live[u]) {
          load_row<T, VPL>(ks + (size_t)key * D, kf, c, LK, NV);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) a = fmaf(qf[g][e], kf[e], a);
          sc[u][g] = a;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        if (o < LK) {
#pragma unroll
          for (int u = 0; u < kKeysPerLane; ++u)
#pragma unroll
            for (int g = 0; g < GW; ++g)
              sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
        }
      }
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kKeysPerLane; ++u)
          if (live[u]) mx = fmaxf(mx, sc[u][g]);
        if (mx > m[g]) {  // the max grew: rescale (rare)
          const float a = fast_exp2(m[g] - mx);
          l[g] *= a;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= a;
          m[g] = mx;
        }
      }
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        if (live[u]) {
          const int key = kb + u * WK * KPW + grp;
          float vf[E];
          load_row<T, VPL>(vs + (size_t)key * D, vf, c, LK, NV);
#pragma unroll
          for (int g = 0; g < GW; ++g) {
            const float p = fast_exp2(sc[u][g] - m[g]);
            l[g] += p;
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[g][e] = fmaf(p, vf[e], acc[g][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the warps' scratch

  // ---- merge the lane groups of each warp (butterfly, fixed order)
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    float mx = m[g];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o >= LK) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float a = fast_exp2(m[g] - mx);
    l[g] *= a;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] *= a;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o >= LK) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
    m[g] = mx;
  }
  // ---- then the warps of each head through shared memory:
  // red[kw][head][D + 2] = (acc, m, l)
  float* red = reinterpret_cast<float*>(smem_raw);
  const int RS = D + 2;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GW; ++g) {
      if (g < ng) {
        float* rg = red + (size_t)(kw * G + h0 + g) * RS;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int vi = c + v * LK;
          if (vi < NV) {
#pragma unroll
            for (int e = 0; e < VE; ++e)
              rg[vi * VE + e] = acc[g][v * VE + e];
          }
        }
        if (c == 0) {
          rg[D] = m[g];
          rg[D + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();
  // each head's weights of its WK warps, and its merged (m, l) (or 1 / l
  // when this split is the row's only one), once
  float* wsb = ws + (size_t)bh * S * G * RS;  // (S, G, D + 2) of this row
  for (int g = tid; g < G; g += kThreads) {
    float mx = kNegInf;
    for (int w = 0; w < WK; ++w) mx = fmaxf(mx, red[(w * G + g) * RS + D]);
    float lsum = 0.f;
    for (int w = 0; w < WK; ++w) {
      const float f = fast_exp2(red[(w * G + g) * RS + D] - mx);
      head_w[w * G + g] = f;
      lsum += red[(w * G + g) * RS + D + 1] * f;
    }
    if (n_live == 1) {
      head_inv_l[g] = __fdividef(1.f, fmaxf(lsum, 1e-30f));
    } else {
      wsb[(size_t)(s * G + g) * RS + D] = mx;
      wsb[(size_t)(s * G + g) * RS + D + 1] = lsum;
    }
  }
  __syncthreads();
  // then the elements: thread tid takes e = tid, tid + kThreads, ...
  // with e = g * D + d, stepped without a division
  const int gstep = kThreads / D, dstep = kThreads - gstep * D;
  for (int g = tid / D, d = tid - (tid / D) * D; g < G;) {
    float a = 0.f;
    for (int w = 0; w < WK; ++w)
      a = fmaf(red[(w * G + g) * RS + d], head_w[w * G + g], a);
    if (n_live == 1)
      ob[g * D + d] = from_f32<T>(a * head_inv_l[g]);
    else
      wsb[(size_t)(s * G + g) * RS + d] = a;
    d += dstep;
    g += gstep;
    if (d >= D) {
      d -= D;
      ++g;
    }
  }
  if (n_live == 1) return;

  // ---- the combine: the last of the row's live splits merges them all
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + bh, 1) == n_live - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the weights of the partials, in the ring's memory: f[i][g] =
  // exp2(m_i - max m) / sum_i l_i exp2(m_i - max m), one warp a head,
  // lanes across the splits (max and sum by butterflies: a fixed order)
  float* f = red;
  for (int g = warp; g < G; g += NW) {
    float mi[kMaxSplits / 32], li[kMaxSplits / 32];
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits / 32; ++r) {
      const int i = lane + 32 * r;
      mi[r] = kNegInf;
      li[r] = 0.f;
      if (i < n_live) {
        const float* pw = wsb + (size_t)(i * G + g) * RS;
        mi[r] = __ldcg(pw + D);
        li[r] = __ldcg(pw + D + 1);
      }
      mx = fmaxf(mx, mi[r]);
    }
    mx = warp_max(mx);
    float lsum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits / 32; ++r) {
      mi[r] = fast_exp2(mi[r] - mx);  // 0 past n_live
      lsum += li[r] * mi[r];
    }
    const float inv = __fdividef(1.f, fmaxf(warp_sum(lsum), 1e-30f));
#pragma unroll
    for (int r = 0; r < kMaxSplits / 32; ++r)
      if (lane + 32 * r < n_live) f[(lane + 32 * r) * G + g] = mi[r] * inv;
  }
  __syncthreads();
  // then the out elements in pairs (D is even), each summed over the
  // splits in split order with 8 splits' loads in flight
  const int gpstep = 2 * kThreads / D, pstep = 2 * kThreads - gpstep * D;
  for (int g = tid / (D / 2), d = 2 * (tid - g * (D / 2)); g < G;) {
    const float* pw = wsb + (size_t)g * RS + d;
    float2 a = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int i = 0; i < n_live; ++i) {
      const float2 x =
          __ldcg(reinterpret_cast<const float2*>(pw + (size_t)i * G * RS));
      const float w = f[i * G + g];
      a.x = fmaf(w, x.x, a.x);
      a.y = fmaf(w, x.y, a.y);
    }
    ob[g * D + d] = from_f32<T>(a.x);
    ob[g * D + d + 1] = from_f32<T>(a.y);
    d += pstep;
    g += gpstep;
    if (d >= D) {
      d -= D;
      ++g;
    }
  }
  if (tid == 0) counters[bh] = 0;  // for the next call on this stream
}

template <typename T, int VPL, int GW, int NW>
int launch_t(const void* q, const void* k, const void* v, const void* bt,
             const void* lens, void* out, void* ws, void* counters, int B,
             int H, int Hkv, int D, int page, int NB, int pps, int S,
             int T_tok, int LK, int WH, float scale, size_t smem,
             cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, VPL, GW, NW>;
  // the shared-memory limit, raised once per instantiation and device
  static size_t smem_set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem > smem_set[dev])) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  int page_shift = -1;
  if ((page & (page - 1)) == 0) {
    page_shift = 0;
    while ((1 << page_shift) < page) ++page_shift;
  }
  kernel<<<dim3(B, Hkv, S), NW * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)bt,
      (const int*)lens, (T*)out, (float*)ws, (int*)counters, H, Hkv, D,
      page, page_shift, NB, pps, S, T_tok, LK, WH, scale);
  return (int)cudaGetLastError();
}

template <typename T, int VPL>
int launch_vpl(int GW, int NW, const void* q, const void* k, const void* v,
               const void* bt, const void* lens, void* out, void* ws,
               void* counters, int B, int H, int Hkv, int D, int page,
               int NB, int pps, int S, int T_tok, int LK, int WH,
               float scale, size_t smem, cudaStream_t stream) {
#define REPRO_LAUNCH(gw, nw)                                                \
  return launch_t<T, VPL, gw, nw>(q, k, v, bt, lens, out, ws, counters, B, \
                                  H, Hkv, D, page, NB, pps, S, T_tok, LK,  \
                                  WH, scale, smem, stream)
  if (NW == 4) {
    switch (GW) {
      case 1: REPRO_LAUNCH(1, 4);
      case 2: REPRO_LAUNCH(2, 4);
      case 3: REPRO_LAUNCH(3, 4);
      case 4: REPRO_LAUNCH(4, 4);
    }
  } else if (NW == 8) {
    switch (GW) {
      case 3: REPRO_LAUNCH(3, 8);
      case 4: REPRO_LAUNCH(4, 8);
    }
  }
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* lens, void* out, void* ws, void* counters, int B,
           int H, int Hkv, int D, int page, int NB, int pps, int S,
           float scale, cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(T);
  if (!vector_loads_ok<T>(k, v, D) || D > 256 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv, NV = D / VE;
  if (G > kGroupMax) return (int)cudaErrorInvalidValue;
  // the split must cover the table; more than one needs the scratch
  if (pps < 1 || S < 1 || S > 65535 || (long long)S * pps < NB ||
      (S > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int VPL = NV > 32 ? 2 : 1;
  int LK = 1;
  while (LK * VPL < NV) LK *= 2;
  // 4 warps; 8 for groups over kMaxHeadsPerWarp heads, whose keys cost
  // more than their bytes.  WH warps across the heads, NW / WH across
  // the keys.
  const int NW = G > kMaxHeadsPerWarp ? 8 : 4;
  int WH = 1;
  while (WH < NW && (G + WH - 1) / WH > kMaxHeadsPerWarp) WH *= 2;
  const int GW = (G + WH - 1) / WH;
  if (GW > kMaxHeadsPerWarp) return (int)cudaErrorInvalidValue;
  int T_tok = 8;  // tokens a stage: kStageBytes of K, at least 8 rows
  while (T_tok * 2 * D * (int)sizeof(T) <= kStageBytes) T_tok *= 2;
  if (T_tok * NV > kMaxCopies * NW * 32) return (int)cudaErrorInvalidValue;
  const size_t ring = (size_t)kStages * 2 * T_tok * D * sizeof(T);
  const size_t red = (size_t)(NW / WH) * G * (D + 2) * sizeof(float);
  const size_t smem = ring > red ? ring : red;
  // the combine's weights (S G floats) reuse the ring: S is bounded by
  // kMaxSplits, never by NB
  if (smem > kMaxSmem || S > kMaxSplits ||
      (size_t)S * G * sizeof(float) > smem)
    return (int)cudaErrorInvalidValue;
  if constexpr (VE == 4) {  // float32 rows of 33-64 vectors: two a lane
    if (VPL == 2)
      return launch_vpl<T, 2>(GW, NW, q, k, v, bt, lens, out, ws, counters, B,
                              H, Hkv, D, page, NB, pps, S, T_tok, LK, WH,
                              scale, smem, stream);
  }
  return launch_vpl<T, 1>(GW, NW, q, k, v, bt, lens, out, ws, counters, B, H,
                          Hkv, D, page, NB, pps, S, T_tok, LK, WH, scale,
                          smem, stream);
}

}  // namespace

// q (B, H, D); k_pages, v_pages (P, page, Hkv, D); block_tables (B, NB)
// int32; lengths (B,) int32; out (B, H, D).  All contiguous, on the
// device; D * sizeof(dtype) a multiple of 16, D <= 256, H / Hkv <= 16.
// The split: pages_per_split * n_splits >= NB; with n_splits > 1,
// workspace is float32 (B, Hkv, n_splits, H / Hkv, D + 2) and counters
// int32 (B * Hkv,), zero on entry and left zero.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out,
    void* workspace, void* counters, int B, int H, int Hkv, int D, int page,
    int NB, int pages_per_split, int n_splits, float scale, int dtype,
    void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, lengths, out,
                         workspace, counters, B, H, Hkv, D, page, NB,
                         pages_per_split, n_splits, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                                 out, workspace, counters, B, H, Hkv, D,
                                 page, NB, pages_per_split, n_splits, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
