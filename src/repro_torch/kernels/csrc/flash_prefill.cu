// Causal, optionally sliding-window, flash attention over dense K/V,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_prefill` in
// src/repro/kernels/flash_prefill.py (`_kernel`, wrapper `flash_prefill`,
// padded to block multiples by `ops.flash_attention`).  Query row i of
// sequence b sits at absolute position qpos = q_offset + i and sees the
// keys kpos < lengths[b] with kpos <= qpos and, for window > 0,
// kpos > qpos - window.  A row that sees no key writes zeros.
//
// What bounds it: per KV head, R = G * Sq query rows meet the live keys:
// 4 * D FLOPs per live (row, key) pair (QK^T and PV) against one read of
// q, K, V and one write of the output.  At the serving shapes (Sq = Sk =
// 2048, G = 2, D = 256, bf16) that is ~500-700 FLOP per byte, above the
// ~295 at which the tensor cores outrun the 3.35 TB/s: the least time is
// set by the operations.
//
// Two bodies, picked by dtype (a dispatch, not a fallback):
// - bf16: flash_prefill_kernel_tc, on Hopper's tensor cores through the
//   shared tile of attn_tile.cuh (wgmma QK^T and PV, the online softmax
//   in registers, a cp.async ring of K/V stages; its header says how).
//   It replaces the CUDA-core body for bf16, which ran at 135-148x
//   the bound and 11-49x slower than SDPA.  At D 256 a block takes 97 KB
//   (32-key stages), so two blocks share an SM.  The causal tiles are
//   unequal (the last query tile walks every key tile, the first one),
//   so the grid pairs heavy and light tiles (zigzag_tile): the first
//   half of the blocks takes the heaviest first, the second half the
//   lightest first, and two blocks that share an SM sum to about the
//   same work.  Takes D a
//   multiple of 16, at most 256.  On an H100 80GB HBM3 at 700 W
//   (chip_smoke.py's timing phase, B 1, S 2048, H 8, Hkv 4, D 256) it
//   takes 0.061 ms with the window 1024 and 0.089 ms without, against
//   1.755 and 2.580 ms for the CUDA-core body and 0.156 and 0.053 ms for
//   SDPA: ~200 TFLOP/s on the live pairs, 4.7-5.1x the bound.  A
//   variant that skips the K/V copies runs 1.3-1.5x faster
//   (benchmarks/bench_torch_tile_variants.py): the copies, not the
//   products, are what is left.
// - float32: flash_prefill_kernel below, the CUDA-core body: CUDA
//   cores in float32 (TF32 tensor cores would miss the float32
//   tolerance of 2e-5/3e-5).
//
// Common to both: one block per (KV head, tile of QT query positions,
// sequence), with the G query heads of the KV group folded into the rows
// (R = G * QT) so that they share each staged K/V tile, as on the TPU.
// The TPU walks the key blocks as a sequential grid dimension with a
// VMEM accumulator and skips dead blocks with `pl.when`; here a loop
// inside the block walks key tiles from the first key the window leaves
// alive, max(0, q_lo - window + 1), to the last the causal limit and the
// length allow, min(q_hi, lengths[b] - 1), so no dead key is ever
// loaded: an SWA layer reads about window + QT keys per tile whatever
// the sequence length.  A tile that straddles the diagonal or the window
// edge is masked inside.  The kernel masks the ragged Sq and Sk edges
// itself; nothing is padded.
//
// The float32 body: the tiles are sized from D (the launcher halves the
// key tile, then the query tile, until the block's shared memory fits
// 227 KB: at D = 256 a 64-row, 64-key tile would need 279 KB).  The
// online softmax runs in float32 in shared memory; p stays masked to 0
// and l is clamped at 1e-30, so a row with no visible key gives exact
// zeros.  The products use the 4 x 4 register micro-tiles and padded
// rows of paged_prefill.cu.
//
// What is left for the bf16 body: TMA copies, a producer warp, pingpong
// between two warpgroups, and a split over keys for short grids.
#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;
constexpr int kTargetRows = 64;

size_t smem_bytes(int rows, int D, int tile) {
  // rows is padded to a multiple of 4.  q: rows*(D+1); acc: rows*D;
  // K tile: tile*(D+1); V tile: tile*D; scores: rows*(tile+1); m, l,
  // alpha: rows
  return sizeof(float) * ((size_t)rows * (D + 1) + (size_t)rows * D +
                          (size_t)tile * (D + 1) + (size_t)tile * D +
                          (size_t)rows * (tile + 1) + 3 * (size_t)rows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int Sq, int Sk, int H, int Hkv, int D, int QT,
                         int tile, int window, int q_offset, float scale) {
  const int hk = blockIdx.x, q0 = blockIdx.y * QT, b = blockIdx.z;
  const int G = H / Hkv, R = G * QT;
  const int RP = (R + 3) / 4 * 4;  // rows padded to whole micro-tiles
  // row strides of q, K and the scores, padded by one float so that
  // neighbouring rows start in different shared-memory banks
  const int QS = D + 1, KD = D + 1, PS = tile + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int nrows = min(QT, Sq - q0);  // rows of this tile that exist
  const int q_lo = q_offset + q0;      // absolute position of row 0
  const int len = min(lengths[b], Sk);
  // the live key range of the whole tile
  const int kfirst = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int klast = min(q_lo + nrows - 1, len - 1);
  // element (b, s, h, d) of q and out
  auto at = [&](int j, int g, int d) {
    return (((size_t)b * Sq + q0 + j) * H + (size_t)hk * G + g) * D + d;
  };
  // may row r (= g * QT + j) see the key at position kpos?
  auto visible = [&](int r, int kpos) {
    const int j = r % QT, qpos = q_lo + j;
    return r < R && j < nrows && kpos <= qpos && kpos < len &&
           (window <= 0 || kpos > qpos - window);
  };

  if (klast < kfirst) {  // no row of the tile sees any key
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

  // micro-tiles of 4 x 4: thread (rb, cb) owns rows rb + i * RP/4 and
  // columns cb + c * width/4 (keys, or d), i, c < 4.  Neighbouring threads
  // take neighbouring columns (distinct banks); each shared-memory value a
  // thread loads feeds four FMAs.
  const int rstep = RP / 4, kstep = tile / 4, dstep = D / 4;
  for (int k0 = kfirst; k0 <= klast; k0 += tile) {
    __syncthreads();
    stage_rows<T, kThreads>(
        k, v, k_s, KD, v_s, tile, D, [&](int tt) -> long long {
          const int kpos = k0 + tt;
          if (kpos > klast) return -1;
          return (((long long)b * Sk + kpos) * Hkv + hk) * D;
        });
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
          p_s[r * PS + tt] = visible(r, k0 + tt) ? s[i][c] : kNegInf;
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
        const float p = visible(r, k0 + tt) ? expf(pr[tt] - m_new) : 0.f;
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
    out[at(j, g, e - r * D)] = from_f32<T>(acc[e] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int Sq, int Sk, int H, int Hkv, int D,
           int window, int q_offset, float scale, cudaStream_t stream) {
  if (!vector_loads_ok<T>(k, v, D)) return (int)cudaErrorInvalidValue;
  if (D % 4 || H % Hkv) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  int qt = kTargetRows / G > 0 ? kTargetRows / G : 1;
  if (qt > Sq) qt = Sq;
  int tile = kTileKeys;
  auto rows = [&] { return (G * qt + 3) / 4 * 4; };
  while (tile > 16 && smem_bytes(rows(), D, tile) > kMaxSmem) tile /= 2;
  while (qt > 1 && smem_bytes(rows(), D, tile) > kMaxSmem) qt /= 2;
  const size_t smem = smem_bytes(rows(), D, tile);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(Hkv, (Sq + qt - 1) / qt, B);
  flash_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (T*)out, Sq,
      Sk, H, Hkv, D, qt, tile, window, q_offset, scale);
  return (int)cudaGetLastError();
}

// The bf16 body on the tensor cores (attn_tile.cuh).  Rows, keys and
// visibility as flash_prefill_kernel's; the query tiles are ordered
// by zigzag_tile (attn_tile.cuh).
template <int DP, int NK, int STAGES>
__global__ void __launch_bounds__(kTileThreads)
    flash_prefill_kernel_tc(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int* __restrict__ lengths,
                            bf16* __restrict__ out, int Sq, int Sk, int H,
                            int Hkv, int D, int QT, int window, int q_offset,
                            float scale) {
  const int hk = blockIdx.x, b = blockIdx.z;
  const int q0 = zigzag_tile(blockIdx.y, gridDim.y) * QT;
  const int G = H / Hkv, R = G * QT;
  const int nrows = min(QT, Sq - q0);  // rows of this tile that exist
  const int q_lo = q_offset + q0, q_hi = q_lo + nrows - 1;
  const int len = min(lengths[b], Sk);
  // the live key range of the whole tile, and the range every row sees
  const int kfirst = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int klast = min(q_hi, len - 1);
  const int kfull_lo = window > 0 ? max(0, q_hi - window + 1) : 0;
  const int kfull_hi = min(q_lo, len - 1);
  // element offset of row r (= g * QT + j) in q and out, or -1
  auto row = [&](int r) -> long long {
    const int g = r / QT, j = r - g * QT;
    if (r >= R || j >= nrows) return -1;
    return (((long long)b * Sq + q0 + j) * H + (long long)hk * G + g) * D;
  };
  auto visible = [&](int r, int kpos) {
    const int j = r % QT, qpos = q_lo + j;
    return r < R && j < nrows && kpos <= qpos && kpos < len &&
           (window <= 0 || kpos > qpos - window);
  };
  extern __shared__ uint8_t tc_smem[];
  attn_tile<DP, NK, STAGES>(
      tc_smem, q, k, v, out, D, scale, kfirst, klast, kfull_lo, kfull_hi,
      row,
      [&](int kpos) -> long long {
        if (kpos > klast) return -1;
        return (((long long)b * Sk + kpos) * Hkv + hk) * D;
      },
      visible, row);
}

template <int DP, int NK, int STAGES>
struct LaunchTc {
  static int run(const void* q, const void* k, const void* v,
                 const void* lengths, void* out, int B, int Sq, int Sk, int H,
                 int Hkv, int D, int window, int q_offset, float scale,
                 cudaStream_t stream) {
    const int smem = AttnTile<DP, NK, STAGES>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel_tc<DP, NK, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int qt = kTileRows / (H / Hkv);
    const dim3 grid(Hkv, (Sq + qt - 1) / qt, B);
    flash_prefill_kernel_tc<DP, NK, STAGES>
        <<<grid, kTileThreads, smem, stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v,
            (const int*)lengths, (bf16*)out, Sq, Sk, H, Hkv, D, qt, window,
            q_offset, scale);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// q (B, Sq, H, D); k, v (B, Sk, Hkv, D); lengths (B,) int32; out (B, Sq,
// H, D).  All contiguous, on the device; D * sizeof(dtype) a multiple of
// 16, and for bfloat16 D a multiple of 16 at most 256.  window 0 means no
// window.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int Sq, int Sk, int H,
                                    int Hkv, int D, int window, int q_offset,
                                    float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, B, Sq, Sk, H, Hkv, D, window,
                         q_offset, scale, s);
  if (dtype == 1)
    return tile_inputs_ok(q, k, v, out, D, H, Hkv)
               ? launch_tile<LaunchTc>(D, q, k, v, lengths, out, B, Sq, Sk,
                                       H, Hkv, D, window, q_offset, scale, s)
               : (int)cudaErrorInvalidValue;
  return (int)cudaErrorInvalidValue;
}
