// The bf16 attention tile on Hopper's tensor cores, shared by
// flash_prefill.cu and paged_prefill.cu.
//
// Replaces, for bf16 inputs, the CUDA-core bodies of those two kernels
// (still their float32 bodies): K/V widened to float32 as they were
// staged, S = QK^T and O += PV as 4 x 4 register micro-tiles over
// float32 shared memory, an online softmax in three shared-memory
// passes with a __syncthreads between each, and synchronous staging
// (stage a key tile, compute it, stage the next).  At D = 256 those float32 tiles took 206 KB of
// shared memory, one block an SM, and the products ran at the 67
// TFLOP/s of the CUDA cores: 135-148x the bound.
//
// What bounds the work: 4 * D FLOPs per live (row, key) pair against
// one read of q, K, V and one write of the output.  flash_prefill at the
// slot prefill shapes (2048 rows a KV head, D 256) is bound by the
// operations; paged_prefill at the serving shapes (128 rows a KV head,
// D 64, ~2 FLOP per byte a row) by the bytes of K/V.
//
// Design.  One block is one consumer warpgroup (128 threads) that owns
// 64 query rows; the caller folds the G query heads of a KV group into
// them (row r = g * QT + j), so all share each K/V tile.
// - S = QK^T: wgmma m64n{NK}k16, Q and the K tile both read from shared
//   memory, both K-major (D contiguous), D walked in steps of 16.  The
//   softmax scale is applied to S in float32.
// - The online softmax stays in registers on the accumulator fragment:
//   each thread holds two rows (r and r + 8), whose max is reduced
//   across the four threads that share them with __shfl_xor_sync; the
//   sum is kept per thread and reduced once at the end; p is one FMA
//   and one ex2.approx from the raw score.  No shared memory and no
//   barrier inside a tile.  Invisible pairs are set to
//   kNegInf before the max, p is masked to 0 and l clamped, so a row
//   that sees no key writes exact zeros.  A tile that every live row
//   sees whole (between kfull_lo and kfull_hi) skips the mask.
// - O += PV: wgmma m64n{DP}k16 with A in registers: P is rounded to
//   bf16 straight from the S fragment (whose layout is the A fragment's
//   for 16-bit inputs); V's tile is read MN-major (transposed).  The sum
//   l is taken from the float32 P, before the rounding.  O stays in
//   float32 registers (128 a thread at D 256).
// - Copies: 16-byte cp.async into a ring of STAGES K/V stages; tile
//   t + STAGES - 1 is in flight while tile t is computed.  Q is copied
//   once, in the first group.  Rows past the live range are zero-filled
//   by the copy (src-size 0), so V holds no garbage that 0 * x could
//   turn into NaN.
// - Layout: every tile is stored in the 128-byte-swizzled K-major form
//   that the wgmma descriptors name: D split into blocks of 64 columns
//   (128 bytes), each block `rows` rows of 128 bytes, the 16-byte chunk
//   c of row r at chunk (c ^ r % 8); tiles start at 1024-byte
//   boundaries.  For Q and K the descriptor is K-major (SBO = 1024 B,
//   8 rows); for V the same bytes are MN-major (LBO = the 64-column
//   block stride, SBO = 1024 B, 8 keys).  D is padded to DP (64, 128 or
//   256) in shared memory only, with zeros: both products run over all
//   DP (no branch between the wgmmas of a batch, which would make ptxas
//   serialise them), and the output columns past D are never stored.
//
// What is left: TMA copies and a producer warp (the paged rows are
// gathered page by page and Q's rows head by head, so one cp.async path
// serves both kernels here), pingpong of softmax and products between
// two warpgroups, and a split over keys for grids that do not fill the
// card (paged_prefill launches 32 blocks at the serving shapes).
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace repro_torch {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;       // query rows of one warpgroup
constexpr int kTileThreads = 128;   // one warpgroup

// orders this thread's shared-memory writes before later wgmma reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
// of `rows` rows (rows a multiple of 8).
__device__ __forceinline__ uint32_t sw128(int r, int c, int rows) {
  return static_cast<uint32_t>((c >> 3) * rows * 128 + r * 128 +
                               (((c & 7) ^ (r & 7)) << 4));
}
// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` rows of D bf16 values from src and src2 (row i at element
// offset row_offset(i), or zeros for -1) into the swizzled tiles at
// shared addresses dst and dst2, DP columns wide: columns D..DP-1 are
// zero-filled, so the products may run over all DP.
template <int DP, typename RowOffset>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src,
                                          uint32_t dst2, const bf16* src2,
                                          int rows, int D,
                                          RowOffset row_offset) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
  static_assert(kTileThreads % kChunks == 0, "one chunk column a thread");
  // each thread keeps one chunk column: one row offset a copy pair
  const int c = threadIdx.x % kChunks;
  const bool live_c = c * 8 < D;
  for (int r = threadIdx.x / kChunks; r < rows;
       r += kTileThreads / kChunks) {
    const long long off = live_c ? row_offset(r) : -1;
    const uint32_t at = sw128(r, c, rows);
    const long long e = off >= 0 ? off + c * 8 : 0;
    cp_async16(dst + at, src + e, off >= 0);
    if (src2 != nullptr) cp_async16(dst2 + at, src2 + e, off >= 0);
  }
}

// The query tile of block y of ny under the causal mask, where tile i
// walks about i + 1 key tiles: the first half of the blocks takes the
// heaviest tiles, heaviest first, the second half the lightest,
// lightest first.  The block scheduler hands out blocks in order, so a
// heavy block and a light one share an SM and the last wave is not one
// long block alone.
__device__ __forceinline__ int zigzag_tile(int y, int ny) {
  const int heavy = (ny + 1) / 2;
  return y < heavy ? ny - 1 - y : y - heavy;
}

// Shared memory of one block: 1024 bytes of alignment slack, Q, and
// STAGES (K, V) stages.  A caller's own data goes at kBytes.
template <int DP, int NK, int STAGES>
struct AttnTile {
  static_assert((DP == 64 || DP == 128 || DP == 256) &&
                    (NK == 32 || NK == 64),
                "tile shape");
  static constexpr int kQBytes = kTileRows * DP * 2;
  static constexpr int kKVBytes = NK * DP * 2;
  static constexpr int kBytes = 1024 + kQBytes + 2 * STAGES * kKVBytes;
};

// One block's attention over bf16 inputs.
//   q_row(r):  element offset in q of query row r (< 64), or -1 (zeros);
//   kv_row(k): element offset in k and v of key position k, or -1 past
//              the live range (zeros);
//   visible(r, k): whether row r may see key position k;
//   out_row(r): element offset in out of row r, or -1 (not written).
// Keys kfirst..klast are walked in tiles of NK; a tile inside
// [kfull_lo, kfull_hi] is seen whole by every written row and is not
// masked.  D is a multiple of 16, at most DP.
template <int DP, int NK, int STAGES, typename QRow, typename KVRow,
          typename Visible, typename OutRow>
__device__ __forceinline__ void attn_tile(
    uint8_t* smem, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int D, float scale,
    int kfirst, int klast, int kfull_lo, int kfull_hi, QRow q_row,
    KVRow kv_row, Visible visible, OutRow out_row) {
  using Tile = AttnTile<DP, NK, STAGES>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8, q4 = lane & 3;
  const int ntiles = klast >= kfirst ? (klast - kfirst) / NK + 1 : 0;

  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  auto k_s = [&](int s) {
    return q_s + Tile::kQBytes + s * 2 * Tile::kKVBytes;
  };
  auto load = [&](int t) {
    const int k0 = kfirst + t * NK, s = t % STAGES;
    copy_rows<DP>(k_s(s), k, k_s(s) + Tile::kKVBytes, v, NK, D,
              [&](int tt) { return kv_row(k0 + tt); });
  };

  copy_rows<DP>(q_s, q, 0u, nullptr, kTileRows, D, q_row);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load(t);
    cp_async_commit();
  }

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  // m: running row max of the raw scores; l: this thread's share of the
  // row sum (reduced across the row's four threads at the end)
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale_log2 = scale * 1.4426950408889634f;  // exp -> exp2
  // descriptors of the tiles' first k-step; a k-step adds a constant
  const uint64_t dq = sw128_desc(q_s, 16, 1024);

  for (int t = 0; t < ntiles; ++t) {
    if (t + STAGES - 1 < ntiles) load(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile t (and Q) have landed
    fence_async_smem();
    __syncthreads();
    const int k0 = kfirst + t * NK;
    const uint32_t ks = k_s(t % STAGES), vs = ks + Tile::kKVBytes;
    const uint64_t dk = sw128_desc(ks, 16, 1024);
    const uint64_t dv = sw128_desc(vs, NK * 128, 1024);

    // S = Q K^T
    float sc[NK / 2];
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      // k-step kk: 64-column block kk / 4, 32 bytes in per kk % 4
      const uint32_t col = kk >> 2, sub = (kk & 3) * 32;
      wgmma_ss<NK>(sc, dq + ((col * kTileRows * 128 + sub) >> 4),
                   dk + ((col * NK * 128 + sub) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on the fragment: sc[4n + e] is row (e < 2 ? r0 :
    // r1), key k0 + 8n + 2 * q4 + (e & 1)
    const bool masked = !(k0 >= kfull_lo && k0 + NK - 1 <= kfull_hi);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * n + e];
        if (masked && !visible(e < 2 ? r0 : r1, k0 + 8 * n + 2 * q4 + (e & 1)))
          x = kNegInf;
        sc[4 * n + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = fast_exp2((m0 - mx0) * scale_log2);
    const float a1 = fast_exp2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    // p = exp(scale * (s - m)) as one FMA and one exp2
    const float mb0 = -mx0 * scale_log2, mb1 = -mx1 * scale_log2;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[4 * n + e];
        const float p =
            masked && x == kNegInf
                ? 0.f
                : fast_exp2(fmaf(x, scale_log2, e < 2 ? mb0 : mb1));
        sc[4 * n + e] = p;
        if (e < 2) s0 += p; else s1 += p;
      }
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }

    // O += P V
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_rs<DP>(o, pa[kk], dv + ((kk * 16 * 128) >> 4));  // 16 keys on
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // the stage is free for the copy of tile t + STAGES
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long o0 = out_row(r0), o1 = out_row(r1);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int c = 8 * n + 2 * q4;
    if (c >= D) continue;
    if (o0 >= 0)
      *reinterpret_cast<__nv_bfloat162*>(out + o0 + c) =
          __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (o1 >= 0)
      *reinterpret_cast<__nv_bfloat162*>(out + o1 + c) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
}

// Whether the tensor-core tile takes these inputs: D a multiple of 16 at
// most 256, at most 64 query heads a KV head, 16-byte aligned rows.
inline bool tile_inputs_ok(const void* q, const void* k, const void* v,
                           const void* out, int D, int H, int Hkv) {
  return D > 0 && D % 16 == 0 && D <= 256 && H % Hkv == 0 &&
         H / Hkv <= kTileRows && vector_loads_ok<bf16>(k, v, D) &&
         vector_loads_ok<bf16>(q, out, D);
}

// Launch<DP, NK, STAGES>::run(args...) at the tile shape for head width
// D: D padded to DP, NK keys a tile, STAGES K/V stages.  At DP 256 a
// block takes 97 KB (Q 32 KB, two 32-key stages of 32 KB), so two blocks
// share an SM; smaller D keeps 64 keys a tile (81 KB at DP 128, 57 KB
// with three stages at DP 64).
template <template <int, int, int> class Launch, typename... Args>
int launch_tile(int D, Args... args) {
  if (D <= 64) return Launch<64, 64, 3>::run(args...);
  if (D <= 128) return Launch<128, 64, 2>::run(args...);
  return Launch<256, 32, 2>::run(args...);
}

}  // namespace repro_torch
