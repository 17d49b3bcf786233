// The float32 attention tile on Hopper's tensor cores, shared by
// flash_prefill.cu and paged_prefill.cu: attn_tile.cuh's float32 twin.
//
// Replaces, for float32 inputs, the CUDA-core bodies of those two
// kernels: K/V staged into float32 shared memory, S = QK^T and O += PV
// as 4 x 4 register micro-tiles of FMAs at the CUDA cores' 67 TFLOP/s,
// and an online softmax in three shared-memory passes.  At gemma3-4b's
// 2048-token prefill (D 256) that body ran at 135-148x its bound.
//
// Float32 on tensor cores: 3xTF32.  One TF32 product keeps 10 mantissa
// bits of each operand and misses the float32 tolerance (2e-5 / 3e-5;
// tests/test_torch_kernels.py holds an emulation of it to that).  Each
// float32 operand x is split in registers as its fragment is loaded:
// big = tf32(x), small = tf32(x - big), both rounded to nearest, ties
// away (cvt.rna's rounding), so x = big + small to ~21 bits.  A product a * b is taken as three TF32 products into one
// float32 accumulator, in CUTLASS FastF32's order: small(a) * big(b) and
// big(a) * small(b) first, then big(a) * big(b); small * small (~2^-22
// relative) is dropped.  At the 495 TFLOP/s of TF32 that is a float32
// rate of 165 TFLOP/s, against 67 on the CUDA cores; mma.sync, the form
// used here, reaches ~320 TFLOP/s of TF32 on an H100 (107 as 3xTF32;
// benchmarks/bench_torch_mma_rate.py).
//
// What bounds the work: 4 * D FLOPs per live (row, key) pair against one
// read of q, K, V and one write of the output.  flash_prefill at the slot
// prefill shapes is bound by the operations, paged_prefill at the
// serving shapes by the bytes (the .cu headers give the numbers).  On
// mma.sync the tile is bound by its issue slots: every TF32 product
// needs its operands split (five integer and float instructions an
// operand) and loaded, about seven instructions a product in all.
//
// Design.  A block is 8 warps (256 threads) that own 64 query rows; the
// caller folds the G query heads of a KV group into them (row r = g * QT
// + j), so all share each K/V tile.  Two warps share each 16 rows, each
// taking its own half of every key tile with its own online softmax
// (m, l, O), and the pair merges at the end through shared memory (one
// warp a 16 rows left an SM with one warp a scheduler at D 256, the
// products waiting on each other).
// - Products: mma.sync m16n8k8 TF32 (row.col), fp32 accumulators, issued
//   term by term across independent accumulators so that no product
//   waits on the one before it.  Each accumulator chain in the tensor
//   cores is short: S is summed in two partials (by k-step) of each 32
//   columns of D, and each key tile's PV in fresh accumulators (4 n-tiles
//   at a time at D 256, 8 below), added to O on the CUDA cores (o = o *
//   alpha + pv, one FMA, round to nearest): the long sums over D and over
//   keys are float32 sums.
// - P into the A fragment without shuffles: a thread's S accumulator
//   holds columns 2t and 2t + 1 of its n-tile (t = lane % 4, g = lane /
//   4), and the A fragment of PV takes columns t and t + 4.  PV sums
//   over keys, so the keys of each 8-key step are taken in the order
//   (0, 2, 4, 6, 1, 3, 5, 7): A's column t is key 2t and column t + 4
//   key 2t + 1, which is exactly what the S fragment holds, and V's B
//   fragment reads rows 2t and 2t + 1 to match.
// - The online softmax stays in float32 registers on the S fragment, as
//   on the bf16 tile: row max reduced over the quad with shuffles, the
//   row sum kept per thread and reduced once at the end, p = exp2f of
//   one FMA from the raw score (the scale folded into log2(e) * scale;
//   exp2f, at most 2 ulp, where the bf16 tile takes ex2.approx.ftz).
//   Invisible pairs are set to kNegInf before the max and p is masked to
//   exactly 0; l is clamped at 1e-30, so a row that sees no key (and a
//   padding row) writes zeros.  A key range that every written row sees
//   whole (kfull_lo..kfull_hi) skips the mask.
// - Copies: 16-byte cp.async into a ring of STAGES K/V stages; tile
//   t + STAGES - 1 is in flight while tile t is computed.  Q is copied
//   once, in the first group, and its fragments are read again from
//   shared memory for each key tile (at D 256 their big and small halves
//   would take 256 registers a thread beside O's 128, and split once
//   into shared memory they leave no room for two 32-key stages).  Rows
//   past the live range and columns past D are zero-filled by the copy
//   (src-size 0).
// - Layout: Q, K and V are stored row-major, D padded to DP (32, 64,
//   128 or 256) with zeros, at a row stride of DP + 4 floats (whole
//   16-byte rows, as cp.async needs).  DP + 4 is 4 modulo 32 banks, so
//   every fragment load of a warp hits 32 distinct banks:
//     Q (A of QK^T): Q[row g][d t]       bank 4g + t
//     K (B of QK^T): K[key g][d t]       bank 4g + t
//     V (B of PV):   V[key 2t][d g]      bank 8t + g (key 2t + 1: + 4)
// - Registers: O takes DP / 2 floats a thread (128 at D 256).  ptxas -v
//   (chip_smoke.py's build line) reports 0 spill bytes for all four
//   instantiations in both kernels, 255 registers at DP 256 (the QK^T
//   chunk loop is kept rolled: unrolled it spilled) and 128 at DP 64.
//
// Why not wgmma yet: wgmma's TF32 form takes only K-major operands from
// shared memory (and A from registers).  V is the B operand of PV with
// keys as its K dimension, so V would have to be stored transposed, and
// each B operand's big and small halves staged as two shared copies
// (the split cannot happen in registers for an operand read from shared
// memory).  At D 256 one 64-key float32 K tile is already 64 KB; two
// copies of K and V each leave no room for a second stage.  mma.sync
// reads its B fragments from registers, where the split is free of
// shared memory.
#pragma once

#include <type_traits>

#include "attn_tile.cuh"
#include "common.cuh"

namespace repro_torch {

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// half a TF32 ulp added to the magnitude's bits, then the low 13 bits
// cleared.  The same value as cvt.rna.tf32.f32 for every finite x, in
// two integer instructions; with cvt.rna, which also keeps a NaN a NaN,
// the tile ran 1.2x slower (f32_cvt in
// benchmarks/bench_torch_tile_variants.py).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x's first and second TF32 digits: x - big is exact in float32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a * b on one m16n8k8 tile, TF32 inputs, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d[j] += a * b[j] for N n-tiles, each in float32 as three TF32 products
// (a = ab + as, b = bb + bs), the small terms first.  Issued term by
// term across the N tiles, so that no mma waits on the one before it.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N][4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[N][2],
                                           const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], ab, bb[j]);
}

// Shared memory of one block: Q and STAGES (K, V) stages, rows of DP + 4
// floats.  A caller's own data goes at kBytes.  kKeyWarps warps share
// each 16 query rows, each taking its own NK / kKeyWarps keys of every
// key tile: 4 * kKeyWarps warps a block.
template <int DP, int NK, int STAGES>
struct AttnTileF32 {
  static_assert((DP == 32 || DP == 64 || DP == 128 || DP == 256) &&
                    (NK == 32 || NK == 64),
                "tile shape");
  static constexpr int kKeyWarps = 2;
  static constexpr int kThreads = kTileThreads * kKeyWarps;
  static constexpr int kStride = DP + 4;  // floats a row
  static constexpr int kQBytes = kTileRows * kStride * 4;
  static constexpr int kKVBytes = NK * kStride * 4;
  static constexpr int kBytes = kQBytes + 2 * STAGES * kKVBytes;
  // the merge of the key warps' (o, m, l) goes through the ring
  static constexpr int kMergeStride = DP / 2 + 4;  // floats a thread
  static_assert((kKeyWarps - 1) * kTileThreads * kMergeStride * 4 <=
                    2 * STAGES * kKVBytes,
                "merge fits the ring");
};

// The tile of element type T: its shared memory and threads a block
template <typename T, int DP, int NK, int STAGES>
struct TileOf;
template <int DP, int NK, int STAGES>
struct TileOf<bf16, DP, NK, STAGES> {
  static constexpr int kBytes = AttnTile<DP, NK, STAGES>::kBytes;
  static constexpr int kThreads = kTileThreads;
};
template <int DP, int NK, int STAGES>
struct TileOf<float, DP, NK, STAGES> : AttnTileF32<DP, NK, STAGES> {};

// Copy `rows` rows of D floats from src and src2 (row i at element
// offset row_offset(i), or zeros for -1) into dst and dst2 (shared
// addresses, rows DP + 4 floats apart), DP columns wide, by THREADS
// threads: columns D..DP-1 are zero-filled.
template <int DP, int THREADS, typename RowOffset>
__device__ __forceinline__ void copy_rows_f32(uint32_t dst, const float* src,
                                              uint32_t dst2,
                                              const float* src2, int rows,
                                              int D, RowOffset row_offset) {
  constexpr int kChunks = DP / 4;  // 16-byte chunks a row
  static_assert(THREADS % kChunks == 0, "one chunk column a thread");
  const int c = threadIdx.x % kChunks;
  const bool live_c = c * 4 < D;
  for (int r = threadIdx.x / kChunks; r < rows; r += THREADS / kChunks) {
    const long long off = live_c ? row_offset(r) : -1;
    const long long e = off >= 0 ? off + c * 4 : 0;
    const uint32_t at = (r * (DP + 4) + c * 4) * 4;
    cp_async16(dst + at, src + e, off >= 0);
    if (src2 != nullptr) cp_async16(dst2 + at, src2 + e, off >= 0);
  }
}

// One block's attention over float32 inputs: the float32 overload of
// attn_tile (attn_tile.cuh), with its arguments:
//   q_row(r):  element offset in q of query row r (< 64), or -1 (zeros);
//   kv_row(k): element offset in k and v of key position k, or -1 past
//              the live range (zeros);
//   visible(r, k): whether row r may see key position k;
//   out_row(r): element offset in out of row r, or -1 (not written).
// Keys kfirst..klast are walked in tiles of NK; a tile inside
// [kfull_lo, kfull_hi] is seen whole by every written row and is not
// masked.  D is a multiple of 8, at most DP.  The block has
// AttnTileF32's kThreads threads.
template <int DP, int NK, int STAGES, typename QRow, typename KVRow,
          typename Visible, typename OutRow>
__device__ __forceinline__ void attn_tile(
    uint8_t* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int D, float scale,
    int kfirst, int klast, int kfull_lo, int kfull_hi, QRow q_row,
    KVRow kv_row, Visible visible, OutRow out_row) {
  using Tile = AttnTileF32<DP, NK, STAGES>;
  constexpr int S = Tile::kStride, THREADS = Tile::kThreads;
  constexpr int KW = Tile::kKeyWarps, NW = NK / KW;
  // independent partial sums of S over a chunk of 32 columns of D (by
  // k-step): with NW / 8 n-tiles, 4 or more accumulators in flight
  constexpr int kParts = 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // rows r0 and r1 of row group rw; keys h * NW .. h * NW + NW - 1 of
  // each key tile
  const int rw = warp % 4, h = warp / 4;
  const int r0 = rw * 16 + g, r1 = r0 + 8;
  const int ntiles = klast >= kfirst ? (klast - kfirst) / NK + 1 : 0;

  float* q_s = reinterpret_cast<float*>(smem);
  auto k_s = [&](int s) { return q_s + kTileRows * S + s * 2 * NK * S; };
  auto load = [&](int i) {
    const int k0 = kfirst + i * NK;
    float* ks = k_s(i % STAGES);
    copy_rows_f32<DP, THREADS>(smem_u32(ks), k, smem_u32(ks + NK * S), v,
                               NK, D, [&](int tt) { return kv_row(k0 + tt); });
  };

  copy_rows_f32<DP, THREADS>(smem_u32(q_s), q, 0u, nullptr, kTileRows, D,
                             q_row);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load(i);
    cp_async_commit();
  }

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // m: running row max of the raw scores; l: this thread's share of the
  // row sum (reduced across the row's four threads at the end)
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale_log2 = scale * 1.4426950408889634f;  // exp -> exp2
  const float* qa = q_s + r0 * S + t;  // A fragment: (r0, t) of Q

  for (int it = 0; it < ntiles; ++it) {
    if (it + STAGES - 1 < ntiles) load(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile it (and Q) have landed
    __syncthreads();
    const int k0 = kfirst + it * NK + h * NW;  // this warp's first key
    const float* ks = k_s(it % STAGES) + h * NW * S;
    const float* vs = k_s(it % STAGES) + NK * S + h * NW * S;

    // S = Q K^T, in partial sums of 32 columns of D
    float sc[NW / 8][4];
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    // not unrolled: unrolled, DP 256 spills at 255 registers
#pragma unroll 1
    for (int c = 0; c < DP / 32; ++c) {
      float part[kParts][NW / 8][4];
#pragma unroll
      for (int i = 0; i < kParts; ++i)
#pragma unroll
        for (int n = 0; n < NW / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][n][e] = 0.f;
#pragma unroll
      for (int kk = 4 * c; kk < 4 * c + 4; ++kk) {
        // a: rows (r0, r1) x columns (8kk + t, 8kk + t + 4)
        uint32_t ab[4], as[4];
        split_tf32(qa[8 * kk], ab[0], as[0]);
        split_tf32(qa[8 * S + 8 * kk], ab[1], as[1]);
        split_tf32(qa[8 * kk + 4], ab[2], as[2]);
        split_tf32(qa[8 * S + 8 * kk + 4], ab[3], as[3]);
        uint32_t bb[NW / 8][2], bs[NW / 8][2];
#pragma unroll
        for (int n = 0; n < NW / 8; ++n) {
          // b: K[key 8n + g][d 8kk + t] and [d 8kk + t + 4]
          const float* kr = ks + (8 * n + g) * S + 8 * kk + t;
          split_tf32(kr[0], bb[n][0], bs[n][0]);
          split_tf32(kr[4], bb[n][1], bs[n][1]);
        }
        mma_3xtf32(part[kk % kParts], ab, as, bb, bs);
      }
#pragma unroll
      for (int i = 0; i < kParts; ++i)
#pragma unroll
        for (int n = 0; n < NW / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] += part[i][n][e];
    }

    // online softmax on the fragment: sc[n][e] is row (e < 2 ? r0 : r1),
    // key k0 + 8n + 2t + (e & 1)
    const bool masked = !(k0 >= kfull_lo && k0 + NW - 1 <= kfull_hi);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e];
        if (masked && !visible(e < 2 ? r0 : r1, k0 + 8 * n + 2 * t + (e & 1)))
          x = kNegInf;
        sc[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f((m0 - mx0) * scale_log2);
    const float a1 = exp2f((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    // p = exp(scale * (s - m)) as one FMA and one exp2f
    const float mb0 = -mx0 * scale_log2, mb1 = -mx1 * scale_log2;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < NW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        const float p = masked && x == kNegInf
                            ? 0.f
                            : exp2f(fmaf(x, scale_log2, e < 2 ? mb0 : mb1));
        sc[n][e] = p;
        if (e < 2) s0 += p; else s1 += p;
      }
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
    // P as the A fragment of 8-key step kk, keys in the order (0, 2, 4,
    // 6, 1, 3, 5, 7): (r0, 2t), (r1, 2t), (r0, 2t + 1), (r1, 2t + 1)
    uint32_t pb[NW / 8][4], ps[NW / 8][4];
#pragma unroll
    for (int kk = 0; kk < NW / 8; ++kk) {
      split_tf32(sc[kk][0], pb[kk][0], ps[kk][0]);
      split_tf32(sc[kk][2], pb[kk][1], ps[kk][1]);
      split_tf32(sc[kk][1], pb[kk][2], ps[kk][2]);
      split_tf32(sc[kk][3], pb[kk][3], ps[kk][3]);
    }

    // O = O * alpha + P V, NG n-tiles of 8 columns of D at a time (NG
    // independent accumulators; 4 at DP 256, where O holds 128 registers)
    constexpr int NG = DP == 256 ? 4 : (DP / 8 < 8 ? DP / 8 : 8);
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += NG) {
      float pv[NG][4];
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NW / 8; ++kk) {
        // b: V[key 8kk + 2t][d 8n + g] and V[key 8kk + 2t + 1][d 8n + g]
        uint32_t bb[NG][2], bs[NG][2];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const float* vr = vs + (8 * kk + 2 * t) * S + 8 * (n0 + j) + g;
          split_tf32(vr[0], bb[j][0], bs[j][0]);
          split_tf32(vr[S], bb[j][1], bs[j][1]);
        }
        mma_3xtf32(pv, pb[kk], ps[kk], bb, bs);
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        o[n0 + j][0] = fmaf(o[n0 + j][0], a0, pv[j][0]);
        o[n0 + j][1] = fmaf(o[n0 + j][1], a0, pv[j][1]);
        o[n0 + j][2] = fmaf(o[n0 + j][2], a1, pv[j][2]);
        o[n0 + j][3] = fmaf(o[n0 + j][3], a1, pv[j][3]);
      }
    }
    __syncthreads();  // the stage is free for the copy of tile it + STAGES
  }
  cp_async_wait<0>();

  if (KW > 1) {
    // merge the key warps' (o, m, l) into warp h = 0 of each row group,
    // through the ring (free now): DP / 2 + 4 floats a thread
    auto slot = [&](int hh) {
      return k_s(0) +
             ((hh - 1) * kTileThreads + rw * 32 + lane) * Tile::kMergeStride;
    };
    __syncthreads();
    if (h > 0) {
      float* xs = slot(h);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[4 * n + e] = o[n][e];
      xs[DP / 2] = m0;
      xs[DP / 2 + 1] = m1;
      xs[DP / 2 + 2] = l0;
      xs[DP / 2 + 3] = l1;
    }
    __syncthreads();
    if (h > 0) return;
    for (int p = 1; p < KW; ++p) {
      const float* x = slot(p);
      const float pm0 = x[DP / 2], pm1 = x[DP / 2 + 1];
      const float mx0 = fmaxf(m0, pm0), mx1 = fmaxf(m1, pm1);
      const float a0 = exp2f((m0 - mx0) * scale_log2);
      const float a1 = exp2f((m1 - mx1) * scale_log2);
      const float b0 = exp2f((pm0 - mx0) * scale_log2);
      const float b1 = exp2f((pm1 - mx1) * scale_log2);
      l0 = l0 * a0 + x[DP / 2 + 2] * b0;
      l1 = l1 * a1 + x[DP / 2 + 3] * b1;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][0] = fmaf(o[n][0], a0, x[4 * n] * b0);
        o[n][1] = fmaf(o[n][1], a0, x[4 * n + 1] * b0);
        o[n][2] = fmaf(o[n][2], a1, x[4 * n + 2] * b1);
        o[n][3] = fmaf(o[n][3], a1, x[4 * n + 3] * b1);
      }
      m0 = mx0;
      m1 = mx1;
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long o0 = out_row(r0), o1 = out_row(r1);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (c >= D) continue;
    if (o0 >= 0)
      *reinterpret_cast<float2*>(out + o0 + c) =
          make_float2(o[n][0] * inv0, o[n][1] * inv0);
    if (o1 >= 0)
      *reinterpret_cast<float2*>(out + o1 + c) =
          make_float2(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// Whether the float32 tile takes these inputs: D a multiple of 8 at most
// 256, at most 64 query heads a KV head, 16-byte aligned rows.
inline bool tile_f32_inputs_ok(const void* q, const void* k, const void* v,
                               const void* out, int D, int H, int Hkv) {
  return D > 0 && D % 8 == 0 && D <= 256 && H % Hkv == 0 &&
         H / Hkv <= kTileRows && vector_loads_ok<float>(k, v, D) &&
         vector_loads_ok<float>(q, out, D);
}

// Launch<DP, NK, STAGES>::run(args...) at the float32 tile shape for
// head width D: D padded to DP, NK keys a tile, STAGES K/V stages.  A
// 256-thread block takes 64.5 KB at DP 32 (three 64-key stages), 85 KB
// at DP 64 (two 64-key stages), 99 KB at DP 128 (two 32-key stages) and
// 195 KB at DP 256 (Q 65 KB, two 32-key stages of 65 KB).  Two blocks
// share an SM at DP 32 and 64 (at most 128 registers a thread), one at
// DP 128 (~200 registers) and 256.
template <template <int, int, int> class Launch, typename... Args>
int launch_tile_f32(int D, Args... args) {
  if (D <= 32) return Launch<32, 64, 3>::run(args...);
  if (D <= 64) return Launch<64, 64, 2>::run(args...);
  if (D <= 128) return Launch<128, 32, 2>::run(args...);
  return Launch<256, 32, 2>::run(args...);
}

}  // namespace repro_torch
