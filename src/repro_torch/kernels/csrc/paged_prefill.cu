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
// What bounds it: each live (row, key) pair costs 4 * D FLOPs (QK^T and
// PV), against one read of q and of the live K/V and one write of out.
// At the serving shape (two chunks of 64 at contexts 0 and 704, H 16,
// Hkv 8, D 64) that is 0.20 GFLOP against 2.2 MB in bf16 and 4.5 MB in
// float32.  bf16: the bytes bound it, 0.000665 ms at 3.35 TB/s (the
// operations take 0.0002 ms at 989 TFLOP/s).  float32: the bytes, 0.00133
// ms, and the operations at 165 TFLOP/s (3xTF32, below), 0.00122 ms, are
// about equal.
//
// Two kernels over one block body (paged_prefill_block), both on
// Hopper's tensor cores, each through the tile of its dtype:
// - bf16, paged_prefill_kernel_tc: attn_tile.cuh (wgmma QK^T and PV, the
//   online softmax in registers, a cp.async ring of K/V stages; its
//   header says how).  It replaced a CUDA-core body, whose products, not
//   its loads, set its time (2.6x slower than SDPA).  Takes D a multiple
//   of 16, at most 256.  On an H100 80GB HBM3 at 700 W it runs a mixed
//   step's 28 launches (chunks of 64 and 37) in 0.51 ms of device time,
//   against 3.48 ms for the CUDA-core body (chip_smoke.py's profile
//   phase).
// - float32, paged_prefill_kernel_f32: attn_tile_f32.cuh (mma.sync
//   m16n8k8 TF32 with each float32 product taken as three TF32 products,
//   3xTF32, which keeps the float32 tolerance; the online softmax in
//   float32 registers; 8 warps a block, two on each 16 rows splitting the
//   key tiles).  It replaces the same CUDA-core body, which float32 ran
//   until then.  Takes D a multiple of 8, at most 256.  On an H100 80GB
//   HBM3 at 700 W (chip_smoke.py, B 2, chunks of 64 at contexts 0 and
//   704, H 16, Hkv 8, D 64) it takes 0.062 device ms against 0.182 for
//   the CUDA-core body and 0.13 ms for SDPA's memory-efficient backend;
//   a float32 mixed step's 28 launches 1.52 ms against 3.53.  Its 32
//   blocks walk up to 12 key tiles each in turn: latency, not the bytes
//   (0.0013 ms), sets its time.
// On the tensor cores the products of a key tile take less time than its
// copy, so the design's answer to the bytes is the cp.async ring: the
// next K/V tiles are in flight while a tile is computed.
//
// One block per (KV head, tile of QT chunk rows, request).  The TPU
// kernel walks page pairs as a sequential grid dimension with a VMEM
// accumulator; here the tile walks key tiles from 0 to the last key
// that the block's causal limit allows (ctx + last valid row), so pages
// past the diagonal or past the live context are never read, and a tile
// of padding rows reads nothing and writes zeros.  The page ids are
// staged once in shared memory; key rows are gathered row by row through
// them.  GQA is folded into the rows, as on the TPU: the G query heads
// of the KV group share each staged K/V tile (R = G * QT rows).  The
// query tiles are ordered by zigzag_tile (attn_tile.cuh).
//
// What is left: TMA copies, a producer warp, pingpong between two
// warpgroups, and a split over keys: at the serving shapes the grid is
// 32 blocks on 132 SMs, each walking at most 12 key tiles.
#include "attn_tile.cuh"
#include "attn_tile_f32.cuh"
#include "common.cuh"

namespace {

using namespace repro_torch;

// One block's rows, keys and visibility, on the tile of T (bf16 or
// float) and its shared memory
template <typename T, int DP, int NK, int STAGES>
__device__ __forceinline__ void paged_prefill_block(
    uint8_t* smem, const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ ctx_lens, const int* __restrict__ chunk_lens,
    T* __restrict__ out, int S, int H, int Hkv, int D, int page, int NB,
    int QT, float scale) {
  const int hk = blockIdx.x, b = blockIdx.z;
  const int q0 = zigzag_tile(blockIdx.y, gridDim.y) * QT;
  const int G = H / Hkv, R = G * QT;
  const int ctx = ctx_lens[b];
  const int total = ctx + chunk_lens[b];
  const int nrows = min(QT, S - q0);  // rows of this tile that exist
  const int nvalid = max(0, min(nrows, chunk_lens[b] - q0));
  // keys past the tile's last valid query position are never needed
  const int klast = nvalid > 0 ? ctx + q0 + nvalid - 1 : -1;
  const int npages = min((klast + page) / page, NB);
  // every written row sees keys 0 .. ctx + q0, unless some are padding
  const int kfull_hi = nvalid == nrows ? min(ctx + q0, total - 1) : -1;
  using Tile = TileOf<T, DP, NK, STAGES>;
  int* pid_s = reinterpret_cast<int*>(smem + Tile::kBytes);
  for (int i = threadIdx.x; i < npages; i += Tile::kThreads)
    pid_s[i] = block_tables[(size_t)b * NB + i];
  __syncthreads();
  // element offset of row r (= g * QT + j) in q and out, or -1
  auto row = [&](int r) -> long long {
    const int g = r / QT, j = r - g * QT;
    if (r >= R || j >= nrows) return -1;
    return (((long long)b * S + q0 + j) * H + (long long)hk * G + g) * D;
  };
  attn_tile<DP, NK, STAGES>(
      smem, q, k_pages, v_pages, out, D, scale, 0, klast, 0, kfull_hi, row,
      [&](int kpos) -> long long {
        const int i = kpos / page;
        if (kpos > klast || i >= npages) return -1;
        return (((long long)pid_s[i] * page + kpos - i * page) * Hkv + hk) *
               D;
      },
      [&](int r, int kpos) {
        const int j = r % QT;
        return r < R && j < nvalid && kpos <= ctx + q0 + j && kpos < total;
      },
      row);
}

// The bf16 kernel: one warpgroup a block on the wgmma tile
template <int DP, int NK, int STAGES>
__global__ void __launch_bounds__(kTileThreads)
    paged_prefill_kernel_tc(const bf16* __restrict__ q,
                            const bf16* __restrict__ k_pages,
                            const bf16* __restrict__ v_pages,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ ctx_lens,
                            const int* __restrict__ chunk_lens,
                            bf16* __restrict__ out, int S, int H, int Hkv,
                            int D, int page, int NB, int QT, float scale) {
  extern __shared__ uint8_t tc_smem[];
  paged_prefill_block<bf16, DP, NK, STAGES>(
      tc_smem, q, k_pages, v_pages, block_tables, ctx_lens, chunk_lens, out,
      S, H, Hkv, D, page, NB, QT, scale);
}

// The float32 kernel: 8 warps a block on the 3xTF32 tile; at DP <= 64
// held to 128 registers a thread, so that two blocks share an SM
template <int DP, int NK, int STAGES,
          int THREADS = AttnTileF32<DP, NK, STAGES>::kThreads>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 2 : 1)
    paged_prefill_kernel_f32(const float* __restrict__ q,
                             const float* __restrict__ k_pages,
                             const float* __restrict__ v_pages,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ ctx_lens,
                             const int* __restrict__ chunk_lens,
                             float* __restrict__ out, int S, int H, int Hkv,
                             int D, int page, int NB, int QT, float scale) {
  extern __shared__ __align__(16) uint8_t f32_smem[];
  paged_prefill_block<float, DP, NK, STAGES>(
      f32_smem, q, k_pages, v_pages, block_tables, ctx_lens, chunk_lens,
      out, S, H, Hkv, D, page, NB, QT, scale);
}

template <typename T>
struct LaunchTc {
  template <int DP, int NK, int STAGES>
  struct At {
    static int run(const void* q, const void* k, const void* v,
                   const void* bt, const void* ctx, const void* chunk,
                   void* out, int B, int S, int H, int Hkv, int D, int page,
                   int NB, float scale, cudaStream_t stream) {
      using Tile = TileOf<T, DP, NK, STAGES>;
      const auto kernel = [] {
        if constexpr (std::is_same<T, float>::value)
          return paged_prefill_kernel_f32<DP, NK, STAGES>;
        else
          return paged_prefill_kernel_tc<DP, NK, STAGES>;
      }();
      const size_t smem = Tile::kBytes + sizeof(int) * (size_t)NB;
      if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      const int qt = kTileRows / (H / Hkv);
      const dim3 grid(Hkv, (S + qt - 1) / qt, B);
      kernel<<<grid, Tile::kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)bt,
          (const int*)ctx, (const int*)chunk, (T*)out, S, H, Hkv, D, page,
          NB, qt, scale);
      return (int)cudaGetLastError();
    }
  };
};

}  // namespace

// q (B, S, H, D); k_pages, v_pages (P, page, Hkv, D); block_tables
// (B, NB) int32; ctx_lens, chunk_lens (B,) int32; out (B, S, H, D).  All
// contiguous, on the device, 16-byte aligned; D at most 256, a multiple
// of 8 for float32 and of 16 for bfloat16; at most 64 query heads a KV
// head.  dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
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
    return tile_f32_inputs_ok(q, k_pages, v_pages, out, D, H, Hkv)
               ? launch_tile_f32<LaunchTc<float>::At>(
                     D, q, k_pages, v_pages, block_tables, ctx_lens,
                     chunk_lens, out, B, S, H, Hkv, D, page, NB, scale, s)
               : (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return tile_inputs_ok(q, k_pages, v_pages, out, D, H, Hkv)
               ? launch_tile<LaunchTc<bf16>::At>(
                     D, q, k_pages, v_pages, block_tables, ctx_lens,
                     chunk_lens, out, B, S, H, Hkv, D, page, NB, scale, s)
               : (int)cudaErrorInvalidValue;
  return (int)cudaErrorInvalidValue;
}
