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
// q, K, V and one write of the output.  At the slot prefill shapes (Sq =
// Sk = 2048, G = 2, D = 256) that is ~500-700 FLOP per byte in bf16 and
// half that in float32, far above the ~295 (bf16, 989 TFLOP/s) and ~49
// (float32 as 3xTF32, 165 TFLOP/s) at which the products outrun the
// 3.35 TB/s: the least time is set by the operations.  gemma3-4b without
// a window: 17.2 GFLOP, 0.0174 ms in bf16 and 0.104 ms in float32; with
// the 1024 window about 0.013 and 0.078 ms.
//
// Two kernels over one block body (flash_prefill_block), both on
// Hopper's tensor cores, each through the tile of its dtype:
// - bf16, flash_prefill_kernel_tc: attn_tile.cuh (wgmma QK^T and PV, the
//   online softmax in registers, a cp.async ring of K/V stages; its
//   header says how).  It replaced a CUDA-core body, which ran at
//   135-148x the bound and 11-49x slower than SDPA.  At D 256 a block
//   takes 97 KB (32-key stages), so two blocks share an SM.  Takes D a
//   multiple of 16, at most 256.  On an H100 80GB HBM3 at 700 W
//   (chip_smoke.py's timing phase, B 1, S 2048, H 8, Hkv 4, D 256) it
//   takes 0.061 ms with the window 1024 and 0.089 ms without, against
//   1.755 and 2.580 ms for the CUDA-core body and 0.156 and 0.053 ms for
//   SDPA: ~200 TFLOP/s on the live pairs, 4.7-5.1x the bound.  A variant
//   that skips the K/V copies runs 1.3-1.5x faster
//   (benchmarks/bench_torch_tile_variants.py): the copies, not the
//   products, are what is left.
// - float32, flash_prefill_kernel_f32: attn_tile_f32.cuh (mma.sync
//   m16n8k8 TF32 with each float32 product taken as three TF32 products,
//   3xTF32, which keeps the float32 tolerance of 2e-5/3e-5; the online
//   softmax in float32 registers; 8 warps a block, two on each 16 rows
//   splitting the key tiles).  It replaces the same CUDA-core body,
//   which float32 ran until then.  At D 256 a block takes 195 KB
//   (32-key stages): one an SM.  Takes D a multiple of 8, at most 256.
//   On the same card and shapes it takes 0.48 device ms with the window
//   and 0.61 without, against 1.59 and 2.31 for the CUDA-core body and
//   1.06 and 0.59 for SDPA's memory-efficient backend (3xTF32 too):
//   6.2x and 5.8x its bound at 165 TFLOP/s, ~28% of what mma.sync's
//   TF32 rate allows.  Its issue slots bound it (attn_tile_f32.cuh).
//
// One block per (KV head, tile of QT query positions, sequence), with the
// G query heads of the KV group folded into the rows (R = G * QT) so that
// they share each staged K/V tile, as on the TPU.  The TPU walks the key
// blocks as a sequential grid dimension with a VMEM accumulator and skips
// dead blocks with `pl.when`; here the tile walks key tiles from the
// first key the window leaves alive, max(0, q_lo - window + 1), to the
// last the causal limit and the length allow, min(q_hi, lengths[b] - 1),
// so no dead key is ever loaded: an SWA layer reads about window + QT
// keys per tile whatever the sequence length.  A tile that straddles the
// diagonal or the window edge is masked inside.  The kernel masks the
// ragged Sq and Sk edges itself; nothing is padded.  The causal tiles
// are unequal (the last query tile walks every key tile, the first one),
// so the grid pairs heavy and light tiles (zigzag_tile, attn_tile.cuh):
// the first half of the blocks takes the heaviest first, the second half
// the lightest first.
//
// What is left: TMA copies, a producer warp, pingpong between two
// warpgroups, and a split over keys for short grids.
#include "attn_tile.cuh"
#include "attn_tile_f32.cuh"
#include "common.cuh"

namespace {

using namespace repro_torch;

// One block's rows, keys and visibility, on the tile of T (bf16 or
// float) and its shared memory
template <typename T, int DP, int NK, int STAGES>
__device__ __forceinline__ void flash_prefill_block(
    uint8_t* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ out, int Sq, int Sk, int H, int Hkv, int D, int QT,
    int window, int q_offset, float scale) {
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
  attn_tile<DP, NK, STAGES>(
      smem, q, k, v, out, D, scale, kfirst, klast, kfull_lo, kfull_hi, row,
      [&](int kpos) -> long long {
        if (kpos > klast) return -1;
        return (((long long)b * Sk + kpos) * Hkv + hk) * D;
      },
      visible, row);
}

// The bf16 kernel: one warpgroup a block on the wgmma tile
template <int DP, int NK, int STAGES>
__global__ void __launch_bounds__(kTileThreads)
    flash_prefill_kernel_tc(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int* __restrict__ lengths,
                            bf16* __restrict__ out, int Sq, int Sk, int H,
                            int Hkv, int D, int QT, int window, int q_offset,
                            float scale) {
  extern __shared__ uint8_t tc_smem[];
  flash_prefill_block<bf16, DP, NK, STAGES>(tc_smem, q, k, v, lengths, out,
                                            Sq, Sk, H, Hkv, D, QT, window,
                                            q_offset, scale);
}

// The float32 kernel: 8 warps a block on the 3xTF32 tile; at DP <= 64
// held to 128 registers a thread, so that two blocks share an SM
template <int DP, int NK, int STAGES,
          int THREADS = AttnTileF32<DP, NK, STAGES>::kThreads>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 2 : 1)
    flash_prefill_kernel_f32(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const int* __restrict__ lengths,
                             float* __restrict__ out, int Sq, int Sk, int H,
                             int Hkv, int D, int QT, int window, int q_offset,
                             float scale) {
  extern __shared__ __align__(16) uint8_t f32_smem[];
  flash_prefill_block<float, DP, NK, STAGES>(f32_smem, q, k, v, lengths, out,
                                             Sq, Sk, H, Hkv, D, QT, window,
                                             q_offset, scale);
}

template <typename T>
struct LaunchTc {
  template <int DP, int NK, int STAGES>
  struct At {
    static int run(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int Sq, int Sk,
                   int H, int Hkv, int D, int window, int q_offset,
                   float scale, cudaStream_t stream) {
      using Tile = TileOf<T, DP, NK, STAGES>;
      const auto kernel = [] {
        if constexpr (std::is_same<T, float>::value)
          return flash_prefill_kernel_f32<DP, NK, STAGES>;
        else
          return flash_prefill_kernel_tc<DP, NK, STAGES>;
      }();
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kBytes);
      if (err != cudaSuccess) return (int)err;
      const int qt = kTileRows / (H / Hkv);
      const dim3 grid(Hkv, (Sq + qt - 1) / qt, B);
      kernel<<<grid, Tile::kThreads, Tile::kBytes, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)lengths,
          (T*)out, Sq, Sk, H, Hkv, D, qt, window, q_offset, scale);
      return (int)cudaGetLastError();
    }
  };
};

}  // namespace

// q (B, Sq, H, D); k, v (B, Sk, Hkv, D); lengths (B,) int32; out (B, Sq,
// H, D).  All contiguous, on the device, 16-byte aligned; D at most 256,
// a multiple of 8 for float32 and of 16 for bfloat16; at most 64 query
// heads a KV head.  window 0 means no window.  dtype: 0 = float32, 1 =
// bfloat16.  Returns a cudaError_t.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int Sq, int Sk, int H,
                                    int Hkv, int D, int window, int q_offset,
                                    float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return tile_f32_inputs_ok(q, k, v, out, D, H, Hkv)
               ? launch_tile_f32<LaunchTc<float>::At>(
                     D, q, k, v, lengths, out, B, Sq, Sk, H, Hkv, D, window,
                     q_offset, scale, s)
               : (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return tile_inputs_ok(q, k, v, out, D, H, Hkv)
               ? launch_tile<LaunchTc<bf16>::At>(
                     D, q, k, v, lengths, out, B, Sq, Sk, H, Hkv, D, window,
                     q_offset, scale, s)
               : (int)cudaErrorInvalidValue;
  return (int)cudaErrorInvalidValue;
}
