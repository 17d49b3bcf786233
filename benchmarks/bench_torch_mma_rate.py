#!/usr/bin/env python3
"""Measure the rate of Hopper's ``mma.sync`` TF32 product on one NVIDIA
card: the ceiling of the float32 prefill tile (``attn_tile_f32.cuh``),
which takes each float32 product as three of them (3xTF32).

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit:

    python3 benchmarks/bench_torch_mma_rate.py

Builds a small kernel with ``nvcc`` into ``build/mma_rate/``: every warp
of a full grid issues ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``
on CHAINS independent accumulators in a loop, operands in registers (no
memory traffic).  Prints one JSON line per CHAINS (1 to 16, with 4 or 8
warps a block) with the TF32 TFLOP/s, the float32 rate as 3xTF32 (a third
of it) and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mma_rate"
SOURCE = r"""
#include <cstdint>
template <int CHAINS>
__global__ void mma_rate_kernel(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed + threadIdx.x * 7 + i) & 0x3f800000u;
  for (int i = 0; i < 2; ++i) b[i] = (seed + threadIdx.x * 3 + i) & 0x3f800000u;
  float d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int CHAINS>
int run(float* out, int blocks, int threads, int iters) {
  mma_rate_kernel<CHAINS><<<blocks, threads>>>(out, iters, 0x3f800000u);
  return (int)cudaGetLastError();
}
extern "C" int mma_rate_launch(void* out, int blocks, int threads,
                               int iters, int chains) {
  float* o = (float*)out;
  switch (chains) {
    case 1: return run<1>(o, blocks, threads, iters);
    case 2: return run<2>(o, blocks, threads, iters);
    case 4: return run<4>(o, blocks, threads, iters);
    case 8: return run<8>(o, blocks, threads, iters);
    case 16: return run<16>(o, blocks, threads, iters);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_mma_rate: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "mma_rate.cu").write_text(SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(OUT / "mma_rate.so"), str(OUT / "mma_rate.cu")],
                   check=True)
    fn = ctypes.CDLL(str(OUT / "mma_rate.so")).mma_rate_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for warps in (4, 8):
        for chains in (1, 2, 4, 8, 16):
            blocks, threads = sms * 8, 32 * warps
            out = torch.empty(blocks * threads, device="cuda")
            for _ in range(2):
                if fn(out.data_ptr(), blocks, threads, iters, chains):
                    raise RuntimeError("mma_rate launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(out.data_ptr(), blocks, threads, iters, chains)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            flop = 2 * 16 * 8 * 8 * chains * iters * blocks * warps
            tflops = flop / ms / 1e9
            print(json.dumps(dict(warps_a_block=warps, chains=chains,
                                  blocks=blocks, ms=ms,
                                  tf32_tflops=tflops,
                                  f32_3xtf32_tflops=tflops / 3,
                                  card=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
