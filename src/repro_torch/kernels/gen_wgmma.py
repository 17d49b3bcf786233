"""Write ``csrc/wgmma.cuh``: the inline-PTX wrappers of the Hopper
``wgmma.mma_async`` shapes that ``csrc/attn_tile.cuh`` runs.

A ``wgmma`` names every accumulator register as an operand, up to 128
of them for N = 256, so the wrappers are generated rather than typed:

    python3 src/repro_torch/kernels/gen_wgmma.py

rewrites the header.  Two forms, both bf16 inputs with float32
accumulators, m64nNk16:
- ``wgmma_ss<N>``: A and B from shared memory (descriptors), both
  K-major.
- ``wgmma_rs<N>``: A from registers (four 32-bit registers of bf16
  pairs a thread), B from shared memory MN-major (transposed).

Both add to the accumulators.
"""
from __future__ import annotations

import pathlib

OUT = pathlib.Path(__file__).resolve().parent / "csrc" / "wgmma.cuh"
SS_WIDTHS = (32, 64)
RS_WIDTHS = (64, 128, 256)

HEADER = """\
// Generated by src/repro_torch/kernels/gen_wgmma.py; edit that script,
// not this file.  Inline-PTX wrappers of wgmma.mma_async m64nNk16 with
// bf16 inputs and float32 accumulators, for sm_90a.
#pragma once

#include <cstdint>

namespace repro_torch {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator
// across the start of a wgmma or the wait for it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t desc_b);
"""

FOOTER = """
}  // namespace repro_torch
"""


def _regs(n: int) -> str:
    return ", ".join(f"%{i}" for i in range(n))


def _outs(n: int) -> str:
    return ",\n        ".join(
        ", ".join(f'"+f"(d[{i + j}])' for j in range(min(4, n - i)))
        for i in range(0, n, 4))


def ss(width: int) -> str:
    n = width // 2
    return f"""
template <>
__device__ __forceinline__ void wgmma_ss<{width}>(float (&d)[{n}],
                                              uint64_t desc_a,
                                              uint64_t desc_b) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{width}k16.f32.bf16.bf16 "
      "{{{_regs(n)}}}, "
      "%{n}, %{n + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {_outs(n)}
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}}
"""


def rs(width: int) -> str:
    n = width // 2
    return f"""
template <>
__device__ __forceinline__ void wgmma_rs<{width}>(float (&d)[{n}],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{width}k16.f32.bf16.bf16 "
      "{{{_regs(n)}}}, "
      "{{%{n}, %{n + 1}, %{n + 2}, %{n + 3}}}, %{n + 4}, p, 1, 1, 1;\\n}}\\n"
      : {_outs(n)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}}
"""


def render() -> str:
    return (HEADER + "".join(ss(w) for w in SS_WIDTHS)
            + "".join(rs(w) for w in RS_WIDTHS) + FOOTER)


if __name__ == "__main__":
    OUT.write_text(render())
