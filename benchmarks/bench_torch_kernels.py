#!/usr/bin/env python3
"""Kernel microbenchmarks of the PyTorch port on one NVIDIA card: each
hand-written CUDA kernel against its plain PyTorch version, us/call.

The twin of ``benchmarks/bench_kernels.py``: the same rows, name for
name (``paged_attn_b{b}h{h}d{d}``, ``flash_prefill_b{b}s{s}h{h}``,
``paged_prefill_b{b}ctx{ctx}s{s}h{h}d{d}``), the same shapes, float32
inputs drawn from a seeded generator, and the same
``name,us_per_call,ref_us=...;max_err=...`` lines, where ``ref_us`` is
the plain version's time and ``max_err`` the largest absolute
difference between the two outputs.  Times are CUDA-event times of 50
calls after 5 warm-up calls.  The first line names the card and its
power limit.

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit (the kernels are built from ``src/repro_torch/kernels/csrc``
at first use):

    python3 benchmarks/bench_torch_kernels.py

Without a CUDA device it exits non-zero and prints no row.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ITERS, WARMUP = 50, 5


def _time_us(torch, fn):
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS * 1e3


def _row(torch, name, kernel, plain, speedup=False):
    t_k, t_r = _time_us(torch, kernel), _time_us(torch, plain)
    err = float((kernel() - plain()).abs().max())
    extra = f";speedup={t_r / t_k:.2f}x" if speedup else ""
    print(f"{name},{t_k:.1f},ref_us={t_r:.1f}{extra};max_err={err:.1e}",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# {card}")
    print("name,us_per_call,derived")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    def full(b, v):
        return torch.full((b,), v, device="cuda", dtype=torch.int32)

    for (b, h, hkv, d, page, nb) in [(4, 8, 4, 64, 16, 8),
                                     (8, 16, 8, 128, 16, 16)]:
        p = b * nb + 1
        q, kp, vp = normal(b, h, d), normal(p, page, hkv, d), normal(
            p, page, hkv, d)
        bt, ln = ints(p, b, nb), full(b, nb * page)
        _row(
            torch, f"paged_attn_b{b}h{h}d{d}",
            lambda: ops.paged_attention(q, kp, vp, bt, ln),
            lambda: ops.paged_attention(q, kp, vp, bt, ln, impl="ref"))
    for (b, s, h, hkv, d) in [(2, 256, 8, 4, 64), (1, 1024, 8, 2, 128)]:
        q, k, v = normal(b, s, h, d), normal(b, s, hkv, d), normal(
            b, s, hkv, d)
        ln = full(b, s)
        _row(
            torch, f"flash_prefill_b{b}s{s}h{h}",
            lambda: ops.flash_attention(q, k, v, ln),
            lambda: ops.flash_attention(q, k, v, ln, impl="ref"))
    for (b, ctx, s, h, hkv, d, page) in [(1, 0, 1024, 8, 2, 128, 64),
                                         (1, 512, 512, 8, 2, 128, 64)]:
        nb = (ctx + s) // page
        p = nb + 2
        q, kp, vp = normal(b, s, h, d), normal(p, page, hkv, d), normal(
            p, page, hkv, d)
        bt = torch.randperm(p, generator=gen, device="cuda")[:b * nb] \
            .reshape(b, nb).to(torch.int32)
        cx, cl = full(b, ctx), full(b, s)
        _row(
            torch, f"paged_prefill_b{b}ctx{ctx}s{s}h{h}d{d}",
            lambda: ops.paged_prefill(q, kp, vp, bt, cx, cl),
            lambda: ops.paged_prefill(q, kp, vp, bt, cx, cl, impl="ref"),
            speedup=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
