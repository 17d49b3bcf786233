#!/usr/bin/env python3
"""The paged step's fused elementwise kernels on one NVIDIA card, each
against the plain PyTorch composition it replaced, at the benchmark
cell's shapes (deepseek-coder-6.7b's mixed step: T 2,112 rows, d 4,096,
H = Hkv 32, D 128, F 11,008; 65% of the rows valid, their K/V slots in
distinct pages).

One line a kernel and dtype:
``name,us_per_call,ref_us=...;bound_us=...;roofline_pct=...;max_err=...``
where ``ref_us`` is the plain composition's time, ``bound_us`` the bytes
the kernel must move (each input read once, each output written once)
over 3.35 TB/s, and ``roofline_pct`` the bound over the kernel's time.
Times are CUDA-event times of 50 calls after 5 warm-up calls.  The first
line names the card and its power limit.

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit (the kernels are built at first use):

    python3 benchmarks/bench_torch_fused.py

Without a CUDA device it exits non-zero and prints no row.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ITERS, WARMUP = 50, 5
HBM_BYTES_PER_S = 3.35e12
T, D_MODEL, H, HKV, D, F = 2112, 4096, 32, 32, 128, 11008
PAGE, VALID = 16, 0.65


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


def _row(torch, name, kernel, plain, nbytes, err):
    t_k, t_r = _time_us(torch, kernel), _time_us(torch, plain)
    bound = nbytes / HBM_BYTES_PER_S * 1e6
    print(f"{name},{t_k:.1f},ref_us={t_r:.1f};bound_us={bound:.1f};"
          f"roofline_pct={100 * bound / t_k:.1f};max_err={err:.1e}",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_fused: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import fused_elementwise as fe
    from repro_torch.kernels import ref
    from repro_torch.models import layers

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# {smi}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev = "cuda"
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dtype).element_size()
        tag = "bf16" if dtype == torch.bfloat16 else "f32"

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).to(dtype)
        x, delta, scale = rand(1, T, D_MODEL), rand(1, T, D_MODEL), \
            rand(D_MODEL, scale=0.1)
        got, want = fe.add_rms_norm(x, delta, scale, 1e-6), \
            ref.add_rms_norm_ref(x, delta, scale, 1e-6)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        _row(torch, f"add_rms_norm_{tag}_t{T}d{D_MODEL}",
             lambda: fe.add_rms_norm(x, delta, scale, 1e-6),
             lambda: ref.add_rms_norm_ref(x, delta, scale, 1e-6),
             (4 * T * D_MODEL + D_MODEL) * es, err)

        q, k, v = rand(1, T, H, D), rand(1, T, HKV, D), rand(1, T, HKV, D)
        n_pages = T // PAGE + 8
        k_pages, v_pages = rand(n_pages + 1, PAGE, HKV, D), \
            rand(n_pages + 1, PAGE, HKV, D)
        pos = torch.randint(0, 8192, (1, T), generator=gen, device=dev)
        sin, cos = layers.rope_freqs(pos, D, 100000.0)
        n = int(T * VALID)
        rows = torch.randperm(T, generator=gen, device=dev)[:n].sort()[0]
        dest = torch.randperm(n_pages * PAGE, generator=gen,
                              device=dev)[:n]
        pidx, slot = dest // PAGE, dest % PAGE
        want = ref.rope_write_kv_ref(q.clone(), k, v, sin, cos,
                                      k_pages.clone(), v_pages.clone(), rows,
                                      pidx, slot)
        err = float((fe.rope_write_kv(q.clone(), k, v, sin, cos,
                                      k_pages.clone(), v_pages.clone(), rows,
                                      pidx, slot).float()
                     - want.float()).abs().max())
        _row(torch, f"rope_write_kv_{tag}_t{T}h{H}d{D}_valid{n}",
             # both rope q in place, again at every call: the bytes are
             # the same
             lambda: fe.rope_write_kv(q, k, v, sin, cos, k_pages, v_pages,
                                      rows, pidx, slot),
             lambda: ref.rope_write_kv_ref(q, k, v, sin, cos, k_pages,
                                            v_pages, rows, pidx, slot),
             2 * T * H * D * es + T * D * 4 + 4 * n * HKV * D * es + 24 * n,
             err)

        gate, up = rand(1, T, F, scale=2.0), rand(1, T, F)
        err = float((fe.gated_act(gate, up, "silu").float()
                     - ref.gated_act_ref(gate, up, "silu").float()
                     ).abs().max())
        _row(torch, f"gated_act_silu_{tag}_t{T}f{F}",
             lambda: fe.gated_act(gate, up, "silu"),
             lambda: ref.gated_act_ref(gate, up, "silu"),
             3 * T * F * es, err)
    return 0


if __name__ == "__main__":
    sys.exit(main())
