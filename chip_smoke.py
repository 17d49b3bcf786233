#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   the card's name and power limit (nvidia-smi);
2. build    compile every CUDA kernel of the serving path from
            ``src/repro_torch/kernels/csrc`` (one nvcc each, in parallel);
3. kernels  every kernel against its plain PyTorch version on the card,
            over the JAX package's test cases and the full-width shapes;
4. step     each full-width qwen3-0.6b step function (mixed_step,
            prefill_step, decode_batch) in float32 with the kernels and
            again with the plain versions: logits and pools must agree;
5. serve    16 greedy requests through ``InferenceEngine`` at full width
            in bfloat16, twice on fresh engines: every request finishes,
            no page leaks, the same tokens both times, and each kernel
            launched exactly 28 times per step that needs it;
6. timing   each kernel, its plain version, the library call and the
            least time the card could take, at the serving shapes;
7. profile  host wall and device time of one full-width bf16
            mixed_step, by kind of kernel (torch.profiler).

Then the line ``{"kernels": [...]}``, the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  Weights are random, drawn from fixed seeds.  Without a
CUDA device, or without the repository beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BYTES_PER_S = 3.35e12                    # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # CUDA cores / TC
TOL = {"float32": (2e-5, 3e-5), "bfloat16": (2e-2, 3e-2)}  # decode, prefill
KERNEL_INFO = {
    "paged_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:128"),
    "paged_prefill": dict(
        source="src/repro_torch/kernels/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/paged_prefill.py:177"),
}
# the serving configuration (ISSUE-style full-width run)
SERVE_ECFG = dict(dtype="bfloat16", page_size=16, num_pages=1024,
                  max_batch=8, max_pages_per_seq=64, chunk_size=64,
                  max_prefills=2)
N_REQUESTS, MAX_NEW, PROMPT_RANGE = 16, 32, (128, 768)
# full-width f32 step: kernel logits vs plain logits, relative to the
# logits' scale.  The two differ only in the order of the attention's
# float32 sums (~1e-6 relative per call); 28 layers of residual updates
# carry that forward, and 1e-3 leaves room for it while a wrong page,
# head or mask gives an O(1) difference.
STEP_REL_TOL = 1e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel cases
def decode_case(torch, gen, b, h, hkv, d, page, nb, dtype, lengths=None,
                num_pages=None):
    dev = "cuda"
    p = num_pages or b * nb + 3
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(p, page, hkv, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(p, page, hkv, d, generator=gen, device=dev).to(dtype)
    bt = torch.randperm(p, generator=gen, device=dev)[:b * nb].reshape(
        b, nb).to(torch.int32)
    if lengths is None:
        lengths = torch.randint(1, nb * page + 1, (b,), generator=gen,
                                device=dev)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    return q, kp, vp, bt, lengths


def prefill_case(torch, gen, b, h, hkv, d, page, s, nb, dtype, ctx=None,
                 chunk=None, num_pages=None):
    dev = "cuda"
    p = num_pages or b * nb + 3
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(p, page, hkv, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(p, page, hkv, d, generator=gen, device=dev).to(dtype)
    bt = torch.randperm(p, generator=gen, device=dev)[:b * nb].reshape(
        b, nb).to(torch.int32)
    if ctx is None:
        ctx = torch.randint(0, nb * page - s + 1, (b,), generator=gen,
                            device=dev)
    if chunk is None:
        chunk = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    return (q, kp, vp, bt, torch.as_tensor(ctx, device=dev).to(torch.int32),
            torch.as_tensor(chunk, device=dev).to(torch.int32))


def check_kernels(torch, ops_mod):
    """Phase 3: every kernel against its plain version on the card."""
    from repro_torch.kernels import ref
    f32, bf16 = torch.float32, torch.bfloat16
    name = {f32: "float32", bf16: "bfloat16"}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = []

    def compare(kernel, args, dtype, tol_idx, label, extra=None):
        out = (ops_mod.paged_attention(*args) if kernel == "paged_attention"
               else ops_mod.paged_prefill(*args))
        plain = (ref.paged_attention_ref(*args) if kernel == "paged_attention"
                 else ref.paged_prefill_ref(*args))
        torch.cuda.synchronize()
        tol = TOL[name[dtype]][tol_idx]
        err = (out.float() - plain.float()).abs().max().item()
        ok = torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol)
        if extra is not None:
            ok = ok and extra(out)
        results.append(dict(kernel=kernel, case=label, dtype=name[dtype],
                            max_abs_err=err, tol=tol, ok=bool(ok)))

    # paged_attention: tests/test_kernels.py:21 + length 1 + length 0
    for b, h, hkv, d, page, nb, dt in [
            (4, 8, 4, 64, 16, 8, f32), (2, 8, 8, 128, 16, 4, f32),
            (3, 16, 2, 64, 32, 4, f32), (1, 4, 1, 256, 16, 8, f32),
            (4, 8, 4, 64, 16, 8, bf16)]:
        compare("paged_attention",
                decode_case(torch, gen, b, h, hkv, d, page, nb, dt), dt, 0,
                f"B{b} H{h} Hkv{hkv} D{d} page{page} NB{nb}")
    compare("paged_attention",
            decode_case(torch, gen, 2, 4, 2, 64, 16, 4, f32, [1, 1]), f32, 0,
            "length 1")
    compare("paged_attention",
            decode_case(torch, gen, 2, 4, 2, 64, 16, 4, f32, [0, 37]), f32,
            0, "length 0 row", extra=lambda o: bool((o[0] == 0).all()))
    # paged_prefill: tests/test_paged_prefill.py:27 + ctx 0 + padding rows
    for b, h, hkv, d, page in [(2, 4, 4, 32, 8), (1, 8, 4, 64, 16),
                               (2, 8, 2, 32, 16), (1, 4, 4, 64, 64),
                               (2, 8, 2, 64, 64), (1, 8, 4, 32, 8)]:
        compare("paged_prefill",
                prefill_case(torch, gen, b, h, hkv, d, page, 24, 192 // page,
                             f32), f32, 1,
                f"B{b} H{h} Hkv{hkv} D{d} page{page} S24")
    compare("paged_prefill",
            prefill_case(torch, gen, 1, 4, 2, 32, 8, 32, 4, f32, [0], [32]),
            f32, 1, "ctx 0")
    compare("paged_prefill",
            prefill_case(torch, gen, 2, 4, 2, 32, 8, 16, 4, f32, [8, 0],
                         [5, 12]), f32, 1, "padding rows zero",
            extra=lambda o: bool((o[0, 5:] == 0).all()
                                 and (o[1, 12:] == 0).all()))
    # full-width shapes: H 16, Hkv 8, D 64, page 16
    for dt in (f32, bf16):
        compare("paged_attention",
                decode_case(torch, gen, 8, 16, 8, 64, 16, 52, dt,
                            num_pages=1025), dt, 0, "full width B8 NB52")
        compare("paged_prefill",
                prefill_case(torch, gen, 2, 16, 8, 64, 16, 64, 52, dt,
                             num_pages=1025), dt, 1, "full width K2 S64 NB52")
    # an empty batch launches nothing and counts nothing
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    before = (pa.launches, pp.launches)
    out_d = ops_mod.paged_attention(
        *decode_case(torch, gen, 0, 4, 2, 64, 16, 4, f32, lengths=[]))
    out_p = ops_mod.paged_prefill(
        *prefill_case(torch, gen, 0, 4, 2, 32, 8, 16, 4, f32, [], []))
    torch.cuda.synchronize()
    for kernel, out in (("paged_attention", out_d), ("paged_prefill", out_p)):
        results.append(dict(kernel=kernel, case="empty batch",
                            dtype="float32", max_abs_err=0.0, tol=0.0,
                            ok=out.shape[0] == 0
                            and (pa.launches, pp.launches) == before))
    return results


# ------------------------------------------------------------ full width
def step_inputs(torch, cfg, dtype):
    """Full-width weights, a random 1025-page pool and the inputs of one
    mixed step: 8 decode rows (one idle) and 2 chunks of 64 (one full at
    context 0, one of 37 tokens at context 448), block tables 52 wide."""
    from repro_torch.engine import paged_model as PM
    from repro_torch.models import model as M
    dev, page, num_pages = "cuda", 16, 1024
    params = M.init(cfg, seed=1, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    pool = PM.init_pool(cfg, num_pages + 1, page, dtype, dev)
    pool.k.normal_(generator=gen)
    pool.v.normal_(generator=gen)
    b, kk, s, nb = 8, 2, 64, 52
    perm = torch.randperm(num_pages, generator=gen, device=dev).to(
        torch.int32)
    dec_active = torch.ones(b, dtype=torch.bool, device=dev)
    dec_active[-1] = False
    args = dict(
        dec_tokens=torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                                 device=dev).to(torch.int32),
        dec_positions=torch.randint(100, nb * page - 1, (b,), generator=gen,
                                    device=dev).to(torch.int32),
        dec_block_tables=perm[:b * nb].reshape(b, nb).contiguous(),
        dec_active=dec_active,
        pre_tokens=torch.randint(0, cfg.vocab_size, (kk, s), generator=gen,
                                 device=dev).to(torch.int32),
        pre_block_tables=perm[b * nb:b * nb + kk * nb].reshape(
            kk, nb).contiguous(),
        pre_ctx=torch.tensor([0, 448], dtype=torch.int32, device=dev),
        pre_chunk=torch.tensor([64, 37], dtype=torch.int32, device=dev))
    return params, pool, args, page


def full_width_step(torch, cfg):
    """Phase 4: each float32 step function (``mixed_step``, then
    ``prefill_step`` and ``decode_batch``) once with the kernels and once
    with the plain versions, on the same weights and pool."""
    from repro_torch.engine import paged_model as PM
    params, pool, a, page = step_inputs(torch, cfg, torch.float32)
    b, (kk, s) = a["dec_tokens"].shape[0], a["pre_tokens"].shape
    steps = {
        "mixed_step": lambda p, impl: torch.cat(PM.mixed_step(
            params, p, **a, cfg=cfg, page_size=page, impl=impl)[:2]),
        "prefill_step": lambda p, impl: PM.prefill_step(
            params, p, a["pre_tokens"][1:], a["pre_block_tables"][1:], 448,
            37, cfg=cfg, page_size=page, impl=impl)[0],
        "decode_batch": lambda p, impl: PM.decode_batch(
            params, p, a["dec_tokens"], a["dec_positions"],
            a["dec_block_tables"], a["dec_active"], cfg=cfg, page_size=page,
            impl=impl)[0],
    }
    for step, run in steps.items():
        outs = {}
        for impl in ("kernel", "ref"):
            p = PM.PagePool(pool.k.clone(), pool.v.clone())
            outs[impl] = (run(p, impl).float(), p)
        torch.cuda.synchronize()
        (lk, pk), (lr, prf) = outs["kernel"], outs["ref"]
        scale = lr.abs().max().item()
        err = (lk - lr).abs().max().item()
        pool_err = max((pk.k - prf.k).abs().max().item(),
                       (pk.v - prf.v).abs().max().item())
        pool_scale = prf.k.abs().max().item()
        ok = (bool(torch.isfinite(lk).all()) and err <= STEP_REL_TOL * scale
              and pool_err <= STEP_REL_TOL * pool_scale)
        emit("step", step=step, model=cfg.name, dtype="float32",
             decode_rows=b, chunks=kk, chunk=s, logits_max_abs=scale,
             max_abs_err=err, pool_max_abs_err=pool_err,
             rel_tol=STEP_REL_TOL, ok=ok)
        if not ok:
            raise AssertionError(f"full-width {step}: kernel and plain "
                                 "logits disagree")
        del outs
    del params, pool


# ------------------------------------------------------------ serving
def serve_once(torch, cfg, prompts, pa, pp):
    from repro_torch.engine import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)
    ecfg = EngineConfig(**SERVE_ECFG)
    eng = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    modes = {"decode": 0, "prefill": 0, "mixed": 0, "idle": 0}
    schedule = eng.sched.schedule

    def recording_schedule(now):
        out = schedule(now)
        modes[out.mode] += 1
        return out

    eng.sched.schedule = recording_schedule
    reqs = [Request(prompt_tokens=list(p),
                    sampling=SamplingParams(max_new_tokens=MAX_NEW))
            for p in prompts]
    torch.cuda.synchronize()
    pa.launches = pp.launches = 0
    t0 = time.perf_counter()
    # the first request arrives alone (a lone prefill step), the rest
    # while it is prefilling
    eng.submit(reqs[0])
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.launches, "paged_prefill": pp.launches}
    finished = sum(r.state.name == "FINISHED"
                   and len(r.output_tokens) == MAX_NEW for r in reqs)
    ttft = [r.ttft for r in reqs]
    free, total = eng.alloc.num_free, eng.alloc.num_pages
    tokens = [list(r.output_tokens) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return dict(tokens=tokens, modes=modes, launches=launches,
                finished=finished, wall_s=wall, ttft=ttft,
                free_pages=free, num_pages=total)


def serve(torch, cfg, pa, pp):
    """Phase 5: the full-width bf16 serve, twice."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    runs = [serve_once(torch, cfg, prompts, pa, pp) for _ in range(2)]
    smi = nvidia_smi()
    for i, run in enumerate(runs):
        m = run["modes"]
        want = {"paged_attention": cfg.n_layers * (m["decode"] + m["mixed"]),
                "paged_prefill": cfg.n_layers * (m["prefill"] + m["mixed"])}
        gen_tokens = sum(len(t) for t in run["tokens"])
        ok = (run["finished"] == N_REQUESTS
              and run["free_pages"] == run["num_pages"]
              and run["launches"] == want
              and run["tokens"] == runs[0]["tokens"])
        emit("serve", run=i + 1, model=cfg.name, requests=N_REQUESTS,
             prompt_tokens=int(lens.sum()), generated_tokens=gen_tokens,
             finished=run["finished"], free_pages=run["free_pages"],
             num_pages=run["num_pages"], steps=m, launches=run["launches"],
             expected_launches=want,
             same_tokens_as_run_1=run["tokens"] == runs[0]["tokens"],
             wall_s=run["wall_s"],
             output_tokens_per_s=gen_tokens / run["wall_s"],
             total_tokens_per_s=(gen_tokens + int(lens.sum()))
             / run["wall_s"],
             mean_ttft_s=float(np.mean(run["ttft"])), card=smi, ok=ok)
        if not ok:
            raise AssertionError(f"serve run {i + 1} failed its checks")
    return runs[0]["launches"]


# ------------------------------------------------------------ timing
def time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timing(torch, cfg, launches):
    """Phase 6: kernel, plain and library times and the bound, at the
    serving shapes (bf16, H 16, Hkv 8, D 64, page 16, a pool of 1025
    pages, block tables 52 wide, 8 decode rows, 2 chunks of 64)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dt, page, h, hkv, d, nb = torch.bfloat16, 16, cfg.n_heads, \
        cfg.n_kv_heads, cfg.head_dim, 52
    esize = 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    lines = []

    def sdpa_inputs(q, kp, vp, bt):
        b = bt.shape[0]
        k = kp[bt.long()].reshape(b, nb * page, hkv, d).transpose(1, 2)
        v = vp[bt.long()].reshape(b, nb * page, hkv, d).transpose(1, 2)
        return k.contiguous(), v.contiguous()

    # decode: 8 rows with serving lengths (prompt 128..768 + 32 new)
    lengths = torch.randint(129, 800, (8,), generator=gen, device="cuda")
    args = decode_case(torch, gen, 8, h, hkv, d, page, nb, dt,
                       lengths=lengths, num_pages=1025)
    q, kp, vp, bt, ln = args
    out = ops.paged_attention(*args)
    plain = ref.paged_attention_ref(*args)
    err = (out.float() - plain.float()).abs().max().item()
    k, v = sdpa_inputs(q, kp, vp, bt)
    mask = (torch.arange(nb * page, device="cuda")[None] < ln[:, None])[
        :, None, None, :]
    qs = q[:, :, None, :]                                 # (B, H, 1, D)
    live = int(ln.sum())
    nbytes = (2 * live * hkv * d * esize + 2 * q.numel() * esize
              + bt.numel() * 4 + ln.numel() * 4)
    flops = 4 * live * h * d
    lines.append(kernel_line(
        "paged_attention", launches, err,
        time_ms(torch, lambda: ops.paged_attention(*args)),
        time_ms(torch, lambda: ref.paged_attention_ref(*args)),
        time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, enable_gqa=True)),
        nbytes, flops, "bfloat16"))

    # prefill: 2 chunks of 64 at serving contexts
    s = 64
    ctx = torch.tensor([0, 704], device="cuda")
    chunk = torch.tensor([64, 64], device="cuda")
    pargs = prefill_case(torch, gen, 2, h, hkv, d, page, s, nb, dt, ctx,
                         chunk, num_pages=1025)
    q, kp, vp, bt, cx, ck = pargs
    out = ops.paged_prefill(*pargs)
    plain = ref.paged_prefill_ref(*pargs)
    err = (out.float() - plain.float()).abs().max().item()
    k, v = sdpa_inputs(q, kp, vp, bt)
    qpos = cx[:, None] + torch.arange(s, device="cuda")[None]
    kpos = torch.arange(nb * page, device="cuda")
    pmask = ((kpos[None, None] <= qpos[:, :, None])
             & (kpos[None, None] < (cx + ck)[:, None, None]))[:, None]
    qs = q.transpose(1, 2)                                # (B, H, S, D)
    pairs = sum(int(c) * int(x) + int(c) * (int(c) + 1) // 2
                for x, c in zip(cx.tolist(), ck.tolist()))
    keys = int((cx + ck).sum())
    nbytes = (2 * keys * hkv * d * esize + 2 * q.numel() * esize
              + bt.numel() * 4 + 8 * cx.numel())
    flops = 4 * pairs * h * d
    lines.append(kernel_line(
        "paged_prefill", launches, err,
        time_ms(torch, lambda: ops.paged_prefill(*pargs)),
        time_ms(torch, lambda: ref.paged_prefill_ref(*pargs)),
        time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=pmask, enable_gqa=True)),
        nbytes, flops, "bfloat16"))
    return lines


def kernel_line(name, launches, err, ms, plain_ms, library_ms, nbytes,
                flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    line = dict(name=name, route="cuda", **KERNEL_INFO[name],
                launches=launches[name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)
    emit("timing", **line, bytes=nbytes, flops=flops)
    return line


def profile_step(torch, cfg):
    """Phase 7: where the time of one full-width bf16 mixed step goes.
    Each step is ended by a synchronize, as the engine's sampling ends
    it.  The host wall per step is timed without the profiler; the
    device time of the kernels, by kind, comes from a trace of the same
    steps with CUDA activity only (CPU tracing slows every operator
    launch and would inflate the idle share).  Busy share = traced
    device ms / untraced wall ms."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine import paged_model as PM
    params, pool, a, page = step_inputs(torch, cfg, torch.bfloat16)

    def step():
        PM.mixed_step(params, pool, **a, cfg=cfg, page_size=page)
        torch.cuda.synchronize()

    for _ in range(3):
        step()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kinds = {"paged_attention": 0.0, "paged_prefill": 0.0, "gemm": 0.0,
             "other": 0.0}
    count = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        count += 1
        us = e.time_range.elapsed_us()
        name = e.name.lower()
        kind = ("paged_attention" if "paged_attention_kernel" in name
                else "paged_prefill" if "paged_prefill_kernel" in name
                else "gemm" if any(w in name for w in (
                    "gemm", "cutlass", "xmma", "nvjet", "matmul"))
                else "other")
        kinds[kind] += us / 1e3 / n
    busy = sum(kinds.values())
    emit("profile", step="mixed_step", dtype="bfloat16", steps=n,
         wall_ms_per_step=wall_ms, traced_wall_ms_per_step=traced_wall_ms,
         device_ms_per_step=busy if count else "not measured",
         device_busy_share=busy / wall_ms if count else "not measured",
         device_kernels_per_step=count / n, device_ms_by_kind=kinds)
    del params, pool


# ------------------------------------------------------------ main
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp

    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    reports = build.build()
    emit("build", seconds=time.perf_counter() - t0, kernels=list(
        build.KERNELS), ptxas={n: [ln.strip() for ln in log.splitlines()
                                   if "registers" in ln or "spill" in ln]
                               for n, log in reports.items()})

    results = check_kernels(torch, ops)
    for r in results:
        emit("kernel_check", **r)
    if not all(r["ok"] for r in results):
        raise AssertionError("a kernel disagrees with its plain version")

    cfg = get_config("qwen3-0.6b")
    full_width_step(torch, cfg)
    launches = serve(torch, cfg, pa, pp)
    lines = timing(torch, cfg, launches)
    profile_step(torch, cfg)

    print(json.dumps({"kernels": lines}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
