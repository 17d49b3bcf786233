#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   the card's name and power limit (nvidia-smi);
2. build    compile every CUDA kernel of the port from
            ``src/repro_torch/kernels/csrc`` (one nvcc each, in parallel);
3. kernels  every kernel against its plain PyTorch version on the card,
            over the JAX package's test cases and the full-width shapes
            (gemma3-4b's D = 256 included); ``paged_attention`` also
            where its split over pages engages (long contexts, rows of
            length 0 and 1, split boundaries, G 1 to 16, D 96 and 256,
            pages 8 and 64), in float32 also against the plain mirror of
            the split, and called twice for identical bits;
4. step     each full-width qwen3-0.6b step function (mixed_step,
            prefill_step, decode_batch) in float32 with the kernels and
            again with the plain versions: logits and pools must agree;
5. serve    16 greedy requests through ``InferenceEngine`` at full width
            in bfloat16, twice on fresh engines: every request finishes,
            no page leaks, the same tokens both times, and each kernel
            launched exactly 28 times per step that needs it;
6. slot step  full-width gemma3-4b in float32: ``prefill`` of a
            1500-token prompt and 4 ``decode_step``s, with the
            ``flash_prefill`` kernel and with its plain version: logits
            and caches must agree;
7. slot serve  8 greedy requests (prompts 1100-3000 tokens, all longer
            than the 1024 window) through ``SlotEngine`` at full width
            in bfloat16, twice on fresh engines: every request finishes
            with the same tokens both times, ``flash_prefill`` launched
            exactly 34 times per prefill and the paged kernels never;
8. timing   each kernel, its plain version, the library call and the
            least time the card could take, at the serving shapes, and
            ``paged_attention`` at long contexts and glm4-9b's group
            shape; each kernel's device time a call from a profiler
            trace;
9. profile  host wall and device time, by kind of kernel
            (torch.profiler), of one full-width bf16 paged mixed_step,
            one gemma3-4b slot prefill of 2048 tokens and one 4-slot
            decode step.

Then the line ``{"kernels": [...]}``, the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  ``--only kernels,timing``
(say) runs the build and just those phases, for a quick check after a
kernel change; it prints no kernels line.  Any failure raises and
exits non-zero.  Weights are random, drawn from fixed seeds.  Without a
CUDA device, or without the repository beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
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
    "flash_prefill": dict(
        source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill.py:125"),
}
# the serving configuration (ISSUE-style full-width run)
SERVE_ECFG = dict(dtype="bfloat16", page_size=16, num_pages=1024,
                  max_batch=8, max_pages_per_seq=64, chunk_size=64,
                  max_prefills=2)
N_REQUESTS, MAX_NEW, PROMPT_RANGE = 16, 32, (128, 768)
# the slot serving configuration (gemma3-4b, full width)
SLOT_ECFG = dict(max_slots=4, max_len=4096, dtype="bfloat16")
SLOT_REQUESTS, SLOT_MAX_NEW, SLOT_PROMPTS = 8, 32, (1100, 3000)
SLOT_STEP_PROMPT, SLOT_STEP_DECODES = 1500, 4
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


def flash_case(torch, gen, b, sq, sk, h, hkv, d, dtype, lengths=None):
    dev = "cuda"
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=dev).to(dtype)
    if lengths is None:
        lengths = torch.randint(sk // 2, sk + 1, (b,), generator=gen,
                                device=dev)
    return q, k, v, torch.as_tensor(lengths, device=dev).to(torch.int32)


def check_kernels(torch, ops_mod):
    """Phase 3: every kernel against its plain version on the card."""
    from repro_torch.kernels import ref
    f32, bf16 = torch.float32, torch.bfloat16
    name = {f32: "float32", bf16: "bfloat16"}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = []

    fns = {"paged_attention": (ops_mod.paged_attention,
                               ref.paged_attention_ref),
           "paged_prefill": (ops_mod.paged_prefill, ref.paged_prefill_ref),
           "flash_prefill": (ops_mod.flash_attention, ref.flash_prefill_ref)}

    def compare(kernel, args, dtype, tol_idx, label, extra=None,
                plain_fn=None, **kw):
        out = fns[kernel][0](*args, **kw)
        plain = (plain_fn or fns[kernel][1])(*args, **kw)
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
    # flash_prefill: tests/test_kernels.py:59 + the ragged case (:86)
    for b, sq, sk, h, hkv, d, win, qoff, dt in [
            (2, 128, 128, 8, 4, 64, 0, 0, f32),
            (2, 128, 256, 4, 2, 64, 0, 128, f32),
            (1, 256, 256, 4, 1, 128, 64, 0, f32),
            (2, 64, 64, 4, 4, 32, 0, 0, f32),
            (1, 192, 320, 6, 3, 64, 100, 128, f32),
            (2, 128, 128, 8, 4, 64, 0, 0, bf16)]:
        compare("flash_prefill",
                flash_case(torch, gen, b, sq, sk, h, hkv, d, dt), dt, 1,
                f"B{b} Sq{sq} Sk{sk} H{h} Hkv{hkv} D{d} window{win} "
                f"q_offset{qoff}", window=win, q_offset=qoff)
    compare("flash_prefill",
            flash_case(torch, gen, 2, 100, 173, 4, 2, 64, f32, [173, 90]),
            f32, 1, "ragged Sq100 Sk173 lengths 173/90")
    # under a window, rows at qpos >= 20 + 16 - 1 of sequence 1 see no key
    compare("flash_prefill",
            flash_case(torch, gen, 2, 64, 64, 4, 2, 32, f32, [64, 20]), f32,
            1, "rows without keys zero", window=16,
            extra=lambda o: bool((o[1, 35:] == 0).all()
                                 and (o[1, :35] != 0).any(-1).all()))
    # gemma3-4b at full width: H 8, Hkv 4, D 256, the serving length
    for dt in (f32, bf16):
        for win in (1024, 0):
            compare("flash_prefill",
                    flash_case(torch, gen, 1, 2048, 2048, 8, 4, 256, dt,
                               [2048]), dt, 1,
                    f"gemma3-4b B1 S2048 D256 window{win}", window=win)
    # the bf16 twin of every float32 prefill case above, which the
    # tensor-core bodies take, then bf16 at G 3, 5 and 16, at D 48, 128,
    # 192 and 256, and at D 256 with Sq no multiple of 64.  Their own
    # generator keeps the inputs of the cases above as they were.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for b, h, hkv, d, page in [(2, 4, 4, 32, 8), (1, 8, 4, 64, 16),
                               (2, 8, 2, 32, 16), (1, 4, 4, 64, 64),
                               (2, 8, 2, 64, 64), (1, 8, 4, 32, 8)]:
        compare("paged_prefill",
                prefill_case(torch, gen, b, h, hkv, d, page, 24, 192 // page,
                             bf16), bf16, 1,
                f"B{b} H{h} Hkv{hkv} D{d} page{page} S24")
    compare("paged_prefill",
            prefill_case(torch, gen, 1, 4, 2, 32, 8, 32, 4, bf16, [0], [32]),
            bf16, 1, "ctx 0")
    compare("paged_prefill",
            prefill_case(torch, gen, 2, 4, 2, 32, 8, 16, 4, bf16, [8, 0],
                         [5, 12]), bf16, 1, "padding rows zero",
            extra=lambda o: bool((o[0, 5:] == 0).all()
                                 and (o[1, 12:] == 0).all()))
    for b, h, hkv, d, page, s in [
            (2, 9, 3, 64, 16, 40), (2, 10, 2, 64, 16, 40),
            (1, 16, 1, 64, 16, 64), (2, 4, 2, 48, 16, 40),
            (2, 8, 4, 128, 16, 64), (1, 8, 4, 256, 16, 64)]:
        compare("paged_prefill",
                prefill_case(torch, gen, b, h, hkv, d, page, s, 24, bf16),
                bf16, 1, f"B{b} H{h} Hkv{hkv} D{d} page{page} S{s}")
    for b, sq, sk, h, hkv, d, win, qoff in [
            (2, 128, 256, 4, 2, 64, 0, 128), (1, 256, 256, 4, 1, 128, 64, 0),
            (2, 64, 64, 4, 4, 32, 0, 0), (1, 192, 320, 6, 3, 64, 100, 128),
            (1, 200, 200, 9, 3, 64, 0, 0), (2, 150, 250, 10, 2, 64, 64, 100),
            (1, 100, 100, 16, 1, 64, 0, 0), (2, 130, 130, 4, 2, 48, 0, 0),
            (1, 300, 300, 8, 4, 128, 128, 0), (1, 300, 300, 4, 2, 192, 0, 0),
            (1, 1000, 1000, 8, 4, 256, 0, 0),
            (2, 1000, 1000, 8, 4, 256, 300, 0)]:
        compare("flash_prefill",
                flash_case(torch, gen, b, sq, sk, h, hkv, d, bf16), bf16, 1,
                f"B{b} Sq{sq} Sk{sk} H{h} Hkv{hkv} D{d} window{win} "
                f"q_offset{qoff}", window=win, q_offset=qoff)
    compare("flash_prefill",
            flash_case(torch, gen, 2, 100, 173, 4, 2, 64, bf16, [173, 90]),
            bf16, 1, "ragged Sq100 Sk173 lengths 173/90")
    compare("flash_prefill",
            flash_case(torch, gen, 2, 64, 64, 4, 2, 32, bf16, [64, 20]), bf16,
            1, "rows without keys zero", window=16,
            extra=lambda o: bool((o[1, 35:] == 0).all()
                                 and (o[1, :35] != 0).any(-1).all()))
    # an empty batch launches nothing and counts nothing
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    before = (pa.launches, pp.launches, fp.launches)
    out_d = ops_mod.paged_attention(
        *decode_case(torch, gen, 0, 4, 2, 64, 16, 4, f32, lengths=[]))
    out_p = ops_mod.paged_prefill(
        *prefill_case(torch, gen, 0, 4, 2, 32, 8, 16, 4, f32, [], []))
    out_f = ops_mod.flash_attention(
        *flash_case(torch, gen, 0, 16, 16, 4, 2, 32, f32, []))
    torch.cuda.synchronize()
    for kernel, out in (("paged_attention", out_d), ("paged_prefill", out_p),
                        ("flash_prefill", out_f)):
        results.append(dict(kernel=kernel, case="empty batch",
                            dtype="float32", max_abs_err=0.0, tol=0.0,
                            ok=out.shape[0] == 0
                            and (pa.launches, pp.launches,
                                 fp.launches) == before))
    # paged_attention where its split over pages engages, on a generator
    # of their own: each case against the plain version and, in float32,
    # against the plain mirror of the split at the planner's
    # pages_per_split
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def split_case(b, h, hkv, d, page, nb, dt, label, lengths=None,
                   extra=None):
        args = decode_case(torch, gen, b, h, hkv, d, page, nb, dt, lengths)
        pps, n_splits = pa.split_plan(b, hkv, nb, page, sms)
        label = (f"{label}: B{b} H{h} Hkv{hkv} D{d} page{page} NB{nb}, "
                 f"split {pps} pages x {n_splits}")
        compare("paged_attention", args, dt, 0, label, extra=extra)
        if dt == f32:
            compare("paged_attention", args, dt, 0, label + " vs split ref",
                    extra=extra, plain_fn=lambda *a: (
                        ref.paged_attention_split_ref(
                            *a, pages_per_split=pps)))
        return args

    def zero_rows(rows):
        return lambda o: bool((o[rows] == 0).all()
                              and (o[[i for i in range(o.shape[0])
                                      if i not in rows]] != 0).any())

    long_args = {}
    for dt in (f32, bf16):
        split_case(1, 16, 8, 64, 16, 256, dt, "one long request", [4096])
        long_args[dt] = split_case(
            8, 16, 8, 64, 16, 256, dt, "long context",
            torch.randint(3072, 4097, (8,), generator=gen, device="cuda"))
        split_case(6, 16, 8, 64, 16, 64, dt, "rows of 0, 1 and the table",
                   [0, 1, 1024, 0, 1, 1024], extra=zero_rows([0, 3]))
        span = pa.split_plan(5, 8, 64, 16, sms)[0] * 16
        split_case(5, 16, 8, 64, 16, 64, dt, "lengths at split boundaries",
                   [span - 1, span, span + 1, 2 * span, 2 * span + 1])
        split_case(4, 32, 2, 128, 16, 64, dt, "G 16 (glm4-9b)")
        split_case(4, 8, 8, 128, 16, 64, dt, "G 1")
        split_case(4, 12, 2, 128, 16, 64, dt, "G 6 (qwen2-1.5b)")
        split_case(4, 25, 5, 64, 16, 64, dt, "G 5 (hymba-1.5b)")
        split_case(3, 8, 4, 96, 16, 64, dt, "D 96")
        split_case(2, 8, 4, 256, 8, 128, dt, "D 256 page 8")
        split_case(2, 8, 4, 256, 64, 32, dt, "D 256 page 64")
    # the combine merges the splits in split order, whichever block comes
    # last: a repeated call gives the same bits
    for dt, args in long_args.items():
        outs = [ops_mod.paged_attention(*args) for _ in range(2)]
        torch.cuda.synchronize()
        results.append(dict(kernel="paged_attention",
                            case="long context, called twice: bit for bit",
                            dtype=name[dt], max_abs_err=(
                                outs[0].float() - outs[1].float()).abs()
                            .max().item(), tol=0.0,
                            ok=bool(torch.equal(outs[0], outs[1]))))
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


# ------------------------------------------------------------ slot path
def slot_step(torch, cfg, fp):
    """Phase 6: full-width float32 ``prefill`` of one 1500-token prompt
    and 4 ``decode_step``s (fixed tokens), once with the flash_prefill
    kernel and once with its plain version, on the same weights."""
    from repro_torch.models import model as M
    dev, s, n_dec = "cuda", SLOT_STEP_PROMPT, SLOT_STEP_DECODES
    cache_len = s + n_dec
    params = M.init(cfg, seed=4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (1, s + n_dec), generator=gen,
                         device=dev).to(torch.int32)
    outs = {}
    for impl in ("kernel", "ref"):
        fp.launches = 0
        caches = M.init_cache(cfg, 1, cache_len, torch.float32, dev)
        logits, caches = M.prefill(params, cfg, toks[:, :s], caches,
                                   impl=impl)
        steps = [logits.float()]
        for i in range(n_dec):
            pos = torch.tensor([s + i], dtype=torch.int32, device=dev)
            logits, caches = M.decode_step(params, cfg, caches,
                                           toks[:, s + i], pos)
            steps.append(logits.float())
        torch.cuda.synchronize()
        outs[impl] = (torch.stack(steps), caches, fp.launches)
    (lk, ck, nk), (lr, cr, nr) = outs["kernel"], outs["ref"]
    scale = lr.abs().max().item()
    err = (lk - lr).abs().max().item()
    kv_err = max((a[n] - b[n]).abs().max().item() for a, b in zip(ck, cr)
                 for n in ("k", "v"))
    kv_scale = max(b[n].abs().max().item() for b in cr for n in ("k", "v"))
    pos_equal = all(torch.equal(a["pos"], b["pos"])
                    for a, b in zip(ck, cr) if "pos" in a)
    ok = (bool(torch.isfinite(lk).all()) and err <= STEP_REL_TOL * scale
          and kv_err <= STEP_REL_TOL * kv_scale and pos_equal
          and nk == cfg.n_layers and nr == 0)
    emit("slot_step", model=cfg.name, dtype="float32", prompt=s,
         decode_steps=n_dec, logits_max_abs=scale, max_abs_err=err,
         cache_max_abs_err=kv_err, cache_max_abs=kv_scale,
         ring_pos_equal=pos_equal, flash_launches={"kernel": nk, "ref": nr},
         rel_tol=STEP_REL_TOL, ok=ok)
    if not ok:
        raise AssertionError("full-width slot step: kernel and plain "
                             "disagree")
    del params, outs


def slot_serve_once(torch, cfg, prompts, counters):
    from repro_torch.engine import (Request, SamplingParams, SlotEngine,
                                    SlotEngineConfig)
    from repro_torch.engine.request import RequestState
    eng = SlotEngine(cfg, SlotEngineConfig(**SLOT_ECFG), seed=0,
                     device="cuda")
    prefills = 0
    prefill_into_slot = eng._prefill_into_slot

    def counting_prefill(req, slot):
        nonlocal prefills
        prefills += 1
        prefill_into_slot(req, slot)

    eng._prefill_into_slot = counting_prefill
    reqs = [Request(prompt_tokens=list(p),
                    sampling=SamplingParams(max_new_tokens=SLOT_MAX_NEW))
            for p in prompts]
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps, step_s = 0, {"prefill": 0.0, "decode": 0.0}
    while eng.has_work:
        before, t1 = prefills, time.perf_counter()
        eng.step()              # ends in sampling's copy to the host
        step_s["prefill" if prefills > before else "decode"] += \
            time.perf_counter() - t1
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    finished = sum(r.state == RequestState.FINISHED
                   and len(r.output_tokens) == SLOT_MAX_NEW for r in reqs)
    out = dict(tokens=[list(r.output_tokens) for r in reqs],
               launches=launches, prefills=prefills, steps=steps,
               step_s=step_s,
               finished=finished, wall_s=wall, ttft=[r.ttft for r in reqs])
    del eng
    torch.cuda.empty_cache()
    return out


def slot_serve(torch, cfg, counters):
    """Phase 7: the full-width bf16 slot serve, twice."""
    import numpy as np
    rng = np.random.default_rng(1)
    lens = rng.integers(SLOT_PROMPTS[0], SLOT_PROMPTS[1] + 1, SLOT_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    runs = [slot_serve_once(torch, cfg, prompts, counters) for _ in range(2)]
    smi = nvidia_smi()
    for i, run in enumerate(runs):
        want = {name: cfg.n_layers * run["prefills"]
                if name == "flash_prefill" else 0 for name in counters}
        gen_tokens = sum(len(t) for t in run["tokens"])
        ok = (run["finished"] == SLOT_REQUESTS
              and run["prefills"] == SLOT_REQUESTS
              and run["launches"] == want
              and run["tokens"] == runs[0]["tokens"])
        emit("slot_serve", run=i + 1, model=cfg.name, engine="SlotEngine",
             config=SLOT_ECFG, requests=SLOT_REQUESTS,
             prompt_tokens=int(lens.sum()), prompt_min=int(lens.min()),
             prompt_max=int(lens.max()), generated_tokens=gen_tokens,
             finished=run["finished"], prefills=run["prefills"],
             steps=run["steps"], wall_s_by_step=run["step_s"],
             launches=run["launches"],
             expected_launches=want,
             same_tokens_as_run_1=run["tokens"] == runs[0]["tokens"],
             wall_s=run["wall_s"],
             output_tokens_per_s=gen_tokens / run["wall_s"],
             total_tokens_per_s=(gen_tokens + int(lens.sum()))
             / run["wall_s"],
             mean_ttft_s=float(np.mean(run["ttft"])), card=smi, ok=ok)
        if not ok:
            raise AssertionError(f"slot serve run {i + 1} failed its checks")
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


def kernel_device_ms(torch, fn, name, iters=20):
    """The device time of one call of ``fn``: the summed time of every
    launch of the kernel ``name`` (any device function whose name holds
    ``name`` and ends in ``_kernel``, so a second kernel of the same call
    counts too) in a CUDA-only ``torch.profiler`` trace of ``iters``
    calls, divided by the calls the trace holds (the launches of
    ``<name>_kernel`` itself: a trace has been seen to drop events, and
    now and then to hold none, when it is taken again).  The kernel
    alone, where ``time_ms`` of a small kernel also counts the host's
    launch overhead between calls."""
    import re
    from torch.profiler import ProfilerActivity, profile
    pattern = re.compile(rf"{name}\w*_kernel")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and pattern.search(e.name.lower())]
        calls = sum(f"{name}_kernel" in e.name.lower() for e in events)
        if calls:
            return sum(e.time_range.elapsed_us() for e in events) / calls \
                / 1e3
    return "not measured"


def decode_row(torch, gen, launches, h, hkv, d, page, nb, lengths,
               num_pages, **extra):
    """One ``paged_attention`` timing row, bf16: the kernel, its plain
    version and SDPA over K/V gathered beforehand, on ``lengths`` rows
    of a ``num_pages`` pool with block tables ``nb`` wide; the planner's
    split beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    dt, esize = torch.bfloat16, 2
    b = len(lengths)
    args = decode_case(torch, gen, b, h, hkv, d, page, nb, dt,
                       lengths=lengths, num_pages=num_pages)
    q, kp, vp, bt, ln = args
    out = ops.paged_attention(*args)
    plain = ref.paged_attention_ref(*args)
    err = (out.float() - plain.float()).abs().max().item()
    k = kp[bt.long()].reshape(b, nb * page, hkv, d).transpose(1, 2) \
        .contiguous()
    v = vp[bt.long()].reshape(b, nb * page, hkv, d).transpose(1, 2) \
        .contiguous()
    mask = (torch.arange(nb * page, device="cuda")[None] < ln[:, None])[
        :, None, None, :]
    qs = q[:, :, None, :]                                 # (B, H, 1, D)
    live = int(ln.sum())
    nbytes = (2 * live * hkv * d * esize + 2 * q.numel() * esize
              + bt.numel() * 4 + ln.numel() * 4)
    flops = 4 * live * h * d
    pps, n_splits = pa.split_plan(b, hkv, nb, page, torch.cuda
                                  .get_device_properties(0)
                                  .multi_processor_count)
    return kernel_line(
        "paged_attention", launches, err,
        time_ms(torch, lambda: ops.paged_attention(*args)),
        time_ms(torch, lambda: ref.paged_attention_ref(*args)),
        time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, enable_gqa=True)),
        nbytes, flops, "bfloat16", device_ms=kernel_device_ms(
            torch, lambda: ops.paged_attention(*args), "paged_attention"),
        pages_per_split=pps, n_splits=n_splits,
        case=f"B{b} H{h} Hkv{hkv} D{d} page{page} NB{nb} lengths "
        f"{int(ln.min())}-{int(ln.max())} bf16", **extra)


def timing(torch, cfg, launches):
    """Phase 8: kernel, plain and library times and the bound, at the
    serving shapes (bf16, H 16, Hkv 8, D 64, page 16, a pool of 1025
    pages, block tables 52 wide, 8 decode rows, 2 chunks of 64); then
    ``paged_attention`` at long contexts and at glm4-9b's group shape,
    on lines of their own."""
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
    lines.append(decode_row(torch, gen, launches, h, hkv, d, page, nb,
                            lengths, 1025))

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
        nbytes, flops, "bfloat16", device_ms=kernel_device_ms(
            torch, lambda: ops.paged_prefill(*pargs), "paged_prefill")))

    # paged_attention where the split matters, on a generator of their
    # own: 8 rows at 3072-4096 tokens and one 4096-token row (block
    # tables 256 wide), and glm4-9b's group (H 32, Hkv 2, D 128, G 16)
    # at the serving lengths
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    decode_row(torch, gen, launches, h, hkv, d, page, 256,
               torch.randint(3072, 4097, (8,), generator=gen,
                             device="cuda"), 8 * 256 + 3,
               row="long context")
    decode_row(torch, gen, launches, h, hkv, d, page, 256, [4096], 259,
               row="single long request")
    decode_row(torch, gen, launches, 32, 2, 128, page, nb,
               torch.randint(129, 800, (8,), generator=gen, device="cuda"),
               1025, row="glm4-9b group shape")
    return lines


def flash_timing(torch, cfg, launches):
    """flash_prefill at the slot path's prefill shapes: gemma3-4b's
    heads (H 8, Hkv 4, D 256), one 2048-token prompt, bf16, with the SWA
    layers' window and without (the DENSE layers).  The first row goes
    into the ``kernels`` line, the second only into its timing line."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    s, h, hkv, d = 2048, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    q, k, v, ln = flash_case(torch, gen, 1, s, s, h, hkv, d, torch.bfloat16,
                             [s])
    # SDPA's (B, H, S, D) layout, made before timing
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lines = []
    for win in (cfg.sliding_window, 0):
        out = ops.flash_attention(q, k, v, ln, window=win)
        plain = ref.flash_prefill_ref(q, k, v, ln, window=win)
        err = (out.float() - plain.float()).abs().max().item()
        mask = layers.causal_mask(s, s, window=win, device="cuda")
        if win:
            def library():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True)
        lib_err = (library().transpose(1, 2).float()
                   - plain.float()).abs().max().item()
        pairs = int(mask.sum())               # live (query, key) pairs
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + ln.numel() * 4
        flops = 4 * pairs * h * d
        lines.append(kernel_line(
            "flash_prefill", launches, err,
            time_ms(torch, lambda: ops.flash_attention(q, k, v, ln,
                                                       window=win)),
            time_ms(torch, lambda: ref.flash_prefill_ref(q, k, v, ln,
                                                         window=win)),
            time_ms(torch, library), nbytes, flops, "bfloat16",
            case=f"B1 S{s} H{h} Hkv{hkv} D{d} bf16 window {win}",
            device_ms=kernel_device_ms(
                torch, lambda: ops.flash_attention(q, k, v, ln, window=win),
                "flash_prefill"),
            library_max_abs_err=lib_err))
    return lines[:1]


def kernel_line(name, launches, err, ms, plain_ms, library_ms, nbytes,
                flops, dtype, **extra):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    line = dict(name=name, route="cuda", **KERNEL_INFO[name],
                launches=launches[name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms, **extra)
    emit("timing", **line, bytes=nbytes, flops=flops)
    return line


def device_profile(torch, step, n):
    """Where the time of ``step`` goes.  The host wall per step is timed
    without the profiler; the device time of the kernels, by kind, comes
    from a trace of the same steps with CUDA activity only (CPU tracing
    slows every operator launch and would inflate the idle share).  Busy
    share = traced device ms / untraced wall ms."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kinds = {name: 0.0 for name in KERNEL_INFO}
    kinds.update(gemm=0.0, other=0.0)
    count = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        count += 1
        name = e.name.lower()
        kind = next((k for k in KERNEL_INFO if f"{k}_kernel" in name),
                    "gemm" if any(w in name for w in (
                        "gemm", "cutlass", "xmma", "nvjet", "matmul"))
                    else "other")
        kinds[kind] += e.time_range.elapsed_us() / 1e3 / n
    busy = sum(kinds.values())
    return dict(steps=n, wall_ms_per_step=wall_ms,
                traced_wall_ms_per_step=traced_wall_ms,
                device_ms_per_step=busy if count else "not measured",
                device_busy_share=busy / wall_ms if count
                else "not measured",
                device_kernels_per_step=count / n, device_ms_by_kind=kinds)


def profile_step(torch, cfg):
    """Phase 9: one full-width bf16 paged mixed step (8 decode rows,
    chunks of 64 and 37), ended by a synchronize as the engine's
    sampling ends it."""
    from repro_torch.engine import paged_model as PM
    params, pool, a, page = step_inputs(torch, cfg, torch.bfloat16)

    def step():
        PM.mixed_step(params, pool, **a, cfg=cfg, page_size=page)
        torch.cuda.synchronize()

    emit("profile", step="mixed_step", model=cfg.name, dtype="bfloat16",
         **device_profile(torch, step, 10))
    del params, pool


def profile_slot(torch, cfg):
    """Phase 9: the slot path at full width in bf16: one prefill of a
    2048-token prompt into a one-row cache, and one decode step of 4
    slots at positions 1200-3000 of a 4096-token cache, each ended by a
    synchronize as the engine's sampling ends it."""
    from repro_torch.models import model as M
    dev, bf16, s = "cuda", torch.bfloat16, 2048
    params = M.init(cfg, seed=0, dtype=bf16, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    one = M.init_cache(cfg, 1, SLOT_ECFG["max_len"], bf16, dev)
    caches = M.init_cache(cfg, SLOT_ECFG["max_slots"], SLOT_ECFG["max_len"],
                          bf16, dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                           device=dev).to(torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (SLOT_ECFG["max_slots"],),
                         generator=gen, device=dev).to(torch.int32)
    pos = torch.tensor([1200, 2048, 2600, 3000], dtype=torch.int32,
                       device=dev)

    def prefill():
        M.prefill(params, cfg, prompt, one)
        torch.cuda.synchronize()

    def decode():
        M.decode_step(params, cfg, caches, toks, pos)
        torch.cuda.synchronize()

    emit("profile", step="slot prefill", model=cfg.name, dtype="bfloat16",
         prompt=s, **device_profile(torch, prefill, 3))
    emit("profile", step="slot decode_step", model=cfg.name,
         dtype="bfloat16", slots=SLOT_ECFG["max_slots"],
         **device_profile(torch, decode, 10))
    del params, one, caches


# ------------------------------------------------------------ main
def ptxas_summary(log):
    """Registers and spills of each compiled kernel from ``ptxas -v``,
    and a count of its other notes by code (C7519 and the like: wgmma
    fences that ptxas injected or wgmmas it serialised)."""
    import re
    fns, notes, fn = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            k = re.search(r"([a-z_]+_kernel(?:_tc)?)I(.*?)EEv", m.group(1))
            fn = m.group(1)[-40:]
            if k:
                args = [a or b for a, b in re.findall(
                    r"Li(\d+)E|^(f|13__nv_bfloat16)", k.group(2) + "E")]
                fn = f"{k.group(1)}<{','.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            fns.setdefault(fn, {})["spill"] = [int(m.group(1)),
                                               int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            fns.setdefault(fn, {})["registers"] = int(m.group(1))
        m = re.search(r"\((C\d+)\)", line)
        if m:
            notes[m.group(1)] = notes.get(m.group(1), 0) + 1
    return dict(functions=fns, notes=notes)


PHASES = ("kernels", "step", "serve", "slot_step", "slot_serve", "timing",
          "profile")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", default=",".join(PHASES),
        help="comma-separated phases to run after the build, of "
        f"{', '.join(PHASES)} (default: all; the kernels line is printed "
        "only when all run)")
    only = set(parser.parse_args().only.split(","))
    if not only <= set(PHASES):
        parser.error(f"unknown phases {sorted(only - set(PHASES))}")
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
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp

    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    reports = build.build()
    emit("build", seconds=time.perf_counter() - t0, kernels=list(
        build.KERNELS), ptxas={n: ptxas_summary(log)
                               for n, log in reports.items()})

    if "kernels" in only:
        results = check_kernels(torch, ops)
        for r in results:
            emit("kernel_check", **r)
        if not all(r["ok"] for r in results):
            raise AssertionError("a kernel disagrees with its plain version")

    cfg = get_config("qwen3-0.6b")
    gemma = get_config("gemma3-4b")
    launches = slot_launches = dict.fromkeys(KERNEL_INFO, 0)
    if "step" in only:
        full_width_step(torch, cfg)
    if "serve" in only:
        launches = serve(torch, cfg, pa, pp)
    if "slot_step" in only:
        slot_step(torch, gemma, fp)
    if "slot_serve" in only:
        slot_launches = slot_serve(torch, gemma, {
            "flash_prefill": fp, "paged_attention": pa, "paged_prefill": pp})
    lines = []
    if "timing" in only:
        lines = timing(torch, cfg, launches) + flash_timing(torch, gemma,
                                                            slot_launches)
    if "profile" in only:
        profile_step(torch, cfg)
        profile_slot(torch, gemma)

    if only == set(PHASES):
        print(json.dumps({"kernels": lines}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
