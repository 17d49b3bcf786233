#!/usr/bin/env python3
"""Time variants of the split ``paged_attention`` decode kernel on one
NVIDIA card, in turns, at the timing rows of ``chip_smoke.py`` (bf16,
page 16): the paged serving shape (B 8, H 16, Hkv 8, D 64, NB 52,
lengths 129-799), long context (B 8, NB 256, lengths 3072-4096), one
4096-token request, and glm4-9b's group (H 32, Hkv 2, D 128, G 16) at
lengths 129-799 and 600-799.

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit:

    python3 benchmarks/bench_torch_decode_variants.py [variant,...]

Each variant is the port's own ``csrc`` sources with text edits, built
with ``nvcc`` into ``build/decode_variants/<variant>/`` and called
through its C entry point with a split plan of its own:

- ``base``      the sources and ``split_plan`` as they are;
- ``nosplit``   one split a row (the grid B x Hkv): what the split buys;
- ``waves3``, ``waves4``  the planner aiming at three or four blocks an
                SM, not two;
- ``stage4k``   4 KB of K a stage, not 8 KB;
- ``minblocks1``  8-warp blocks (G > 4) free to take more than 128
                registers (then one block an SM);
- ``hkfirst``   blocks handed out KV head first, so that the Hkv blocks
                of a (row, split) read the same pages at the same time;
- ``timed``     the base with a globaltimer stamp of each block's phases
                (start, ring, merge, ticket, combine) written past the
                workspace: prints the median and largest phase times and
                the span of one call;
- ``nocompute`` no scores or PV (copies and combine only), ``nocopy``
                K/V copied for the first ring stages only: wrong answers
                (max_abs_err shows it) whose times say what the rest
                costs.

Prints one JSON line per build and per (variant, row, round): the
device time of one call from a profiler trace, two rounds, the second in
reverse order, so that a drift of the card shows.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "decode_variants"
SRC = "paged_attention.cu"
# name -> (text edits of paged_attention.cu, planner keyword overrides)
VARIANTS = {
    "base": ([], {}),
    "nosplit": ([], {"split": False}),
    "waves3": ([], {"waves": 3}),
    "waves4": ([], {"waves": 4}),
    "stage4k": ([("constexpr int kStageBytes = 8192;",
                  "constexpr int kStageBytes = 4096;")], {}),
    "minblocks1": ([("__launch_bounds__(NW * 32, NW == 8 ? 2 : 1)",
                     "__launch_bounds__(NW * 32, 1)")], {}),
    "hkfirst": ([("const int b = blockIdx.x, hk = blockIdx.y, s = blockIdx.z;",
                  "const int lin = blockIdx.x + gridDim.x * (blockIdx.y + "
                  "gridDim.y * blockIdx.z);\n  const int hk = lin % Hkv, "
                  "b = lin / Hkv % gridDim.x, s = lin / Hkv / gridDim.x;")],
                {}),
    "nocompute": ([("for (int kb = kw * KPW; kb < n_tok;",
                    "for (int kb = kw * KPW; kb < 0;")], {}),
    "nocopy": ([("    if (st < n_st) {\n      const int t_base",
                 "    if (st < min(n_st, kStages)) {\n"
                 "      const int t_base")], {}),
    "timed": ([
        ("  const int tok0 = s * pps * page;",
         "  unsigned long long* dbg =\n"
         "      reinterpret_cast<unsigned long long*>(\n"
         "          ws + (((size_t)gridDim.x * gridDim.y * gridDim.z * G *\n"
         "                 (D + 2) + 1) & ~(size_t)1)) +\n"
         "      8 * (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *\n"
         "                                     blockIdx.z));\n"
         "#define STAMP(k) if (tid == 0) { unsigned long long t_; asm "
         "volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
         "dbg[k] = t_; }\n"
         "  if (tid == 0) dbg[6] = n_live;\n  STAMP(0)\n"
         "  const int tok0 = s * pps * page;"),
        ("  fetch_ids(0);", "  STAMP(1)\n  fetch_ids(0);"),
        ("  __syncthreads();  // the ring is free: it becomes the warps' "
         "scratch", "  __syncthreads();\n  STAMP(2)"),
        ("  if (n_live == 1) return;",
         "  STAMP(3)\n  if (n_live == 1) return;"),
        ("  if (!last_s) return;",
         "  STAMP(4)\n  if (tid == 0) dbg[7] = last_s;\n"
         "  if (!last_s) return;"),
        ("  if (tid == 0) counters[bh] = 0;",
         "  STAMP(5)\n  if (tid == 0) counters[bh] = 0;")], {}),
}
WRONG = ("nocompute", "nocopy")   # timed, not checked
ROWS = [  # (row, H, Hkv, D, NB, lengths as (low, high, count))
    ("serving", 16, 8, 64, 52, (129, 800, 8)),
    ("long context", 16, 8, 64, 256, (3072, 4097, 8)),
    ("single long request", 16, 8, 64, 256, (4096, 4097, 1)),
    ("glm4-9b group", 32, 2, 128, 52, (129, 800, 8)),
    ("glm4-9b group, long rows", 32, 2, 128, 52, (600, 800, 8)),
]


def write_sources(name):
    """Write the sources with the variant's edits; raises if an edit no
    longer applies."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    files = {p.name: p.read_text() for p in CSRC.iterdir()
             if p.suffix in (".cu", ".cuh")}
    for old, new in VARIANTS[name][0]:
        if old not in files[SRC]:
            raise RuntimeError(f"{name}: {old!r} not in {SRC}")
        files[SRC] = files[SRC].replace(old, new, 1)
    for path, text in files.items():
        (d / path).write_text(text)


def start_build(name):
    d = OUT / name
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
         str(d / "lib.so"), str(d / SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def plan(pa, b, hkv, nb, page, sms, split=True, waves=None,
         min_tokens=None):
    """The variant's split: ``split_plan`` with its knobs overridden."""
    if not split:
        return nb, 1
    saved = pa.WAVES, pa.MIN_SPLIT_TOKENS
    pa.WAVES = waves or pa.WAVES
    pa.MIN_SPLIT_TOKENS = min_tokens or pa.MIN_SPLIT_TOKENS
    try:
        return pa.split_plan(b, hkv, nb, page, sms)
    finally:
        pa.WAVES, pa.MIN_SPLIT_TOKENS = saved


def device_ms(torch, call, iters=50):
    """Device time of one call (one kernel a call): the mean time of the
    kernel in a CUDA-only profiler trace of ``iters`` calls, taken again
    if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "paged_attention" in e.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def phases(torch, call, ws, dbg_at):
    """One call of the timed variant: each live block's phase times
    from its globaltimer stamps (us): start -> q loaded (q), -> ring
    done (ring), -> partial merged and written (merge), -> ticket taken
    (ticket), -> combine done (combine, the last split only); the median
    and largest of each, and the call's span from the first start to the
    last end."""
    ws[dbg_at:].zero_()
    call()
    torch.cuda.synchronize()
    t = ws[dbg_at:].view(torch.int64).reshape(-1, 8).cpu()
    t = t[t[:, 0] > 0]
    n_live, last = t[:, 6], t[:, 7]
    end = torch.where(n_live == 1, t[:, 3],
                      torch.where(last == 1, t[:, 5], t[:, 4]))
    out = dict(live_blocks=int(t.shape[0]),
               span_us=float(end.max() - t[:, 0].min()) / 1e3,
               start_spread_us=float(t[:, 0].max() - t[:, 0].min()) / 1e3)
    spans = {"q": (0, 1, n_live > 0), "ring": (1, 2, n_live > 0),
             "merge": (2, 3, n_live > 0), "ticket": (3, 4, n_live > 1),
             "combine": (4, 5, last == 1)}
    for name, (a, z, sel) in spans.items():
        d = (t[sel, z] - t[sel, a]).double() / 1e3
        if d.numel():
            out[name] = [float(d.median()), float(d.max())]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_decode_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_ref

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    built = {}
    for n in names:               # every edit checked before any build
        write_sources(n)
        key = tuple(VARIANTS[n][0])
        if key not in built:      # variants of the same sources share one
            built[key] = n
    procs = {n: start_build(n) for n in built.values()}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        print(json.dumps(dict(
            variant=n, build_rc=proc.returncode,
            registers=[int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)],
            spill_stores=[int(r) for r in re.findall(
                r"(\d+) bytes spill stores", log)],
            log=log[-2000:] if proc.returncode else "")), flush=True)
        if proc.returncode == 0:
            fn = ctypes.CDLL(str(OUT / n / "lib.so")).paged_attention_launch
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            libs[n] = fn
    fns = {n: libs.get(built[tuple(VARIANTS[n][0])]) for n in names}

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = all(fns.values())
    page = 16
    for row, h, hkv, d, nb, (lo, hi, b) in ROWS:
        pool = b * nb + 3
        q = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
        kp = torch.randn(pool, page, hkv, d, generator=gen,
                         device="cuda").bfloat16()
        vp = torch.randn(pool, page, hkv, d, generator=gen,
                         device="cuda").bfloat16()
        bt = torch.randperm(pool, generator=gen, device="cuda")[
            :b * nb].reshape(b, nb).to(torch.int32)
        ln = torch.randint(lo, hi, (b,), generator=gen, device="cuda").to(
            torch.int32)
        want = paged_attention_ref(q, kp, vp, bt, ln).float()
        out = torch.empty_like(q)
        for rnd, order in enumerate((names, names[::-1])):
            for n in order:
                if fns[n] is None:
                    continue
                pps, splits = plan(pa, b, hkv, nb, page, sms,
                                   **VARIANTS[n][1])
                n_ws = b * hkv * splits * (h // hkv) * (d + 2)
                dbg_at = (n_ws + 1) // 2 * 2   # the timed variant's stamps
                ws = torch.empty(dbg_at + b * hkv * splits * 16,
                                 dtype=torch.float32, device="cuda")

                def call(fn=fns[n], pps=pps, splits=splits, ws=ws):
                    return fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                              bt.data_ptr(), ln.data_ptr(), out.data_ptr(),
                              ws.data_ptr(), counters.data_ptr(), b, h, hkv,
                              d, page, nb, pps, splits, d ** -0.5, 1, stream)
                rc = call()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                ms = device_ms(torch, call)
                ok = ok and rc == 0 and ms is not None and (
                    n in WRONG or err <= 2e-2)
                if n == "timed":
                    print(json.dumps(dict(variant=n, row=row,
                                          round=rnd + 1, **phases(
                                              torch, call, ws, dbg_at))),
                          flush=True)
                print(json.dumps(dict(
                    variant=n, row=row, round=rnd + 1, rc=rc,
                    pages_per_split=pps, n_splits=splits, max_abs_err=err,
                    device_ms=ms, card=smi)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
