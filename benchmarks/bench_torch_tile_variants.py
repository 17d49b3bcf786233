#!/usr/bin/env python3
"""Time variants of the tensor-core bodies of ``flash_prefill`` (the bf16
tile, ``attn_tile.cuh``, and the float32 one, ``attn_tile_f32.cuh``) on
one NVIDIA card, in turns, at the slot prefill shapes of gemma3-4b (B 1,
S 2048, H 8, Hkv 4, D 256), with the SWA window 1024 and without.

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit:

    python3 benchmarks/bench_torch_tile_variants.py [variant,...]

Each variant is the port's own ``csrc`` sources with one text edit,
built with ``nvcc`` into ``build/tile_variants/<variant>/`` and called
through its C entry point:

- ``base``     the sources as they are;
- ``reverse``  query tiles heaviest first instead of zigzag_tile's order;
- ``natural``  query tiles in grid order;
- ``nocopy``   K/V copied only for the first ring stages: a wrong answer
               (max_abs_err shows it) whose time says what the copies
               cost;
- ``nk64``     64-key tiles at D 256 (161 KB, one block an SM);
- ``f32_*``    the float32 tile (3xTF32): ``f32_base``; ``f32_nocopy``
               as ``nocopy``; ``f32_unrolled``, the QK^T chunk loop
               unrolled (ptxas spills at D 256); ``f32_kw1``, one warp a
               16 query rows (not two sharing each key tile);
               ``f32_cvt``, the TF32 rounding by cvt.rna.tf32.f32.

Prints one JSON line per build and per (variant, window, round): two
rounds, the second in reverse order, so that a drift of the card shows.
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
OUT = ROOT / "build" / "tile_variants"
ZIGZAG = "return y < heavy ? ny - 1 - y : y - heavy;"
VARIANTS = {
    "base": [],
    "reverse": [("attn_tile.cuh", ZIGZAG, "return ny - 1 - y;")],
    "natural": [("attn_tile.cuh", ZIGZAG, "return y;")],
    "nocopy": [("attn_tile.cuh",
                "if (t + STAGES - 1 < ntiles) load(t + STAGES - 1);",
                "if (t + STAGES - 1 < min(ntiles, STAGES)) "
                "load(t + STAGES - 1);")],
    "nk64": [("attn_tile.cuh", "return Launch<256, 32, 2>::run",
              "return Launch<256, 64, 2>::run")],
    "f32_base": [],
    "f32_nocopy": [("attn_tile_f32.cuh",
                    "if (it + STAGES - 1 < ntiles) load(it + STAGES - 1);",
                    "if (it + STAGES - 1 < min(ntiles, STAGES)) "
                    "load(it + STAGES - 1);")],
    "f32_unrolled": [("attn_tile_f32.cuh", "#pragma unroll 1\n",
                      "#pragma unroll\n")],
    "f32_kw1": [("attn_tile_f32.cuh", "kKeyWarps = 2;", "kKeyWarps = 1;")],
    "f32_cvt": [("attn_tile_f32.cuh",
                 "return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                 "uint32_t r; asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) "
                 ": \"f\"(x)); return r;")],
}


def write_sources(name):
    """Write the sources with the variant's edits; raises if an edit no
    longer applies."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    files = {p.name: p.read_text() for p in CSRC.iterdir()
             if p.suffix in (".cu", ".cuh")}
    for path, old, new in VARIANTS[name]:
        if old not in files[path]:
            raise RuntimeError(f"{name}: {old!r} not in {path}")
        files[path] = files[path].replace(old, new, 1)
    for path, text in files.items():
        (d / path).write_text(text)


def start_build(name):
    """Start nvcc on a variant's written sources."""
    d = OUT / name
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
         str(d / "lib.so"), str(d / "flash_prefill.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_tile_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ref import flash_prefill_ref

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    for n in names:               # every edit checked before any build
        write_sources(n)
    procs = {n: start_build(n) for n in names}
    fns = {}
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
            fn = ctypes.CDLL(str(OUT / n / "lib.so")).flash_prefill_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[n] = fn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    s, h, hkv, d = 2048, 8, 4, 256
    qkv = {dt: [t.to(dt) for t in (
        torch.randn(1, s, h, d, generator=gen, device="cuda"),
        torch.randn(1, s, hkv, d, generator=gen, device="cuda"),
        torch.randn(1, s, hkv, d, generator=gen, device="cuda"))]
        for dt in (torch.float32, torch.bfloat16)}
    ln = torch.tensor([s], dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    ok = len(fns) == len(names)   # every variant built
    for win in (0, 1024):
        refs = {dt: flash_prefill_ref(*t, ln, window=win).float()
                for dt, t in qkv.items()}
        for rnd, order in enumerate((names, names[::-1])):
            for n in order:
                if n not in fns:
                    continue
                f32 = n.startswith("f32_")
                dt = torch.float32 if f32 else torch.bfloat16
                q, k, v = qkv[dt]
                out, ref = torch.empty_like(q), refs[dt]

                def call(fn=fns[n]):
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              ln.data_ptr(), out.data_ptr(), 1, s, s, h,
                              hkv, d, win, 0, d ** -0.5, 0 if f32 else 1,
                              stream)
                rc = call()
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                for _ in range(5):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(50):
                    call()
                end.record()
                torch.cuda.synchronize()
                ok = ok and rc == 0 and ("nocopy" in n
                                         or err <= (3e-5 if f32 else 3e-2))
                print(json.dumps(dict(
                    variant=n, window=win, round=rnd + 1, rc=rc,
                    max_abs_err=err, ms=start.elapsed_time(end) / 50,
                    card=smi)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
