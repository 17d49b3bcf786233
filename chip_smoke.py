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
            ``paged_prefill`` also at speculative verify shapes through
            ``ops.paged_verify`` (lanes of 2 and 5 rows padded to 8,
            contexts ending on and across page boundaries, idle lanes
            zero, G 2, 3 and 16, float32 and bf16); both paged kernels
            at granite-moe-3b-a800m's G 3 (H 24, Hkv 8, D 64): its
            serving shape, long contexts, chunks at context 0 and across
            page boundaries; the float32 twins of the bf16-only prefill
            cases (G 3, 5 and 16; D 8, 40, 48, 128, 192 and 256; D 256
            with Sq no multiple of 64), which the 3xTF32 tile takes;
   sampling the port's threefry PRNG on the card bit for bit against
            values recorded from jax 0.9.0 (``row_keys``, ``split``,
            ``uniform``, ``gumbel``), the XLA-rounded logs of every
            uniform value and exp over softmax's range against the CPU,
            and ``sample`` at temperature 0.8 (no top-p, 0.5, 0.9 and
            1.0, whose token-0 rows included) against the JAX sampler's
            recorded tokens and the CPU, at V 64 and 151,936; its time;
4. step     each full-width qwen3-0.6b step function (mixed_step,
            prefill_step, decode_batch, spec_decode_step) in float32
            with the kernels and again with the plain versions: logits
            and pools must agree;
5. serve    16 greedy requests through ``InferenceEngine`` at full width
            in bfloat16, twice on fresh engines: every request finishes,
            no page leaks, the same tokens both times, and each kernel
            launched exactly 28 times per step that needs it;
6. lora     a float32 ``mixed_step`` with a bank of 4 adapters, kernels
            against plain versions and LoRA on against off; then 16
            greedy bf16 requests over the base and 10 adapters through a
            bank of 7 (evicting to the host tier and reloading), twice,
            with the checks of ``serve``, and 3 of them alone on fresh
            engines with the same tokens; adapter load times;
7. tiers    bf16: swap preemption through the host tier, a prefix served
            from the host tier, the SSD tier with promotion, P/D handoff
            over the distributed pool on the raw and the int8 wire, each
            token-identical to the plain run (the int8 wire: finishes, at
            the compressed size); one page's payload off the card and
            back, timed;
   spec     speculative decoding at qwen3-0.6b's full width: (a) the
            float32 ``spec_decode_step`` and ``spec_mixed_step`` with a
            bank of 4 adapters, kernels against plain versions, logits
            and pools, 28 and 56 ``paged_prefill`` launches and no
            ``paged_attention``; (c) 8 float32 requests whose prompts
            repeat a random 16-64-token segment, speculation off and on
            (``spec_tokens=4``), at temperature 0 and at 0.8 with top-p
            0.9 and a seed per request: the same tokens, exact launch
            counts by kind of step, no page leak; (d) 16 such bf16
            requests (prompts 128-768), off and on: tok/s, TTFT, drafts
            accepted and the share of tokens equal to the run without;
   launch   the port's serving launcher (``repro_torch.launch.serve``:
            its flags, gateway, role pools and request loop) at
            qwen3-0.6b's full width, the serve phase's engine sizes, 16
            requests of 512 tokens sharing the launcher's 24-token
            prefix, 32 new tokens: two colocated bf16 engines behind
            prefix-cache-aware routing (all finish, no page leaks, both
            paged kernels launched on each engine at exactly 28 a step
            that needs them, each engine's tokens equal to a lone
            engine's fed the same submits and steps); 1P1D over the raw
            wire, every engine seed 0, against a lone seed-0 engine fed
            the same arrivals (equal tokens in float32; bf16's share of
            equal tokens printed, its batches differ); the colocated
            serve again, then with ``--async-loop`` (the sync tokens and
            routing; every async dispatch under
            ``torch.cuda.set_sync_debug_mode("error")``; sync, async and
            sync walls, ``device_wait_s``, ``host_overhead_frac``); and
            in float32 ``--spec-tokens 4 --async-loop`` against the sync
            loop (the same tokens, drafts taken); the launcher's own
            report goes to ``build/chip_smoke_launch.log``;
8. slot step  full-width gemma3-4b in float32: ``prefill`` of a
            1500-token prompt and 4 ``decode_step``s, with the
            ``flash_prefill`` kernel and with its plain version: logits
            and caches must agree;
9. slot serve  8 greedy requests (prompts 1100-3000 tokens, all longer
            than the 1024 window) through ``SlotEngine`` at full width
            in bfloat16, twice on fresh engines: every request finishes
            with the same tokens both times, finite logits,
            ``flash_prefill`` launched exactly 34 times per prefill and
            the paged kernels never;
10. moe     mixture-of-experts and MLA at full width: ``moe_ffn`` on the
            card against the CPU (granite-moe-3b-a800m's widths, float32,
            capacity factor 1.25, T 136 and 8: the same kept (token,
            expert) pairs bit for bit, dropped pairs at T 136, outputs
            within the float32 tolerances; its bf16 time); full-depth
            granite's mixed_step, prefill_step, decode_batch and
            spec_decode_step in float32 with the kernels and with the
            plain versions; granite's bf16 serve as in phase 5 (twice,
            32 launches of each paged kernel a step that needs it), and
            once more with ``async_loop=True``, every async dispatch
            under ``set_sync_debug_mode("error")``, with the sync run's
            tokens; deepseek-v2 at its published widths cut to 2 layers
            (MLA_DENSE, MLA_MOE) through ``SlotEngine`` in bf16, 4
            greedy requests (prompts 512-2000, 16 new tokens) twice:
            the same tokens, finite logits, no kernel launched;
   ssm      Hymba and xLSTM (``models/ssm.py``: Mamba, mLSTM, sLSTM) at
            full width: ``flash_prefill`` at hymba-1.5b's G 5 (H 25, Hkv 5,
            D 64, S 1280, windows 1024 and 0, f32 and bf16) in the kernels
            phase; hymba-1.5b's float32 ``prefill`` of 1200 tokens (the
            ring wraps) and 4 ``decode_step``s, kernel against plain:
            logits, K/V and Mamba states within 1e-3 of their scale, ring
            positions equal, exactly 32 ``flash_prefill`` launches (29 at
            window 1024, 3 at 0) and none with the plain version; 4
            greedy bf16 requests through ``SlotEngine`` for each of
            hymba-1.5b (prompts 1100-1400) and xlstm-1.3b (600-1200: the
            mLSTM parallel form over more than one 512-query block, the
            sLSTM scan ending on a partial chunk), 16 new tokens, twice:
            the same tokens, finite logits, launches by window (none for
            xlstm), walls split into prefill and decode, peak memory;
            the scans' share of each model's bf16 prefill and decode
            step's wall; reduced hymba and xlstm gradients
            on 2 x 256 tokens, card against CPU (loss 1e-6 relative,
            each leaf within 1e-5 of its max);
   train    the port's trainer (``repro_torch.training``): (a) one
            ``make_train_step`` and its gradients of reduced qwen3-0.6b
            and reduced granite-moe-3b-a800m (aux losses) on 4 x 1024
            tokens, card against CPU in float32 at "highest" (loss 1e-5
            relative, each gradient leaf within 1e-4 of its max and
            nonzero somewhere); (b) full-width qwen3-0.6b in float32,
            batch 8 x 1024 (the chunked, checkpointed cross-entropy),
            3 steps with remat: finite losses and grad norms, the first
            loss near ln V, a ``grad_accum=2`` step equal to the
            ``grad_accum=1`` step on the same batch (1e-4); (c) the same
            with bf16 params and float32 moments; walls, tokens/s,
            6*N*tokens/s over the peak, peak memory, a step's device time
            by kind (torch.profiler); (d) remat on against
            off at the 100M config of ``examples/
            torch_train_dense_100m.py`` (1e-5), both peak memories; (e)
            that example, 300 steps: the loss falls by more than 0.3 and
            the restored checkpoint equals the final state; (f) the
            blockwise attention of sequences over 2048 tokens: reduced
            qwen3-0.6b's gradients on one 4096-token sequence, card
            against CPU as in (a), and at qwen3-0.6b's heads the
            attention's forward and backward against the dense path
            (1e-4), each one's peak memory and wall.  No hand-written
            kernel launches in the whole phase;
   sim      the cluster simulator, the diagnostics and the analytic
            roofline of the port (``core/sim``, ``core/diagnostics``,
            ``launch/analytic.py``): (a) the planner's ``h100`` entry
            fitted from full-width bf16 qwen3-0.6b serves (MFU from a
            4 x 512-token prefill batch, MBU from the median step in
            which 8 rows decode), the copied ``PerfModel`` reproducing
            the fitted points, its prediction against the measured time
            at a second point (one 2048-token prompt, 8 rows near context
            700), the analytic roofline's bound beside each; (b) the
            ``ServingCluster`` on the fitted h100 and on the a10:
            birdsql-like traffic, a thermal throttle on engine-1 (the
            monitor must diagnose it), an engine crash (no request
            lost); the GPU optimizer over a10, l20 and h100; (c) crash
            recovery through the diagnostics around two real float32
            engines sharing a pool: the monitor must answer
            ``DEVICE_LOST`` with ``restart``, the harvested requests
            resume on the second engine from the recovery log with a
            lone engine's tokens, remote hits equal to the logged
            coverage, no page leaked, exact kernel launches;
   shard    the reference's weights and the sharded trainer: (a)
            ``repro_torch.random``'s ``normal`` and ``truncated_normal``
            on the card bit for bit against values recorded from jax
            0.9.0 (float32 and bf16), ``M.init`` of reduced qwen3-0.6b
            and granite-moe-3b-a800m equal on the card and the CPU leaf
            for leaf, and full-width bf16 ``M.init`` of qwen3-0.6b,
            gemma3-4b and granite-moe-3b-a800m timed (seconds, peak
            memory); (b) full-width qwen3-0.6b bf16 train steps on a
            one-rank NCCL (1, 1) mesh with the default rules (params
            and moments DTensors) against the unsharded step from the
            same state and batches: loss and grad norm within the train
            phase's grad_accum bound, tokens/s and peak memory of both;
            (c) the dry-run (``repro_torch.launch.dryrun``, a child
            process a case, started with the script, on a fake process
            group of 256 or 512 ranks) of qwen3-0.6b and
            granite-moe-3b-a800m train_4k and gemma3-4b decode_32k on
            16x16 and gemma3-4b decode_32k on 2x16x16:
            each record ok, its per-device bytes (shapes, not a
            measurement), collective bytes by kind, dominant roofline
            term and seconds; no kernel launches;
11. timing  each kernel, its plain version, the library call and the
            least time the card could take, at the serving shapes (also
            at granite's G 3 for the paged kernels, and
            ``flash_prefill`` also at hymba-1.5b's G 5), and
            ``paged_attention`` at long contexts and glm4-9b's group
            shape; each kernel's device time a call from a profiler
            trace; then the same serving-shape rows in float32, the
            library call on SDPA's memory-efficient backend (K/V
            expanded to H heads), the bound at 3xTF32's 165 TFLOP/s and
            the CUDA cores' beside it;
12. profile host wall and device time, by kind of kernel
            (torch.profiler), of one full-width bf16 paged mixed_step
            (without and with 4 adapters; and in float32, the engines'
            default dtype), one decode_batch of 8 rows
            and one spec_decode_step of 8 lanes of 5 rows, granite's
            mixed_step and decode_batch beside its weight-read bound,
            one gemma3-4b slot prefill of 2048 tokens (bf16 and float32)
            and one 4-slot decode step, and a 512-token prefill and a
            4-slot decode step of hymba-1.5b and of xlstm-1.3b.

Opt-in, not among the default phases (it needs four cards):

   tp4      ``--only tp4`` on four cards of one host: 4 NCCL ranks (one
            process a card) run the sharded train step of full-width
            qwen3-0.6b, 8 x 1024 tokens a step, on (data, model) meshes
            (4, 1), (1, 4) and (2, 2): tensor-, sequence- and
            expert-parallel over ``model`` (``models.sharding``).  Each
            against the unsharded step on one card from the same weights
            and batches: float32 at "highest", loss and grad norm of 3
            steps within ``TRAIN_ACCUM_RTOL``; bf16, tokens/s (best of 3
            steps), the largest peak memory over the ranks and the loss
            within 1e-2 relative of one card's bf16 step.  granite-moe-
            3b-a800m in bf16 at (1, 4) (10 experts a rank), the same
            numbers, against one card's loss and gradient of the first
            batch (its whole step, float32 moments and all, does not fit
            one card).  The dry-run against the real mesh: one more bf16
            qwen3-0.6b step at (2, 2) in the dry-run's placements under
            ``comm_analysis.StepRecorder`` gives the real run's
            collective bytes by kind; a child process runs the same step
            on a fake 4-rank group under ``FakeTensorMode`` through the
            dry-run's ``input_specs`` and ``step_fn``: its bytes must
            equal the real run's, and its arguments plus temporaries are
            printed beside rank 0's peak memory.  MLA, Hymba and xLSTM
            layers on their model shards at (1, 4): full-width
            hymba-1.5b float32 train steps of 4 x 512 tokens (cut: the
            scans are plain torch), loss and grad norm of 3 steps within
            ``TRAIN_ACCUM_RTOL`` of one card's; xlstm-1.3b's the same
            of 3 batches from the same weights, no update (its 48
            layers amplify rounding: its trajectories part after an
            AdamW step on one card too, however the sums are ordered);
            deepseek-v2 cut to 3 layers (MLA_DENSE + 2 MLA_MOE: 32
            heads and 40 experts a card) in bf16, the first batch's loss
            and grad norm within 1e-2 of one card's ``value_and_grad``;
            tokens/s and the largest peak a card of each.  Decode over a
            sequence-split cache: the dry-run's prefill of 8 x 1024
            tokens and 8 ``decode_step``s against 4096-token caches of
            full-width hymba-1.5b (5 KV heads: every attention cache
            splits its sequence over ``model``) and the 3-layer
            deepseek-v2 (its latents likewise) in float32: every step's
            logits within 1e-5 of one card's, the largest peak a card,
            the real collective bytes by kind, and no all-gather of a
            decode step as large as one layer's smallest cache field.
            Fewer than 4 cards fail the phase.

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
import functools
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BYTES_PER_S = 3.35e12                    # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # CUDA cores / TC
# float32 on the tensor cores as three TF32 products (495 TFLOP/s of
# TF32): the kernels' float32 bound; PEAK_FLOPS's 67e12 stays the CUDA
# cores' (the train phase's MFU, each float32 row's bound_cuda_core_ms)
PEAK_FLOPS_3XTF32 = 495e12 / 3
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
# the multi-LoRA serve: the serving configuration with a bank of 7
# adapters (slot 0 is the base) and a host tier of 32
LORA_ECFG = dict(SERVE_ECFG, max_adapters=8, lora_rank=8,
                 host_adapter_slots=32)
LORA_ADAPTERS, LORA_RANK, LORA_MAX_NEW = 4, 8, 16
# the KV tier checks: the serving configuration, 16 new tokens
TIER_ECFG = dict(SERVE_ECFG)
TIER_MAX_NEW = 16
# the slot serving configuration (gemma3-4b, full width)
SLOT_ECFG = dict(max_slots=4, max_len=4096, dtype="bfloat16")
SLOT_REQUESTS, SLOT_MAX_NEW, SLOT_PROMPTS = 8, 32, (1100, 3000)
SLOT_STEP_PROMPT, SLOT_STEP_DECODES = 1500, 4
# the ssm phase: hymba-1.5b and xlstm-1.3b at full width through the
# slot engine's serving configuration, 4 greedy requests each (hymba's
# prompts past its 1024 window; xlstm's past one 512-query block of the
# mLSTM parallel form), 16 new tokens; hymba's f32 step check prefills
# 1200 tokens (the ring wraps); the scans' share and the profile take a
# 512-token prefill (a trace of a 1200-token xlstm prefill holds 188k
# kernels and took tens of seconds to read); the reduced trainers, card
# against CPU on 2 x 256 tokens: loss within 1e-6 relative, each
# gradient leaf within 1e-5 of its max |g|
SSM_REQUESTS, SSM_MAX_NEW = 4, 16
SSM_PROMPTS = {"hymba-1.5b": (1100, 1400), "xlstm-1.3b": (600, 1200)}
HYMBA_STEP_PROMPT, SSM_PROFILE_PROMPT, HYMBA_FLASH_SEQ = 1200, 512, 1280
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 2, 256
SSM_TRAIN_LOSS_RTOL, SSM_TRAIN_GRAD_TOL = 1e-6, 1e-5
# gradient leaves the loss does not depend on: mLSTM's parallel form
# cancels a constant added to every input gate of a head (the weights
# are exp(bias - max bias)), so ``igate_b``'s gradient is rounding noise
# on both devices; it is held to be negligible (1e-6 of the tree's
# largest gradient) instead of compared
INVARIANT_GRADS, INVARIANT_TOL = ("mlstm/igate_b",), 1e-6
# the MLA slot serve: deepseek-v2 cut to 2 layers at full width
MLA_ECFG = dict(max_slots=4, max_len=2048, dtype="bfloat16")
MLA_REQUESTS, MLA_MAX_NEW, MLA_PROMPTS = 4, 16, (512, 2000)
# the launch phase: the port's launcher at full width with the serve
# phase's engine sizes; prompts of the launcher's 24-token shared prefix
# and a random tail
LAUNCH_REQUESTS, LAUNCH_PROMPT, LAUNCH_MAX_NEW = 16, 512, 32
# speculative decoding: 4 drafts a decode row (lanes of 5 rows); the
# float32 serve of 8 requests (prompts 96-256 tokens) and the bf16 one
# of 16 (PROMPT_RANGE), each prompt a random 16-64-token segment repeated
SPEC_TOKENS, SPEC_F32_REQUESTS, SPEC_F32_PROMPTS = 4, 8, (96, 256)
SPEC_SEGMENT = (16, 64)
SPEC_SAMPLING = dict(temperature=0.8, top_p=0.9)
# jax.random values recorded from jax 0.9.0 on the CPU
# (jax_threefry_partitionable=True), which the card has no way to run:
# row_keys(seed, position), split(PRNGKey(s), 3), and the float32 bits
# of uniform and gumbel(PRNGKey(s), (6,))
JAX_ROW_KEYS = [(1, 5, [3006591476, 2914868775]),
                (0, 0, [4165894930, 804218099]),
                (7, 1000, [1831534255, 1091784610]),
                (123456, 151935, [2147324095, 54635239]),
                (2147483647, 77, [2735158544, 3609530407])]
JAX_SPLITS = {0: [[1797259609, 2579123966], [928981903, 3453687069],
                  [4146024105, 2718843009]],
              42: [[1832780943, 270669613], [64467757, 2916123636],
                   [2465931498, 255383827]]}
JAX_UNIFORM_BITS = {0: [1064475214, 1064993846, 1051337244, 1055913296,
                        1058137146, 1042905504],
                    42: [1056585764, 1059981104, 1058915320, 1057988288,
                         1055308516, 1058405198]}
JAX_GUMBEL_BITS = {0: [1077614729, 1081428380, 3183898615, 1049490596,
                       1058234552, 3205909564],
                   42: [1051397706, 1064548236, 1060748383, 1057772792,
                        1047019407, 1059080482]}
# repro.engine.sampling.sample's tokens at temperature 0.8 with row keys
# (seed i, position 17) over logits 4 * gumbel(split(PRNGKey(2024),
# 8)[i], (V,)), by "V/top_p"; at top_p 1.0 some rows draw token 0 (the
# reference's fault, which the port reproduces)
JAX_SAMPLES = {
    "64/None": [32, 16, 57, 58, 45, 4, 42, 36],
    "64/0.5": [32, 16, 57, 58, 45, 4, 42, 36],
    "64/0.9": [32, 16, 57, 58, 45, 4, 42, 36],
    "64/1.0": [0, 16, 0, 0, 45, 4, 42, 36],
    "151936/None": [9225, 7656, 144488, 30491, 141411, 140739, 104416,
                    78432],
    "151936/0.5": [9225, 96180, 144488, 30491, 141411, 140739, 104416,
                   78432],
    "151936/0.9": [9225, 7656, 144488, 30491, 141411, 140739, 104416,
                   78432],
    "151936/1.0": [9225, 0, 144488, 0, 141411, 140739, 104416, 78432]}
# the train phase: full-width qwen3-0.6b steps of 8 x 1024 tokens (the
# chunked, checkpointed cross-entropy: 2 chunks of 512), the reduced
# card-vs-CPU steps at the same length, the 100M example's 300 steps.
# Card against CPU in float32 at "highest": loss within 1e-5 relative,
# each gradient leaf within 1e-4 of its leaf's max |g|; grad_accum 2
# against 1 within 1e-4 relative; remat on against off within 1e-5.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, EXAMPLE_STEPS = 8, 1024, 3, 300
TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=100)
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_ACCUM_RTOL = 1e-5, 1e-4, 1e-4
REMAT_RTOL = 1e-5
# (f) the blockwise attention (Sq*Sk > 2048**2): one sequence this long
BLOCKWISE_SEQ = 4096
# the sim phase.  (a) The planner's h100 entry fitted from full-width
# bf16 qwen3-0.6b serves on the serve phase's engine, with room for one
# 2048-token prompt: MFU from a prefill-only batch of 4 x 512 tokens,
# MBU from the median step in which all 8 rows decode (prompts of 128,
# 64 new tokens); the second point: one 2048-token prompt, and 8 rows
# at contexts near 700.  (b) The cluster simulator on the fitted card:
# birdsql-like traffic, engine-1 throttled, an engine crash; engines
# sized as the real one.  (c) Crash recovery around two real float32
# engines: 4 requests, the crash once each has 24 tokens and a
# checkpointed generated page
SIM_ECFG = dict(SERVE_ECFG, max_pages_per_seq=160)
SIM_FIT_PREFILL, SIM_FIT_DECODE = (4, 512), (8, 128, 64)
SIM_CHECK_PREFILL, SIM_CHECK_DECODE = (1, 2048), (8, 680, 40)
SIM_CLUSTER = dict(requests=400, rate_rps=8.0, engines=4, throttle_at=10.0,
                   crash_at=20.0)
SIM_ENGINE = dict(page_size=16, max_batch=8, chunk_size=64,
                  mixed_batching=True, ckpt_interval_tokens=64)
SIM_RECOVER_REQUESTS, SIM_RECOVER_PROMPTS = 4, (100, 300)
SIM_RECOVER_NEW, SIM_CRASH_AFTER = 48, 24
# the shard phase.  (a) ``normal`` / ``truncated_normal`` of
# fold_in(PRNGKey(3), 12345) over 2**20 + 5 values: the first 6 bit
# patterns and the sum of all of them, recorded from jax 0.9.0.
SHARD_DRAW_N = (1 << 20) + 5
JAX_DRAWS = {
    ("normal", "float32"): ([3218547637, 3219348457, 1057628464,
                             1063602947, 3189937786, 1055946771],
                            2234143415673488),
    ("normal", "bfloat16"): ([16305, 48887, 48865, 16144, 49047, 48821],
                             34121157881),
    ("truncated_normal", "float32"): ([3217015991, 3217570486, 1057177406,
                                       1062723893, 3189449153, 1055178664],
                                      2233236689381963),
    ("truncated_normal", "bfloat16"): ([16288, 48879, 48856, 16134, 49037,
                                        48816], 33982351337),
}
# full-width bf16 inits timed; (c) the dry-run's cases (arch:shape:mesh),
# each in a child process of its own on a fake process group of 256 /
# 512 ranks, all started with the script (a train case runs ~1.4M fake
# ops a micro-batch: qwen3-0.6b ~130 s on one core, granite's 4
# micro-batches several minutes); the phase waits at most this long
SHARD_INIT_ARCHS = ("qwen3-0.6b", "gemma3-4b", "granite-moe-3b-a800m")
SHARD_DRYRUN = ("qwen3-0.6b:train_4k:pod", "granite-moe-3b-a800m:train_4k:pod",
                "gemma3-4b:decode_32k:pod", "gemma3-4b:decode_32k:multipod")
SHARD_DRYRUN_TIMEOUT = 200
# the tp4 phase (opt-in, four cards): full-width qwen3-0.6b on these
# (data, model) meshes, granite-moe-3b-a800m at (1, 4), each against the
# unsharded step on one card; bf16 losses within this of one card's; the
# dry-run's fake-group step at (2, 2) against the real one; the phase's
# ranks must end within TP4_TIMEOUT seconds
TP4_MESHES = ((4, 1), (1, 4), (2, 2))
TP4_GRANITE_MESH, TP4_DRYRUN_MESH = (1, 4), (2, 2)
TP4_BF16_RTOL = 1e-2
TP4_TIMEOUT = 1200
# MLA, Hymba and xLSTM layers at (1, 4): full-width hymba-1.5b train
# steps and xlstm-1.3b's loss and gradient of 3 batches in float32 at
# 4 x 512 tokens (the scans are plain torch and slow, so batch and
# sequence are cut), deepseek-v2 cut
# to 3 layers in bf16 (its first batch's loss and grad norm against one
# card's value_and_grad); the split-cache decode: the dry-run's prefill
# of 8 x 1024 tokens and 8 decode steps against 4096-token caches of
# full-width hymba-1.5b and the 3-layer deepseek-v2 in float32, each
# rank's logits made whole within TP4_SERVE_TOL of one card's
TP4_LAYER_MESH = (1, 4)
TP4_LAYER_BATCH, TP4_LAYER_SEQ = 4, 512
TP4_SERVE = dict(batch=8, prompt=1024, cache_len=4096, steps=8)
TP4_SERVE_TOL = 1e-5
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
                plain_fn=None, kernel_fn=None, **kw):
        out = (kernel_fn or fns[kernel][0])(*args, **kw)
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
    # granite-moe-3b-a800m's group (H 24, Hkv 8, D 64, G 3; page 16):
    # neither G nor H is a power of two, so paged_prefill's tiles hold 21
    # query rows (R 63, rounded up to 64) and a 64-row chunk splits into
    # 21 + 21 + 21 + 1 rows; on a generator of their own
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for dt in (f32, bf16):
        compare("paged_attention",
                decode_case(torch, gen, 8, 24, 8, 64, 16, 52, dt,
                            num_pages=1025), dt, 0, "G 3 (granite) B8 NB52")
        split_case(8, 24, 8, 64, 16, 256, dt, "G 3 (granite) long context",
                   torch.randint(3072, 4097, (8,), generator=gen,
                                 device="cuda"))
        compare("paged_prefill",
                prefill_case(torch, gen, 2, 24, 8, 64, 16, 64, 52, dt,
                             [0, 40], [64, 64], num_pages=1025), dt, 1,
                "G 3 (granite) K2 S64 NB52 ctx 0 and 40 (across pages)")
        compare("paged_prefill",
                prefill_case(torch, gen, 2, 24, 8, 64, 16, 64, 52, dt,
                             [700, 15], [37, 64], num_pages=1025), dt, 1,
                "G 3 (granite) K2 S64 NB52 ctx 700 and 15, rows 37 and 64",
                extra=lambda o: bool((o[0, 37:] == 0).all()))
    # paged_prefill at speculative verify shapes, through
    # ops.paged_verify (lanes of 1 + drafts rows, padded to 8): 4 lanes,
    # one ending on a page boundary, one crossing one, one idle (zeros),
    # one at context 0, on a generator of their own
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for dt in (f32, bf16):
        for s_, h, hkv, d in [(2, 16, 8, 64), (5, 16, 8, 64),
                              (5, 32, 2, 128), (2, 32, 2, 128),
                              (5, 24, 8, 64)]:
            ctx = [48 - s_, 63, 20, 0]          # page 16: 48 ends page 3
            chunk = [s_, s_, 0, max(s_ - 1, 1)]
            compare("paged_prefill",
                    prefill_case(torch, gen, 4, h, hkv, d, 16, s_, 8, dt,
                                 ctx, chunk), dt, 1,
                    f"verify lanes S{s_} G{h // hkv} H{h} Hkv{hkv} D{d} "
                    f"ctx {ctx} rows {chunk}",
                    kernel_fn=ops_mod.paged_verify,
                    extra=lambda o: bool((o[2] == 0).all()
                                         and (o[0] != 0).any()))
    # hymba-1.5b at full width: H 25, Hkv 5 (G 5: the bf16 body holds 60
    # of its tile's 64 rows), D 64, a prompt past the 1024 window, with
    # the SWA layers' window and without (the global layers); on a
    # generator of their own
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    s_h = HYMBA_FLASH_SEQ
    for dt in (f32, bf16):
        for win in (1024, 0):
            compare("flash_prefill",
                    flash_case(torch, gen, 1, s_h, s_h, 25, 5, 64, dt,
                               [s_h]), dt, 1,
                    f"hymba-1.5b B1 S{s_h} H25 Hkv5 D64 window{win}",
                    window=win)
    # the float32 twins of the bf16-only prefill cases above, which the
    # 3xTF32 tile (attn_tile_f32.cuh) takes: G 3, 5 and 16, D 48, 128,
    # 192 and 256, D 256 with Sq no multiple of 64, ragged and window-edge
    # rows; and D 8 and 40, which it pads to 32 and 64 columns.  On a
    # generator of their own.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    for b, h, hkv, d, page, s in [
            (2, 9, 3, 64, 16, 40), (2, 10, 2, 64, 16, 40),
            (1, 16, 1, 64, 16, 64), (2, 4, 2, 48, 16, 40),
            (2, 8, 4, 128, 16, 64), (1, 8, 4, 256, 16, 64),
            (2, 8, 4, 8, 16, 40), (2, 8, 2, 40, 8, 24)]:
        compare("paged_prefill",
                prefill_case(torch, gen, b, h, hkv, d, page, s, 24, f32),
                f32, 1, f"B{b} H{h} Hkv{hkv} D{d} page{page} S{s}")
    for b, sq, sk, h, hkv, d, win, qoff in [
            (1, 200, 200, 9, 3, 64, 0, 0), (2, 150, 250, 10, 2, 64, 64, 100),
            (1, 100, 100, 16, 1, 64, 0, 0), (2, 130, 130, 4, 2, 48, 0, 0),
            (1, 300, 300, 8, 4, 128, 128, 0), (1, 300, 300, 4, 2, 192, 0, 0),
            (1, 1000, 1000, 8, 4, 256, 0, 0),
            (2, 1000, 1000, 8, 4, 256, 300, 0),
            (2, 130, 170, 4, 2, 8, 0, 40), (1, 150, 150, 6, 2, 40, 32, 0)]:
        compare("flash_prefill",
                flash_case(torch, gen, b, sq, sk, h, hkv, d, f32), f32, 1,
                f"B{b} Sq{sq} Sk{sk} H{h} Hkv{hkv} D{d} window{win} "
                f"q_offset{qoff}", window=win, q_offset=qoff)
    # a D the float32 tile does not take raises before a launch
    before = (pp.launches, fp.launches)
    for kernel, fn, args in (
            ("paged_prefill", ops_mod.paged_prefill, prefill_case(
                torch, gen, 1, 4, 2, 36, 8, 16, 4, f32)),
            ("flash_prefill", ops_mod.flash_attention, flash_case(
                torch, gen, 1, 16, 16, 4, 2, 264, f32))):
        try:
            fn(*args)
            refused = False
        except ValueError:
            refused = True
        results.append(dict(kernel=kernel, dtype="float32",
                            case=f"D {args[0].shape[-1]} refused",
                            max_abs_err=0.0, tol=0.0,
                            ok=refused and (pp.launches,
                                            fp.launches) == before))
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
    ``prefill_step``, ``decode_batch`` and ``spec_decode_step`` over the
    decode rows' tables, 7 lanes of 5 rows and an idle one) once with
    the kernels and once with the plain versions, on the same weights
    and pool.  Returns the paged kernels' launches in the kernel runs."""
    from repro_torch.engine import paged_model as PM
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    spec_tokens = torch.randint(0, cfg.vocab_size, (b, SPEC_TOKENS + 1),
                                generator=gen, device="cuda").to(torch.int32)
    spec_len = torch.full((b,), SPEC_TOKENS + 1, dtype=torch.int32,
                          device="cuda")
    spec_len[-1] = 0
    spec_ctx = a["dec_positions"].clamp(
        max=a["dec_block_tables"].shape[1] * page - SPEC_TOKENS - 1)
    steps["spec_decode_step"] = lambda p, impl: PM.spec_decode_step(
        params, p, spec_tokens, spec_ctx, spec_len, a["dec_block_tables"],
        cfg=cfg, page_size=page, impl=impl)[0].flatten(0, 1)
    counts = dict.fromkeys(("paged_attention", "paged_prefill"), 0)
    for step, run in steps.items():
        outs = {}
        for impl in ("kernel", "ref"):
            p = PM.PagePool(pool.k.clone(), pool.v.clone())
            before = (pa.launches, pp.launches)
            outs[impl] = (run(p, impl).float(), p)
            if impl == "kernel":
                counts["paged_attention"] += pa.launches - before[0]
                counts["paged_prefill"] += pp.launches - before[1]
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
    return counts


# ------------------------------------------------------------ serving
def counted(torch, eng, pa, pp, drive, steps=None):
    """Run ``drive()`` on ``eng`` with the paged kernels' counts set to 0
    just before and read just after; returns the steps by mode (an async
    loop's overlapped decode dispatch as ``async_decode``), the
    launches, and the launches expected: one a layer for each step that
    needs the kernel.  Given a list ``steps``, each executed step is
    also timed between two synchronizes and the list gains ``(mode,
    decode rows, their mean context, seconds)`` (a row's context: the
    tokens it attends to).  The hooks are taken off afterwards."""
    modes = {"decode": 0, "prefill": 0, "mixed": 0, "idle": 0,
             "async_decode": 0}
    exec_, dispatch = eng._exec, eng._dispatch_async

    def recording_exec(out):
        modes[out.mode] += 1
        if steps is None:
            return exec_(out)
        ctx = [r.prompt_len + len(r.output_tokens) for r in out.decode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = exec_(out)
        torch.cuda.synchronize()
        steps.append((out.mode, len(ctx), sum(ctx) / max(len(ctx), 1),
                      time.perf_counter() - t0))
        return n

    def recording_dispatch(reqs):
        modes["async_decode"] += 1
        return dispatch(reqs)

    eng._exec, eng._dispatch_async = recording_exec, recording_dispatch
    torch.cuda.synchronize()
    pa.launches = pp.launches = 0
    drive()
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.launches, "paged_prefill": pp.launches}
    del eng._exec, eng._dispatch_async      # back to the class's methods
    n = eng.cfg.n_layers
    want = {"paged_attention": n * (modes["decode"] + modes["mixed"]
                                    + modes["async_decode"]),
            "paged_prefill": n * (modes["prefill"] + modes["mixed"])}
    return modes, launches, want


def greedy(Request, SamplingParams, prompt, n, **kw):
    return Request(prompt_tokens=list(prompt),
                   sampling=SamplingParams(max_new_tokens=n), **kw)


def serve_once(torch, cfg, prompts, pa, pp, async_loop=False):
    """One serve of ``prompts`` on a fresh engine.  With ``async_loop``
    every async decode dispatch runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a wait for the card
    raises."""
    from repro_torch.engine import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)
    ecfg = EngineConfig(**SERVE_ECFG, async_loop=async_loop)
    eng = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    reqs = [greedy(Request, SamplingParams, p, MAX_NEW) for p in prompts]
    guarded = [0]
    run_async = eng.runner.run_decode_async

    def guarded_run_async(reqs, prev):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run_async(reqs, prev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            guarded[0] += 1

    eng.runner.run_decode_async = guarded_run_async

    def drive():
        # the first request arrives alone (a lone prefill step), the
        # rest while it is prefilling
        eng.submit(reqs[0])
        eng.step()
        for r in reqs[1:]:
            eng.submit(r)
        eng.run_until_idle()
    t0 = time.perf_counter()
    modes, launches, want = counted(torch, eng, pa, pp, drive)
    wall = time.perf_counter() - t0
    finished = sum(r.state.name == "FINISHED"
                   and len(r.output_tokens) == MAX_NEW for r in reqs)
    ttft = [r.ttft for r in reqs]
    free, total = eng.alloc.num_free, eng.alloc.num_pages
    tokens = [list(r.output_tokens) for r in reqs]
    device_wait_s = eng.metrics().device_wait_s
    del eng
    gc.collect()            # the hooks above hold the engine in a cycle
    torch.cuda.empty_cache()
    return dict(tokens=tokens, modes=modes, launches=launches, want=want,
                finished=finished, wall_s=wall, ttft=ttft,
                free_pages=free, num_pages=total, guarded=guarded[0],
                device_wait_s=device_wait_s)


def serve_prompts(cfg):
    """The serve phase's 16 prompts of 128-768 random tokens."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    return lens, [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                  for n in lens]


def serve(torch, cfg, pa, pp):
    """Phase 5: the full-width bf16 serve, twice."""
    import numpy as np
    lens, prompts = serve_prompts(cfg)
    runs = [serve_once(torch, cfg, prompts, pa, pp) for _ in range(2)]
    smi = nvidia_smi()
    for i, run in enumerate(runs):
        m, want = run["modes"], run["want"]
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
    return runs[0]


# ------------------------------------------------------------ launcher
def launch_serve(torch, cfg, argv, pa, pp, engine_kw, guard_dispatch=False):
    """One serve through the port's launcher (``repro_torch.launch.serve``:
    its arguments, gateway, role pools and request loop) at ``cfg`` on the
    card, with ``engine_kw`` as the engines' sizes.  Each engine the
    launcher builds is instrumented: its kinds of step, the paged
    kernels' launches made inside its steps, and the order of its
    submits and steps (for a lone replay).  The kernels' counts are set
    to 0 just before the serve and read just after.  With
    ``guard_dispatch`` every async decode dispatch runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a dispatch that waits
    for the card raises."""
    import contextlib
    import io

    import numpy as np
    from repro_torch.engine import InferenceEngine
    from repro_torch.launch import serve as L
    made = {}
    guarded = [0]

    def count(eid, key):
        made[eid]["kinds"][key] = made[eid]["kinds"].get(key, 0) + 1

    def factory(cfg_, ecfg, **kw):
        eng = InferenceEngine(cfg_, ecfg, **kw)
        eid = kw["engine_id"]
        rec = made[eid] = dict(eng=eng, ecfg=ecfg, seed=kw.get("seed", 0),
                               kinds={}, events=[], launches={
                                   "paged_attention": 0, "paged_prefill": 0})
        step, submit, exec_ = eng.step, eng.submit, eng._exec
        dispatch = eng._dispatch_async
        run_async = eng.runner.run_decode_async

        def step_():
            rec["events"].append(None)
            a, b = pa.launches, pp.launches
            try:
                return step()
            finally:
                rec["launches"]["paged_attention"] += pa.launches - a
                rec["launches"]["paged_prefill"] += pp.launches - b

        def submit_(r):
            rec["events"].append(r)
            return submit(r)

        def exec__(out):
            key = out.mode
            if out.spec:
                key = ("spec_mixed" if any(w.chunk_len for w in out.prefills)
                       else "spec_decode")
            count(eid, key)
            return exec_(out)

        def dispatch_(reqs):
            count(eid, "async_decode")
            return dispatch(reqs)

        def run_async_(reqs, prev):
            if not guard_dispatch:
                return run_async(reqs, prev)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return run_async(reqs, prev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                guarded[0] += 1
        eng.step, eng.submit, eng._exec = step_, submit_, exec__
        eng._dispatch_async = dispatch_
        eng.runner.run_decode_async = run_async_
        return eng

    args = L.parse_args(argv)
    report = io.StringIO()
    L.InferenceEngine = factory
    try:
        torch.cuda.synchronize()
        pa.launches = pp.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(report):
            served = L.serve(cfg, args, device="cuda", engine_kw=engine_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        L.InferenceEngine = InferenceEngine
    total = {"paged_attention": pa.launches, "paged_prefill": pp.launches}
    reqs = [r for _, r in served.reqs]
    n = cfg.n_layers
    engines = {}
    for eid, rec in made.items():
        eng, k = rec["eng"], rec["kinds"]
        m = eng.metrics()
        want = {"paged_attention": n * (k.get("decode", 0) + k.get("mixed", 0)
                                        + k.get("async_decode", 0)),
                "paged_prefill": n * (k.get("prefill", 0) + k.get("mixed", 0)
                                      + k.get("spec_decode", 0))
                + 2 * n * k.get("spec_mixed", 0)}
        engines[eid] = dict(
            role=served.manager.role_of(eid), seed=rec["seed"], steps=k,
            launches=rec["launches"], expected_launches=want,
            routed=served.gateway.stats.per_engine.get(eid, 0),
            finished=m.finished_requests,
            prefix_hit_tokens=m.prefix_hit_tokens,
            remote_hit_tokens=m.remote_hit_tokens,
            free_pages=eng.alloc.num_free, num_pages=eng.alloc.num_pages,
            device_wait_s=m.device_wait_s,
            host_overhead_frac=m.host_overhead_frac,
            spec_drafted_tokens=m.spec_drafted_tokens,
            spec_accepted_tokens=m.spec_accepted_tokens)
    gen = sum(len(r.output_tokens) for r in reqs)
    out = dict(
        tokens=[list(r.output_tokens) for r in reqs],
        routed_to=[eid for eid, _ in served.reqs],
        finished=sum(r.state.name == "FINISHED"
                     and len(r.output_tokens) == args.max_new for r in reqs),
        engines=engines, launches=total, wall_s=wall,
        output_tokens_per_s=gen / wall,
        mean_ttft_s=float(np.mean([r.ttft for r in reqs])),
        guarded_dispatches=guarded[0], report=report.getvalue(),
        pool=(None if served.pool is None else dict(
            puts=served.pool.stats.puts,
            hits=served.pool.stats.hits_local
            + served.pool.stats.hits_remote)),
        events={eid: rec["events"] for eid, rec in made.items()},
        recs={eid: (rec["ecfg"], rec["seed"]) for eid, rec in made.items()})
    del served, made, engines
    gc.collect()            # an engine's hooks hold it in a cycle
    torch.cuda.empty_cache()
    return out


def lone_replay(torch, cfg, ecfg, seed, events, pa, pp, max_new):
    """A lone engine (``ecfg``, ``seed``) fed what one engine of a served
    group was fed: the same prompts submitted at the same points between
    its steps, then run to idle; returns each request's tokens (by the
    identity of the group's request) and ``counted``'s result."""
    from repro_torch.engine import InferenceEngine, Request, SamplingParams
    eng = InferenceEngine(cfg, ecfg, seed=seed, device="cuda")
    mine = {}

    def drive():
        for ev in events:
            if ev is None:
                eng.step()
            else:
                mine[id(ev)] = greedy(Request, SamplingParams,
                                      ev.prompt_tokens, max_new)
                eng.submit(mine[id(ev)])
        eng.run_until_idle()
    counts = counted(torch, eng, pa, pp, drive)
    free = eng.alloc.num_free == eng.alloc.num_pages
    del eng
    gc.collect()            # an engine's hooks hold it in a cycle
    torch.cuda.empty_cache()
    return {k: list(r.output_tokens) for k, r in mine.items()}, counts, free


def launch(torch, cfg, pa, pp):
    """The launch phase: the port's launcher (gateway, role pools, request
    loop) at qwen3-0.6b's full width on the card; see the module's
    docstring."""
    import dataclasses
    smi = nvidia_smi()
    base = ["--requests", str(LAUNCH_REQUESTS), "--prompt-len",
            str(LAUNCH_PROMPT), "--max-new", str(LAUNCH_MAX_NEW)]
    mixed = base + ["--roles", "mixed", "--engines", "2",
                    "--policy", "prefix-cache-aware"]
    logs = []

    def check(item, run, ok, **fields):
        emit("launch", item=item, model=cfg.name, requests=LAUNCH_REQUESTS,
             prompt_len=LAUNCH_PROMPT, max_new=LAUNCH_MAX_NEW,
             finished=run["finished"], launches=run["launches"],
             engines=run["engines"], wall_s=run["wall_s"],
             output_tokens_per_s=run["output_tokens_per_s"],
             mean_ttft_s=run["mean_ttft_s"], **fields, card=smi,
             ok=bool(ok))
        logs.append(f"== {item}\n{run['report']}")
        if not ok:
            raise AssertionError(f"launch: {item} failed its checks")

    def served_ok(run):
        return (run["finished"] == LAUNCH_REQUESTS
                and all(e["free_pages"] == e["num_pages"]
                        for e in run["engines"].values())
                and sum(e["launches"]["paged_attention"]
                        for e in run["engines"].values())
                == run["launches"]["paged_attention"]
                and sum(e["launches"]["paged_prefill"]
                        for e in run["engines"].values())
                == run["launches"]["paged_prefill"])

    def versus_lone(events, toks):
        """(group tokens, lone tokens) of each request submitted in
        ``events``, and whether all LAUNCH_REQUESTS are there, equal."""
        pairs = [(list(r.output_tokens), toks[id(r)]) for r in events
                 if r is not None]
        return pairs, (len(pairs) == LAUNCH_REQUESTS
                       and all(a == b for a, b in pairs))

    bf16 = dict(SERVE_ECFG)
    try:
        # 1. two colocated engines, prefix-cache-aware routing
        sync = launch_serve(torch, cfg, mixed, pa, pp, bf16)
        events, lone, lone_ok = [], {}, True
        for eid, evs in sync["events"].items():
            ecfg, seed = sync["recs"][eid]
            toks, (modes, launches, want), free = lone_replay(
                torch, cfg, ecfg, seed, evs, pa, pp, LAUNCH_MAX_NEW)
            events += evs
            lone.update(toks)
            lone_ok = lone_ok and free and launches == want
        _, same = versus_lone(events, lone)
        both = all(min(e["launches"].values()) > 0
                   and e["launches"] == e["expected_launches"]
                   for e in sync["engines"].values())
        check("mixed x2, prefix-cache-aware", sync,
              served_ok(sync) and same and lone_ok and both,
              routing={eid: e["routed"] for eid, e in
                       sync["engines"].items()},
              same_tokens_as_lone_engines=same)

        # 2. 1P1D over the raw wire, every engine seed 0, against a lone
        # seed-0 engine fed the same arrivals.  The decode engine's
        # batches are not the lone engine's, and in bf16 the rounding
        # follows the batch (cuBLAS's tiles, paged_attention's split
        # plan): the tokens are held equal in float32, and bf16's share
        # of equal tokens is printed
        for dtype in ("bfloat16", "float32"):
            pd = launch_serve(torch, cfg, base + [
                "--roles", "1P1D", "--wire-dtype", "fp"], pa, pp,
                dict(SERVE_ECFG, dtype=dtype))
            pre = next(eid for eid, e in pd["engines"].items()
                       if e["role"] == "prefill")
            ecfg, _ = pd["recs"][pre]
            arrivals = []
            for ev in pd["events"][pre]:
                if ev is not None:
                    arrivals += [ev, None]      # the launcher pumps once
            toks, counts, free = lone_replay(
                torch, cfg, dataclasses.replace(ecfg, role="mixed"), 0,
                arrivals, pa, pp, LAUNCH_MAX_NEW)
            pairs, same_pd = versus_lone(pd["events"][pre], toks)
            equal = sum(x == y for a, b in pairs for x, y in zip(a, b))
            first = [next((j for j, (x, y) in enumerate(zip(a, b))
                           if x != y), None) for a, b in pairs]
            check(f"1P1D, fp wire, {dtype}", pd,
                  served_ok(pd) and free and counts[1] == counts[2]
                  and pd["pool"]["puts"] > 0 and pd["pool"]["hits"] > 0
                  and (same_pd or dtype == "bfloat16"),
                  dtype=dtype, pool=pd["pool"],
                  same_tokens_as_lone_seed0_engine=same_pd,
                  share_of_tokens_equal=equal / (LAUNCH_REQUESTS
                                                 * LAUNCH_MAX_NEW),
                  first_different_token_by_request=first)
            del pd

        # 3. item 1 with the async loop; its dispatches under the sync
        # debug mode
        asy = launch_serve(torch, cfg, mixed + ["--async-loop"], pa, pp,
                           bf16, guard_dispatch=True)
        same_async = (asy["tokens"] == sync["tokens"]
                      and asy["routed_to"] == sync["routed_to"])
        dispatched = sum(e["steps"].get("async_decode", 0)
                         for e in asy["engines"].values())
        both = all(min(e["launches"].values()) > 0
                   and e["launches"] == e["expected_launches"]
                   for e in asy["engines"].values())
        # the sync serve again, so that sync and async walls are taken in
        # turns (sync, async, sync) in one call
        again = launch_serve(torch, cfg, mixed, pa, pp, bf16)
        check("mixed x2, again", again, served_ok(again)
              and again["tokens"] == sync["tokens"],
              same_tokens_as_first_serve=again["tokens"] == sync["tokens"])
        check("mixed x2, --async-loop", asy,
              served_ok(asy) and same_async and both and dispatched > 0
              and asy["guarded_dispatches"] == dispatched,
              same_tokens_as_sync=same_async,
              async_dispatches=dispatched,
              dispatches_without_a_sync=asy["guarded_dispatches"],
              sync_walls_s=[sync["wall_s"], again["wall_s"]],
              async_wall_s=asy["wall_s"],
              async_over_mean_sync_wall=2 * asy["wall_s"]
              / (sync["wall_s"] + again["wall_s"]))

        # 4. speculation with the async loop, against the sync loop; in
        # float32, where speculation keeps the tokens (bf16 verify lanes
        # and decode rows take different kernels: see the spec phase)
        f32 = dict(SERVE_ECFG, dtype="float32")
        sync32 = launch_serve(torch, cfg, mixed, pa, pp, f32)
        spec = launch_serve(torch, cfg, mixed + [
            "--spec-tokens", "4", "--async-loop"], pa, pp, f32)
        same_spec = (spec["tokens"] == sync32["tokens"]
                     and spec["routed_to"] == sync32["routed_to"])
        drafted = sum(e["spec_drafted_tokens"]
                      for e in spec["engines"].values())
        check("mixed x2, float32, sync", sync32, served_ok(sync32))
        check("mixed x2, float32, --spec-tokens 4 --async-loop", spec,
              served_ok(spec) and same_spec and drafted > 0
              and all(e["launches"] == e["expected_launches"]
                      for e in spec["engines"].values()),
              same_tokens_as_float32_sync=same_spec,
              spec_drafted_tokens=drafted)
    finally:
        out = ROOT / "build"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_launch.log").write_text("\n".join(logs))


# ------------------------------------------------------------ LoRA, tiers
def lora_step(torch, cfg):
    """Phase 6 (a): one float32 ``mixed_step`` at full width with a
    bank of 4 random adapters (decode rows and chunks on different
    adapters, some rows on the base model), with the kernels and with the
    plain versions: logits and pools must agree, and the adapters must
    change the logits."""
    from repro_torch import random as R
    from repro_torch.engine import paged_model as PM
    params, pool, a, page = step_inputs(torch, cfg, torch.float32)
    bank = PM.init_lora(cfg, LORA_ADAPTERS + 1, LORA_RANK, torch.float32,
                        "cuda")
    for i in range(1, LORA_ADAPTERS + 1):
        for k, w in PM.make_adapter(cfg, LORA_RANK,
                                    R.prng_key(100 + i)).items():
            bank[k][i].copy_(w)
    ids = dict(dec_adapter_ids=torch.tensor(
        [1, 2, 0, 3, 4, 0, 1, 0], dtype=torch.int32, device="cuda"),
        pre_adapter_ids=torch.tensor([3, 0], dtype=torch.int32,
                                     device="cuda"))
    outs = {}
    for label, impl, lora in (("kernel", "kernel", bank), ("ref", "ref", bank),
                              ("off", "kernel", None)):
        p = PM.PagePool(pool.k.clone(), pool.v.clone())
        d, pr, _ = PM.mixed_step(params, p, **a, lora=lora,
                                 **(ids if lora is not None else {}),
                                 cfg=cfg, page_size=page, impl=impl)
        outs[label] = (torch.cat([d, pr]).float(), p)
    torch.cuda.synchronize()
    (lk, pk), (lr, prf), (lo, _) = outs["kernel"], outs["ref"], outs["off"]
    scale = lr.abs().max().item()
    err = (lk - lr).abs().max().item()
    pool_err = max((pk.k - prf.k).abs().max().item(),
                   (pk.v - prf.v).abs().max().item())
    pool_scale = prf.k.abs().max().item()
    # rows 0..7 decode (row 7 idle), 8 and 9 the chunks' last rows
    adapter_rows, base_rows = [0, 1, 3, 4, 6, 8], [2, 5, 9]
    lora_effect = (lk[adapter_rows] - lo[adapter_rows]).abs().max().item()
    base_diff = (lk[base_rows] - lo[base_rows]).abs().max().item()
    ok = (bool(torch.isfinite(lk).all()) and err <= STEP_REL_TOL * scale
          and pool_err <= STEP_REL_TOL * pool_scale
          and lora_effect > STEP_REL_TOL * scale
          and base_diff <= STEP_REL_TOL * scale)
    emit("lora_step", step="mixed_step", model=cfg.name, dtype="float32",
         adapters=LORA_ADAPTERS, rank=LORA_RANK,
         dec_adapter_ids=ids["dec_adapter_ids"].tolist(),
         pre_adapter_ids=ids["pre_adapter_ids"].tolist(),
         logits_max_abs=scale, max_abs_err=err, pool_max_abs_err=pool_err,
         lora_on_off_max_abs=lora_effect, base_rows_on_off_max_abs=base_diff,
         rel_tol=STEP_REL_TOL, ok=ok)
    if not ok:
        raise AssertionError("full-width LoRA mixed_step failed its checks")
    del params, pool, bank, outs


def lora_serve_once(torch, cfg, prompts, pa, pp):
    """Three waves through one bf16 engine whose bank holds 7 adapters:
    base + lora-0..5 (7 requests), base + lora-6..9 (5: the bank evicts
    three of the first wave's adapters to the host tier), then base + the
    three evicted names (4: they come back from the host tier).  Each
    wave is submitted at once and served to the end."""
    from repro_torch.engine import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)
    eng = InferenceEngine(cfg, EngineConfig(**LORA_ECFG), seed=0,
                          device="cuda")
    waves = [[None] + [f"lora-{i}" for i in range(6)],
             [None] + [f"lora-{i}" for i in range(6, 10)]]
    reqs, modes, launches, want = [], {}, {}, {}
    t0 = time.perf_counter()
    for w in range(3):
        if w == 2:
            evicted = sorted(set(waves[0][1:]) - set(eng.adapters))
            waves.append([None] + evicted)
        wave = [greedy(Request, SamplingParams, prompts[len(reqs) + i],
                       LORA_MAX_NEW, lora_adapter=name)
                for i, name in enumerate(waves[w])]
        reqs += wave

        def drive():
            for r in wave:
                eng.submit(r)
            eng.run_until_idle()
        m, n, x = counted(torch, eng, pa, pp, drive)
        for d, part in ((modes, m), (launches, n), (want, x)):
            for k, v in part.items():
                d[k] = d.get(k, 0) + v
    wall = time.perf_counter() - t0
    met = eng.metrics()
    out = dict(adapters=[r.lora_adapter for r in reqs],
               tokens=[list(r.output_tokens) for r in reqs],
               finished=sum(r.state.name == "FINISHED"
                            and len(r.output_tokens) == LORA_MAX_NEW
                            for r in reqs),
               modes=modes, launches=launches, want=want, wall_s=wall,
               free_pages=eng.alloc.num_free, num_pages=eng.alloc.num_pages,
               lora_cold_loads=met.lora_cold_loads,
               lora_cold_load_s=met.lora_cold_load_s,
               lora_evictions=met.lora_evictions,
               lora_host_hits=met.lora_host_hits, lora_miss=met.lora_miss,
               loaded=list(met.loaded_adapters))
    del eng
    torch.cuda.empty_cache()
    return out


def lora_serve(torch, cfg, pa, pp):
    """Phase 6 (b): the bf16 multi-LoRA serve, twice on fresh engines,
    then 3 of its requests each alone on a fresh engine."""
    import numpy as np
    from repro_torch.engine import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)
    rng = np.random.default_rng(5)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    runs = [lora_serve_once(torch, cfg, prompts, pa, pp) for _ in range(2)]
    smi = nvidia_smi()
    for i, run in enumerate(runs):
        gen_tokens = sum(len(t) for t in run["tokens"])
        ok = (run["finished"] == N_REQUESTS
              and run["free_pages"] == run["num_pages"]
              and run["launches"] == run["want"]
              and run["lora_evictions"] > 0 and run["lora_host_hits"] > 0
              and run["lora_miss"] == 0
              and run["adapters"] == runs[0]["adapters"]
              and run["tokens"] == runs[0]["tokens"])
        emit("lora_serve", run=i + 1, model=cfg.name, config=LORA_ECFG,
             requests=N_REQUESTS, adapters=run["adapters"],
             distinct_adapters=len({a for a in run["adapters"] if a}),
             generated_tokens=gen_tokens, finished=run["finished"],
             free_pages=run["free_pages"], num_pages=run["num_pages"],
             steps=run["modes"], launches=run["launches"],
             expected_launches=run["want"],
             lora_cold_loads=run["lora_cold_loads"],
             lora_cold_load_s=run["lora_cold_load_s"],
             lora_evictions=run["lora_evictions"],
             lora_host_hits=run["lora_host_hits"],
             lora_miss=run["lora_miss"], loaded_adapters=run["loaded"],
             same_tokens_as_run_1=run["tokens"] == runs[0]["tokens"],
             wall_s=run["wall_s"],
             output_tokens_per_s=gen_tokens / run["wall_s"], card=smi, ok=ok)
        if not ok:
            raise AssertionError(f"LoRA serve run {i + 1} failed its checks")
    # alone on a fresh engine: the base row of wave 1, an adapter of wave
    # 1, and an adapter that came back through the host tier in wave 3
    picks = [0, 1, N_REQUESTS - 1]
    for j in picks:
        eng = InferenceEngine(cfg, EngineConfig(**LORA_ECFG), seed=0,
                              device="cuda")
        r = greedy(Request, SamplingParams, prompts[j], LORA_MAX_NEW,
                   lora_adapter=runs[0]["adapters"][j])
        eng.submit(r)
        eng.run_until_idle()
        batch = runs[0]["tokens"][j]
        first_diff = next((t for t, (x, y) in enumerate(zip(
            r.output_tokens, batch)) if x != y), None)
        ok = list(r.output_tokens) == batch
        emit("lora_alone", request=j, adapter=runs[0]["adapters"][j],
             same_tokens_as_batch=ok, first_divergent_token=first_diff,
             ok=ok)
        del eng
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"request {j} alone differs from the batch")


def adapter_load_times(torch, cfg):
    """Cold-load (from the name) and host-hit load of one adapter into a
    bf16 bank, wall ms each, 8 of each (the runner syncs the card)."""
    from repro_torch.engine import EngineConfig, InferenceEngine
    eng = InferenceEngine(cfg, EngineConfig(**LORA_ECFG), seed=0,
                          device="cuda")
    r = eng.runner
    cold, host = [], []
    for i in range(8):
        t0 = time.perf_counter()
        r.register_adapter(f"load-{i}")
        cold.append((time.perf_counter() - t0) * 1e3)
        r.unregister_adapter(f"load-{i}")
        t0 = time.perf_counter()
        r.register_adapter(f"load-{i}")
        host.append((time.perf_counter() - t0) * 1e3)
        r.unregister_adapter(f"load-{i}")
    nbytes = sum(t[1].numel() * t.element_size() for t in r.lora.values())
    emit("adapter_load", model=cfg.name, rank=LORA_RANK, dtype="bfloat16",
         adapter_bytes=nbytes, cold_ms=cold, host_hit_ms=host,
         host_hits=r.adapter_host_hits, card=nvidia_smi())
    del eng
    torch.cuda.empty_cache()


def tier_engine(cfg, **kw):
    from repro_torch.engine import EngineConfig, InferenceEngine
    ecfg = dict(TIER_ECFG)
    extra = {k: kw.pop(k) for k in ("clock", "kv_pool_client", "engine_id")
             if k in kw}
    ecfg.update(kw)
    return InferenceEngine(cfg, EngineConfig(**ecfg), seed=0, device="cuda",
                           **extra)


def tiers(torch, cfg, pa, pp):
    """Phase 7 (bf16, full width): swap preemption, host-tier prefix,
    SSD cascade with promotion, P/D over the raw and the int8 wire, and
    the time of one page's payload off the card and back."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.core.kvcache import DistributedKVPool
    from repro_torch.engine import Request, SamplingParams
    rng = np.random.default_rng(9)
    n_new = TIER_MAX_NEW

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    def serve(eng, toks, **kw):
        r = greedy(Request, SamplingParams, toks, n_new, **kw)
        eng.submit(r)
        eng.run_until_idle()
        return list(r.output_tokens)

    def check(name, ok, **fields):
        emit("tiers", check=name, model=cfg.name, dtype="bfloat16", **fields,
             ok=bool(ok))
        if not ok:
            raise AssertionError(f"tiers: {name} failed")

    def launch_fields(counts):
        modes, launches, want = counts
        return dict(steps=modes, launches=launches, expected_launches=want)

    # swap preemption: preempt a decoding request, resume from the host tier
    p = prompt(300)
    ref = serve(tier_engine(cfg), p)
    eng = tier_engine(cfg, host_cache_gb=1.0)
    req = greedy(Request, SamplingParams, p, n_new)

    swapped = []

    def drive_swap():
        eng.submit(req)
        while len(req.output_tokens) < n_new // 2:
            eng.step()
        eng.sched.preempt(req, eng.clock())
        swapped.append(req.state.name)
        eng.run_until_idle()
    counts = counted(torch, eng, pa, pp, drive_swap)
    m = eng.metrics()
    check("swap preemption", req.output_tokens == ref
          and swapped == ["SWAPPED"] and m.swap_out == m.swap_in == 1
          and counts[1] == counts[2]
          and eng.alloc.num_free == eng.alloc.num_pages,
          swap_out=m.swap_out, swap_in=m.swap_in,
          kv_bytes_offloaded=m.kv_bytes_offloaded,
          kv_bytes_fetched=m.kv_bytes_fetched,
          same_tokens_as_unpreempted=req.output_tokens == ref,
          **launch_fields(counts))
    del eng

    # host-tier prefix: evicted from the device under page pressure
    shared = prompt(256)
    eng = tier_engine(cfg, host_cache_gb=1.0, num_pages=64)
    first = serve(eng, shared)
    for _ in range(3):
        serve(eng, prompt(700))
    out = {}
    counts = counted(torch, eng, pa, pp,
                     lambda: out.setdefault("again", serve(eng, shared)))
    m = eng.metrics()
    check("host-tier prefix", out["again"] == first
          and m.host_hit_tokens > 0 and counts[1] == counts[2],
          device_evictions=eng.sched.alloc.stats["evictions"],
          host_puts=eng.host_pool.stats.puts,
          host_hit_tokens=m.host_hit_tokens,
          same_tokens_as_first=out["again"] == first,
          **launch_fields(counts))
    page_bytes = eng.runner.page_bytes
    del eng

    # SSD tier: device -> host (24 pages) -> SSD, then promotion back
    ssd_dir = tempfile.mkdtemp(prefix="chip-smoke-ssd-")
    try:
        eng = tier_engine(cfg, num_pages=64,
                          host_cache_gb=24 * page_bytes / (1 << 30),
                          ssd_cache_gb=1.0, ssd_dir=ssd_dir)
        first = serve(eng, shared, session_id="conv0")
        for _ in range(3):
            serve(eng, prompt(700))
        eng.ssd_pool.drain()
        promotable = eng.sched.session_promotable("conv0")
        queued = eng.promote_session("conv0")
        eng.drain_promotions()
        out = {}
        counts = counted(torch, eng, pa, pp, lambda: out.setdefault(
            "again", serve(eng, shared, session_id="conv0")))
        m = eng.metrics()
        check("SSD tier with promotion", out["again"] == first
              and queued == len(promotable) > 0 and m.promote_hits > 0
              and counts[1] == counts[2],
              ssd_puts=eng.ssd_pool.stats.puts,
              ssd_bytes_written=eng.ssd_pool.stats.bytes_written,
              promoted=queued, promote_hits=m.promote_hits,
              host_hit_tokens=m.host_hit_tokens,
              same_tokens_as_first=out["again"] == first,
              **launch_fields(counts))
        del eng
    finally:
        shutil.rmtree(ssd_dir, ignore_errors=True)

    # P/D: a prefill engine publishes to the pool, a decode engine pulls
    p = prompt(400)
    ref = serve(tier_engine(cfg), p)
    for wire in ("fp", "int8"):
        t0 = time.monotonic()
        clock = lambda: time.monotonic() - t0    # noqa: E731
        pool = DistributedKVPool(capacity_bytes=8 << 30, metadata_lag=0.0,
                                 clock=clock)
        kw = dict(wire_dtype=wire, clock=clock, kv_pool_client=pool)
        pre = tier_engine(cfg, role="prefill", engine_id="p0", **kw)
        dec = tier_engine(cfg, role="decode", engine_id="d0", **kw)
        pre.handoff = dec.submit
        req = greedy(Request, SamplingParams, p, n_new)
        pre.submit(req)
        for _ in range(1000):
            if not (pre.has_work or dec.has_work):
                break
            if pre.has_work:
                pre.step()
            if dec.has_work:
                dec.step()
        md = dec.metrics()
        per_page = pool.stats.bytes_stored / max(len(pool.blocks), 1)
        done = (req.state.name == "FINISHED"
                and len(req.output_tokens) == n_new)
        # int8 + a float32 scale per layer for K and for V
        int8_page = page_bytes // 2 + 2 * cfg.n_layers * 4
        ok = (done and md.remote_hit_tokens > 0
              and (req.output_tokens == ref if wire == "fp"
                   else per_page == int8_page))
        check(f"P/D handoff, {wire} wire", ok, blocks=len(pool.blocks),
              pool_bytes_per_page=per_page, page_bytes=page_bytes,
              remote_hit_tokens=md.remote_hit_tokens,
              kv_bytes_fetched=md.kv_bytes_fetched,
              same_tokens_as_mixed=req.output_tokens == ref)
        del pre, dec, pool

    # one page off the card and back, at the serving page
    eng = tier_engine(cfg)
    eng.runner.pool.k[:, 7].normal_()
    eng.runner.pool.v[:, 7].normal_()
    k, v = eng.runner.page_payload(7)
    torch.cuda.synchronize()

    def d2h():
        eng.runner.page_payload(7)

    def h2d():
        eng.runner.write_remote_page(9, k, v)
        torch.cuda.synchronize()
    times = {}
    for name, fn in (("page_payload", d2h), ("write_remote_page", h2d)):
        for _ in range(3):
            fn()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        times[name] = (time.perf_counter() - t0) * 1e3 / 50
    same = (torch.equal(eng.runner.pool.k[:, 9], eng.runner.pool.k[:, 7])
            and torch.equal(eng.runner.pool.v[:, 9], eng.runner.pool.v[:, 7]))
    check("page payload round trip", same and k.nbytes + v.nbytes
          == page_bytes, page_bytes=page_bytes,
          page_payload_ms=times["page_payload"],
          page_payload_gb_per_s=page_bytes / times["page_payload"] / 1e6,
          write_remote_page_ms=times["write_remote_page"],
          write_remote_page_gb_per_s=page_bytes
          / times["write_remote_page"] / 1e6, card=nvidia_smi())
    del eng
    torch.cuda.empty_cache()


# ------------------------------------------------------------ sampling
def sampling(torch):
    """The sampling phase: the port's PRNG on the card bit for bit against
    jax's recorded values; the XLA-rounded float steps against the CPU;
    ``sample`` against the JAX sampler's recorded tokens and the CPU."""
    from repro_torch.engine import sampling as S
    dev, mask = "cuda", 0xFFFFFFFF

    def check(name, ok, **fields):
        emit("sampling", check=name, ok=bool(ok), **fields)
        if not ok:
            raise AssertionError(f"sampling: {name} failed")

    def bits(t):
        return [int(x) & mask for x in t.view(torch.int32).tolist()]

    for seed, pos, want in JAX_ROW_KEYS:
        got = S.row_keys(torch.tensor([seed], device=dev),
                         torch.tensor([pos], device=dev))[0].tolist()
        check("row_keys", got == want, seed=seed, position=pos, key=got)
    for seed, want in JAX_SPLITS.items():
        key = S.prng_key(seed, dev)
        got = S.split(key, 3).tolist()
        check("split", got == want, seed=seed, keys=got)
        got = bits(S.uniform(key, 6))
        check("uniform bits", got == JAX_UNIFORM_BITS[seed], seed=seed,
              bits=got)
        got = bits(S.gumbel(key, 6))
        check("gumbel bits", got == JAX_GUMBEL_BITS[seed], seed=seed,
              bits=got)
    # every uniform value (2**23) through both logs, and exp over
    # softmax's range down to where it flushes, on the card vs the CPU
    m = torch.arange(1 << 23, dtype=torch.int32)
    u = torch.clamp_min((m | 0x3F800000).view(torch.float32) - 1.0,
                        S._TINY)
    g_cpu, g_dev = (-S._log(-S._log(x)) for x in (u, u.to(dev)))
    check("gumbel logs, all 2**23 uniform values, card == CPU",
          torch.equal(g_cpu.view(torch.int32),
                      g_dev.cpu().view(torch.int32)), values=u.numel())
    x = -S.uniform(S.prng_key(5), 1 << 22) * 104.0
    check("exp over [-104, 0], card == CPU",
          torch.equal(S._exp(x).view(torch.int32),
                      S._exp(x.to(dev)).cpu().view(torch.int32)),
          values=x.numel())
    keys = S.row_keys(torch.arange(8), torch.full((8,), 17))
    for v in (64, 151936):
        logits = 4.0 * S.gumbel(S.split(S.prng_key(2024, dev), 8), v)
        for top_p in (None, 0.5, 0.9, 1.0):
            tp = None if top_p is None else [top_p] * 8
            got = S.sample(logits, None, [0.8] * 8, top_p=tp,
                           keys=keys.to(dev))
            cpu = S.sample(logits.cpu(), None, [0.8] * 8, top_p=tp,
                           keys=keys)
            want = JAX_SAMPLES[f"{v}/{top_p}"]
            zero_rows = [i for i, (a, b) in enumerate(zip(
                want, JAX_SAMPLES[f"{v}/None"])) if a == 0 != b]
            check("sample", got.tolist() == want == cpu.tolist()
                  and got.device.type == "cuda", vocab=v, temperature=0.8,
                  top_p=top_p, tokens=got.tolist(),
                  top_p_fault_rows=zero_rows)
        ms = {str(tp): time_ms(torch, lambda: S.sample(
            logits, None, [0.8] * 8, top_p=None if tp is None else [tp] * 8,
            keys=keys.to(dev)), iters=5, warmup=1) for tp in (None, 0.9)}
        greedy_ms = time_ms(torch, lambda: S.sample(
            logits, None, [0.0] * 8, keys=keys.to(dev)), iters=20)

        def sampled():
            S.sample(logits, None, [0.8] * 8, top_p=[0.9] * 8,
                     keys=keys.to(dev))
            torch.cuda.synchronize()
        emit("sampling_time", vocab=v, rows=8, ms_by_top_p=ms,
             greedy_ms=greedy_ms, profile_top_p_0_9=device_profile(
                 torch, sampled, 3), card=nvidia_smi())


# ------------------------------------------------------------ speculation
def spec_steps(torch, cfg, pa, pp):
    """The spec phase (a): the float32 ``spec_decode_step`` (8 lanes of 5
    rows: 5, 5, 3, 1, 5, idle, 2, 5 valid) and ``spec_mixed_step`` (the
    same lanes and chunks of 64 and 37) at full width with a bank of 4
    adapters, with the kernels and with the plain versions: logits and
    pools must agree, and each step launch ``paged_prefill`` once a
    layer for the lanes (and once more for the chunks) and never
    ``paged_attention``."""
    from repro_torch import random as R
    from repro_torch.engine import paged_model as PM
    params, pool, a, page = step_inputs(torch, cfg, torch.float32)
    sd, b = 1 + SPEC_TOKENS, a["dec_tokens"].shape[0]
    nb = a["dec_block_tables"].shape[1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    i32 = dict(dtype=torch.int32, device="cuda")
    lanes = dict(
        spec_tokens=torch.randint(0, cfg.vocab_size, (b, sd), generator=gen,
                                  device="cuda").to(torch.int32),
        spec_ctx=torch.clamp(a["dec_positions"], max=nb * page - sd),
        spec_len=torch.tensor([5, 5, 3, 1, 5, 0, 2, 5], **i32),
        spec_block_tables=a["dec_block_tables"])
    chunks = {k: a[k] for k in ("pre_tokens", "pre_block_tables", "pre_ctx",
                                "pre_chunk")}
    bank = PM.init_lora(cfg, LORA_ADAPTERS + 1, LORA_RANK, torch.float32,
                        "cuda")
    for i in range(1, LORA_ADAPTERS + 1):
        for k, w in PM.make_adapter(cfg, LORA_RANK,
                                    R.prng_key(100 + i)).items():
            bank[k][i].copy_(w)
    lane_ids = torch.tensor([1, 2, 0, 3, 4, 0, 1, 0], **i32)
    pre_ids = torch.tensor([3, 0], **i32)
    kw = dict(cfg=cfg, page_size=page)

    def decode_step(p, impl):
        return PM.spec_decode_step(
            params, p, **lanes, lora=bank, adapter_ids=lane_ids, impl=impl,
            **kw)[0].reshape(b * sd, -1)

    def mixed_step(p, impl):
        return torch.cat([x.reshape(-1, cfg.vocab_size)
                          for x in PM.spec_mixed_step(
                              params, p, **lanes, **chunks, lora=bank,
                              spec_adapter_ids=lane_ids,
                              pre_adapter_ids=pre_ids, impl=impl,
                              **kw)[:2]])
    steps = {"spec_decode_step": (cfg.n_layers, decode_step),
             "spec_mixed_step": (2 * cfg.n_layers, mixed_step)}
    for step, (want_pp, run) in steps.items():
        outs, counts = {}, {}
        for impl in ("kernel", "ref"):
            p = PM.PagePool(pool.k.clone(), pool.v.clone())
            torch.cuda.synchronize()
            pa.launches = pp.launches = 0
            outs[impl] = (run(p, impl).float(), p)
            torch.cuda.synchronize()
            counts[impl] = {"paged_attention": pa.launches,
                            "paged_prefill": pp.launches}
        (lk, pk), (lr, prf) = outs["kernel"], outs["ref"]
        scale = lr.abs().max().item()
        err = (lk - lr).abs().max().item()
        pool_err = max((pk.k - prf.k).abs().max().item(),
                       (pk.v - prf.v).abs().max().item())
        pool_scale = prf.k.abs().max().item()
        want = {"paged_attention": 0, "paged_prefill": want_pp}
        ok = (bool(torch.isfinite(lk).all()) and err <= STEP_REL_TOL * scale
              and pool_err <= STEP_REL_TOL * pool_scale
              and counts["kernel"] == want
              and counts["ref"] == dict.fromkeys(want, 0))
        emit("spec_step", step=step, model=cfg.name, dtype="float32",
             lanes=b, lane_rows=sd, spec_len=lanes["spec_len"].tolist(),
             lane_adapter_ids=lane_ids.tolist(), logits_rows=lk.shape[0],
             logits_max_abs=scale, max_abs_err=err,
             pool_max_abs_err=pool_err, rel_tol=STEP_REL_TOL,
             launches=counts["kernel"], expected_launches=want, ok=ok)
        if not ok:
            raise AssertionError(f"full-width {step}: kernel and plain "
                                 "disagree, or the launches are off")
        del outs
    del params, pool, bank


def repeating_prompts(rng, n, lengths, vocab):
    """``n`` prompts of ``lengths`` tokens, each a random segment of
    16-64 tokens repeated: the n-gram drafter finds continuations."""
    out = []
    for length in rng.integers(lengths[0], lengths[1] + 1, n):
        seg = rng.integers(0, vocab, int(rng.integers(
            SPEC_SEGMENT[0], SPEC_SEGMENT[1] + 1))).tolist()
        out.append((seg * (int(length) // len(seg) + 1))[:int(length)])
    return out


def spec_serve_once(torch, cfg, ecfg, prompts, samplings, pa, pp):
    """One serve of ``prompts`` (32 new tokens each, a seed each, request
    i sampled with ``samplings[i]``) on a fresh engine, the first
    request alone for a step, with the paged kernels' counts set to 0
    just before and read just after.  Records the kind of every step the
    runner ran, the tokens emitted by speculative passes, the rows at
    temperature > 0 that those passes sampled, and the top-2 logit gap
    of every row that sampled a token, by (request, position)."""
    from repro_torch.engine import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)
    eng = InferenceEngine(cfg, EngineConfig(**ecfg), seed=0, device="cuda")
    reqs = [Request(prompt_tokens=list(p), sampling=SamplingParams(
        max_new_tokens=MAX_NEW, seed=100 + i, **samp))
        for i, (p, samp) in enumerate(zip(prompts, samplings))]
    rid = {r.request_id: i for i, r in enumerate(reqs)}
    kinds = dict.fromkeys(("decode", "prefill", "mixed", "spec_decode",
                           "spec_mixed"), 0)
    gaps, spec_tokens, spec_sampled = {}, [0], [0]
    r_ = eng.runner
    orig = {n: getattr(r_, n) for n in ("run_decode", "run_prefill",
                                         "run_mixed", "run_spec", "sample",
                                         "verify_drafts")}

    def kind(name, fn):
        def run(out, *args):
            key = name
            if name == "spec":
                key = ("spec_mixed" if any(w.chunk_len for w in out.prefills)
                       else "spec_decode")
            kinds[key] += 1
            return fn(out, *args)
        return run

    def gap_rows(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        return (top[..., 0] - top[..., 1]).tolist()

    def sample(logits, rs, positions=None):
        for r, g, pos in zip(rs, gap_rows(logits), positions or []):
            gaps[(rid[r.request_id], pos)] = (sum(kinds.values()), g)
        return orig["sample"](logits, rs, positions)

    def verify(spec_logits, rs, spec):
        spec_sampled[0] += sum(r.sampling.temperature > 0 for r in rs)
        for r, g in zip(rs, gap_rows(spec_logits)):
            base = r.prompt_len + len(r.output_tokens)
            for j, gj in enumerate(g):
                gaps[(rid[r.request_id], base + j)] = (
                    sum(kinds.values()), gj)
        return orig["verify_drafts"](spec_logits, rs, spec)

    for name in ("decode", "prefill", "mixed", "spec"):
        setattr(r_, f"run_{name}", kind(name, orig[f"run_{name}"]))
    r_.sample, r_.verify_drafts = sample, verify
    on_spec = eng.sched.on_spec_batch

    def counting_on_spec(*args):
        n = on_spec(*args)
        spec_tokens[0] += n
        return n
    eng.sched.on_spec_batch = counting_on_spec
    torch.cuda.synchronize()
    pa.launches = pp.launches = 0
    t0 = time.perf_counter()
    eng.submit(reqs[0])
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.launches, "paged_prefill": pp.launches}
    n = cfg.n_layers
    want = {"paged_attention": n * (kinds["decode"] + kinds["mixed"]),
            "paged_prefill": n * (kinds["prefill"] + kinds["mixed"]
                                  + kinds["spec_decode"])
            + 2 * n * kinds["spec_mixed"]}
    m = eng.metrics()
    out = dict(tokens=[list(r.output_tokens) for r in reqs],
               prompt_lens=[r.prompt_len for r in reqs],
               finished=sum(r.state.name == "FINISHED"
                            and len(r.output_tokens) == MAX_NEW
                            for r in reqs),
               kinds=kinds, launches=launches, want=want, wall_s=wall,
               ttft=[r.ttft for r in reqs], free_pages=eng.alloc.num_free,
               num_pages=eng.alloc.num_pages,
               drafted=m.spec_drafted_tokens,
               accepted=m.spec_accepted_tokens, spec_rows=m.spec_steps,
               spec_pass_tokens=spec_tokens[0],
               spec_sampled_rows=spec_sampled[0], gaps=gaps)
    del eng
    torch.cuda.empty_cache()
    return out


def first_difference(off, on):
    """(request, token index) of the first token that differs, or None."""
    for i, (a, b) in enumerate(zip(off["tokens"], on["tokens"])):
        for j, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return i, j
    return None


def spec_run_fields(run):
    passes = run["kinds"]["spec_decode"] + run["kinds"]["spec_mixed"]
    gen_tokens = sum(len(t) for t in run["tokens"])
    return dict(
        finished=run["finished"], free_pages=run["free_pages"],
        num_pages=run["num_pages"], steps=run["kinds"],
        launches=run["launches"], expected_launches=run["want"],
        drafted_tokens=run["drafted"], accepted_tokens=run["accepted"],
        drafting_rows=run["spec_rows"], spec_passes=passes,
        rows_at_temperature_in_spec_passes=run["spec_sampled_rows"],
        tokens_per_spec_pass=(run["spec_pass_tokens"] / passes
                              if passes else None),
        generated_tokens=gen_tokens, wall_s=run["wall_s"],
        output_tokens_per_s=gen_tokens / run["wall_s"],
        mean_ttft_s=sum(run["ttft"]) / len(run["ttft"]))


def spec_serve(torch, cfg, pa, pp):
    """The spec phase (c) and (d): float32 serves, speculation off and
    on: all requests greedy, all at temperature 0.8 (top-p 0.9, a seed
    each), and half of each, whose sampled rows ride the passes the
    greedy rows' drafts start (random weights sample near-uniformly at
    0.8, so those rows rarely find a draft of their own): the same
    tokens, exact launches; then the bf16 serve off and on, measured."""
    import numpy as np
    rng = np.random.default_rng(12)
    n = SPEC_F32_REQUESTS
    prompts = repeating_prompts(rng, n, SPEC_F32_PROMPTS, cfg.vocab_size)
    smi = nvidia_smi()
    f32 = dict(SERVE_ECFG, dtype="float32")
    for label, samplings, need in (
            ("greedy", [{}] * n, "passes"),
            ("temperature 0.8", [SPEC_SAMPLING] * n, None),
            ("greedy and temperature 0.8 rows",
             [{} if i % 2 == 0 else SPEC_SAMPLING for i in range(n)],
             "sampled rows in passes")):
        runs = {spec: spec_serve_once(torch, cfg, dict(f32, spec_tokens=spec),
                                      prompts, samplings, pa, pp)
                for spec in (0, SPEC_TOKENS)}
        off, on = runs[0], runs[SPEC_TOKENS]
        diff = first_difference(off, on)
        exercised = {None: True,
                     "passes": on["kinds"]["spec_decode"] > 0,
                     "sampled rows in passes": on["spec_sampled_rows"] > 0
                     }[need]
        for spec, run in runs.items():
            ok = (run["finished"] == SPEC_F32_REQUESTS
                  and run["free_pages"] == run["num_pages"]
                  and run["launches"] == run["want"] and diff is None
                  and (spec == 0 or exercised))
            emit("spec_serve", model=cfg.name, dtype="float32",
                 sampling=label, spec_tokens=spec,
                 requests=SPEC_F32_REQUESTS,
                 prompt_tokens=sum(run["prompt_lens"]),
                 same_tokens_as_spec_off=diff is None,
                 **spec_run_fields(run), card=smi, ok=ok)
        if diff is not None:
            i, j = diff
            pos = off["prompt_lens"][i] + j
            emit("spec_mismatch", sampling=label, request=i, token=j,
                 position=pos, spec_off=off["tokens"][i][j],
                 spec_on=on["tokens"][i][j],
                 spec_off_step_and_top2_gap=off["gaps"].get((i, pos)),
                 spec_on_step_and_top2_gap=on["gaps"].get((i, pos)))
        if not all(r["finished"] == SPEC_F32_REQUESTS
                   and r["free_pages"] == r["num_pages"]
                   and r["launches"] == r["want"] for r in runs.values()) \
                or diff is not None or not exercised:
            raise AssertionError(f"float32 spec serve ({label}) failed "
                                 "its checks")
    # bf16, 16 requests: measured, identity not required (verify lanes
    # and decode rows take different kernels)
    rng = np.random.default_rng(13)
    prompts = repeating_prompts(rng, N_REQUESTS, PROMPT_RANGE,
                                cfg.vocab_size)
    runs = {spec: spec_serve_once(torch, cfg, dict(SERVE_ECFG,
                                                   spec_tokens=spec),
                                  prompts, [{}] * N_REQUESTS, pa, pp)
            for spec in (0, SPEC_TOKENS)}
    off = runs[0]
    for spec, run in runs.items():
        same = sum(x == y for a, b in zip(off["tokens"], run["tokens"])
                   for x, y in zip(a, b))
        ok = (run["finished"] == N_REQUESTS
              and run["free_pages"] == run["num_pages"]
              and run["launches"] == run["want"])
        emit("spec_serve", model=cfg.name, dtype="bfloat16",
             sampling="greedy", spec_tokens=spec, requests=N_REQUESTS,
             prompt_tokens=sum(run["prompt_lens"]),
             share_of_tokens_equal_to_spec_off=same / (N_REQUESTS * MAX_NEW),
             **spec_run_fields(run), card=smi, ok=ok)
        if not ok:
            raise AssertionError("bf16 spec serve failed its checks")


def profile_spec(torch, cfg):
    """Phase 12: one full-width bf16 ``decode_batch`` of 8 rows and one
    ``spec_decode_step`` of the same 8 rows as lanes of 5 (4 drafts
    each), each ended by a synchronize."""
    from repro_torch.engine import paged_model as PM
    params, pool, a, page = step_inputs(torch, cfg, torch.bfloat16)
    sd, b = 1 + SPEC_TOKENS, a["dec_tokens"].shape[0]
    nb = a["dec_block_tables"].shape[1]
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    ctx = torch.clamp(a["dec_positions"], max=nb * page - sd)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (b, sd), generator=gen,
                         device="cuda").to(torch.int32)
    slen = torch.full((b,), sd, dtype=torch.int32, device="cuda")

    def decode():
        PM.decode_batch(params, pool, toks[:, 0], ctx, a["dec_block_tables"],
                        active, cfg=cfg, page_size=page)
        torch.cuda.synchronize()

    def spec():
        PM.spec_decode_step(params, pool, toks, ctx, slen,
                            a["dec_block_tables"], cfg=cfg, page_size=page)
        torch.cuda.synchronize()

    emit("profile", step="decode_batch", model=cfg.name, dtype="bfloat16",
         rows=b, **device_profile(torch, decode, 10))
    emit("profile", step="spec_decode_step", model=cfg.name,
         dtype="bfloat16", lanes=b, lane_rows=sd,
         **device_profile(torch, spec, 10))
    del params, pool


# ------------------------------------------------------------ slot path
def slot_step(torch, cfg, fp, s=SLOT_STEP_PROMPT):
    """Phase 8: full-width float32 ``prefill`` of one ``s``-token prompt
    and 4 ``decode_step``s (fixed tokens), once with the flash_prefill
    kernel and once with its plain version, on the same weights: logits
    and every cache field (K/V, recurrent states) within STEP_REL_TOL of
    its largest magnitude, ring positions equal, the kernel launched
    once an attention layer, by window (``flash_windows``), and never
    with the plain version.  Returns the kernel run's launches and its
    launches by window."""
    from repro_torch.models import model as M
    dev, n_dec = "cuda", SLOT_STEP_DECODES
    cache_len = s + n_dec
    params = M.init(cfg, seed=4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (1, s + n_dec), generator=gen,
                         device=dev).to(torch.int32)
    outs = {}
    for impl in ("kernel", "ref"):
        fp.launches = 0
        fp.launches_by_window.clear()
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
        outs[impl] = (torch.stack(steps), caches, fp.launches,
                      dict(fp.launches_by_window))
    (lk, ck, nk, wk), (lr, cr, nr, _) = outs["kernel"], outs["ref"]
    scale = lr.abs().max().item()
    err = (lk - lr).abs().max().item()
    fields = {}                 # name -> (max abs err, max abs), all runs
    for a, b in zip(ck, cr):
        for n in a:
            if n != "pos":
                e, m = fields.get(n, (0.0, 0.0))
                fields[n] = (max(e, (a[n] - b[n]).abs().max().item()),
                             max(m, b[n].abs().max().item()))
    pos_equal = all(torch.equal(a["pos"], b["pos"])
                    for a, b in zip(ck, cr) if "pos" in a)
    by_window = flash_windows(cfg)
    ok = (bool(torch.isfinite(lk).all()) and err <= STEP_REL_TOL * scale
          and all(e <= STEP_REL_TOL * m for e, m in fields.values())
          and pos_equal and nk == sum(by_window.values()) and nr == 0
          and wk == by_window)
    emit("slot_step", model=cfg.name, dtype="float32", prompt=s,
         decode_steps=n_dec, logits_max_abs=scale, max_abs_err=err,
         cache_max_abs_err={n: e for n, (e, _) in fields.items()},
         cache_max_abs={n: m for n, (_, m) in fields.items()},
         ring_pos_equal=pos_equal, flash_launches={"kernel": nk, "ref": nr},
         flash_launches_by_window=wk, expected_by_window=by_window,
         rel_tol=STEP_REL_TOL, ok=ok)
    if not ok:
        raise AssertionError("full-width slot step: kernel and plain "
                             "disagree")
    del params, outs
    return nk, wk


def slot_serve_once(torch, cfg, prompts, counters, ecfg=SLOT_ECFG,
                    max_new=SLOT_MAX_NEW):
    from repro_torch.engine import (Request, SamplingParams, SlotEngine,
                                    SlotEngineConfig)
    from repro_torch.engine.request import RequestState
    gc.collect()                # an earlier phase's garbage is not this peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = SlotEngine(cfg, SlotEngineConfig(**ecfg), seed=0, device="cuda")
    prefills = 0
    finite = [True]
    prefill_into_slot, sample = eng._prefill_into_slot, eng._sample

    def counting_prefill(req, slot):
        nonlocal prefills
        prefills += 1
        prefill_into_slot(req, slot)

    def checking_sample(logits, reqs):
        finite[0] &= bool(torch.isfinite(logits).all())
        return sample(logits, reqs)

    eng._prefill_into_slot = counting_prefill
    eng._sample = checking_sample
    reqs = [Request(prompt_tokens=list(p),
                    sampling=SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    counters["flash_prefill"].launches_by_window.clear()
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
    by_window = dict(counters["flash_prefill"].launches_by_window)
    finished = sum(r.state == RequestState.FINISHED
                   and len(r.output_tokens) == max_new for r in reqs)
    out = dict(tokens=[list(r.output_tokens) for r in reqs],
               launches=launches, flash_by_window=by_window,
               prefills=prefills, steps=steps,
               step_s=step_s, finite_logits=finite[0],
               finished=finished, wall_s=wall, ttft=[r.ttft for r in reqs],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    # the wrappers above hold the engine in a cycle: collect it, so that
    # the next serve's peak memory does not count this one's
    del eng, counting_prefill, checking_sample, prefill_into_slot, sample
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flash_windows(cfg) -> dict:
    """window -> ``flash_prefill`` launches of one prefill of ``cfg``:
    one a GQA attention layer, at the sliding window for SWA and HYMBA
    layers and 0 for DENSE and HYMBA_GLOBAL ones (MLA, mLSTM and sLSTM
    layers launch none)."""
    from repro_torch.models import config as C
    window = {C.SWA: cfg.sliding_window, C.HYMBA: cfg.sliding_window,
              C.DENSE: 0, C.HYMBA_GLOBAL: 0}
    out = {}
    for t in cfg.layer_pattern:
        if t in window:
            out[window[t]] = out.get(window[t], 0) + 1
    return out


def slot_serve(torch, cfg, counters, requests=SLOT_REQUESTS,
               prompt_range=SLOT_PROMPTS, max_new=SLOT_MAX_NEW, seed=1):
    """Phase 9 (gemma3-4b) and the ssm phase's serves: ``requests``
    greedy requests, prompts drawn from ``prompt_range`` with ``seed``,
    through ``SlotEngine`` at full width in bf16, twice on fresh
    engines: every request finishes with the same tokens both times,
    finite logits, ``flash_prefill`` launched once an attention layer a
    prefill, by window (``flash_windows``), and the paged kernels
    never."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_range[0], prompt_range[1] + 1, requests)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    runs = [slot_serve_once(torch, cfg, prompts, counters, max_new=max_new)
            for _ in range(2)]
    per_prefill = flash_windows(cfg)
    smi = nvidia_smi()
    for i, run in enumerate(runs):
        n = run["prefills"]
        want = {name: sum(per_prefill.values()) * n
                if name == "flash_prefill" else 0 for name in counters}
        want_by_window = {w: c * n for w, c in per_prefill.items()}
        gen_tokens = sum(len(t) for t in run["tokens"])
        ok = (run["finished"] == requests and n == requests
              and run["launches"] == want and run["finite_logits"]
              and run["flash_by_window"] == want_by_window
              and run["tokens"] == runs[0]["tokens"])
        emit("slot_serve", run=i + 1, model=cfg.name, engine="SlotEngine",
             config=SLOT_ECFG, requests=requests,
             prompt_tokens=int(lens.sum()), prompt_min=int(lens.min()),
             prompt_max=int(lens.max()), generated_tokens=gen_tokens,
             finished=run["finished"], prefills=n, steps=run["steps"],
             wall_s_by_step=run["step_s"], launches=run["launches"],
             flash_prefill_launches_by_window=run["flash_by_window"],
             expected_launches=want, expected_by_window=want_by_window,
             finite_logits=run["finite_logits"],
             same_tokens_as_run_1=run["tokens"] == runs[0]["tokens"],
             wall_s=run["wall_s"],
             output_tokens_per_s=gen_tokens / run["wall_s"],
             total_tokens_per_s=(gen_tokens + int(lens.sum()))
             / run["wall_s"],
             mean_ttft_s=float(np.mean(run["ttft"])),
             peak_memory_gb=run["peak_memory_gb"], card=smi, ok=ok)
        if not ok:
            raise AssertionError(f"{cfg.name} slot serve run {i + 1} "
                                 "failed its checks")
    return runs[0]["launches"], runs[0]["flash_by_window"]


# ------------------------------------------------------------ moe
def moe_ffn_check(torch, cfg):
    """``moe_ffn`` on the card against the same call on the CPU, float32,
    at ``cfg``'s widths and capacity factor, at a mixed step's T (8
    decode rows + 2 chunks of 64) and a decode step's (8 rows): the same
    kept (token, expert) pairs bit for bit, as each call's own plan holds
    them, outputs within the f32 tolerances; then its bf16 time on the
    card beside the least time the card could take to read the expert
    banks.  Expert 0's router column is raised by 0.15, as in
    tests/test_torch_moe.py, so that it draws more than its capacity and
    tens of pairs drop at T 136."""
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    m, d = cfg.moe, cfg.d_model
    params = init_params(moe.moe_specs(d, m), 13, torch.float32, "cuda")
    params["router"][:, 0] += 0.15
    cpu = {"router": params["router"].cpu(),
           "experts": {k: w.cpu() for k, w in params["experts"].items()}}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    for t in (136, 8):
        x = torch.randn(1, t, d, generator=gen, device="cuda")
        cap = moe._capacity(t, m)
        out, r, pl = moe.moe_ffn(params, m, x, cfg.act)
        out_c, r_c, pl_c = moe.moe_ffn(cpu, m, x.cpu(), cfg.act)
        keep, keep_c = pl.keep, pl_c.keep
        aux, aux_c = moe.aux_losses(r, m), moe.aux_losses(r_c, m)
        err = (out.cpu() - out_c).abs().max().item()
        same_keep = bool(torch.equal(keep.cpu(), keep_c))
        drops = int((~keep_c).sum())
        ok = (same_keep and bool(torch.isfinite(out).all())
              and torch.allclose(out.cpu(), out_c, atol=TOL["float32"][0],
                                 rtol=TOL["float32"][1])
              and all(abs(aux[k].item() - aux_c[k].item())
                      <= 1e-5 * abs(aux_c[k].item()) for k in aux)
              and (drops > 0 or t < 136))
        xb = x.bfloat16()
        pb = {"router": params["router"].bfloat16(),
              "experts": {k: w.bfloat16()
                          for k, w in params["experts"].items()}}
        bank_bytes = sum(w.numel() * 2 for w in pb["experts"].values())
        emit("moe_ffn", model=cfg.name, tokens=t, capacity=cap,
             capacity_factor=m.capacity_factor, experts=m.num_experts,
             top_k=m.top_k, dropped_pairs=drops, pairs=t * m.top_k,
             same_keep_mask=same_keep, max_abs_err=err,
             tol=TOL["float32"], aux={k: [aux[k].item(), aux_c[k].item()]
                                      for k in aux},
             bf16_ms=time_ms(torch, lambda: moe.moe_ffn(pb, m, xb,
                                                        cfg.act)),
             bank_read_bound_ms=bank_bytes / PEAK_BYTES_PER_S * 1e3,
             card=nvidia_smi(), ok=ok)
        if not ok:
            raise AssertionError(f"moe_ffn at T {t}: card and CPU disagree")
    del params, cpu


def deepseek_cut(cfg):
    """deepseek-v2 at its published widths, the depth cut to its first
    two layer types: (MLA_DENSE, MLA_MOE)."""
    from repro_torch.models.config import MLA_DENSE, MLA_MOE
    return cfg.replace(name=cfg.name + "-depth2", n_layers=2,
                       layer_pattern=(MLA_DENSE, MLA_MOE))


def moe_phase(torch, granite, deepseek, counters):
    """Phase 10: mixture-of-experts and MLA at full width.  ``moe_ffn``
    on the card against the CPU; full-depth granite-moe-3b-a800m's four
    paged step functions in float32, kernels against plain versions; the
    granite bf16 serve twice and once with the async loop; deepseek-v2
    cut to 2 layers through the slot engine in bf16, twice.  Returns the
    granite serve's launches and those of its float32 step functions."""
    import numpy as np
    pa, pp = counters["paged_attention"], counters["paged_prefill"]
    moe_ffn_check(torch, granite)
    f32_launches = full_width_step(torch, granite)
    first = serve(torch, granite, pa, pp)
    run = serve_once(torch, granite, serve_prompts(granite)[1], pa, pp,
                     async_loop=True)
    gen_tokens = sum(len(t) for t in run["tokens"])
    ok = (run["finished"] == N_REQUESTS
          and run["free_pages"] == run["num_pages"]
          and run["launches"] == run["want"]
          and run["guarded"] == run["modes"]["async_decode"] > 0
          and run["tokens"] == first["tokens"])
    emit("serve", run="async", model=granite.name, requests=N_REQUESTS,
         generated_tokens=gen_tokens, finished=run["finished"],
         free_pages=run["free_pages"], num_pages=run["num_pages"],
         steps=run["modes"], launches=run["launches"],
         expected_launches=run["want"], guarded_dispatches=run["guarded"],
         same_tokens_as_sync=run["tokens"] == first["tokens"],
         wall_s=run["wall_s"], output_tokens_per_s=gen_tokens
         / run["wall_s"], mean_ttft_s=float(np.mean(run["ttft"])),
         device_wait_s=run["device_wait_s"], card=nvidia_smi(), ok=ok)
    if not ok:
        raise AssertionError("granite async serve failed its checks")
    deepseek_serve(torch, deepseek, counters)
    return first["launches"], f32_launches


def deepseek_serve(torch, cfg, counters):
    """deepseek-v2 (2 layers at full width) through ``SlotEngine`` in
    bf16: 4 greedy requests, prompts of 512-2000 tokens (the dense path
    of ``attn_causal_plain``), 16 new tokens, twice on fresh engines.
    MLA and the MoE FFN run no hand-written kernel: every count stays
    0."""
    import numpy as np
    rng = np.random.default_rng(2)
    lens = rng.integers(MLA_PROMPTS[0], MLA_PROMPTS[1] + 1, MLA_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    runs = [slot_serve_once(torch, cfg, prompts, counters, MLA_ECFG,
                            MLA_MAX_NEW) for _ in range(2)]
    for i, run in enumerate(runs):
        gen_tokens = sum(len(t) for t in run["tokens"])
        ok = (run["finished"] == MLA_REQUESTS and run["finite_logits"]
              and run["launches"] == dict.fromkeys(counters, 0)
              and run["tokens"] == runs[0]["tokens"])
        emit("mla_slot_serve", run=i + 1, model=cfg.name,
             depth=f"{cfg.n_layers} layers {list(cfg.layer_pattern)} of "
             "60 (cut to fit one card; widths as published)",
             engine="SlotEngine", config=MLA_ECFG, requests=MLA_REQUESTS,
             prompt_tokens=int(lens.sum()), prompt_min=int(lens.min()),
             prompt_max=int(lens.max()), generated_tokens=gen_tokens,
             finished=run["finished"], prefills=run["prefills"],
             steps=run["steps"], wall_s_by_step=run["step_s"],
             launches=run["launches"], finite_logits=run["finite_logits"],
             same_tokens_as_run_1=run["tokens"] == runs[0]["tokens"],
             wall_s=run["wall_s"],
             output_tokens_per_s=gen_tokens / run["wall_s"],
             mean_ttft_s=float(np.mean(run["ttft"])), card=nvidia_smi(),
             ok=ok)
        if not ok:
            raise AssertionError(f"deepseek-v2 slot serve run {i + 1} "
                                 "failed its checks")


# ------------------------------------------------------------ ssm
def scan_share(torch, run):
    """Host wall of ``run`` and the seconds of it spent in each
    recurrent mixer's core (the scans ``ssm._mamba_core``,
    ``ssm._slstm_scan`` and ``ssm._mlstm_core``, and mLSTM's parallel
    form ``layers.mlstm_parallel``), each wrapped in synchronizes."""
    from repro_torch.models import layers, ssm
    cores = [(ssm, "_mamba_core"), (ssm, "_slstm_scan"),
             (ssm, "_mlstm_core"), (layers, "mlstm_parallel")]
    spent = {name: 0.0 for _, name in cores}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    orig = {name: getattr(mod, name) for mod, name in cores}
    for mod, name in cores:
        setattr(mod, name, timed(name, orig[name]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        for mod, name in cores:
            setattr(mod, name, orig[name])
    scans = sum(v for k, v in spent.items() if k != "mlstm_parallel")
    return dict(wall_s=wall, core_s={k: v for k, v in spent.items() if v},
                scan_share=scans / wall)


def profile_ssm(torch, cfg, traced):
    """Where the time of the SSM slot path goes at full width in bf16:
    one prefill of a 512-token prompt into a one-row cache and one
    decode step of 4 slots at positions 600-1400, each ended by a
    synchronize as the engine's sampling ends it.  ``traced=False``
    ((e) of the ssm phase): the scans' share of the host wall
    (``scan_share``); ``traced=True`` (the profile phase): host wall and
    device time by kind (``device_profile``).  A trace of a prefill holds
    tens of thousands of kernels; after such traces a later trace in the
    same process lost a third of its events, so they are taken last."""
    from repro_torch.models import model as M
    dev, bf16, s = "cuda", torch.bfloat16, SSM_PROFILE_PROMPT
    params = M.init(cfg, seed=0, dtype=bf16, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    one = M.init_cache(cfg, 1, SLOT_ECFG["max_len"], bf16, dev)
    caches = M.init_cache(cfg, SLOT_ECFG["max_slots"], SLOT_ECFG["max_len"],
                          bf16, dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                           device=dev).to(torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (SLOT_ECFG["max_slots"],),
                         generator=gen, device=dev).to(torch.int32)
    pos = torch.tensor([600, 900, 1200, 1400], dtype=torch.int32,
                       device=dev)

    def prefill():
        M.prefill(params, cfg, prompt, one)
        torch.cuda.synchronize()

    def decode():
        M.decode_step(params, cfg, caches, toks, pos)
        torch.cuda.synchronize()

    def measure(step, n):
        return (device_profile(torch, step, n) if traced
                else scan_share(torch, step))

    smi = nvidia_smi()
    emit("profile" if traced else "ssm_scan_share", step="slot prefill",
         model=cfg.name, dtype="bfloat16", prompt=s,
         **measure(prefill, 1), card=smi)
    emit("profile" if traced else "ssm_scan_share",
         step="slot decode_step", model=cfg.name, dtype="bfloat16",
         slots=SLOT_ECFG["max_slots"], **measure(decode, 5), card=smi)
    del params, one, caches


def ssm_phase(torch, hymba, xlstm, counters):
    """The ssm phase: (a) the hymba kernel cases ran in check_kernels;
    (b) full-width hymba-1.5b ``prefill`` + 4 ``decode_step``s in
    float32, kernel against plain (``slot_step``), 32 ``flash_prefill``
    launches, 29 at window 1024 and 3 at 0; (c) the full-width bf16
    serves of hymba-1.5b and xlstm-1.3b, twice each; (d) the reduced
    trainers, card against CPU; (e) the scans' share of a prefill's
    and a decode step's wall (the profile phase traces the same
    steps).  Returns the hymba serve's launches and its
    ``flash_prefill`` launches by window, and those of the float32 step
    (``slot_step``'s)."""
    from repro_torch.configs import get_reduced_config
    t0 = time.perf_counter()
    f32_launches = slot_step(torch, hymba, counters["flash_prefill"],
                             HYMBA_STEP_PROMPT)
    emit("ssm_step_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    serves = {cfg.name: slot_serve(torch, cfg, counters, SSM_REQUESTS,
                                   SSM_PROMPTS[cfg.name], SSM_MAX_NEW, 2)
              for cfg in (hymba, xlstm)}
    for cfg in (hymba, xlstm):
        profile_ssm(torch, cfg, traced=False)
        gc.collect()
        torch.cuda.empty_cache()
    before = {n: m.launches for n, m in counters.items()}
    for arch in ("hymba-1.5b", "xlstm-1.3b"):
        train_card_vs_cpu(torch, get_reduced_config(arch), SSM_TRAIN_BATCH,
                          SSM_TRAIN_SEQ, SSM_TRAIN_LOSS_RTOL,
                          SSM_TRAIN_GRAD_TOL)
    after = {n: m.launches for n, m in counters.items()}
    if after != before:
        raise AssertionError(f"a kernel launched in training: {before} -> "
                             f"{after}")
    return (*serves[hymba.name], f32_launches)


# ------------------------------------------------------------ train
def train_batch(torch, cfg, seed, b, s, device="cuda"):
    """Random tokens and labels of ``cfg``'s vocabulary from ``seed``,
    every weight 1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    draw = lambda: torch.from_numpy(rng.integers(  # noqa: E731
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(device)
    return {"tokens": draw(), "labels": draw(),
            "weights": torch.ones(b, s, device=device)}


def rel_err(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def grads_err(got, want, invariant=()):
    """(the worst leaf's max |got - want| over its max |want|, whether
    every leaf of both is nonzero somewhere).  A leaf whose path ends in
    one of ``invariant`` (a parameter the loss does not depend on) is
    not compared: both its gradients must stay below INVARIANT_TOL of
    the largest gradient of ``want``, else the error is infinite."""
    from repro_torch.tree import tree_flatten
    worst, nonzero = 0.0, True
    pairs = [(p, g.float().cpu(), w.float().cpu()) for (p, g), (_, w)
             in zip(tree_flatten(got), tree_flatten(want))]
    top = max(w.abs().max().item() for _, _, w in pairs)
    for path, g, w in pairs:
        if path.endswith(tuple(invariant)):
            if max(g.abs().max().item(), w.abs().max().item()) \
                    > INVARIANT_TOL * top:
                worst = float("inf")
            continue
        scale = w.abs().max().item()
        nonzero &= scale > 0 and g.abs().max().item() > 0
        worst = max(worst, (g - w).abs().max().item() / max(scale, 1e-30))
    return worst, nonzero


def train_card_vs_cpu(torch, cfg, b=4, s=TRAIN_SEQ, loss_tol=TRAIN_LOSS_RTOL,
                      grad_tol=TRAIN_GRAD_TOL):
    """(a) ``value_and_grad`` and one ``make_train_step`` of the reduced
    ``cfg`` (b x s tokens; at 4 x 1024 the chunked cross-entropy; remat)
    on the card against the same on the CPU, float32 at "highest": loss
    and aux within ``loss_tol`` relative, each gradient leaf within
    ``grad_tol`` of its max |g| and nonzero somewhere (a silent detach
    gives zeros; ``INVARIANT_GRADS`` held to be negligible instead), the
    step's loss and grad norm within ``loss_tol`` relative."""
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as T
    from repro_torch.tree import tree_map
    params = M.init(cfg, 5, device="cpu")
    params_c = tree_map(lambda t: t.cuda(), params)
    batch = train_batch(torch, cfg, 6, b, s, "cpu")
    batch_c = {k: v.cuda() for k, v in batch.items()}
    loss_c, met_c, grads_c = T.value_and_grad(params_c, cfg, batch_c)
    loss, met, grads = T.value_and_grad(params, cfg, batch)
    worst, nonzero = grads_err(grads_c, grads, INVARIANT_GRADS)
    step = T.make_train_step(cfg, O.AdamWConfig(**TRAIN_OPT))
    _, m_c = step(T.TrainState(params_c, O.adamw_init(params_c)), batch_c)
    _, m = step(T.TrainState(params, O.adamw_init(params)), batch)
    errs = {k: rel_err(met_c[k], met[k]) for k in met}
    errs.update({f"step_{k}": rel_err(m_c[k], m[k])
                 for k in ("loss", "grad_norm")})
    ok = (rel_err(loss_c, loss) <= loss_tol
          and all(e <= loss_tol for e in errs.values())
          and worst <= grad_tol and nonzero)
    emit("train_card_vs_cpu", model=cfg.name, tokens=[b, s],
         loss=[float(loss_c), float(loss)], rel_errs=errs,
         worst_grad_err=worst, every_leaf_nonzero=nonzero,
         tol=dict(loss=loss_tol, grad=grad_tol), ok=ok)
    if not ok:
        raise AssertionError(f"{cfg.name}: the train step on the card "
                             "disagrees with the CPU")


def timed_step(torch, step, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    return state, {k: float(v) for k, v in m.items()}, \
        time.perf_counter() - t0


def train_full_width(torch, cfg, dtype):
    """(b), (c) ``TRAIN_STEPS`` steps with remat of ``cfg`` at full width
    on 8 x 1024 tokens of the Markov corpus, params in ``dtype`` and
    float32 moments: finite losses and grad norms, the first loss near
    ln V; in float32 also the first batch's step with ``grad_accum=2``
    from the same state, whose loss and grad norm must equal the
    ``grad_accum=1`` step's.  Step walls, tokens/s, 6*N*tokens/s over
    the card's peak for the dtype, peak memory, and where a step's time
    goes (``device_profile``)."""
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as T
    opt = O.AdamWConfig(**TRAIN_OPT)
    data = synthetic_lm_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                device="cuda")
    batch0 = next(data)
    state = T.init_state(cfg, 0, dtype, "cuda")
    fields = {}
    ok = True
    if dtype == torch.float32:
        torch.cuda.reset_peak_memory_stats()
        _, m2, wall2 = timed_step(torch, T.make_train_step(
            cfg, opt, grad_accum=2), state, batch0)
        fields["grad_accum_2"] = dict(
            loss=m2["loss"], grad_norm=m2["grad_norm"], wall_s=wall2,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    step = T.make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(TRAIN_STEPS):
        state, m, wall = timed_step(torch, step, state,
                                    batch0 if i == 0 else next(data))
        rows.append(dict(loss=m["loss"], grad_norm=m["grad_norm"],
                         wall_s=wall))
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        step(state, batch0)
        torch.cuda.synchronize()
    fields["profile"] = device_profile(torch, one_step, 2)
    if dtype == torch.float32:
        errs = {k: rel_err(fields["grad_accum_2"][k], rows[0][k])
                for k in ("loss", "grad_norm")}
        fields["grad_accum_2_vs_1_rel_err"] = errs
        ok &= all(e <= TRAIN_ACCUM_RTOL for e in errs.values())
    n_params = M.count_params(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    best = min(r["wall_s"] for r in rows)
    dname = str(dtype).removeprefix("torch.")
    peak_flops = PEAK_FLOPS[dname]
    ln_v = math.log(cfg.vocab_size)
    ok &= (all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in rows) and abs(rows[0]["loss"] - ln_v) < 0.5)
    emit("train_step", model=cfg.name, dtype=dname, params=n_params,
         batch=[TRAIN_BATCH, TRAIN_SEQ], remat=True, steps=rows,
         ln_vocab=ln_v, best_wall_s=best, tokens_per_s=tokens / best,
         model_flops_share=6 * n_params * tokens / best / peak_flops,
         peak_flops=peak_flops, peak_memory_gb=peak / 1e9,
         card=nvidia_smi(), ok=ok, **fields)
    if not ok:
        raise AssertionError(f"{cfg.name} {dname} train steps failed "
                             "their checks")


def load_example(name):
    """A module of ``examples/`` by file name."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_remat(torch, cfg):
    """(d) ``value_and_grad`` of the 100M config on 8 x 256 tokens with
    remat on and off: the same loss and gradients within 1e-5, and each
    one's peak memory."""
    from repro_torch.models import model as M
    from repro_torch.training import train_loop as T
    params = M.init(cfg, 0, device="cuda")
    batch = train_batch(torch, cfg, 7, 8, 256)
    runs = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        runs[remat] = T.value_and_grad(params, cfg, batch, remat=remat)
        torch.cuda.synchronize()
        runs[remat] += (time.perf_counter() - t0,
                        (torch.cuda.max_memory_allocated() - base) / 1e9)
    (l1, _, g1, w1, p1), (l0, _, g0, w0, p0) = runs[True], runs[False]
    worst, nonzero = grads_err(g1, g0)
    ok = (rel_err(l1, l0) <= REMAT_RTOL and worst <= REMAT_RTOL
          and nonzero)
    emit("train_remat", model=cfg.name, tokens=[8, 256],
         loss=[float(l1), float(l0)], worst_grad_err=worst,
         peak_gb_above_weights=dict(remat=p1, no_remat=p0),
         wall_s=dict(remat=w1, no_remat=w0), tol=REMAT_RTOL,
         card=nvidia_smi(), ok=ok)
    if not ok:
        raise AssertionError("remat on and off disagree")


def train_phase(torch, counters):
    """The train phase: (a) the train step of reduced qwen3-0.6b and
    granite-moe-3b-a800m on the card against the CPU; (b) full-width
    qwen3-0.6b in float32 with grad_accum 2 against 1; (c) the same in
    bf16; (d) remat on against off at the 100M config; (e) the 100M
    example, 300 steps, its loss falling by more than 0.3 and its
    checkpoint restoring the final state; (f) the blockwise attention
    of sequences over 2048 tokens.  No hand-written kernel launches: the
    trainer's attention is plain torch."""
    import shutil
    from repro_torch.configs import get_config, get_reduced_config
    gc.collect()
    torch.cuda.empty_cache()
    before = {n: m.launches for n, m in counters.items()}
    for arch in ("qwen3-0.6b", "granite-moe-3b-a800m"):
        train_card_vs_cpu(torch, get_reduced_config(arch))
    qwen = get_config("qwen3-0.6b")
    train_blockwise(torch, get_reduced_config("qwen3-0.6b"), qwen)
    gc.collect()
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        train_full_width(torch, qwen, dtype)
        gc.collect()
        torch.cuda.empty_cache()
    example = load_example("torch_train_dense_100m")
    train_remat(torch, example.model_100m())
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt_100m"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    _, history = example.main(["--steps", str(EXAMPLE_STEPS),
                               "--torch-device", "cuda", "--ckpt-dir",
                               str(ckpt_dir)])
    if example.ckpt.latest_step(str(ckpt_dir)) != EXAMPLE_STEPS:
        raise AssertionError("the example saved no checkpoint of its last "
                             "step")
    emit("train_example", steps=EXAMPLE_STEPS,
         loss=[history[0]["loss"], history[-1]["loss"]],
         wall_s=time.perf_counter() - t0, card=nvidia_smi(), ok=True)
    after = {n: m.launches for n, m in counters.items()}
    if after != before:
        raise AssertionError(f"a kernel launched in training: {before} -> "
                             f"{after}")


def train_blockwise(torch, cfg, full):
    """(f) The trainer's blockwise attention, which every sequence over
    2048 tokens trains through (Sq*Sk > 2048**2).  ``value_and_grad`` of
    the reduced ``cfg`` on one ``BLOCKWISE_SEQ``-token sequence, card
    against CPU with (a)'s tolerances, and its peak memory on the card;
    then the attention alone at ``full``'s heads on one such sequence,
    forward and backward on the card: ``attn_causal_plain`` (blockwise,
    each q block's sweep rematerialized) against the dense masked
    ``attention`` it stands in for, outputs and Q/K/V gradients within
    1e-4 of their max, each path's peak memory above its inputs and its
    wall (the second of two calls)."""
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.training import train_loop as T
    from repro_torch.tree import tree_map
    s = BLOCKWISE_SEQ
    params = M.init(cfg, 7, device="cpu")
    params_c = tree_map(lambda t: t.cuda(), params)
    batch = train_batch(torch, cfg, 8, 1, s, "cpu")
    batch_c = {k: v.cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss_c, _, grads_c = T.value_and_grad(params_c, cfg, batch_c)
    torch.cuda.synchronize()
    model_peak = torch.cuda.max_memory_allocated() - base
    loss, _, grads = T.value_and_grad(params, cfg, batch)
    worst, nonzero = grads_err(grads_c, grads)
    model_ok = (rel_err(loss_c, loss) <= TRAIN_LOSS_RTOL
                and worst <= TRAIN_GRAD_TOL and nonzero)

    h, hkv, d = full.n_heads, full.n_kv_heads, full.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    q = torch.randn(1, s, h, d, generator=gen, device="cuda")
    k, v = (torch.randn(1, s, hkv, d, generator=gen, device="cuda")
            for _ in range(2))
    cot = torch.randn(1, s, h, d, generator=gen, device="cuda")
    mask = layers.causal_mask(s, s, device="cuda")[None]
    paths = {"dense": lambda q, k, v: layers.attention(q, k, v, mask),
             "blockwise": layers.attn_causal_plain}
    res = {}
    for name, fn in paths.items():
        for _ in range(2):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            o = fn(*ts)
            g = torch.autograd.grad((o * cot).sum(), ts)
            torch.cuda.synchronize()
            res[name] = ([o.detach(), *g], time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated() - base)
            del o, g, ts
    errs = [(b - a).abs().max().item() / a.abs().max().item()
            for a, b in zip(res["dense"][0], res["blockwise"][0])]
    ok = model_ok and max(errs) <= TRAIN_GRAD_TOL
    emit("train_blockwise", model=cfg.name, tokens=[1, s],
         loss=[float(loss_c), float(loss)],
         loss_rel_err=rel_err(loss_c, loss), worst_grad_err=worst,
         every_leaf_nonzero=nonzero, model_peak_mem_bytes=model_peak,
         attention=dict(heads=[h, hkv, d], dtype="float32",
                        rel_errs_out_dq_dk_dv=errs,
                        wall_s={n: r[1] for n, r in res.items()},
                        peak_mem_bytes={n: r[2] for n, r in res.items()}),
         tol=dict(loss=TRAIN_LOSS_RTOL, grad=TRAIN_GRAD_TOL),
         card=nvidia_smi(), ok=ok)
    if not ok:
        raise AssertionError("the blockwise attention's training path "
                             "disagrees")
    del res, q, k, v, cot, mask


# ------------------------------------------------------------ shard
def shard_phase(torch, counters, dryrun):
    """The shard phase (see the module's docstring): the dry-run
    children (``start_dryrun``) run on the CPU while (a) and (b) run on
    the card; the phase then waits for them."""
    out_dir, children = dryrun
    try:
        before = {n: m.launches for n, m in counters.items()}
        shard_draws(torch)
        shard_init(torch)
        shard_train(torch)
        after = {n: m.launches for n, m in counters.items()}
        if after != before:
            raise AssertionError(f"a kernel launched in the shard phase: "
                                 f"{before} -> {after}")
        t0 = time.perf_counter()
        for c in children:
            c.wait(timeout=max(
                SHARD_DRYRUN_TIMEOUT - (time.perf_counter() - t0), 1))
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    logs = [(out_dir / f"child{i}.log").read_text()
            for i in range(len(children))]
    shard_dryrun(out_dir, [c.returncode for c in children], logs)


def shard_draws(torch):
    """(a) The draws on the card against jax's recorded bits."""
    from repro_torch import random as R
    key = R.fold_in(R.prng_key(3, "cuda"), 12345)
    res, ok = {}, True
    for (kind, dname), (head, total) in JAX_DRAWS.items():
        dtype = getattr(torch, dname)
        x = (R.normal(key, (SHARD_DRAW_N,), dtype) if kind == "normal"
             else R.truncated_normal(key, -2.0, 2.0, (SHARD_DRAW_N,),
                                     dtype))
        bits = x.view(torch.int16 if dname == "bfloat16" else torch.int32
                      ).long() & (0xFFFF if dname == "bfloat16"
                                  else 0xFFFFFFFF)
        got = (bits[:len(head)].tolist(), int(bits.sum()))
        res[f"{kind}/{dname}"] = got == (head, total)
        ok &= got == (head, total)
    emit("shard_draws", n=SHARD_DRAW_N, equal_to_jax=res, ok=ok)
    if not ok:
        raise AssertionError("the draws on the card differ from jax's")


def shard_init(torch):
    """(a) ``M.init`` card against CPU (reduced), and full-width bf16
    inits timed."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_flatten
    draw = getattr(M.init, "__wrapped__", M.init)     # never a held tree
    equal = {}
    for arch in ("qwen3-0.6b", "granite-moe-3b-a800m"):
        cfg = get_reduced_config(arch)
        card = dict(tree_flatten(draw(cfg, 0, device="cuda")))
        cpu = dict(tree_flatten(draw(cfg, 0, device="cpu")))
        equal[arch] = set(card) == set(cpu) and all(
            torch.equal(card[k].cpu(), cpu[k]) for k in cpu)
    timed = {}
    for arch in SHARD_INIT_ARCHS:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = draw(cfg, 0, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timed[arch] = dict(
            seconds=wall, params=M.count_params(cfg),
            param_gb=(torch.cuda.memory_allocated() - base) / 1e9,
            peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        del params
    ok = all(equal.values())
    emit("shard_init", card_equals_cpu=equal, full_width_bf16=timed,
         card=nvidia_smi(), ok=ok)
    if not ok:
        raise AssertionError("M.init differs between the card and the CPU")
    gc.collect()
    torch.cuda.empty_cache()


def shard_train(torch):
    """(b) Full-width qwen3-0.6b bf16: the sharded step on a one-rank
    NCCL (1, 1) mesh against the unsharded step."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as T
    cfg = get_config("qwen3-0.6b")
    opt = O.AdamWConfig(**TRAIN_OPT)
    data = synthetic_lm_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                device="cuda")
    batches = [next(data) for _ in range(TRAIN_STEPS)]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        ctx = sharding.ShardingCtx(make_debug_mesh(), sharding.DEFAULT_RULES)
        runs = {}
        for name in ("unsharded", "sharded"):
            gc.collect()
            torch.cuda.empty_cache()
            params = M.init(cfg, 0, torch.bfloat16, "cuda")
            if name == "sharded":
                params = sharding.distribute(ctx, params, M.param_axes(cfg))
            state = T.TrainState(params, O.adamw_init(params))
            step = T.make_train_step(cfg, opt, ctx=(
                ctx if name == "sharded" else None))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rows = []
            for b in batches:
                if name == "sharded":
                    b = sharding.distribute(ctx, b, {
                        k: ("batch", "seq") for k in b})
                state, m, wall = timed_step(torch, step, state, b)
                rows.append(dict(loss=m["loss"], grad_norm=m["grad_norm"],
                                 wall_s=wall))
            best = min(r["wall_s"] for r in rows)
            runs[name] = dict(steps=rows, best_wall_s=best,
                              tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / best,
                              peak_memory_gb=torch.cuda.max_memory_allocated()
                              / 1e9)
            del state, params, step
        errs = [max(rel_err(s[k], u[k]) for k in ("loss", "grad_norm"))
                for s, u in zip(runs["sharded"]["steps"],
                                runs["unsharded"]["steps"])]
        ok = max(errs) <= TRAIN_ACCUM_RTOL
        emit("shard_train", model=cfg.name, dtype="bfloat16",
             batch=[TRAIN_BATCH, TRAIN_SEQ], mesh=[1, 1], backend="nccl",
             rel_errs=errs, tol=TRAIN_ACCUM_RTOL, card=nvidia_smi(), ok=ok,
             **runs)
    finally:
        dist.destroy_process_group()
    if not ok:
        raise AssertionError("the sharded train step disagrees with the "
                             "unsharded step")
    gc.collect()
    torch.cuda.empty_cache()


def shard_dryrun(out_dir, rcs, logs):
    """(c) The dry-run children's records."""
    recs = {}
    for case in SHARD_DRYRUN:
        arch, shape, mesh = case.split(":")
        tag = f"{arch}_{shape}_{'2x16x16' if mesh == 'multipod' else '16x16'}"
        path = out_dir / f"{tag}.json"
        recs[case] = json.loads(path.read_text()) if path.exists() else {
            "status": "missing"}
    for case, r in recs.items():
        if r.get("status") != "ok":
            emit("shard_dryrun", case=case, status=r.get("status"),
                 error=r.get("error"), op=r.get("op"), ok=False)
            continue
        coll = r["collectives_per_device_bytes"]
        emit("shard_dryrun", case=case, status="ok", chips=r["chips"],
             per_device_gb_shapes=r["memory"]["per_device_bytes"] / 1e9,
             argument_gb=r["memory"]["argument_bytes"] / 1e9,
             fits_80g_hbm=r["memory"]["fits_80g_hbm"],
             collective_gb={k: v / 1e9 for k, v in coll.items() if v},
             dominant=r["roofline"]["dominant"], seconds=r["seconds"],
             ok=True)
    ok = rcs == [0] * len(rcs) and all(r.get("status") == "ok"
                                        for r in recs.values())
    if not ok:
        for log in logs:
            print(log[-3000:], file=sys.stderr)
        raise AssertionError(f"the dry-run failed (exits {rcs})")


# ------------------------------------------------------------ tp4
# the dry-run's method on a fake 4-rank group (argv: config, mesh shape,
# batch, sequence, output path), run as a child process on the CPU
TP4_FAKE = r"""
import json, sys
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.comm_analysis import StepRecorder
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import sharding
arch, mesh, batch, seq, out = sys.argv[1:6]
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
cfg, shape = get_config(arch), InputShape("tp4", int(seq), int(batch), "train")
ctx = sharding.ShardingCtx(make_debug_mesh(*json.loads(mesh)))
rec = StepRecorder()
with FakeTensorMode(allow_non_fake_inputs=True):
    kwargs = dryrun.input_specs(cfg, shape, ctx)
    fn = dryrun.step_fn(cfg, shape, ctx)
    rec.own(kwargs)
    with rec:
        fn(**kwargs)
    args = dryrun._local_bytes(kwargs)
json.dump({"collectives": rec.collective_report(), "argument_bytes": args,
           "temp_bytes": rec.peak_bytes}, open(out, "w"))
dist.destroy_process_group()
"""


def tp4_phase(torch):
    """The tp4 phase (see the module's docstring): the fake-group child
    and the 4 NCCL ranks run at once; rank 0 writes the ranks' results,
    which are checked and printed here."""
    import multiprocessing
    import socket
    n = torch.cuda.device_count()
    if n < 4:
        raise AssertionError(f"the tp4 phase needs 4 cards; this host "
                             f"has {n}")
    out_dir = ROOT / "build" / "chip_smoke_tp4"
    out_dir.mkdir(parents=True, exist_ok=True)
    fake_out = out_dir / "fake.json"
    with open(out_dir / "fake.log", "w") as log:
        child = subprocess.Popen(
            [sys.executable, "-c", TP4_FAKE, "qwen3-0.6b",
             json.dumps(TP4_DRYRUN_MESH), str(TRAIN_BATCH), str(TRAIN_SEQ),
             str(fake_out)], env=dict(os.environ, PYTHONPATH=str(SRC),
                                      OMP_NUM_THREADS="1"),
            stdout=log, stderr=subprocess.STDOUT)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp = multiprocessing.get_context("spawn")
    ranks = [mp.Process(target=tp4_rank, args=(r, port, str(out_dir)))
             for r in range(4)]
    t0 = time.perf_counter()
    try:
        for p in ranks:
            p.start()
        # a rank that fails leaves the others waiting in a collective:
        # stop them all at once
        while (any(p.is_alive() for p in ranks)
               and not any(p.exitcode for p in ranks)
               and time.perf_counter() - t0 < TP4_TIMEOUT):
            time.sleep(1)
        if all(p.exitcode == 0 for p in ranks):
            child.wait(timeout=max(TP4_TIMEOUT - (time.perf_counter() - t0),
                                   1))
    finally:
        for p in ranks:
            if p.is_alive():
                p.kill()
                p.join()
        if child.poll() is None:
            child.kill()
            child.wait()
    codes = [p.exitcode for p in ranks]
    if codes != [0] * 4 or child.returncode != 0:
        print((out_dir / "fake.log").read_text()[-3000:], file=sys.stderr)
        raise AssertionError(f"the tp4 ranks exited {codes}, the fake-group "
                             f"child {child.returncode}")
    res = json.loads((out_dir / "rank0.json").read_text())
    fake = json.loads(fake_out.read_text())
    card = nvidia_smi()
    ok = True
    for run in res["runs"]:
        base = res["one_card"][f"{run['model']}/{run['dtype']}"]
        errs = [max(rel_err(s[k], u[k]) for k in run["keys"])
                for s, u in zip(run["steps"], base["steps"])]
        tol = (TRAIN_ACCUM_RTOL if run["dtype"] == "float32"
               else TP4_BF16_RTOL)
        # granite's one-card baseline is the first step's loss alone
        run_ok = (max(errs) <= tol and len(errs) == len(base["steps"])
                  and all(math.isfinite(s["loss"]) for s in run["steps"]))
        ok &= run_ok
        emit("tp4_train", **run, rel_errs=errs, tol=tol,
             one_card=base, card=card, ok=run_ok)
    real = res["dryrun"]
    same = real["collectives"] == fake["collectives"]
    ok &= same
    fake_bytes = fake["argument_bytes"] + fake["temp_bytes"]
    emit("tp4_dryrun", model="qwen3-0.6b", dtype="bfloat16",
         mesh=list(TP4_DRYRUN_MESH), batch=[TRAIN_BATCH, TRAIN_SEQ],
         real_collectives=real["collectives"],
         fake_collectives=fake["collectives"], equal=same,
         fake_argument_bytes=fake["argument_bytes"],
         fake_temp_bytes=fake["temp_bytes"],
         real_rank0_peak_bytes=real["rank0_peak_bytes"],
         fake_over_real=fake_bytes / real["rank0_peak_bytes"],
         card=card, ok=same)
    for run in res["serves"]:
        base = res["one_card"][f"{run['model']}/serve"]
        run_ok = (run["max_rel_err"] <= TP4_SERVE_TOL
                  and run["max_all_gather_bytes"]
                  < run["smallest_layer_cache_bytes"])
        ok &= run_ok
        emit("tp4_serve", **run, tol=TP4_SERVE_TOL, one_card=base,
             card=card, ok=run_ok)
    emit("tp4_done", seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("the tp4 phase failed (see tp4_train, "
                             "tp4_serve and tp4_dryrun)")


def tp4_rank(rank, port, out_dir):
    """One of the tp4 phase's 4 NCCL ranks, on card ``rank``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        res = tp4_runs(torch, dist, rank, pathlib.Path(out_dir))
        if rank == 0:
            with open(pathlib.Path(out_dir) / "rank0.json", "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def deepseek_cut3(cfg):
    """deepseek-v2 at its published widths, the depth cut to 3 layers:
    (MLA_DENSE, MLA_MOE, MLA_MOE), ~9.3 B parameters."""
    from repro_torch.models.config import MLA_DENSE, MLA_MOE
    return cfg.replace(name=cfg.name + "-depth3", n_layers=3,
                       layer_pattern=(MLA_DENSE, MLA_MOE, MLA_MOE))


def tp4_runs(torch, dist, rank, out_dir):
    """Every rank: the one-card runs (one model and dtype a rank at a
    time, the ranks at once), then each sharded run, the dry-run's step
    at (2, 2) and the split-cache decodes."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as T
    qwen, granite = get_config("qwen3-0.6b"), get_config(
        "granite-moe-3b-a800m")
    hymba, xlstm = get_config("hymba-1.5b"), get_config("xlstm-1.3b")
    deepseek = deepseek_cut3(get_config("deepseek-v2-236b"))
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = {c.name: (TRAIN_BATCH, TRAIN_SEQ) for c in (qwen, granite)}
    shapes.update({c.name: (TP4_LAYER_BATCH, TP4_LAYER_SEQ)
                   for c in (hymba, xlstm, deepseek)})
    batches = {n: [next(it) for _ in range(TRAIN_STEPS)] for n, it in (
        (c.name, synthetic_lm_batches(c.vocab_size, *shapes[c.name],
                                      device="cuda"))
        for c in (qwen, granite, hymba, xlstm, deepseek))}

    def weights(cfg, dtype):
        """The drawn weights on the card, drawn afresh for each run."""
        return M.init(cfg, 0, dtype, "cuda")

    def settle():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def grads(cfg, dtype, mesh=None, n=1):
        """The loss and gradient norm of each of the first ``n`` batches
        from the drawn weights, no update, on one card or sharded on
        ``mesh``.  Granite's and deepseek's whole bf16 steps do not fit
        one card (their float32 moments, old and new, and the update's
        float32 temporaries pass 80 GB); xlstm-1.3b's 48 layers amplify
        rounding, so its trajectories part after an AdamW update however
        the sums are ordered: its batches are compared from the same
        weights."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        params = weights(cfg, dtype)
        ctx = None
        if mesh is not None:
            ctx = sharding.ShardingCtx(make_debug_mesh(*mesh))
            params = sharding.distribute(ctx, params, M.param_axes(cfg))
        settle()
        rows = []
        for b in batches[cfg.name][:n]:
            t0 = time.perf_counter()
            if ctx is None:
                loss, _m, g = T.value_and_grad(params, cfg, b)
                gnorm = O.global_norm(g)
            else:
                b = sharding.distribute(ctx, b, {k: ("batch", "seq")
                                                 for k in b})
                with sharding.use_sharding(ctx.local(
                        b["tokens"].placements)):
                    loss, _m, g = T.value_and_grad(params, cfg, {
                        k: sharding.batch_shard(v) for k, v in b.items()})
                    loss = sharding.batch_sum(loss)
                with implicit_replication():
                    gnorm = O.global_norm(g)
                if isinstance(gnorm, DTensor):
                    gnorm = gnorm.full_tensor()
            torch.cuda.synchronize()
            rows.append(dict(loss=float(loss), grad_norm=float(gnorm),
                             wall_s=time.perf_counter() - t0))
            del g
        peak = torch.cuda.max_memory_allocated()
        del params
        settle()
        return rows, peak

    def run(cfg, dtype, mesh=None):
        params = weights(cfg, dtype)
        ctx = None
        if mesh is not None:
            ctx = sharding.ShardingCtx(make_debug_mesh(*mesh))
            params = sharding.distribute(ctx, params, M.param_axes(cfg))
        state = T.TrainState(params, O.adamw_init(params))
        step = T.make_train_step(cfg, O.AdamWConfig(**TRAIN_OPT), ctx=ctx)
        del params
        settle()
        rows = []
        for b in batches[cfg.name]:
            if ctx is not None:
                b = sharding.distribute(ctx, b, {k: ("batch", "seq")
                                                 for k in b})
            state, m, wall = timed_step(torch, step, state, b)
            rows.append(dict(loss=m["loss"], grad_norm=m["grad_norm"],
                             wall_s=wall))
        peak = torch.cuda.max_memory_allocated()
        del state, step
        settle()
        return rows, peak

    g = torch.Generator().manual_seed(7)
    sv = TP4_SERVE
    serve_tokens = {c.name: (
        torch.randint(0, c.vocab_size, (sv["batch"], sv["prompt"]),
                      generator=g, dtype=torch.int32),
        torch.randint(0, c.vocab_size, (sv["steps"], sv["batch"]),
                      generator=g, dtype=torch.int32))
        for c in (hymba, deepseek)}

    def positions(t):
        return torch.full((sv["batch"],), sv["prompt"] + t,
                          dtype=torch.int32, device="cuda")

    def serve_one(cfg, dtype):
        """One card's prefill and decode logits (float32), saved for the
        sharded run to read."""
        params = weights(cfg, dtype)
        caches = M.init_cache(cfg, sv["batch"], sv["cache_len"], dtype,
                              "cuda")
        tok, nxt = (t.to("cuda") for t in serve_tokens[cfg.name])
        settle()
        t0 = time.perf_counter()
        out = [M.prefill(params, cfg, tok.long(), caches, impl="train")[0]]
        for t in range(sv["steps"]):
            out.append(M.decode_step(params, cfg, caches, nxt[t].long(),
                                     positions(t).long())[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.save([o.cpu() for o in out], out_dir / f"{cfg.name}.pt")
        peak = torch.cuda.max_memory_allocated()
        del params, caches, out
        settle()
        return [dict(wall_s=wall)], peak

    def serve_sharded(cfg, dtype, mesh):
        """The dry-run's prefill and decode steps on the mesh, under
        ``StepRecorder``: each rank's logits made whole against one
        card's, the collective bytes by kind (rank 0's, prefill and the
        decode steps), the largest all-gather of a decode step beside
        the smallest cache field of one layer."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.configs import InputShape
        from repro_torch.launch import dryrun
        from repro_torch.launch.comm_analysis import StepRecorder
        from repro_torch.models import blocks
        b, n = sv["batch"], sv["cache_len"]
        ctx = sharding.ShardingCtx(make_debug_mesh(*mesh))
        params = sharding.distribute(ctx, weights(cfg, dtype),
                                     M.param_axes(cfg))
        caches = sharding.distribute(ctx, M.init_cache(
            cfg, b, n, dtype, "cuda"), M.cache_axes(cfg, b, n))
        tok, nxt = (t.to("cuda") for t in serve_tokens[cfg.name])
        tokens = sharding.distribute(ctx, tok, ("batch", "seq"))
        prefill = dryrun.step_fn(cfg, InputShape(
            "p", sv["prompt"], b, "prefill"), ctx)
        decode = dryrun.step_fn(cfg, InputShape("d", n, b, "decode"), ctx)
        steps = [sharding.distribute(ctx, t, ("batch",)) for t in nxt]
        pos = [sharding.distribute(ctx, positions(t), ("batch",))
               for t in range(sv["steps"])]
        settle()
        t0 = time.perf_counter()
        rec_p, rec_d = StepRecorder(), StepRecorder()
        rec_p.own((params, caches, tokens))
        with rec_p:
            got = [prefill(params, caches, tokens)[0]]
        rec_d.own((params, caches, steps, pos))
        with rec_d:
            for t in range(sv["steps"]):
                got.append(decode(params, caches, steps[t], pos[t])[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        rows = ctx.placements_for((b,), ("batch",))
        errs = []
        for gl, w in zip(got, torch.load(out_dir / f"{cfg.name}.pt")):
            pl = [Shard(0) if isinstance(p, Shard) else Replicate()
                  for p in rows]
            if gl.shape[-1] != cfg.vocab_size:
                pl[ctx.model_dim] = Shard(gl.dim() - 1)
            whole = DTensor.from_local(gl, ctx.mesh, pl,
                                       run_check=False).full_tensor()
            errs.append(float((whole.cpu() - w).abs().max()
                              / w.abs().max()))
        size = torch.tensor([], dtype=dtype).element_size()
        smallest = min(math.prod(shape[1:]) * size for run in
                       M.cache_struct(cfg, b, n)
                       for name, (shape, _a) in run.items()
                       if name in blocks.SEQ_FIELDS)
        gathers = [math.prod(s) * size for s in rec_d.shapes["all-gather"]]
        del params, caches, got
        settle()
        return dict(
            model=cfg.name, dtype=str(dtype).split(".")[-1],
            mesh=list(mesh), batch=b, prompt=sv["prompt"], cache_len=n,
            decode_steps=sv["steps"], rel_errs=errs, max_rel_err=max(errs),
            wall_s=wall, prefill_collectives=rec_p.collective_report(),
            decode_collectives=rec_d.collective_report(),
            max_all_gather_bytes=max(gathers, default=0),
            smallest_layer_cache_bytes=smallest), peak

    xlstm_grads = functools.partial(grads, n=TRAIN_STEPS)
    jobs = [(run, qwen, f32), (run, qwen, bf16), (grads, granite, bf16),
            (run, hymba, f32), (xlstm_grads, xlstm, f32),
            (grads, deepseek, bf16), (serve_one, hymba, f32),
            (serve_one, deepseek, f32)]
    mine = {}
    for fn, cfg, dtype in jobs[rank::4]:
        rows, peak = fn(cfg, dtype)
        if fn is serve_one:
            mine[f"{cfg.name}/serve"] = dict(rows[0],
                                             peak_memory_gb=peak / 1e9)
            continue
        best = min(r["wall_s"] for r in rows)
        mine[f"{cfg.name}/{str(dtype).split('.')[-1]}"] = dict(
            steps=rows, tokens_per_s=math.prod(shapes[cfg.name]) / best,
            peak_memory_gb=peak / 1e9, update=fn is run)
    gathered = [None] * 4
    dist.all_gather_object(gathered, mine)
    one_card = {k: v for g in gathered for k, v in g.items()}

    runs, serves, dry = [], [], None
    plan = [(run, qwen, dt, mesh) for dt in (f32, bf16)
            for mesh in TP4_MESHES]
    plan += [(run, granite, bf16, TP4_GRANITE_MESH),
             (run, hymba, f32, TP4_LAYER_MESH),
             (xlstm_grads, xlstm, f32, TP4_LAYER_MESH),
             (run, deepseek, bf16, TP4_LAYER_MESH)]
    t0 = time.perf_counter()

    def worst_peak(peak):
        peaks = [None] * 4
        dist.all_gather_object(peaks, peak)
        return peaks

    for fn, cfg, dtype, mesh in plan:
        if cfg is granite and dry is None:
            dry = tp4_dryrun_step(torch, qwen, weights(qwen, bf16),
                                  batches[qwen.name][0])
        rows, peak = fn(cfg, dtype, mesh)
        if rank == 0:
            emit("tp4_progress", model=cfg.name, mesh=list(mesh),
                 dtype=str(dtype), seconds=time.perf_counter() - t0)
        walls = torch.tensor([r["wall_s"] for r in rows], device="cuda")
        dist.all_reduce(walls, op=dist.ReduceOp.MAX)
        peaks = worst_peak(peak)
        for r, w in zip(rows, walls.tolist()):
            r["wall_s"] = w                 # the slowest rank's
        best = min(r["wall_s"] for r in rows)
        keys = (("loss", "grad_norm") if dtype == f32 or cfg is deepseek
                else ("loss",))
        runs.append(dict(model=cfg.name, dtype=str(dtype).split(".")[-1],
                         mesh=list(mesh), batch=list(shapes[cfg.name]),
                         steps=rows, keys=keys,
                         tokens_per_s=math.prod(shapes[cfg.name]) / best,
                         peak_memory_gb_by_rank=[p / 1e9 for p in peaks],
                         max_peak_memory_gb=max(peaks) / 1e9))
    for cfg in (hymba, deepseek):
        row, peak = serve_sharded(cfg, f32, TP4_LAYER_MESH)
        if rank == 0:
            emit("tp4_progress", model=cfg.name, mesh=list(TP4_LAYER_MESH),
                 dtype="serve", seconds=time.perf_counter() - t0)
        peaks = worst_peak(peak)
        serves.append(dict(row, peak_memory_gb_by_rank=[
            p / 1e9 for p in peaks], max_peak_memory_gb=max(peaks) / 1e9))
    return dict(one_card=one_card, runs=runs, serves=serves, dryrun=dry)


def tp4_dryrun_step(torch, cfg, full, batch):
    """One bf16 step at ``TP4_DRYRUN_MESH`` in the dry-run's placements
    (weights ZeRO-1, moments split over both axes) and its ``step_fn``,
    under ``StepRecorder``: the collective bytes by kind and rank 0's
    peak memory."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.comm_analysis import StepRecorder
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_loop import TrainState
    from repro_torch.tree import tree_map
    shape = InputShape("tp4", TRAIN_SEQ, TRAIN_BATCH, "train")
    ctx = sharding.ShardingCtx(make_debug_mesh(*TP4_DRYRUN_MESH))
    assert cfg.param_count() < 8e9          # the dry-run's ZeRO-1 regime
    zero1 = sharding.ShardingCtx(ctx.mesh, tuple(ctx.rules.items()),
                                 fsdp=False)
    axes = M.param_axes(cfg)
    moments = [sharding.distribute(ctx, tree_map(
        lambda t: torch.zeros_like(t, dtype=torch.float32), full), axes)
        for _ in range(2)]
    state = TrainState(sharding.distribute(zero1, full, axes), AdamWState(
        torch.zeros((), dtype=torch.int32, device="cuda"), *moments))
    batch = sharding.distribute(ctx, batch, {k: ("batch", "seq")
                                             for k in batch})
    step = dryrun.step_fn(cfg, shape, ctx)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = StepRecorder()
    rec.own((state, batch))
    with rec:
        step(state, batch)
    torch.cuda.synchronize()
    return dict(collectives=rec.collective_report(),
                rank0_peak_bytes=torch.cuda.max_memory_allocated())


# ------------------------------------------------------------ sim
def sim_fit(torch, cfg, pa, pp):
    """The sim phase (a): the planner's ``h100`` entry fitted from the
    port's own full-width bf16 serves.  ``mfu_prefill`` from a
    prefill-only batch and ``mbu_decode`` from the median step in which
    every row decodes, each by inverting the copied ``PerfModel``'s
    ``prefill_time`` and ``decode_step_time`` with its own parameter
    and KV byte counts, so that ``PerfModel(cfg, spec)`` reproduces the
    fitted points (checked); then the model's prediction at a second
    point against the measured time, and the analytic roofline's bound
    beside each.  Every serve runs under ``counted``, whose hook times
    the steps; the paged kernels must launch once a layer for each step
    that needs them.  Returns the fitted ``DeviceSpec`` and the
    launches."""
    import statistics

    import numpy as np
    from repro_torch.core.optimizer import h100
    from repro_torch.core.optimizer.profiles import PerfModel
    from repro_torch.engine import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)
    from repro_torch.launch import analytic
    eng = InferenceEngine(cfg, EngineConfig(**SIM_ECFG), seed=0,
                          device="cuda")
    steps = []
    launches = {"paged_attention": 0, "paged_prefill": 0}
    want = dict(launches)
    rng = np.random.default_rng(21)

    def serve(n, prompt, max_new):
        reqs = [greedy(Request, SamplingParams, rng.integers(
            0, cfg.vocab_size, prompt).tolist(), max_new) for _ in range(n)]

        def drive():
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
        steps.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, got, expected = counted(torch, eng, pa, pp, drive, steps)
        wall = time.perf_counter() - t0
        for k in launches:
            launches[k] += got[k]
            want[k] += expected[k]
        if not all(len(r.output_tokens) == max_new for r in reqs):
            raise AssertionError("sim_fit: a request did not finish")
        return wall, list(steps)

    def decode(rows, prompt, max_new):
        _, st = serve(rows, prompt, max_new)
        full = [(ctx, s) for mode, n, ctx, s in st
                if mode == "decode" and n == rows]
        return (statistics.median(s for _, s in full),
                statistics.median(c for c, _ in full), len(full))

    def bound_ms(kind, batch, seq):
        t = analytic.roofline_terms(analytic.estimate(cfg, kind, batch,
                                                      seq), 0.0, 1)
        return 1e3 * max(t["compute_s"], t["memory_s"])

    serve(2, 64, 4)                                  # warm-up
    (n_pre, s_pre), (rows, s_dec, new) = SIM_FIT_PREFILL, SIM_FIT_DECODE
    t_pre, pre_steps = serve(n_pre, s_pre, 1)
    t_dec, ctx, n_full = decode(rows, s_dec, new)
    pm = PerfModel(cfg, h100.h100_spec())
    mfu = 2.0 * pm.n_active * n_pre * s_pre / (analytic.PEAK_FLOPS * t_pre)
    mbu = ((pm.param_bytes + rows * pm.kv_bytes_per_token * ctx)
           / (analytic.HBM_BW * t_dec))
    spec = h100.h100_spec(mfu_prefill=mfu, mbu_decode=mbu)
    fitted = PerfModel(cfg, spec)
    reproduced = (
        math.isclose(fitted.prefill_time(n_pre * s_pre), t_pre,
                     rel_tol=1e-9)
        and math.isclose(fitted.decode_step_time(rows, ctx), t_dec,
                         rel_tol=1e-9))
    (n2, s2), (rows2, s_dec2, new2) = SIM_CHECK_PREFILL, SIM_CHECK_DECODE
    t_pre2, pre2_steps = serve(n2, s2, 1)
    t_dec2, ctx2, n_full2 = decode(rows2, s_dec2, new2)
    points = [
        dict(point="fit", kind="prefill", prompts=n_pre, tokens=s_pre,
             steps=len(pre_steps), measured_ms=1e3 * t_pre,
             predicted_ms=1e3 * fitted.prefill_time(n_pre * s_pre),
             roofline_bound_ms=bound_ms("prefill", n_pre, s_pre)),
        dict(point="fit", kind="decode", rows=rows, context=ctx,
             steps=n_full, measured_ms=1e3 * t_dec,
             predicted_ms=1e3 * fitted.decode_step_time(rows, ctx),
             roofline_bound_ms=bound_ms("decode", rows, round(ctx))),
        dict(point="check", kind="prefill", prompts=n2, tokens=s2,
             steps=len(pre2_steps), measured_ms=1e3 * t_pre2,
             predicted_ms=1e3 * fitted.prefill_time(n2 * s2),
             roofline_bound_ms=bound_ms("prefill", n2, s2)),
        dict(point="check", kind="decode", rows=rows2, context=ctx2,
             steps=n_full2, measured_ms=1e3 * t_dec2,
             predicted_ms=1e3 * fitted.decode_step_time(rows2, ctx2),
             roofline_bound_ms=bound_ms("decode", rows2, round(ctx2)))]
    ok = (reproduced and n_full > 0 and n_full2 > 0 and launches == want
          and min(launches.values()) > 0)
    emit("sim_fit", model=cfg.name, dtype=SIM_ECFG["dtype"],
         mfu_prefill=mfu, mbu_decode=mbu,
         catalogue_default=dict(mfu_prefill=0.55, mbu_decode=0.70),
         fit_reproduced=reproduced, points=points, launches=launches,
         expected_launches=want, card=nvidia_smi(), ok=ok)
    del eng
    gc.collect()        # the engine's scheduler holds its bound methods
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("sim_fit failed its checks")
    return spec, launches


def sim_cluster(torch, cfg, spec):
    """The sim phase (b): the port's cluster simulator on the fitted
    ``h100`` and on the catalogue's ``a10``: a thermal throttle injected
    on engine-1 as ``examples/serve_cluster.py`` injects it, and an
    engine crash with recovery from the recovery log.  Every request
    finishes or is rejected, the monitor diagnoses the throttled pod, the
    crash loses no request.  Then the GPU optimizer over a10, l20 and
    the fitted h100 for ``examples/hetero_optimizer.py``'s demand."""
    from repro_torch.configs import get_config
    from repro_torch.core.diagnostics import FaultKind
    from repro_torch.core.optimizer import (GPUOptimizer, ProfileTable,
                                            homogeneous_cost, h100)
    from repro_torch.core.sim import (ClusterConfig, ServingCluster,
                                      SimEngineConfig)
    from repro_torch.core.sim.chaos import ChaosSchedule
    from repro_torch.core.sim.workloads import birdsql_like
    h100.register(spec)
    keys = load_example("torch_serve_cluster").SUMMARY_KEYS
    c = SIM_CLUSTER
    runs = {}
    for device in ("h100", "a10"):
        cluster = ServingCluster(cfg, ClusterConfig(
            routing_policy="prefix-load", device_type=device,
            num_engines=c["engines"], use_kv_pool=True, telemetry=True,
            chaos=ChaosSchedule.engine_crash(at=c["crash_at"]),
            engine=SimEngineConfig(device_type=device, **SIM_ENGINE)))
        cluster.loop.after(c["throttle_at"], lambda cl=cluster: (
            cl.injector.inject("engine-1", FaultKind.THERMAL_THROTTLE,
                               c["throttle_at"], severity=0.8)))
        t0 = time.perf_counter()
        s = cluster.run(birdsql_like(c["requests"], rate_rps=c["rate_rps"],
                                     seed=7))
        host_s = time.perf_counter() - t0
        throttled = [(d.t, d.action) for d in cluster.diagnoses
                     if d.pod_id == "engine-1"
                     and d.fault is FaultKind.THERMAL_THROTTLE]
        ok = (s["finished"] + s["rejected"] == c["requests"]
              and bool(throttled) and s["crashed_requests"] > 0
              and s["crash_recovered"] == s["crashed_requests"])
        runs[device] = dict(
            ok=ok, host_s=host_s, throttle_diagnoses=throttled,
            summary={k: s.get(k, 0) for k in keys + (
                "crashed_requests", "crash_recovered", "quarantines",
                "diagnoses", "ckpt_pages")},
            diagnoses=[(d.pod_id, d.t, d.fault.value, d.action)
                       for d in cluster.diagnoses])
        del cluster
    demand = load_example("torch_hetero_optimizer").demand()
    table = ProfileTable(get_config("deepseek-coder-7b"), slo_ttft_s=5.0,
                         slo_itl_s=0.25)
    devices = ("a10", "l20", "h100")
    alloc = GPUOptimizer(table, devices).optimize(demand)
    n_h, c_h = homogeneous_cost(table, demand, "h100")   # inf: no fit
    ok = all(r["ok"] for r in runs.values())
    emit("sim_cluster", model=cfg.name, requests=c["requests"],
         rate_rps=c["rate_rps"], engines=c["engines"], h100=dict(
             mfu_prefill=spec.mfu_prefill, mbu_decode=spec.mbu_decode,
             cost_per_hour=spec.cost_per_hour), runs=runs,
         optimizer=dict(model="deepseek-coder-7b", devices=devices,
                        counts=alloc.counts,
                        cost_per_hour=alloc.cost_per_hour,
                        note=alloc.note, assignment=[
                            [list(b), dev, rps] for (b, dev), rps
                            in sorted(alloc.assignment.items())],
                        homogeneous_h100=[n_h, c_h if c_h < float("inf")
                                          else None]), ok=ok)
    if not ok:
        raise AssertionError("sim_cluster failed its checks")


def sim_recover(torch, cfg, pa, pp):
    """The sim phase (c): the diagnostics -> remediation chain around two
    real full-width float32 qwen3-0.6b engines, A and B, that share a
    ``DistributedKVPool`` and log every full page (the recovery log).
    After each of A's steps a ``DiagnosticMonitor`` observes a
    ``Telemetry`` sample of A's own token rate through a
    ``FailureInjector``.  Once every request has decoded past a
    checkpointed page, ``DEVICE_LOST`` is injected on A; the monitor's
    diagnosis must be ``restart``, on which the harness calls
    ``A.sched.crash_takeover`` (as ``ServingCluster._remediate`` does for
    a dead pod) and submits the harvested requests to B.  Each output
    must equal a lone uncrashed engine's, B's remote hits the
    checkpointed coverage, its ``crash_resumes`` the number resumed, no
    page leaked on B, and the paged kernels launched exactly once a
    layer for each step that needs them.  Returns the launches of A's
    steps and B's (``counted`` around each)."""
    import numpy as np
    from repro_torch.core.diagnostics import (DiagnosticMonitor,
                                              FailureInjector, FaultKind,
                                              Telemetry)
    from repro_torch.core.kvcache.pool import DistributedKVPool
    from repro_torch.engine import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)
    f32 = dict(SERVE_ECFG, dtype="float32")
    ecfg = EngineConfig(**f32, ckpt_interval_tokens=f32["page_size"])
    start = time.monotonic()

    def clock():
        return time.monotonic() - start
    pool = DistributedKVPool(capacity_bytes=8 << 30, metadata_lag=0.0,
                             clock=clock)
    a, b = (InferenceEngine(cfg, ecfg, seed=0, device="cuda", clock=clock,
                            kv_pool_client=pool, engine_id=eid)
            for eid in ("a", "b"))
    rng = np.random.default_rng(53)
    lo, hi = SIM_RECOVER_PROMPTS
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(lo, hi + 1, SIM_RECOVER_REQUESTS)]
    reqs = [greedy(Request, SamplingParams, p, SIM_RECOVER_NEW)
            for p in prompts]
    monitor, injector = DiagnosticMonitor(), FailureInjector()
    healthy = []

    def observe():
        sample = Telemetry(pod_id="a", t=clock(),
                           tokens_per_sec=a.metrics().tokens_per_sec)
        return monitor.observe(injector.perturb(sample))

    def drive_a():
        for r in reqs:
            a.submit(r)
        while not all(r.ckpt_tokens > r.prompt_len
                      and len(r.output_tokens) >= SIM_CRASH_AFTER
                      for r in reqs):
            if not a.has_work:
                raise AssertionError("sim_recover: A finished before "
                                     "the crash")
            a.step()
            healthy.extend(observe())

    t0 = time.perf_counter()
    modes_a, launches_a, want_a = counted(torch, a, pa, pp, drive_a)
    generated = [list(r.output_tokens) for r in reqs]
    injector.inject("a", FaultKind.DEVICE_LOST, clock())
    action = [(d.pod_id, d.fault.value, d.action) for d in observe()]
    if action != [("a", "device_lost", "restart")]:
        raise AssertionError(f"sim_recover: the monitor said {action}")
    lost = a.sched.crash_takeover(clock())
    covered = [r.ckpt_tokens for r in reqs]
    resumed = sum(r.ckpt_tokens > r.prompt_len for r in lost)
    rewound = all(r.output_tokens == g[:r.ckpt_tokens - r.prompt_len]
                  for r, g in zip(reqs, generated))

    def drive_b():
        for r in lost:
            b.submit(r)
        b.run_until_idle()
    modes_b, launches_b, want_b = counted(torch, b, pa, pp, drive_b)
    wall = time.perf_counter() - t0
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    want = {k: want_a[k] + want_b[k] for k in want_a}
    remote_hits = b.metrics().remote_hit_tokens
    b_resumes = b.sched._m["crash_resumes"]
    leaked = b.alloc.num_pages - b.alloc.num_free
    del a, b
    gc.collect()        # each engine's scheduler holds its bound methods

    lone = InferenceEngine(cfg, EngineConfig(**f32), seed=0, device="cuda")
    alone = [greedy(Request, SamplingParams, p, SIM_RECOVER_NEW)
             for p in prompts]
    for r in alone:
        lone.submit(r)
    lone.run_until_idle()
    del lone
    gc.collect()
    torch.cuda.empty_cache()
    same = [list(r.output_tokens) == list(x.output_tokens)
            for r, x in zip(reqs, alone)]
    ok = (healthy == [] and len(lost) == SIM_RECOVER_REQUESTS and rewound
          and all(same) and all(len(r.output_tokens) == SIM_RECOVER_NEW
                                for r in reqs)
          and remote_hits == sum(covered)
          and b_resumes == resumed == SIM_RECOVER_REQUESTS
          and leaked == 0 and launches == want
          and min(launches.values()) > 0)
    emit("sim_recover", model=cfg.name, dtype="float32",
         requests=SIM_RECOVER_REQUESTS,
         prompt_tokens=[len(p) for p in prompts],
         max_new=SIM_RECOVER_NEW, steps_a=modes_a, steps_b=modes_b,
         tokens_at_crash=[len(g) for g in generated],
         diagnoses_before_fault=len(healthy), diagnosis=action,
         harvested=len(lost), checkpointed_tokens=covered,
         remote_hit_tokens=remote_hits, resumed=resumed,
         crash_resumes=b_resumes, leaked_pages_b=leaked,
         same_tokens_as_lone_engine=same, launches=launches,
         expected_launches=want, wall_s=wall, card=nvidia_smi(), ok=ok)
    if not ok:
        raise AssertionError("sim_recover failed its checks")
    return launches


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
    calls, divided by ``iters``.  A trace that holds another number of
    calls (launches of ``<name>_kernel`` itself) than were timed is
    refused and taken again, at most three times: traces have been seen
    to drop events, and now and then to hold none, and a short one read
    a kernel's time above its own ``time_ms``.  The kernel alone, where
    ``time_ms`` of a small kernel also counts the host's launch overhead
    between calls."""
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
        if calls == iters:
            return sum(e.time_range.elapsed_us() for e in events) / iters \
                / 1e3
        emit("trace_refused", kernel=name, calls_timed=iters,
             calls_in_trace=calls)
    return "not measured"


def library_sdpa(torch, dtype, q, k, v, mask=None, is_causal=False):
    """The library call beside a kernel: one
    ``F.scaled_dot_product_attention`` over (B, H, S, D) tensors laid out
    beforehand, and the name of its backend.  bf16: the default backend
    with ``enable_gqa``.  float32: the memory-efficient backend (CUTLASS,
    each float32 product as three TF32 products, so the tensor cores at
    the float32 tolerance; the math backend's plain float32 matmuls are
    no yardstick), K/V expanded to H heads here, since that backend may
    refuse ``enable_gqa``; a call it refuses raises."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if dtype == torch.bfloat16:
        return (lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=is_causal, enable_gqa=True),
            "default, enable_gqa")
    g = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(g, dim=1).contiguous() for t in (k, v))

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=is_causal)
    return call, "EFFICIENT_ATTENTION, K/V expanded to H heads"


def dtype_label(torch, dtype):
    return "bf16" if dtype == torch.bfloat16 else "float32"


def decode_row(torch, gen, launches, h, hkv, d, page, nb, lengths,
               num_pages, dtype=None, **extra):
    """One ``paged_attention`` timing row (bf16 unless ``dtype``): the
    kernel, its plain version and SDPA (``library_sdpa``) over K/V
    gathered beforehand, on ``lengths`` rows of a ``num_pages`` pool
    with block tables ``nb`` wide; the planner's split beside it."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    dt = dtype or torch.bfloat16
    esize = torch.tensor([], dtype=dt).element_size()
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
    library, backend = library_sdpa(torch, dt, qs, k, v, mask)
    lib_err = (library()[:, :, 0].float() - plain.float()).abs().max() \
        .item()
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
        time_ms(torch, library), nbytes, flops, str(dt)[6:],
        device_ms=kernel_device_ms(
            torch, lambda: ops.paged_attention(*args), "paged_attention"),
        pages_per_split=pps, n_splits=n_splits, library_backend=backend,
        library_max_abs_err=lib_err,
        case=f"B{b} H{h} Hkv{hkv} D{d} page{page} NB{nb} lengths "
        f"{int(ln.min())}-{int(ln.max())} {dtype_label(torch, dt)}",
        **extra)


def timing(torch, cfg, launches, long_rows=True, dtype=None, **extra):
    """Phase 11: kernel, plain and library times and the bound, at the
    serving shapes (bf16 unless ``dtype``, ``cfg``'s heads: H 16, Hkv 8,
    D 64 for qwen3-0.6b, H 24, Hkv 8, D 64 for granite-moe-3b-a800m;
    page 16, a pool of 1025 pages, block tables 52 wide, 8 decode rows,
    2 chunks of 64); then, with ``long_rows``, ``paged_attention`` at
    long contexts and at glm4-9b's group shape, on lines of their own.
    ``extra`` fields go on each serving-shape line."""
    from repro_torch.kernels import ops, ref
    dt = dtype or torch.bfloat16
    page, h, hkv, d, nb = 16, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 52
    esize = torch.tensor([], dtype=dt).element_size()
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
                            lengths, 1025, dtype=dt, **extra))

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
    library, backend = library_sdpa(torch, dt, qs, k, v, pmask)
    lib_err = (library().transpose(1, 2).float() - plain.float()).abs() \
        .max().item()
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
        time_ms(torch, library), nbytes, flops, str(dt)[6:],
        device_ms=kernel_device_ms(
            torch, lambda: ops.paged_prefill(*pargs), "paged_prefill"),
        library_backend=backend, library_max_abs_err=lib_err,
        case=f"K2 S{s} H{h} Hkv{hkv} D{d} page{page} NB{nb} ctx 0 and 704 "
        f"{dtype_label(torch, dt)}", **extra))
    if not long_rows:
        return lines

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


def flash_timing(torch, cfg, launches, by_window, s=2048, dtype=None,
                 **extra):
    """flash_prefill at a slot path's prefill shapes, ``cfg``'s heads
    (gemma3-4b: H 8, Hkv 4, D 256; hymba-1.5b: H 25, Hkv 5, D 64), one
    ``s``-token prompt, bf16 unless ``dtype``, with the SWA layers'
    window and without (the DENSE or global layers).  The first row is
    returned, for the ``kernels`` line; both go into timing lines.  Each
    row's ``launches_in_mode`` is the path's launches with its window,
    as the wrapper counted them (``by_window``); ``extra`` fields go on
    each line."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    dt = dtype or torch.bfloat16
    esize = torch.tensor([], dtype=dt).element_size()
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    q, k, v, ln = flash_case(torch, gen, 1, s, s, h, hkv, d, dt, [s])
    # SDPA's (B, H, S, D) layout, made before timing
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lines = []
    for win in (cfg.sliding_window, 0):
        out = ops.flash_attention(q, k, v, ln, window=win)
        plain = ref.flash_prefill_ref(q, k, v, ln, window=win)
        err = (out.float() - plain.float()).abs().max().item()
        mask = layers.causal_mask(s, s, window=win, device="cuda")
        library, backend = (
            library_sdpa(torch, dt, qs, ks, vs, mask=mask) if win
            else library_sdpa(torch, dt, qs, ks, vs, is_causal=True))
        lib_err = (library().transpose(1, 2).float()
                   - plain.float()).abs().max().item()
        pairs = int(mask.sum())               # live (query, key) pairs
        nbytes = 2 * q.numel() * esize + 2 * k.numel() * esize \
            + ln.numel() * 4
        flops = 4 * pairs * h * d
        lines.append(kernel_line(
            "flash_prefill", launches, err,
            time_ms(torch, lambda: ops.flash_attention(q, k, v, ln,
                                                       window=win)),
            time_ms(torch, lambda: ref.flash_prefill_ref(q, k, v, ln,
                                                         window=win)),
            time_ms(torch, library), nbytes, flops, str(dt)[6:],
            case=f"B1 S{s} H{h} Hkv{hkv} D{d} {dtype_label(torch, dt)} "
            f"window {win}",
            launches_in_mode=by_window.get(win, 0),
            device_ms=kernel_device_ms(
                torch, lambda: ops.flash_attention(q, k, v, ln, window=win),
                "flash_prefill"),
            library_backend=(backend if win else backend + ", is_causal"),
            library_max_abs_err=lib_err, **extra))
    return lines[:1]


def kernel_line(name, launches, err, ms, plain_ms, library_ms, nbytes,
                flops, dtype, **extra):
    """One timing line.  ``bound_ms``: the larger of the bytes over 3.35
    TB/s and the operations over the card's peak for ``dtype``: bf16 on
    the tensor cores; float32 as three TF32 products on the tensor cores
    (``PEAK_FLOPS_3XTF32``), with the CUDA cores' bound beside it
    (``bound_cuda_core_ms``)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    peak = PEAK_FLOPS_3XTF32 if dtype == "float32" else PEAK_FLOPS[dtype]
    t_ops = flops / peak * 1e3
    if dtype == "float32":
        extra["bound_cuda_core_ms"] = max(
            t_bytes, flops / PEAK_FLOPS["float32"] * 1e3)
    line = dict(name=name, route="cuda", **KERNEL_INFO[name],
                launches=launches[name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms, **extra)
    emit("timing", **line, dtype=dtype, bytes=nbytes, flops=flops)
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
    """Phase 12: one full-width bf16 paged mixed step (8 decode rows,
    chunks of 64 and 37), ended by a synchronize as the engine's
    sampling ends it; then the same step with a bank of 4 adapters, the
    rows on 4 distinct adapters and the base model; then the step in
    float32, the engines' default dtype."""
    from repro_torch import random as R
    from repro_torch.engine import paged_model as PM
    params, pool, a, page = step_inputs(torch, cfg, torch.bfloat16)
    bank = PM.init_lora(cfg, LORA_ADAPTERS + 1, LORA_RANK, torch.bfloat16,
                        "cuda")
    for i in range(1, LORA_ADAPTERS + 1):
        for k, w in PM.make_adapter(cfg, LORA_RANK,
                                    R.prng_key(100 + i)).items():
            bank[k][i].copy_(w)
    ids = dict(dec_adapter_ids=torch.tensor(
        [1, 2, 0, 3, 4, 0, 1, 0], dtype=torch.int32, device="cuda"),
        pre_adapter_ids=torch.tensor([3, 0], dtype=torch.int32,
                                     device="cuda"))

    def step():
        PM.mixed_step(params, pool, **a, cfg=cfg, page_size=page)
        torch.cuda.synchronize()

    def step_with_lora():
        PM.mixed_step(params, pool, **a, lora=bank, **ids, cfg=cfg,
                      page_size=page)
        torch.cuda.synchronize()

    emit("profile", step="mixed_step", model=cfg.name, dtype="bfloat16",
         **device_profile(torch, step, 10))
    emit("profile", step="mixed_step with LoRA", model=cfg.name,
         dtype="bfloat16", adapters=LORA_ADAPTERS, rank=LORA_RANK,
         dec_adapter_ids=ids["dec_adapter_ids"].tolist(),
         pre_adapter_ids=ids["pre_adapter_ids"].tolist(),
         **device_profile(torch, step_with_lora, 10))
    del params, pool, bank
    params, pool, a, page = step_inputs(torch, cfg, torch.float32)
    emit("profile", step="mixed_step", model=cfg.name, dtype="float32",
         **device_profile(torch, step, 10))
    del params, pool


def profile_moe(torch, cfg):
    """Phase 12: one full-width bf16 paged mixed step of
    granite-moe-3b-a800m (8 decode rows, chunks of 64 and 37) and one
    ``decode_batch`` of its 8 rows, each ended by a synchronize, beside
    the least time the card could take to read every weight once (the
    capacity buffer runs every expert in every step)."""
    from repro_torch.engine import paged_model as PM
    from repro_torch.tree import tree_leaves
    params, pool, a, page = step_inputs(torch, cfg, torch.bfloat16)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))

    def step():
        PM.mixed_step(params, pool, **a, cfg=cfg, page_size=page)
        torch.cuda.synchronize()

    def decode():
        PM.decode_batch(params, pool, a["dec_tokens"], a["dec_positions"],
                        a["dec_block_tables"], a["dec_active"], cfg=cfg,
                        page_size=page)
        torch.cuda.synchronize()

    bound = weight_bytes / PEAK_BYTES_PER_S * 1e3
    emit("profile", step="mixed_step", model=cfg.name, dtype="bfloat16",
         weight_bytes=weight_bytes, weight_read_bound_ms=bound,
         **device_profile(torch, step, 10))
    emit("profile", step="decode_batch", model=cfg.name, dtype="bfloat16",
         decode_rows=a["dec_tokens"].shape[0], weight_bytes=weight_bytes,
         weight_read_bound_ms=bound, **device_profile(torch, decode, 10))
    del params, pool


def profile_slot(torch, cfg):
    """Phase 12: the slot path at full width in bf16: one prefill of a
    2048-token prompt into a one-row cache, and one decode step of 4
    slots at positions 1200-3000 of a 4096-token cache, each ended by a
    synchronize as the engine's sampling ends it; then the prefill in
    float32, the engines' default dtype."""
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
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init(cfg, seed=0, dtype=torch.float32, device=dev)
    one = M.init_cache(cfg, 1, SLOT_ECFG["max_len"], torch.float32, dev)
    emit("profile", step="slot prefill", model=cfg.name, dtype="float32",
         prompt=s, **device_profile(torch, prefill, 3))
    del params, one


# ------------------------------------------------------------ main
def kernel_label(mangled):
    """``paged_prefill_kernel_f32<64,64,2,256>`` for a kernel's mangled
    name (the last 40 characters of any other name)."""
    import re
    k = re.search(r"([a-z_]+_kernel(?:_tc|_f32)?)I(.*?)EEv", mangled)
    if not k:
        return mangled[-40:]
    types = {"f": "float", "13__nv_bfloat16": "bf16"}
    args = [a or types[b] for a, b in re.findall(
        r"Li(\d+)E|^(f|13__nv_bfloat16)", k.group(2) + "E")]
    return f"{k.group(1)}<{','.join(args)}>"


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
            fn = kernel_label(m.group(1))
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


def sass_mma_counts(lib):
    """The tensor-core instructions of each kernel in a built library,
    by opcode (``HMMA.1684.F32.TF32`` and the like for mma.sync,
    ``HGMMA.*`` for wgmma), from ``cuobjdump -sass``; "not measured"
    without the tool."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "not measured"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    fns, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = fns.setdefault(kernel_label(m.group(1)), {})
            continue
        m = re.search(r"\b(HG?MMA\.[\w.]+)", line)
        if m and fn is not None:
            fn[m.group(1)] = fn.get(m.group(1), 0) + 1
    return fns


PHASES = ("kernels", "sampling", "step", "serve", "lora", "tiers", "spec",
          "launch", "slot_step", "slot_serve", "moe", "ssm", "train", "sim",
          "timing", "profile", "shard")


def memo_init():
    """Draw each (config, seed, device) once while it is the newest:
    ``M.init`` draws the reference's weights with the ported threefry
    and erf_inv (2.4 s for qwen3-0.6b, 18.6 s for gemma3-4b on the
    card), and the phases build engines of one model many times, in
    float32 and in bf16.  One tree is held: a bf16 request of the held
    float32 draw takes its cast (as ``init_params`` casts its float32
    draw) and is held instead.  Nothing here writes to a weight.
    ``M.init.__wrapped__`` draws afresh (the shard phase times it)."""
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    draw = M.init
    held = {}

    @functools.wraps(draw)
    def init(cfg, seed=0, dtype=None, device=None):
        import torch
        dtype = dtype or torch.float32
        key = (cfg, seed, str(device))
        have = held.get(key)
        if have is None or have[0] not in (dtype, torch.float32):
            held.clear()
            have = held[key] = (torch.float32,
                                draw(cfg, seed, torch.float32, device))
        if have[0] != dtype:
            held[key] = (dtype, tree_map(lambda t: t.to(dtype), have[1]))
        return held[key][1]
    M.init = init


def start_dryrun():
    """(c) of the shard phase: one dry-run child a case, started with
    the script so that they run on the host's cores beside the other
    phases (they hold no card: a fake process group, fake tensors)."""
    import atexit
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    children = []
    for i, case in enumerate(SHARD_DRYRUN):
        with open(out_dir / f"child{i}.log", "w") as log:
            children.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--out", str(out_dir), "--case", case], env=env,
                stdout=log, stderr=subprocess.STDOUT))

    def stop():                 # a phase failed before (c) collected them
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    atexit.register(stop)
    return out_dir, children


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", default=",".join(PHASES),
        help="comma-separated phases to run after the build, of "
        f"{', '.join(PHASES)} (default: all; the kernels line is printed "
        "only when all run), or tp4 (four cards)")
    only = set(parser.parse_args().only.split(","))
    if not only <= set(PHASES) | {"tp4"}:
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

    memo_init()
    dryrun = start_dryrun() if "shard" in only else None
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    reports = build.build()
    seconds = time.perf_counter() - t0
    sass = {n: sass_mma_counts(build.library_path(n)) for n in build.KERNELS}
    emit("build", seconds=seconds, kernels=list(build.KERNELS),
         ptxas={n: ptxas_summary(log) for n, log in reports.items()},
         sass_mma=sass)

    starts = []                 # (phase, start time), in the order run
    if "kernels" in only:
        starts.append(("kernels", time.perf_counter()))
        results = check_kernels(torch, ops)
        # every float32 prefill kernel runs on the tensor cores (3xTF32)
        for n in ("paged_prefill", "flash_prefill"):
            if not isinstance(sass[n], dict):
                continue                # no cuobjdump: not measured
            f32 = {f: mma for f, mma in sass[n].items() if "_f32<" in f}
            results.append(dict(
                kernel=n, dtype="float32", case="float32 kernels: TF32 HMMA",
                max_abs_err=0.0, tol=0.0, sass_mma=f32,
                ok=bool(f32) and all(any("TF32" in o for o in mma)
                                     for mma in f32.values())))
        for r in results:
            emit("kernel_check", **r)
        if not all(r["ok"] for r in results):
            raise AssertionError("a kernel disagrees with its plain version")

    if "sampling" in only:
        starts.append(("sampling", time.perf_counter()))
        t0 = time.perf_counter()
        sampling(torch)
        emit("sampling_done", seconds=time.perf_counter() - t0)

    cfg = get_config("qwen3-0.6b")
    gemma = get_config("gemma3-4b")
    granite = get_config("granite-moe-3b-a800m")
    hymba = get_config("hymba-1.5b")
    launches = slot_launches = moe_launches = ssm_launches = dict.fromkeys(
        KERNEL_INFO, 0)
    fit_launches = sim_launches = launches
    slot_by_window, ssm_by_window = {}, {}
    # each model's float32 step functions' launches (the step, moe,
    # slot_step and ssm phases): the float32 timing rows' counts
    f32_launches = {}
    if "step" in only:
        starts.append(("step", time.perf_counter()))
        f32_launches[cfg.name] = full_width_step(torch, cfg)
    if "serve" in only:
        starts.append(("serve", time.perf_counter()))
        launches = serve(torch, cfg, pa, pp)["launches"]
    if "lora" in only:
        starts.append(("lora", time.perf_counter()))
        t0 = time.perf_counter()
        lora_step(torch, cfg)
        lora_serve(torch, cfg, pa, pp)
        adapter_load_times(torch, cfg)
        emit("lora_done", seconds=time.perf_counter() - t0)
    if "tiers" in only:
        starts.append(("tiers", time.perf_counter()))
        t0 = time.perf_counter()
        tiers(torch, cfg, pa, pp)
        emit("tiers_done", seconds=time.perf_counter() - t0)
    if "spec" in only:
        starts.append(("spec", time.perf_counter()))
        t0 = time.perf_counter()
        spec_steps(torch, cfg, pa, pp)
        spec_serve(torch, cfg, pa, pp)
        emit("spec_done", seconds=time.perf_counter() - t0)
    if "launch" in only:
        starts.append(("launch", time.perf_counter()))
        t0 = time.perf_counter()
        launch(torch, cfg, pa, pp)
        emit("launch_done", seconds=time.perf_counter() - t0)
    if "slot_step" in only:
        starts.append(("slot_step", time.perf_counter()))
        f32_launches[gemma.name] = slot_step(torch, gemma, fp)
    if "slot_serve" in only:
        starts.append(("slot_serve", time.perf_counter()))
        slot_launches, slot_by_window = slot_serve(torch, gemma, {
            "flash_prefill": fp, "paged_attention": pa, "paged_prefill": pp})
    if "moe" in only:
        starts.append(("moe", time.perf_counter()))
        t0 = time.perf_counter()
        moe_launches, f32_launches[granite.name] = moe_phase(
            torch, granite, deepseek_cut(get_config("deepseek-v2-236b")), {
                "flash_prefill": fp, "paged_attention": pa,
                "paged_prefill": pp})
        emit("moe_done", seconds=time.perf_counter() - t0)
    if "ssm" in only:
        starts.append(("ssm", time.perf_counter()))
        t0 = time.perf_counter()
        ssm_launches, ssm_by_window, f32_launches[hymba.name] = ssm_phase(
            torch, hymba, get_config("xlstm-1.3b"), {
                "flash_prefill": fp, "paged_attention": pa,
                "paged_prefill": pp})
        emit("ssm_done", seconds=time.perf_counter() - t0)
    if "train" in only:
        starts.append(("train", time.perf_counter()))
        t0 = time.perf_counter()
        train_phase(torch, {"flash_prefill": fp, "paged_attention": pa,
                            "paged_prefill": pp})
        emit("train_done", seconds=time.perf_counter() - t0)
    if "sim" in only:
        starts.append(("sim", time.perf_counter()))
        t0 = time.perf_counter()
        spec, fit_launches = sim_fit(torch, cfg, pa, pp)
        sim_cluster(torch, cfg, spec)
        sim_launches = sim_recover(torch, cfg, pa, pp)
        emit("sim_done", seconds=time.perf_counter() - t0)
    lines = []
    if "timing" in only:
        starts.append(("timing", time.perf_counter()))
        lines = timing(torch, cfg, launches) + flash_timing(
            torch, gemma, slot_launches, slot_by_window)
        timing(torch, granite, moe_launches, long_rows=False,
               model=granite.name)
        flash_timing(torch, hymba, ssm_launches, ssm_by_window,
                     s=HYMBA_FLASH_SEQ, model=hymba.name)
        # float32, the engines' default dtype, at the same shapes; each
        # row's launches are its model's float32 step functions' (the
        # step, moe, slot_step and ssm phases)
        f32 = torch.float32
        for m in (cfg, granite):
            timing(torch, m, {**dict.fromkeys(KERNEL_INFO, 0),
                              **f32_launches.get(m.name, {})},
                   long_rows=False, dtype=f32, model=m.name,
                   launches_path=f"{m.name} float32 step functions")
        for m, s_ in ((gemma, 2048), (hymba, HYMBA_FLASH_SEQ)):
            n, by_window = f32_launches.get(m.name, (0, {}))
            flash_timing(torch, m, {**dict.fromkeys(KERNEL_INFO, 0),
                                    "flash_prefill": n},
                         by_window, s=s_, dtype=f32, model=m.name,
                         launches_path=f"{m.name} float32 slot step")
        # each path's launches: the serves of qwen3-0.6b (the kernels'
        # own ``launches``), granite-moe-3b-a800m, gemma3-4b and
        # hymba-1.5b, and the fit and the crash recovery of the sim phase
        for line in lines:
            line["launches_by_path"] = {
                f"{cfg.name} sim fit": fit_launches.get(line["name"], 0),
                f"{cfg.name} sim recover": sim_launches.get(line["name"], 0),
                f"{cfg.name} serve": launches.get(line["name"], 0),
                f"{granite.name} serve": moe_launches.get(line["name"], 0),
                f"{gemma.name} slot serve": slot_launches.get(line["name"],
                                                              0),
                f"{hymba.name} slot serve": ssm_launches.get(line["name"],
                                                             0)}
    if "profile" in only:
        starts.append(("profile", time.perf_counter()))
        profile_step(torch, cfg)
        profile_spec(torch, cfg)
        profile_moe(torch, granite)
        profile_slot(torch, gemma)
        for arch in ("hymba-1.5b", "xlstm-1.3b"):
            profile_ssm(torch, get_config(arch), traced=True)
    if "shard" in only:
        # last: after its NCCL group, traces of the timing phase held no
        # kernel events
        starts.append(("shard", time.perf_counter()))
        t0 = time.perf_counter()
        shard_phase(torch, {"flash_prefill": fp, "paged_attention": pa,
                            "paged_prefill": pp}, dryrun)
        emit("shard_done", seconds=time.perf_counter() - t0)

    if "tp4" in only:
        starts.append(("tp4", time.perf_counter()))
        tp4_phase(torch)

    ends = [t for _, t in starts[1:]] + [time.perf_counter()]
    emit("phase_seconds", **{name: end - t0 for (name, t0), end
                             in zip(starts, ends)})
    if only == set(PHASES):
        print(json.dumps({"kernels": lines}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
