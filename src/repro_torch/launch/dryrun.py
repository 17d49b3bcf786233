"""Multi-pod dry-run on ``torch.distributed``, the counterpart of
``repro/launch/dryrun.py``:
``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k``.

For every (architecture x input shape x mesh) case it builds the step's
inputs as DTensors on a fake process group of 256 (16x16) or 512
(2x16x16) ranks, in this one process, and runs the real step of rank 0
under a ``FakeTensorMode``: no allocation, and the fake group moves no
data.  That proves the distribution config is coherent (every
placement legal, every op and collective runs at full width) and
yields one JSON record per case, with the reference's keys:

* ``memory``: the local bytes of the arguments and outputs, the peak of
  the bytes the step allocates beyond its arguments (``temp_bytes``),
  and ``per_device_bytes``, the arguments plus that peak: what one card
  must hold.  Nothing is donated (``alias_bytes`` 0): the new train
  state is made while the old one lives.  The fit flag reads against an
  H100's 80 GB (``fits_80g_hbm``), not the v5e's 16 GB of the reference
  (``fits_16g_hbm``), as ``analytic.py``'s constants are an H100's;
* ``collectives_per_device_bytes`` from ``comm_analysis``;
* ``analytic`` and ``roofline``, from ``analytic.py``.

The reference's ``cost_analysis`` (XLA's FLOP and byte counts of the
compiled module) has no counterpart: nothing is compiled, and
``analytic`` is the work model both packages use.  The inputs follow
the reference's ``input_specs``, its ZeRO-1 / FSDP regime by size and
its micro-batching; the step is the port's (``training.train_loop``:
each rank runs its batch shard, tensor-, sequence- and expert-parallel
over ``model`` as ``models.sharding`` describes, its weights gathered
over the batch dims as it runs, its cache read as its shards, a
sequence split included), so these bytes are the port's, not the
reference's.

Run it in a process of its own: it makes the fake process group, which
must not meet a real one.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, InputShape,
                                 get_config, shape_applicable)
from repro_torch.launch import analytic
from repro_torch.launch.comm_analysis import StepRecorder
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, AdamWState
from repro_torch.training.train_loop import TrainState, make_train_step

DTYPE = torch.bfloat16
HBM_BYTES = 80e9            # an H100's


def input_specs(cfg: ModelConfig, shape: InputShape,
                ctx: sharding.ShardingCtx) -> Dict:
    """DTensor stand-ins for one case (call under a ``FakeTensorMode``:
    no allocation).  Returns the step's keyword arguments."""
    b, s = shape.global_batch, shape.seq_len
    tok_shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    tok_axes = (("batch", "seq", None) if cfg.num_codebooks
                else ("batch", "seq"))

    def sds(shp, dt, axes):
        return sharding.with_shardings(
            ctx, torch.empty(shp, dtype=dt, device="meta"), axes)

    if shape.kind == "train":
        params_abs = M.abstract(cfg, DTYPE)
        paxes = M.param_axes(cfg)
        # sharding regime by model size, as the reference's:
        #   < 8B : ZeRO-1 — weights replicated across data (TP only),
        #          optimizer moments sharded data x model.
        #   >= 8B: full FSDP (weights + moments 2D-sharded).
        full_fsdp = cfg.param_count() >= 8e9
        pctx = ctx if full_fsdp else sharding.ShardingCtx(
            ctx.mesh, tuple(ctx.rules.items()), fsdp=False)
        params = sharding.with_shardings(pctx, params_abs, paxes)
        # bf16 Adam moments at 200B-scale (math stays f32 in the update)
        opt_dtype = torch.bfloat16 if cfg.param_count() >= 5e10 \
            else torch.float32
        opt_abs = M.abstract(cfg, opt_dtype)
        mu = sharding.with_shardings(ctx, opt_abs, paxes)
        nu = sharding.with_shardings(ctx, opt_abs, paxes)
        state = TrainState(params, AdamWState(
            torch.zeros((), dtype=torch.int32), mu, nu))
        batch = {
            "tokens": sds(tok_shape, torch.int32, tok_axes),
            "labels": sds(tok_shape, torch.int32, tok_axes),
            "weights": sds((b, s), torch.float32, ("batch", "seq")),
        }
        return {"state": state, "batch": batch}

    params = sharding.with_shardings(ctx, M.abstract(cfg, DTYPE),
                                     M.param_axes(cfg))
    caches = sharding.with_shardings(
        ctx, M.abstract_cache(cfg, b, s, DTYPE), M.cache_axes(cfg, b, s))
    if shape.kind == "prefill":
        return {"params": params, "caches": caches,
                "tokens": sds(tok_shape, torch.int32, tok_axes)}
    # decode: ONE new token against a seq_len cache
    dec_tok = ((b, cfg.num_codebooks) if cfg.num_codebooks else (b,))
    dec_axes = (("batch", None) if cfg.num_codebooks else ("batch",))
    return {"params": params, "caches": caches,
            "tokens": sds(dec_tok, torch.int32, dec_axes),
            "positions": sds((b,), torch.int32, ("batch",))}


def step_fn(cfg: ModelConfig, shape: InputShape,
            ctx: sharding.ShardingCtx):
    """The case's step on the mesh: the sharded train step (remat, the
    reference's micro-batching by size), or prefill / one decode step
    run on each rank's batch shard."""
    if shape.kind == "train":
        n = cfg.param_count()
        accum = 1 if n < 1.2e9 else (4 if n < 12e9 else
                                     (8 if n < 50e9 else 16))
        return make_train_step(cfg, AdamWConfig(), remat=True,
                               grad_accum=accum, ctx=ctx)

    def local(tokens: DTensor):
        return sharding.use_sharding(ctx.local(tokens.placements,
                                               serve=True))

    if shape.kind == "prefill":
        def prefill_step(params, caches, tokens):
            with local(tokens):
                return M.prefill(params, cfg, sharding.batch_shard(tokens),
                                 caches, impl="train")
        return prefill_step

    def serve_step(params, caches, tokens, positions):
        with local(tokens):
            return M.decode_step(params, cfg, caches,
                                 sharding.batch_shard(tokens),
                                 sharding.batch_shard(positions))
    return serve_step


def _local_bytes(tree) -> int:
    total = 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


def _fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks (this one rank 0)."""
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def run_case(arch: str, shape_name: str, multi_pod: bool,
             mla_absorb: Optional[bool] = None) -> Dict:
    cfg = get_config(arch)
    if mla_absorb is not None and cfg.mla is not None:
        cfg = cfg.replace(mla_absorb=mla_absorb)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind in ("prefill", "decode"):
        # inference weight layout: no per-step FSDP weight gathers
        cfg = cfg.replace(inference_weight_layout=True)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    case = f"{arch}|{shape_name}|{mesh_name}"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"case": case, "status": "skipped", "reason": why}
    chips = 512 if multi_pod else 256
    _fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = (sharding.LONG_CONTEXT_RULES if shape_name == "long_500k"
             else sharding.DEFAULT_RULES)
    ctx = sharding.ShardingCtx(mesh, rules)
    rec = StepRecorder()
    t0 = time.time()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            kwargs = input_specs(cfg, shape, ctx)
            fn = step_fn(cfg, shape, ctx)
            rec.own(kwargs)
            with rec:
                out = fn(**kwargs)
            arg_bytes = _local_bytes(kwargs)
            out_bytes = _local_bytes(out)
        coll = rec.collective_report()
        est = analytic.estimate(cfg, shape.kind, shape.global_batch,
                                shape.seq_len)
        terms = analytic.roofline_terms(est, coll["total"], chips)
        per_dev = arg_bytes + rec.peak_bytes
        hist = rec.op_histogram()
        record = {
            "case": case, "status": "ok",
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "chips": chips,
            "seconds": round(time.time() - t0, 1),
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": rec.peak_bytes,
                "alias_bytes": 0,
                "per_device_bytes": per_dev,
                "fits_80g_hbm": bool(per_dev < HBM_BYTES),
            },
            "collectives_per_device_bytes": coll,
            "ops": {"total": sum(hist.values()),
                    "top": dict(list(hist.items())[:12])},
            "analytic": {
                "flops": est.flops, "hbm_bytes": est.hbm_bytes,
                "model_flops": est.model_flops,
            },
            "roofline": terms,
        }
        print(f"[OK] {case}: {record['seconds']}s, "
              f"{per_dev / 1e9:.2f} GB/dev, "
              f"dominant={terms['dominant']}, "
              f"coll={coll['total'] / 1e6:.1f} MB/dev "
              + json.dumps({k: v for k, v in coll.items() if v}))
        return record
    except Exception as e:
        traceback.print_exc()
        return {"case": case, "status": "error",
                "error": f"{type(e).__name__}: {e}"[:2000],
                "op": rec.last_op,
                "seconds": round(time.time() - t0, 1)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (10 assigned)")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(INPUT_SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="pod",
                    choices=("pod", "multipod", "both"))
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--mla-absorb", action="store_true",
                    help="use the absorbed MLA decode path")
    ap.add_argument("--case", action="append", default=[],
                    help="arch:shape:pod|multipod, repeatable; replaces "
                    "the --arch x --shape x --mesh product")
    args = ap.parse_args(argv)
    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else \
        args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else \
        args.shape.split(",")
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    cases = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    if args.case:
        cases = [(a, s, m == "multipod")
                 for a, s, m in (c.split(":") for c in args.case)]
    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_err = 0
    for arch, shape, mp in cases:
        rec = run_case(arch, shape, mp,
                       mla_absorb=args.mla_absorb or None)
        tag = rec["case"].replace("|", "_")
        if args.mla_absorb:
            tag += "_absorb"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        n_ok += rec["status"] == "ok"
        n_skip += rec["status"] == "skipped"
        n_err += rec["status"] == "error"
        if rec["status"] == "skipped":
            print(f"[SKIP] {rec['case']}: {rec['reason']}")
        elif rec["status"] == "error":
            print(f"[ERR] {rec['case']}: {rec['error'][:300]} "
                  f"(op {rec['op']})")
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped "
          f"(documented), {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
