"""Training launcher on the port: ``python -m repro_torch.launch.train
--arch qwen3-0.6b``, the counterpart of ``repro/launch/train.py`` with
the same flags, schedule and printed rows.

It trains the full config of ``--arch`` from random weights (seed 0),
float32, with per-layer rematerialization, on the reference's
production mesh (``--multi-pod``: 2x16x16, else 16x16) with the
default sharding rules; ``--debug`` trains the reduced config without
remat on a 1x1 mesh, as the reference's does.  The mesh needs a process
group of its size: the launcher joins the one ``torchrun``'s
environment names (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), uses one the caller made, or else makes a one-rank
group, and fails naming the world size a mesh needs when the group is
smaller.  ``--torch-device`` names the device, the card by default
(``--torch-device cpu`` trains on the CPU over gloo); rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data import synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import TrainState, make_train_step


def _join_group(device: torch.device) -> bool:
    """Make the process group if there is none; True if this call made
    it (and so must destroy it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def _batch_axes(cfg, name: str) -> tuple:
    if name == "weights" or not cfg.num_codebooks:
        return ("batch", "seq")
    return ("batch", "seq", None)


def main(argv=None) -> List[dict]:
    """Train ``--steps`` steps; print a row of metrics every 10 steps
    and at the last, and return the rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--debug", action="store_true",
                    help="reduced config on a 1x1 mesh, no remat")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--log-json", default="")
    ap.add_argument("--torch-device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.torch_device)
    made = _join_group(device)
    try:
        try:
            mesh = make_debug_mesh() if args.debug \
                else make_production_mesh(multi_pod=args.multi_pod)
        except RuntimeError as e:
            ap.error(str(e))
        return _train(args, device, sharding.ShardingCtx(
            mesh, sharding.DEFAULT_RULES))
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, device, ctx: sharding.ShardingCtx) -> List[dict]:
    cfg = get_reduced_config(args.arch) if args.debug \
        else get_config(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    data = synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq,
                                num_codebooks=cfg.num_codebooks,
                                device=device)
    params = sharding.distribute(ctx, M.init(cfg, 0, device=device),
                                 M.param_axes(cfg))
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, opt_cfg, remat=not args.debug, ctx=ctx)
    history = []
    for i in range(args.steps):
        batch = next(data)
        batch = sharding.distribute(
            ctx, batch, {k: _batch_axes(cfg, k) for k in batch})
        state, metrics = step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            row = {"step": i, **{k: float(v) for k, v in metrics.items()}}
            history.append(row)
            if dist.get_rank() == 0:
                print(row)
    if args.log_json and dist.get_rank() == 0:
        with open(args.log_json, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
