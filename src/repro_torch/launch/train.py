"""Training launcher on the port: ``python -m repro_torch.launch.train
--arch qwen3-0.6b``, the counterpart of ``repro/launch/train.py`` with
the same flags, schedule and printed rows.

It trains the full config of ``--arch`` from random weights (seed 0) on
one card, float32, with per-layer rematerialization.  ``--debug`` trains
the reduced config without remat, as the reference's does.
``--torch-device`` names the device, the card by default (``--torch-device
cpu`` trains on the CPU).  The reference shards the step over a
production mesh; the port runs on one device, and ``--multi-pod`` is
refused until sharding is ported (ROADMAP C3).
"""
from __future__ import annotations

import argparse
import json
from typing import List

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data import synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import TrainState, make_train_step


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
                    help="reduced config, no remat")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--log-json", default="")
    ap.add_argument("--torch-device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error("--multi-pod needs a sharded train step, which the port "
                 "does not have yet (ROADMAP C3); it trains on one device")

    device = resolve_device(args.torch_device)
    cfg = get_reduced_config(args.arch) if args.debug \
        else get_config(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    data = synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq,
                                num_codebooks=cfg.num_codebooks,
                                device=device)
    params = M.init(cfg, 0, device=device)
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, opt_cfg, remat=not args.debug)
    history = []
    for i in range(args.steps):
        state, metrics = step(state, next(data))
        if i % 10 == 0 or i == args.steps - 1:
            row = {"step": i, **{k: float(v) for k, v in metrics.items()}}
            history.append(row)
            print(row)
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
