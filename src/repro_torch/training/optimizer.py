"""AdamW and its cosine LR schedule, the PyTorch counterpart of
``repro/training/optimizer.py``.

The API stays functional, as the reference's: parameters, gradients and
the moments are trees (nested dicts) of tensors, and ``adamw_update``
returns new trees instead of stepping a ``torch.optim`` optimizer in
place.  The math runs in float32 whatever the parameters' dtype; the
moments keep the dtype they are carried in (float32 from
``adamw_init``); ``b1 ** step`` is a float32 power, as jax computes it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the parameters' device
    mu: Any
    nu: Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac *
    lr`` at ``total_steps``; float32, in the reference's order of
    operations."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> AdamWState:
    """Step 0 and float32 zero moments shaped like ``params``."""
    leaf = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaf.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf."""
    return torch.sqrt(sum(g.float().square().sum()
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params
                 ) -> tuple:
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}):
    gradients clipped to ``grad_clip`` by their global norm, bias-
    corrected moments, decoupled weight decay."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)

    def upd(g, m, v, p):
        g = g.float() * scale
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * g
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
        update = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        update = update + cfg.weight_decay * p.float()
        return ((p.float() - lr * update).to(p.dtype), mf.to(m.dtype),
                vf.to(v.dtype))

    new = {p: upd(g, m, v, x) for (p, x), g, m, v in zip(
        tree_flatten(params), tree_leaves(grads), tree_leaves(state.mu),
        tree_leaves(state.nu))}
    pick = lambda i: tree_unflatten(  # noqa: E731
        params, {p: t[i] for p, t in new.items()})
    metrics: Dict[str, torch.Tensor] = {"grad_norm": gnorm, "lr": lr}
    return pick(0), AdamWState(step, pick(1), pick(2)), metrics
