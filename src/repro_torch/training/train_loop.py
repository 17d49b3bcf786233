"""The training step and loop, the PyTorch counterpart of
``repro/training/train_loop.py``.

``value_and_grad`` (and so ``make_train_step``) takes the gradients
with ``torch.autograd.grad`` over the parameter leaves, the counterpart
of ``jax.value_and_grad``: nothing is accumulated into ``.grad`` and
the state's tensors never require grad, so a step is a function from
(state, batch) to a new state, as in the reference.

On a mesh (``make_train_step(..., ctx=ShardingCtx)``) the parameters
and AdamW moments are DTensors with ``placements_for`` their axes and
the batch is a DTensor split along its rows.  Each rank runs the model
on its shard of the batch under the context's ``local`` view: a layer's
weights are all-gathered as it runs (again in the backward, under
remat) and its gradients come back summed over the batch shards and
re-sharded, FSDP-style; the loss is each shard's share of the whole
batch's, and the optimizer updates each rank's shards.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_state(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
               device=None) -> TrainState:
    """Random weights from ``seed`` and a fresh AdamW state, on
    ``device`` (the card unless one is named)."""
    params = M.init(cfg, seed, dtype, device)
    return TrainState(params, adamw_init(params))


def value_and_grad(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   remat: bool = True):
    """``jax.value_and_grad(loss_fn, has_aux=True)``'s counterpart:
    (loss, metrics, grads), every result detached, grads a tree shaped
    like ``params`` (zeros for a leaf the loss does not reach)."""
    flat = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    tree = tree_unflatten(params, {p: t for (p, _), t in zip(flat, leaves)})
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {p: torch.zeros_like(t) if g is None else g
             for (p, t), g in zip(flat, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    remat: bool = True, grad_accum: int = 1,
                    ctx: Optional[sharding.ShardingCtx] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``grad_accum`` > 1 splits the batch into that many micro-batches
    along its first dim and sums their float32 gradients (and losses)
    before dividing, so activation memory scales 1/grad_accum at
    unchanged math; the metrics then hold the mean loss as "nll", as the
    reference's do.

    With ``ctx`` the step runs on its mesh: state and batch are DTensors
    (see the module's docstring) and the metrics are whole-batch values
    on every rank.  Micro-batches then split each rank's shard."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if grad_accum <= 1:
            loss, metrics, grads = value_and_grad(state.params, cfg, batch,
                                                  remat)
        else:
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            loss = torch.zeros((), device=batch["weights"].device)
            for i in range(grad_accum):
                loss_i, _m, g = value_and_grad(
                    state.params, cfg, {k: v[i] for k, v in micro.items()},
                    remat)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + loss_i
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
            metrics = {"nll": loss}
        if ctx is None:
            new_params, new_opt, opt_metrics = adamw_update(
                opt_cfg, grads, state.opt, state.params)
        else:
            # plain 0-d tensors (the step count, lr) act as replicated
            with implicit_replication():
                new_params, new_opt, opt_metrics = adamw_update(
                    opt_cfg, grads, state.opt, state.params)
        metrics = {"loss": loss, **metrics, **opt_metrics}
        return TrainState(new_params, new_opt), metrics

    if ctx is None:
        return step

    def sharded_step(state: TrainState, batch: Dict[str, DTensor]):
        local = {k: sharding.batch_shard(v) for k, v in batch.items()}
        with sharding.use_sharding(ctx.local(batch["tokens"].placements)):
            new_state, metrics = step(state, local)
            shares = {k: sharding.batch_sum(v) for k, v in metrics.items()
                      if k not in ("grad_norm", "lr")}
        gnorm = metrics["grad_norm"]
        return new_state, {**metrics, **shares, "grad_norm": (
            gnorm.full_tensor() if isinstance(gnorm, DTensor) else gnorm)}

    return sharded_step


def train_loop(cfg: ModelConfig, opt_cfg: AdamWConfig, data_iter,
               num_steps: int, seed: int = 0, log_every: int = 10,
               dtype=torch.float32, checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, device=None):
    """Simple single-device loop from random weights (``seed``) on
    ``device`` (the card unless one is named); returns (state, history),
    a row of float metrics with "step" and "elapsed_s" every
    ``log_every`` steps and at the last, and saves the state every
    ``checkpoint_every`` steps into ``checkpoint_dir``."""
    from repro_torch.training import checkpoint as ckpt
    state = init_state(cfg, seed, dtype, device)
    step_fn = make_train_step(cfg, opt_cfg)
    history = []
    t0 = time.time()
    for step in range(num_steps):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        if step % log_every == 0 or step == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["elapsed_s"] = time.time() - t0
            history.append(m)
        if checkpoint_dir and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, step + 1, state)
    return state, history
