"""Decoder-only model over run-grouped layers, the PyTorch counterpart of
``repro/models/model.py`` for every layer type (see ``blocks``), codebook
streams included.

The parameter tree keeps ``repro``'s layout — ``embedding`` ((V, d), or
(K, V, d) for K codebooks), one stacked ``run_<i>`` per run of identical
layers in ``cfg.layer_runs`` whose leaves carry a leading layer dim,
``final_norm`` and, for untied heads, ``lm_head`` ((d, V) or (d, K, V))
— so the bridge maps it leaf for leaf.  Where the JAX package runs a
``lax.scan`` over each run, ``forward`` loops over the layers in Python.
Caches are a list with one dict per run, each leaf stacked over the
run's layers; ``forward`` writes them in place and returns the same
list.

Entry points:
  * ``loss_fn``      training: full causal pass, chunked cross-entropy
                     and the MoE aux losses, differentiable
  * ``prefill``      full causal pass over a prompt, fills the caches
  * ``decode_step``  one token per row against the caches
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers, moe
from repro_torch.models import config as C
from repro_torch.models.params import (Spec, init_params,
                                       map_specs_with_path, stack_specs)


# ===================================================================== specs
def model_specs(cfg: C.ModelConfig) -> dict:
    d, v, nc = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    specs: Dict[str, Any] = {}
    if nc:
        specs["embedding"] = Spec((nc, v, d), (None, "vocab", None), "embed")
    else:
        specs["embedding"] = Spec((v, d), ("vocab", "embed"), "embed")
    for i, (ltype, n) in enumerate(cfg.layer_runs):
        specs[f"run_{i}"] = stack_specs(blocks.layer_specs(cfg, ltype), n,
                                        "layers")
    specs["final_norm"] = layers.norm_spec(d)
    if not cfg.tie_embeddings:
        if nc:
            specs["lm_head"] = Spec((d, nc, v), ("embed", None, "vocab"),
                                    "scaled", 0)
        else:
            specs["lm_head"] = Spec((d, v), ("embed", "vocab"), "scaled", 0)
    return specs


def init(cfg: C.ModelConfig, seed: int = 0, dtype=torch.float32,
         device=None):
    """Random weights from ``seed`` on ``device`` (the card unless one is
    named)."""
    return init_params(model_specs(cfg), seed, dtype, device)


def count_params(cfg: C.ModelConfig, active_only: bool = False) -> int:
    """Total (or MoE-active: expert banks scaled by top_k / num_experts)
    parameter count, from the spec tree."""
    total = 0

    def visit(path: str, s: Spec):
        nonlocal total
        n = math.prod(s.shape)
        if active_only and cfg.moe is not None and "/experts/" in path:
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n

    map_specs_with_path(visit, model_specs(cfg))
    return total


# ===================================================================== cache
def cache_struct(cfg: C.ModelConfig, batch: int, cache_len: int):
    """[(run cache shapes dict) ...] — name -> ((n, *shape), (axes))."""
    out = []
    for ltype, n in cfg.layer_runs:
        shapes = blocks.cache_shape(cfg, ltype, batch, cache_len)
        out.append({name: ((n,) + shape, ("layers",) + axes)
                    for name, (shape, axes) in shapes.items()})
    return out


def init_cache(cfg: C.ModelConfig, batch: int, cache_len: int,
               dtype=torch.float32, device=None) -> List[dict]:
    """Stacked caches for every run on ``device`` (the card unless one is
    named): K/V, latents and conv buffers in ``dtype``, the recurrent
    states (``blocks.STATE_FIELDS``) in float32, as in the JAX package."""
    device = resolve_device(device)
    return [blocks.alloc_cache(run, dtype, device)
            for run in cache_struct(cfg, batch, cache_len)]


# ===================================================================== embed
def embed(params, cfg: C.ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S), or (B, S, K) for codebooks, whose K embeddings are
    summed (MusicGen)."""
    emb = params["embedding"]
    tokens = tokens.long()
    if cfg.num_codebooks:
        x = emb[0][tokens[..., 0]]
        for k in range(1, cfg.num_codebooks):
            x = x + emb[k][tokens[..., k]]
        return x
    return emb[tokens]


def unembed(params, cfg: C.ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> logits (B, S, V), or (B, S, K, V) for codebooks."""
    nc = cfg.num_codebooks
    if cfg.tie_embeddings:
        emb = params["embedding"]
        if nc:
            return (x @ emb.reshape(-1, emb.shape[-1]).T).unflatten(
                -1, (nc, cfg.vocab_size))
        return x @ emb.T
    head = params["lm_head"]
    if nc:
        return (x @ head.reshape(head.shape[0], -1)).unflatten(
            -1, (nc, cfg.vocab_size))
    return x @ head


# ===================================================================== forward
def layer_view(tree, i: int):
    """Layer ``i``'s view of a stacked run tree."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def _trunk(params, cfg: C.ModelConfig, tokens: torch.Tensor,
           positions: Optional[torch.Tensor], caches: Optional[List[dict]],
           mode: str, impl: str, remat: bool = False):
    """The embedding, every layer and the final norm.  Returns (hidden,
    the MoE layers' routings).  ``remat`` runs each layer under
    ``torch.utils.checkpoint`` (recomputed in the backward), as the
    reference wraps its scan body in ``jax.checkpoint``."""
    if mode == "full":
        b, s = tokens.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = embed(params, cfg, tokens)
    else:
        x = embed(params, cfg, tokens[:, None] if tokens.dim() == 1
                  else tokens[:, None, :])
    routings = []
    for i, (ltype, n) in enumerate(cfg.layer_runs):
        run_p = params[f"run_{i}"]
        run_c = caches[i] if caches is not None else None
        for j in range(n):
            c_l = layer_view(run_c, j) if run_c is not None else None
            layer = functools.partial(
                blocks.apply_layer, layer_view(run_p, j), cfg, ltype,
                positions=positions, cache=c_l, mode=mode, impl=impl)
            x, _, r = (checkpoint(layer, x, use_reentrant=False) if remat
                       else layer(x))
            if r is not None:
                routings.append(r)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), routings


def forward(params, cfg: C.ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[List[dict]] = None, mode: str = "full",
            impl: str = "kernel", remat: bool = False):
    """Returns (hidden (B, S, d), caches, aux): aux sums each MoE
    auxiliary loss over the layers, one 0-d tensor a key (empty without
    MoE layers).  ``prefill`` and ``decode_step`` skip the aux.

    mode="full": tokens (B, S) (or (B, S, K)), positions default to
    0..S-1.  mode="decode": tokens (B,) (or (B, K)), positions (B,).
    ``impl`` routes the full-mode attention (``blocks.apply_layer``):
    "kernel" or "ref" for serving, "train" for a differentiable pass.
    ``remat`` recomputes each layer in the backward instead of keeping
    its activations."""
    x, routings = _trunk(params, cfg, tokens, positions, caches, mode, impl,
                         remat)
    aux_total: Dict[str, torch.Tensor] = {}
    for r in routings:
        for k, v in moe.aux_losses(r, cfg.moe).items():
            aux_total[k] = aux_total[k] + v if k in aux_total else v
    return x, caches, aux_total


# ===================================================================== steps
def _nll_chunk(params, cfg: C.ModelConfig, x_chunk: torch.Tensor,
               labels_chunk: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over one sequence chunk, from float32 logits (B,
    chunk, V), averaged over the codebooks where there are several."""
    logits = unembed(params, cfg, x_chunk).float()
    labels = labels_chunk.long()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1), reduction="none")
    nll = nll.reshape(labels.shape)
    if cfg.num_codebooks:
        nll = nll.mean(-1)
    return nll


def loss_fn(params, cfg: C.ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True, ce_chunk: int = 512):
    """batch: tokens, labels, weights.  Returns (loss + the MoE aux
    losses, metrics {"nll": loss, **aux}), differentiable in ``params``.

    The attention is the trainer's plain one (``impl="train"``).  Where
    the sequence splits into more than one whole ``ce_chunk``, the
    cross-entropy runs chunk by chunk, each under
    ``torch.utils.checkpoint``, so the float32 logits of only one
    (B, chunk, V) block live at a time, forward and backward."""
    x, _, aux = forward(params, cfg, batch["tokens"], mode="full",
                        impl="train", remat=remat)
    labels = batch["labels"]
    s = x.shape[1]
    ck = min(ce_chunk, s)
    if s % ck == 0 and s > ck:
        chunk = functools.partial(_nll_chunk, params, cfg)
        nll = torch.cat([checkpoint(chunk, x[:, i:i + ck],
                                    labels[:, i:i + ck], use_reentrant=False)
                         for i in range(0, s, ck)], dim=1)
    else:
        nll = _nll_chunk(params, cfg, x, labels)
    w = batch["weights"].float()
    loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    metrics = {"nll": loss, **aux}
    total = loss + sum(aux.values(), torch.zeros((), device=loss.device))
    return total, metrics


def prefill(params, cfg: C.ModelConfig, tokens: torch.Tensor,
            caches: List[dict], impl: str = "kernel"):
    """Full prefill; returns (last-token logits (B, ...), caches)."""
    x, _ = _trunk(params, cfg, tokens, None, caches, "full", impl)
    return unembed(params, cfg, x[:, -1:])[:, 0], caches


def decode_step(params, cfg: C.ModelConfig, caches: List[dict],
                tokens: torch.Tensor, positions: torch.Tensor):
    """One decode step.  tokens: (B,) or (B, K); positions: (B,)."""
    x, _ = _trunk(params, cfg, tokens, positions, caches, "decode",
                  "kernel")
    return unembed(params, cfg, x)[:, 0], caches
