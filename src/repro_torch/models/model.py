"""Decoder-only model over run-grouped layers, the PyTorch counterpart of
``repro/models/model.py`` for the layer types ported so far (DENSE and
SWA, see ``blocks``), codebook streams included.

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
  * ``prefill``      full causal pass over a prompt, fills the caches
  * ``decode_step``  one token per row against the caches
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models import config as C
from repro_torch.models.params import (Spec, init_params, map_specs,
                                       stack_specs)


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
    """Parameter count from the spec tree (no MoE is ported, so active ==
    total)."""
    total = 0

    def add(s: Spec):
        nonlocal total
        total += math.prod(s.shape)

    map_specs(add, model_specs(cfg))
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
    named)."""
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


def forward(params, cfg: C.ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[List[dict]] = None, mode: str = "full",
            impl: str = "kernel"):
    """Returns (hidden (B, S, d), caches).

    mode="full": tokens (B, S) (or (B, S, K)), positions default to
    0..S-1.  mode="decode": tokens (B,) (or (B, K)), positions (B,).
    ``impl`` picks the kernel or the plain version of the full-mode
    attention."""
    if mode == "full":
        b, s = tokens.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = embed(params, cfg, tokens)
    else:
        x = embed(params, cfg, tokens[:, None] if tokens.dim() == 1
                  else tokens[:, None, :])
    for i, (ltype, n) in enumerate(cfg.layer_runs):
        run_p = params[f"run_{i}"]
        run_c = caches[i] if caches is not None else None
        for j in range(n):
            c_l = layer_view(run_c, j) if run_c is not None else None
            x, _ = blocks.apply_layer(layer_view(run_p, j), cfg, ltype, x,
                                      positions, c_l, mode, impl=impl)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, caches


# ===================================================================== steps
def prefill(params, cfg: C.ModelConfig, tokens: torch.Tensor,
            caches: List[dict], impl: str = "kernel"):
    """Full prefill; returns (last-token logits (B, ...), caches)."""
    x, caches = forward(params, cfg, tokens, caches=caches, mode="full",
                        impl=impl)
    return unembed(params, cfg, x[:, -1:])[:, 0], caches


def decode_step(params, cfg: C.ModelConfig, caches: List[dict],
                tokens: torch.Tensor, positions: torch.Tensor):
    """One decode step.  tokens: (B,) or (B, K); positions: (B,)."""
    x, caches = forward(params, cfg, tokens, positions=positions,
                        caches=caches, mode="decode")
    return unembed(params, cfg, x)[:, 0], caches
