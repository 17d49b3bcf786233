"""Decoder parameters, embedding and head: the part of
``repro/models/model.py`` that the paged serving path uses.

The parameter tree keeps ``repro``'s layout — ``embedding``, one
stacked ``run_0`` whose leaves carry a leading layer dim,
``final_norm`` and, for untied heads, ``lm_head`` — so the bridge maps
it leaf for leaf.  Only the DENSE layer type is ported so far.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import config as C
from repro_torch.models import layers
from repro_torch.models.params import (Spec, init_params, map_specs,
                                       stack_specs)


def layer_specs(cfg: C.ModelConfig, ltype: str) -> dict:
    if ltype != C.DENSE:
        raise NotImplementedError(
            f"{cfg.name}: layer type {ltype!r} is not ported yet")
    d = cfg.d_model
    return {"ln1": layers.norm_spec(d), "attn": layers.attn_specs(cfg),
            "ln2": layers.norm_spec(d), "mlp": layers.mlp_specs(d, cfg.d_ff)}


def model_specs(cfg: C.ModelConfig) -> dict:
    if cfg.num_codebooks:
        raise NotImplementedError(f"{cfg.name}: codebook models are not "
                                  "ported yet")
    d, v = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {"embedding": Spec((v, d), ("vocab", "embed"),
                                               "embed")}
    for i, (ltype, n) in enumerate(cfg.layer_runs):
        specs[f"run_{i}"] = stack_specs(layer_specs(cfg, ltype), n, "layers")
    specs["final_norm"] = layers.norm_spec(d)
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, v), ("embed", "vocab"), "scaled", 0)
    return specs


def init(cfg: C.ModelConfig, seed: int = 0, dtype=torch.float32,
         device=None):
    """Random weights from ``seed`` on ``device`` (the card unless one is
    named)."""
    return init_params(model_specs(cfg), seed, dtype, device)


def count_params(cfg: C.ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the spec tree (dense: active == total)."""
    total = 0

    def add(s: Spec):
        nonlocal total
        total += math.prod(s.shape)

    map_specs(add, model_specs(cfg))
    return total


def embed(params, cfg: C.ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens.long()]


def unembed(params, cfg: C.ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embedding"].T
    return x @ params["lm_head"]
