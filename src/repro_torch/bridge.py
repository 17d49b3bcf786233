"""Carry weights, adapters, KV pages, slot caches and training states over
from the JAX package, as numpy arrays, and training states back.

``repro`` draws its parameters with ``jax.random`` and the port with
``torch.Generator``s, so the two never agree from a seed.  To compute
the same thing in both packages, a caller hands the JAX param tree
(``repro.models.model.init``: ``embedding``, one stacked ``run_<i>``
per layer run, ``final_norm``, an optional ``lm_head``), any K/V pool
and any slot caches (``repro.models.model.init_cache``) to these
functions as numpy arrays.  The layouts are the same in both
packages, so each leaf is checked against the port's spec tree and
copied as it is.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine import paged_model as PM
from repro_torch.engine.paged_model import PagePool
from repro_torch.models import model as M
from repro_torch.models.blocks import STATE_FIELDS
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec
from repro_torch.payload import from_payload, to_payload
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_loop import TrainState
from repro_torch.tree import tree_map


def to_tensor(a: Any, dtype=None, device=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor on ``device`` (the card unless
    one is named), a copy; bfloat16 payloads are reinterpreted bit for
    bit."""
    device = resolve_device(device)
    t = from_payload(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Mapping, cfg: ModelConfig, dtype=None,
                      device=None) -> dict:
    """The JAX package's param tree (leaves as numpy arrays) -> the
    port's, on ``device`` (the card unless one is named).  Raises on a
    missing or extra leaf or a shape mismatch."""
    device = resolve_device(device)

    def convert(spec, sub, path):
        if isinstance(spec, Spec):
            t = to_tensor(sub, dtype, device)
            if tuple(t.shape) != tuple(spec.shape):
                raise ValueError(f"{path}: shape {tuple(t.shape)}, "
                                 f"expected {spec.shape}")
            return t
        if not isinstance(sub, Mapping) or set(sub) != set(spec):
            got = sorted(sub) if isinstance(sub, Mapping) else type(sub)
            raise ValueError(f"{path or '/'}: keys {got}, expected "
                             f"{sorted(spec)}")
        return {k: convert(spec[k], sub[k], f"{path}/{k}") for k in spec}

    return convert(M.model_specs(cfg), tree, "")


def adapter_from_numpy(weights: Mapping, cfg: ModelConfig, rank: int,
                       dtype=None, device=None) -> dict:
    """One adapter's weights from the JAX package (``A_q``, ``B_q``,
    ``A_v``, ``B_v`` as numpy arrays, the layout of
    ``repro.engine.paged_model.make_adapter``) -> tensors on ``device``
    (the card unless one is named), for ``register_adapter(name,
    weights=...)``.  Raises on a missing or extra leaf or a shape
    mismatch."""
    device = resolve_device(device)
    specs = PM.lora_specs(cfg, 1, rank)
    if set(weights) != set(specs):
        raise ValueError(f"adapter keys {sorted(weights)}, expected "
                         f"{sorted(specs)}")
    out = {}
    for k, spec in specs.items():
        t = to_tensor(weights[k], dtype, device)
        if tuple(t.shape) != spec.shape[1:]:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, expected "
                             f"{spec.shape[1:]}")
        out[k] = t
    return out


def pool_from_numpy(k: Any, v: Any, dtype=None, device=None) -> PagePool:
    """A numpy ``(L, P, page, Hkv, D)`` K/V pool -> the port's pool
    (same layout), on ``device`` (the card unless one is named)."""
    device = resolve_device(device)
    return PagePool(to_tensor(k, dtype, device), to_tensor(v, dtype, device))


def caches_from_numpy(caches: Sequence[Mapping], cfg: ModelConfig,
                      batch: int, cache_len: int, dtype=None,
                      device=None) -> List[dict]:
    """The JAX package's slot caches (one dict per layer run, leaves as
    numpy arrays) -> the port's, on ``device`` (the card unless one is
    named).  K/V, MLA latents and conv buffers take ``dtype`` if given;
    ring positions stay int32 and the recurrent states (Mamba's ``h``,
    mLSTM's ``C``/``n``/``m``, sLSTM's ``c``/``n``/``m``/``h``) float32,
    as ``models.model.init_cache`` holds them.
    Raises on a missing or extra run or field, or a shape mismatch with
    ``models.model.cache_struct(cfg, batch, cache_len)``."""
    device = resolve_device(device)
    struct = M.cache_struct(cfg, batch, cache_len)
    if len(caches) != len(struct):
        raise ValueError(f"{len(caches)} cache runs, expected "
                         f"{len(struct)}")
    out = []
    for i, (run, want) in enumerate(zip(caches, struct)):
        if set(run) != set(want):
            raise ValueError(f"run {i}: fields {sorted(run)}, expected "
                             f"{sorted(want)}")
        conv = {}
        for name, (shape, _axes) in want.items():
            want_dtype = (torch.int32 if name == "pos" else torch.float32
                          if name in STATE_FIELDS else dtype)
            t = to_tensor(run[name], want_dtype, device)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"run {i}/{name}: shape {tuple(t.shape)}, "
                                 f"expected {shape}")
            conv[name] = t
        out.append(conv)
    return out


def train_state_from_numpy(state: Any, cfg: ModelConfig, dtype=None,
                           device=None) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``params``, and ``opt``
    with ``step``, ``mu`` and ``nu``) -> the port's, on ``device`` (the
    card unless one is named).  The params take ``dtype`` if given; the
    moments keep theirs and the step stays int32."""
    device = resolve_device(device)
    opt = state.opt
    return TrainState(
        params_from_numpy(state.params, cfg, dtype, device),
        AdamWState(to_tensor(opt.step, torch.int32, device),
                   params_from_numpy(opt.mu, cfg, None, device),
                   params_from_numpy(opt.nu, cfg, None, device)))


def tree_to_numpy(tree: Any) -> Any:
    """A tree of tensors (dicts and NamedTuples, a ``TrainState`` among
    them) -> the same tree of numpy arrays on the host; bfloat16 leaves
    as ``ml_dtypes.bfloat16`` where that imports, which ``jnp.asarray``
    takes as they are."""
    return tree_map(to_payload, tree)
