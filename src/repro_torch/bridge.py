"""Carry weights, adapters, KV pages and slot caches over from the JAX
package, as numpy arrays.

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
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec


def to_tensor(a: Any, dtype=None, device=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor on ``device`` (the card unless
    one is named); numpy bfloat16 (ml_dtypes) arrays are reinterpreted
    bit for bit."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
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
    named).  K/V and MLA latents take ``dtype`` if given; ring positions
    stay int32.
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
            t = to_tensor(run[name], torch.int32 if name == "pos" else dtype,
                          device)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"run {i}/{name}: shape {tuple(t.shape)}, "
                                 f"expected {shape}")
            conv[name] = t
        out.append(conv)
    return out
