"""Carry weights and KV pages over from the JAX package, as numpy arrays.

``repro`` draws its parameters with ``jax.random`` and the port with
``torch.Generator``s, so the two never agree from a seed.  To compute
the same thing in both packages, a caller hands the JAX param tree
(``repro.models.model.init``: ``embedding``, the stacked ``run_0``
leaves, ``final_norm``, an optional ``lm_head``) and any K/V pool to
these functions as numpy arrays.  The layouts are the same in both
packages, so each leaf is checked against the port's spec tree and
copied as it is.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
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


def pool_from_numpy(k: Any, v: Any, dtype=None, device=None) -> PagePool:
    """A numpy ``(L, P, page, Hkv, D)`` K/V pool -> the port's pool
    (same layout), on ``device`` (the card unless one is named)."""
    device = resolve_device(device)
    return PagePool(to_tensor(k, dtype, device), to_tensor(v, dtype, device))
