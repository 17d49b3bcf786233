"""Minimal parameter-spec system, the PyTorch counterpart of
``repro/models/params.py``.

Modules describe their parameters once as a nested dict of ``Spec``s
(shape + logical axes + init style); ``init_params`` materializes a
tree of tensors from it.  Every leaf draws from its own
``torch.Generator`` seeded from the model seed and the leaf's path, so
a parameter does not depend on which other leaves exist.  The numbers
differ from ``jax.random``'s: tests that need both packages on the same
weights carry them over with ``repro_torch.bridge``.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones | embed | scaled
    scale_dim: int = -1               # fan-in dim index for "scaled"


SpecTree = Dict[str, Any]   # nested dict of Spec


def map_specs(fn, tree: SpecTree):
    """Map ``fn`` over every Spec leaf, preserving dict structure."""
    if isinstance(tree, Spec):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def map_specs_with_path(fn, tree: SpecTree, path: str = ""):
    if isinstance(tree, Spec):
        return fn(path, tree)
    return {k: map_specs_with_path(fn, v, f"{path}/{k}")
            for k, v in tree.items()}


def _path_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def init_params(specs: SpecTree, seed: int, dtype=torch.float32,
                device=None):
    """Materialize parameters for a spec tree (deterministic in seed and
    path).  Draws happen in float32 on ``device`` (the card unless one is
    named) and are then cast."""
    device = resolve_device(device)

    def init_one(path: str, s: Spec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(_path_seed(seed, path))
        x = torch.empty(s.shape, dtype=torch.float32, device=device)
        if s.init == "embed":
            return (x.normal_(generator=gen) * 0.02).to(dtype)
        # normal / scaled: truncated-normal with 1/sqrt(fan_in) scaling
        fan_in = s.shape[s.scale_dim] if s.init == "scaled" else (
            s.shape[0] if len(s.shape) > 1 else s.shape[-1])
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (x * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)

    return map_specs_with_path(init_one, specs)


def param_count(specs: SpecTree) -> int:
    total = 0

    def add(s: Spec):
        nonlocal total
        total += math.prod(s.shape)

    map_specs(add, specs)
    return total


def stack_specs(specs: SpecTree, n: int,
                axis_name: Optional[str] = None) -> SpecTree:
    """Stack a per-layer spec tree ``n`` times along a new leading
    'layers' dim (the layout of ``repro``'s scanned layer runs, kept so
    that parameters carry over between the packages leaf for leaf)."""
    return map_specs(
        lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                       s.scale_dim if s.scale_dim < 0 else s.scale_dim + 1),
        specs)
