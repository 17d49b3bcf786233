"""Minimal parameter-spec system, the PyTorch counterpart of
``repro/models/params.py``.

Modules describe their parameters once as a nested dict of ``Spec``s
(shape + logical axes + init style).  From one spec tree we derive:

  * concrete parameters  (``init_params``: the reference's draws, bit
                          for bit, from ``repro_torch.random``)
  * abstract parameters  (``abstract_params``: meta tensors, no
                          allocation; the dry-run's stand-ins)
  * logical-axis tree    (``axes_tree``, which ``models.sharding`` maps
                          onto a device mesh)
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import random as R
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


def _path_key(key: torch.Tensor, path: str) -> torch.Tensor:
    """The reference's per-leaf key: ``fold_in`` of the first 4 bytes of
    sha256(path), little-endian."""
    digest = hashlib.sha256(path.encode()).digest()
    return R.fold_in(key, int.from_bytes(digest[:4], "little"))


def init_params(specs: SpecTree, seed: int, dtype=torch.float32,
                device=None):
    """Materialize parameters for a spec tree (deterministic in seed and
    path): the weights ``repro.models.params.init_params`` draws from
    ``jax.random.PRNGKey(seed)``, bit for bit.  Draws happen in float32
    on ``device`` (the card unless one is named), leaf by leaf and in
    chunks, and are then cast."""
    device = resolve_device(device)
    key = R.prng_key(seed, device)

    def init_one(path: str, s: Spec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        k = _path_key(key, path)
        if s.init == "embed":
            return (R.normal(k, s.shape) * 0.02).to(dtype)
        # normal / scaled: truncated-normal with 1/sqrt(fan_in) scaling
        fan_in = s.shape[s.scale_dim] if s.init == "scaled" else (
            s.shape[0] if len(s.shape) > 1 else s.shape[-1])
        scale = R._r32(1.0 / math.sqrt(max(fan_in, 1)))
        return (R.truncated_normal(k, -2.0, 2.0, s.shape) * scale).to(dtype)

    return map_specs_with_path(init_one, specs)


def abstract_params(specs: SpecTree, dtype=torch.float32):
    """Meta tensors shaped like the parameters: no allocation (the
    dry-run's stand-ins)."""
    return map_specs(
        lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def axes_tree(specs: SpecTree):
    """Tree of logical-axis tuples matching the param tree structure."""
    return map_specs(lambda s: s.axes, specs)


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
