"""Random weights for a configuration, drawn on the device from the seed.

The tree has the port's parameter layout (what ``InferenceEngine(params=)``
takes); the configuration's family (``servebench/families/<family>.py``)
lists its leaves, their shapes and scales.  One ``torch.Generator`` on
the device, one ``randn`` call a leaf (stacked over the layers), in the
dtype the weights are served in.
"""
from __future__ import annotations

from typing import Dict

import torch

from servebench.families import family

def make(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The nested weight dict for ``cfg`` from ``seed``, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    tree: Dict = {}
    for path, shape, scale in family(cfg).leaves(cfg):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        t.mul_(scale)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t
    return tree
