"""Tensors to and from numpy arrays in the JAX package's formats: KV
pages for the tiers, training states for the checkpoints and the bridge.

bfloat16 travels as ``ml_dtypes.bfloat16`` arrays where that package
imports (it comes with JAX), which JAX takes as they are, else as
``core/kvcache/tiers.BF16`` bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kvcache.tiers import BF16

try:        # numpy's bfloat16, where installed (it comes with JAX)
    from ml_dtypes import bfloat16 as _NP_BF16
except ImportError:
    _NP_BF16 = BF16


def to_payload(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy array that owns its memory (a copy on the CPU
    too: ``.numpy()`` of a CPU tensor would alias it, and a KV pool is
    overwritten in place by the next step).  bfloat16 comes out as an
    ``ml_dtypes.bfloat16`` array, or as ``BF16`` bit patterns where
    ``ml_dtypes`` is not installed (JAX cannot then take the array)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_NP_BF16)
    return t.numpy()


def from_payload(a) -> torch.Tensor:
    """A payload array -> a CPU tensor: ``BF16`` and ``ml_dtypes.bfloat16``
    arrays (by dtype name) bit for bit as bfloat16, others as they are."""
    a = np.asarray(a, order="C")        # 0-d stays 0-d
    if a.dtype == BF16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)
