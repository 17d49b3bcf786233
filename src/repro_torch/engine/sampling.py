"""Token sampling, the counterpart of ``repro/engine/sampling.py``.

Greedy only so far: the JAX package samples at temperature > 0 with
``jax.random`` keys derived per (seed, position), and matching those
draws needs threefry and the Gumbel draw written out; that port comes
later.  Until then a request with ``temperature > 0`` is refused rather
than sampled differently.
"""
from __future__ import annotations

from typing import Sequence

import torch


def sample(logits: torch.Tensor, temperatures: Sequence[float]
           ) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32 greedy tokens (first index of the
    maximum, as ``jnp.argmax``)."""
    if any(t > 0.0 for t in temperatures):
        raise NotImplementedError(
            "sampling at temperature > 0 is not ported yet; use greedy "
            "requests (temperature=0)")
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
