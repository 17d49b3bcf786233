"""Where the port's entry points put their tensors.

Every entry point that allocates (``models.model.init``,
``models.params.init_params``, ``engine.paged_model.init_pool``, the
bridge and ``InferenceEngine``) runs on the card unless the caller names
another device; tests name ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The named device, or the card when none is named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card "
                           "unless a device is named (device='cpu')")
    return torch.device("cuda")
