"""Flat-namespace checkpointing, the PyTorch counterpart of
``repro/training/checkpoint.py``: a tree -> one ``.npz`` per step plus a
``manifest.json``, in the reference's format key for key (a leaf's key
is its path of field names and dict keys, ``/params/run_0/attn/wq``
say), so a checkpoint that either package saves restores in the
other.

Tensors go through numpy (``repro_torch.payload``).  bfloat16 leaves
leave as ``ml_dtypes.bfloat16`` arrays where ``ml_dtypes`` imports (else
as ``core/kvcache/tiers.BF16`` bit patterns), which ``np.savez`` stores
as raw 2-byte voids, as the reference stores its bf16 leaves; neither
package can restore such a leaf (ROADMAP Queue 3, F3), and ``restore``
says so.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.payload import to_payload
from repro_torch.tree import tree_flatten, tree_unflatten


def _flatten(tree: Any) -> dict:
    return {path: to_payload(leaf) if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for path, leaf in tree_flatten(tree)}


def save(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    np.savez(path, **flat)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump({"latest_step": step, "latest": path}, f)
    return path


def latest_step(directory: str) -> int:
    try:
        with open(os.path.join(directory, "manifest.json")) as f:
            return json.load(f)["latest_step"]
    except FileNotFoundError:
        return 0


def restore(directory: str, like: Any, step: int = 0) -> Any:
    """Restore into the structure of ``like``: each tensor leaf takes
    the dtype and device of ``like``'s."""
    step = step or latest_step(directory)
    npz = os.path.join(directory, f"ckpt_{step:08d}.npz")

    def leaf(data, path, like_leaf):
        arr = data[path]
        if arr.dtype.kind == "V":
            raise ValueError(
                f"{npz}{path}: a {arr.dtype} leaf (a bfloat16 leaf as "
                "np.savez stores it) cannot be restored; the reference "
                "cannot restore it either (ROADMAP Queue 3, F3)")
        t = torch.from_numpy(arr)
        if isinstance(like_leaf, torch.Tensor):
            return t.to(device=like_leaf.device, dtype=like_leaf.dtype)
        return t

    with np.load(npz) as data:
        return tree_unflatten(like, {p: leaf(data, p, x)
                                     for p, x in tree_flatten(like)})
