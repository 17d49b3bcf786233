"""Architecture registry + assigned input shapes.

``get_config(arch_id)`` resolves any of the 10 assigned architectures
(plus the paper's own eval model).  ``INPUT_SHAPES`` are the four
assigned (seq_len, global_batch, kind) workload shapes.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig, reduced

_MODULES: Dict[str, str] = {
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen2-1.5b": "qwen2_1_5b",
    "hymba-1.5b": "hymba_1_5b",
    "glm4-9b": "glm4_9b",
    "xlstm-1.3b": "xlstm_1_3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "gemma3-4b": "gemma3_4b",
    "musicgen-large": "musicgen_large",
    "chameleon-34b": "chameleon_34b",
    # the paper's own evaluation model (not in the assigned pool)
    "deepseek-coder-7b": "deepseek_coder_7b",
}

ASSIGNED_ARCHS: Tuple[str, ...] = tuple(k for k in _MODULES
                                        if k != "deepseek-coder-7b")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config()


def get_reduced_config(arch_id: str, **kw) -> ModelConfig:
    return reduced(get_config(arch_id), **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runs?, reason) — long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention architecture "
                       "(see DESIGN.md long_500k policy)")
    return True, ""
