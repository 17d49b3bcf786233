"""Gemma-3-4B — 5:1 local(window 1024):global attention, 128k context.

head_dim 256 (decoupled from d_model/n_heads).  [hf:google/gemma-3-1b-pt]
"""
from repro_torch.models.config import DENSE, SWA, ModelConfig


def config() -> ModelConfig:
    pattern = ((SWA,) * 5 + (DENSE,)) * 5 + (SWA,) * 4   # 34 layers
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
        d_ff=10_240, vocab_size=262_144,
        head_dim=256, qk_norm=True, rope_theta=1_000_000.0,
        sliding_window=1024,
        layer_pattern=pattern,
        tie_embeddings=True,
        source="[hf:google/gemma-3-1b-pt]",
        max_seq_len=131_072, sub_quadratic=True)
