"""Qwen3-0.6B — dense, GQA, qk_norm.  [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=3072, vocab_size=151_936,
        qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="[hf:Qwen/Qwen3-8B]",
        max_seq_len=32_768)
