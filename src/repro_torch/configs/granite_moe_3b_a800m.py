"""Granite-3.0 MoE 3B-A800M — 40 routed experts, top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base]  (assigned spec line says 40
experts top-8; the HF 1b card lists 32 — we follow the assigned spec.)
"""
from repro_torch.models.config import MOE, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49_155,
        moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
        layer_pattern=(MOE,) * 32,
        tie_embeddings=True,
        source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
        max_seq_len=8_192)
