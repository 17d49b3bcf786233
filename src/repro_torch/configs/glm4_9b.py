"""GLM-4-9B — dense, RoPE, GQA kv=2.  [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13_696, vocab_size=151_552,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        source="[hf:THUDM/glm-4-9b]",
        max_seq_len=131_072)
