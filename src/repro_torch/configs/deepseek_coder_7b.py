"""DeepSeek-Coder-7B analogue — the model the AIBrix paper itself uses
for the heterogeneous GPU-optimizer evaluation (Fig. 7).  Not part of
the assigned pool; used by benchmarks/bench_hetero.py."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11_008, vocab_size=102_400,
        tie_embeddings=False,
        source="[hf:deepseek-ai/deepseek-coder-6.7b-base]",
        max_seq_len=16_384)
