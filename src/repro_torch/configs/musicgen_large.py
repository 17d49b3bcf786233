"""MusicGen-large — decoder-only over EnCodec tokens (4 codebooks,
2048-way each).  The EnCodec conv frontend is a STUB per the assignment
carve-out: input_specs() supplies (B, S, 4) codebook-token ids.
[arXiv:2306.05284]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=2048,
        num_codebooks=4, act="gelu",
        tie_embeddings=False,
        source="[arXiv:2306.05284]",
        max_seq_len=16_384)
