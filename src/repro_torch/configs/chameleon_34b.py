"""Chameleon-34B — early-fusion VLM: text + VQ image tokens in one
unified 65536-way vocabulary; qk-norm for stability.  The VQ-GAN image
tokenizer is a STUB per the assignment carve-out: input_specs() supplies
pre-tokenized mixed-modal token ids.  [arXiv:2405.09818]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22_016, vocab_size=65_536,
        qk_norm=True,
        tie_embeddings=False,
        source="[arXiv:2405.09818]",
        max_seq_len=8_192)
