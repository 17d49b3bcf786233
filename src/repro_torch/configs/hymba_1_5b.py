"""Hymba-1.5B — hybrid: parallel attention + Mamba heads per layer.

Full (global) attention in layers {0, 15, 31}; sliding-window attention
elsewhere; every layer carries an SSM state of 16.  [arXiv:2411.13676]
"""
from repro_torch.models.config import HYMBA, HYMBA_GLOBAL, ModelConfig, SSMConfig

_GLOBAL = (0, 15, 31)


def config() -> ModelConfig:
    pattern = tuple(HYMBA_GLOBAL if i in _GLOBAL else HYMBA
                    for i in range(32))
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32_001,
        ssm=SSMConfig(state_size=16, conv_width=4, expand=1),
        sliding_window=1024,
        layer_pattern=pattern,
        tie_embeddings=True,
        source="[arXiv:2411.13676]",
        max_seq_len=1_048_576, sub_quadratic=True)
