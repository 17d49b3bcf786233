"""xLSTM-1.3B — sLSTM + mLSTM blocks at 7:1 (mLSTM:sLSTM).

No attention, no KV cache — constant-size recurrent state makes this the
canonical long_500k architecture.  [arXiv:2405.04517]
"""
from repro_torch.models.config import MLSTM, SLSTM, ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    pattern = ((MLSTM,) * 7 + (SLSTM,)) * 6           # 48 layers
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50_304,
        xlstm=XLSTMConfig(num_heads=4),
        layer_pattern=pattern,
        tie_embeddings=False,
        source="[arXiv:2405.04517]",
        max_seq_len=1_048_576, sub_quadratic=True)
