"""DeepSeek-V2-236B — MLA (kv_lora=512) + MoE (2 shared + 160 routed,
top-6); layer 0 has a dense FFN.  [arXiv:2405.04434]"""
from repro_torch.models.config import (MLA_DENSE, MLA_MOE, MLAConfig, ModelConfig,
                                 MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12_288,                       # dense FFN width (layer 0)
        vocab_size=102_400,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536,
                      num_shared_experts=2, d_shared_expert=1536),
        layer_pattern=(MLA_DENSE,) + (MLA_MOE,) * 59,
        tie_embeddings=False,
        source="[arXiv:2405.04434]",
        max_seq_len=131_072)
