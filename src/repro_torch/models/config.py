"""Model configuration for all assigned architectures.

A single decoder-only ``ModelConfig`` describes every architecture in the
assigned pool (dense / MoE / MLA-MoE / SSM / hybrid / audio / vlm).  The
per-layer ``layer_pattern`` drives the run-grouped scan execution in
``repro_torch.models.model`` (maximal uniform segments of identical layer types
are stacked and executed with ``lax.scan``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer type identifiers (see repro.models.blocks).
DENSE = "dense"            # GQA attention + (Swi)GLU MLP
SWA = "swa"                # sliding-window GQA attention + MLP
MOE = "moe"                # GQA attention + mixture-of-experts FFN
MLA_DENSE = "mla_dense"    # multi-head latent attention + dense FFN
MLA_MOE = "mla_moe"        # multi-head latent attention + MoE FFN
HYMBA = "hymba"            # parallel (SWA attention ‖ mamba SSM) + MLP
HYMBA_GLOBAL = "hymba_g"   # parallel (full attention ‖ mamba SSM) + MLP
MLSTM = "mlstm"            # xLSTM matrix-memory block (pre-up projection)
SLSTM = "slstm"            # xLSTM scalar-memory block (post-up FFN)

ATTN_LAYER_TYPES = (DENSE, SWA, MOE, HYMBA, HYMBA_GLOBAL)
MLA_LAYER_TYPES = (MLA_DENSE, MLA_MOE)
SSM_ONLY_LAYER_TYPES = (MLSTM, SLSTM)
FULL_ATTN_LAYER_TYPES = (DENSE, MOE, HYMBA_GLOBAL, MLA_DENSE, MLA_MOE)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # hidden width of each routed expert
    num_shared_experts: int = 0    # deepseek-style always-on experts
    d_shared_expert: int = 0       # hidden width of the shared expert(s)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01  # load-balance auxiliary loss weight
    router_z_coef: float = 1e-3


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 => dense q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 16
    conv_width: int = 4
    expand: int = 1                # d_inner = expand * d_model
    dt_rank: int = 0               # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    mlstm_proj_factor: float = 2.0   # pre-up projection factor (mLSTM)
    slstm_proj_factor: float = 4.0 / 3.0  # post-up FFN factor (sLSTM)
    conv_width: int = 4
    num_heads: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # window size for SWA layers
    attn_logit_softcap: float = 0.0
    # sub-module configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # per-layer types; () => (DENSE,) * n_layers
    layer_pattern: Tuple[str, ...] = ()
    # embedding / head
    tie_embeddings: bool = True
    num_codebooks: int = 0         # musicgen: EnCodec codebooks (0 => text)
    norm_eps: float = 1e-6
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    # MLA decode path: False = paper-faithful expand (vLLM v0.7-era),
    # True = absorbed latent-space attention (beyond-paper perf option).
    mla_absorb: bool = False
    # Weight sharding layout: False = training layout (2D FSDP: d_model
    # over data) — right when per-step compute amortizes weight
    # gathers.  True = inference layout (weights shard over model only;
    # expert banks shard expert->model, f->data with contraction dims
    # unsharded) — at decode the per-layer FSDP gathers dominate the
    # collective term (§Perf pair 2, iteration 4).
    inference_weight_layout: bool = False
    # provenance
    source: str = ""
    # serving hints
    max_seq_len: int = 131_072
    sub_quadratic: bool = False    # eligible for long_500k decode

    def __post_init__(self):
        if not self.layer_pattern:
            object.__setattr__(self, "layer_pattern", (DENSE,) * self.n_layers)
        if len(self.layer_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: layer_pattern has {len(self.layer_pattern)} "
                f"entries, expected n_layers={self.n_layers}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    # ------------------------------------------------------------------
    @property
    def layer_runs(self) -> Tuple[Tuple[str, int], ...]:
        """Maximal runs of identical consecutive layer types."""
        runs = []
        for t in self.layer_pattern:
            if runs and runs[-1][0] == t:
                runs[-1][1] += 1
            else:
                runs.append([t, 1])
        return tuple((t, n) for t, n in runs)

    @property
    def uses_attention(self) -> bool:
        return any(t in ATTN_LAYER_TYPES or t in MLA_LAYER_TYPES
                   for t in self.layer_pattern)

    @property
    def is_pure_full_attention(self) -> bool:
        """True when every token-mixing layer is full (unwindowed) attention.

        Such architectures skip the long_500k decode shape (see DESIGN.md).
        """
        return all(t in FULL_ATTN_LAYER_TYPES for t in self.layer_pattern)

    def param_count(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        from repro_torch.models import model as _model
        return _model.count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models import model as _model
        return _model.count_params(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            vocab: int = 512, max_experts: int = 4) -> ModelConfig:
    """A tiny same-family variant of ``cfg`` for CPU smoke tests.

    Preserves the layer-type mix (first/last pattern entries survive) while
    shrinking every dimension per the assignment rules (≤2 layers,
    d_model ≤ 512, ≤4 experts).
    """
    # Keep a representative layer pattern: first layer + a "typical" layer.
    pattern = tuple(cfg.layer_pattern[i] for i in
                    _representative_indices(cfg.layer_pattern, n_layers))
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    moe = cfg.moe
    if moe is not None:
        n_exp = min(moe.num_experts, max_experts)
        top_k = min(moe.top_k, 2)
        moe = dataclasses.replace(
            moe, num_experts=n_exp, top_k=top_k,
            d_expert=min(moe.d_expert, d_model),
            num_shared_experts=min(moe.num_shared_experts, 1),
            d_shared_expert=min(moe.d_shared_expert, d_model),
            # dropless in tests: capacity == all tokens, so results are
            # independent of batch grouping (exact prefill/decode parity)
            capacity_factor=n_exp / top_k)
    mla = cfg.mla
    if mla is not None:
        mla = dataclasses.replace(mla, kv_lora_rank=64, q_lora_rank=0,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
    return cfg.replace(
        name=cfg.name + "-reduced", n_layers=len(pattern),
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        d_ff=min(cfg.d_ff, d_model * 2) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, vocab),
        head_dim=d_model // n_heads,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        moe=moe, mla=mla, layer_pattern=pattern, max_seq_len=2048)


def _representative_indices(pattern, n):
    """Pick ``n`` indices covering as many distinct layer types as possible."""
    seen, idxs = set(), []
    for i, t in enumerate(pattern):
        if t not in seen:
            seen.add(t)
            idxs.append(i)
    while len(idxs) < n:
        idxs.append(len(pattern) - 1)
    return sorted(idxs[:n])
