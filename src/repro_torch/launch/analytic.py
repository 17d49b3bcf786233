"""Analytic FLOPs / HBM-bytes model per (architecture x input shape):
the port's copy of ``repro/launch/analytic.py``.

``estimate`` is the reference's, line for line: every matmul of the
models is enumerated, so it does not depend on the hardware.  The one
meant difference is the roofline's constants below, which are the
H100's where the reference's are a TPU v5e's.  (The reference pairs
this model with a parse of XLA's HLO for the collective term; the port
has no HLO and passes its collective bytes in directly.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.models import config as C
from repro_torch.models.config import ModelConfig


@dataclass
class WorkEstimate:
    flops: float               # total FLOPs for the step (fwd+bwd if train)
    hbm_bytes: float           # HBM traffic for the step
    model_flops: float         # 6·N·D (train) or 2·N·D (inference) headline
    note: str = ""


def _attn_flops(cfg: ModelConfig, ltype: str, b: int, s: int,
                ctx: float) -> float:
    """Forward attention-core FLOPs for one layer over the whole batch.
    ``ctx`` = average attended context per query token."""
    h, dh = cfg.n_heads, cfg.head_dim
    if ltype in (C.MLA_DENSE, C.MLA_MOE):
        m = cfg.mla
        dh_qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return 2.0 * b * s * ctx * h * (dh_qk + m.v_head_dim)
    if ltype in (C.MLSTM,):
        xc = cfg.xlstm
        di = int(xc.mlstm_proj_factor * cfg.d_model)
        return 2.0 * b * s * ctx * di * 2
    if ltype in (C.SLSTM,):
        return 0.0
    return 2.0 * b * s * ctx * h * dh * 2        # QK^T + AV


def _layer_ctx(cfg: ModelConfig, ltype: str, s: int, kind: str,
               cache_len: int) -> float:
    """Average context per query for this layer type."""
    window = cfg.sliding_window
    if kind == "decode":
        full = float(cache_len)
        if ltype in (C.SWA, C.HYMBA) and window:
            return min(window, full)
        if ltype in (C.MLSTM, C.SLSTM):
            return 0.0
        return full
    # train/prefill: causal mean context = s/2, or window
    if ltype in (C.SWA, C.HYMBA) and window:
        return min(window, s / 2.0)
    if ltype == C.SLSTM:
        return 0.0
    if ltype == C.MLSTM:
        return s / 2.0
    return s / 2.0


def _kv_bytes_per_token(cfg: ModelConfig, ltype: str, dtype_bytes: int
                        ) -> float:
    if ltype in (C.MLA_DENSE, C.MLA_MOE):
        return (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * dtype_bytes
    if ltype in (C.MLSTM, C.SLSTM):
        return 0.0
    return 2.0 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes


def estimate(cfg: ModelConfig, kind: str, batch: int, seq: int,
             dtype_bytes: int = 2) -> WorkEstimate:
    """kind: train | prefill | decode.  decode: seq = cache length,
    1 new token per sequence."""
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    b = batch
    s = 1 if kind == "decode" else seq
    tokens = b * s

    # matmul FLOPs through parameters: 2·N_active per token forward
    fwd = 2.0 * n_active * tokens
    attn = 0.0
    state_flops = 0.0
    for ltype in cfg.layer_pattern:
        ctx = _layer_ctx(cfg, ltype, seq if kind != "decode" else seq, kind,
                         cache_len=seq)
        attn += _attn_flops(cfg, ltype, b, s, ctx)
        if ltype in (C.HYMBA, C.HYMBA_GLOBAL) and cfg.ssm:
            di = cfg.ssm.expand * cfg.d_model
            state_flops += 6.0 * tokens * di * cfg.ssm.state_size
        if ltype == C.MLSTM and kind == "decode":
            xc = cfg.xlstm
            di = int(xc.mlstm_proj_factor * cfg.d_model)
            dh = di // xc.num_heads
            state_flops += 4.0 * b * xc.num_heads * dh * dh
        if ltype == C.SLSTM:
            dh = cfg.d_model // cfg.xlstm.num_heads
            state_flops += 2.0 * tokens * 4 * cfg.d_model * dh

    fwd += attn + state_flops
    mult = 3.0 if kind == "train" else 1.0       # bwd ≈ 2x fwd
    flops = fwd * mult

    # ---- HBM bytes
    pbytes = n_params * dtype_bytes
    kv_tok = sum(_kv_bytes_per_token(cfg, lt, dtype_bytes)
                 for lt in cfg.layer_pattern)
    act = tokens * cfg.d_model * dtype_bytes     # one residual stream pass
    if kind == "train":
        # params: read fwd + read bwd + write; adam m,v: rw in f32;
        # activations: remat keeps ~2 passes per layer
        hbm = (pbytes * 3 + n_params * 4 * 4
               + act * cfg.n_layers * 4)
    elif kind == "prefill":
        hbm = pbytes + kv_tok * tokens + act * cfg.n_layers * 2
    else:                                        # decode
        read_ctx = 0.0
        for lt in cfg.layer_pattern:
            ctx = _layer_ctx(cfg, lt, seq, "decode", seq)
            read_ctx += _kv_bytes_per_token(cfg, lt, dtype_bytes) * ctx
        hbm = pbytes + b * read_ctx + b * kv_tok + act * cfg.n_layers * 2
    model_flops = (6.0 if kind == "train" else 2.0) * n_active * tokens
    return WorkEstimate(flops=flops, hbm_bytes=hbm, model_flops=model_flops)


# NVIDIA H100 SXM constants (per card), from NVIDIA's H100 Tensor Core
# GPU datasheet (dense rates, no sparsity), which assume the full 700 W.
# The card the port runs on reads "NVIDIA H100 80GB HBM3, 700.00 W" in
# ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
PEAK_FLOPS = 989e12        # bf16 on the tensor cores
HBM_BW = 3.35e12           # bytes/s of HBM3
# NVLink 4: 900 GB/s a card, both directions of all 18 links together;
# this is one direction of all of them (the reference's TPU value is
# one ICI link's)
ICI_BW = 450e9             # bytes/s


def roofline_terms(est: WorkEstimate, collective_bytes_per_dev: float,
                   chips: int) -> Dict[str, float]:
    compute_s = est.flops / (chips * PEAK_FLOPS)
    memory_s = est.hbm_bytes / (chips * HBM_BW)
    collective_s = collective_bytes_per_dev / ICI_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "useful_flops_ratio": est.model_flops / max(est.flops, 1.0),
    }
