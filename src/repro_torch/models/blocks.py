"""Per-layer-type blocks, the PyTorch counterpart of
``repro/models/blocks.py``: parameter specs, cache shapes and the residual
block forward.

Every layer type of the JAX package: DENSE and SWA (sliding-window)
layers, MOE (GQA attention and the mixture-of-experts FFN), MLA_DENSE
and MLA_MOE (multi-head latent attention, whose caches hold the latents
``c_kv`` and ``k_rope``), HYMBA and HYMBA_GLOBAL (windowed or full
attention in parallel with a Mamba head, whose states ``conv`` and ``h``
sit beside the K/V), and xLSTM's MLSTM and SLSTM (recurrent states
only: ``conv``, ``C``, ``n``, ``m``; ``c``, ``n``, ``m``, ``h``).

``apply_layer`` runs in two modes:
  * mode="full":   x (B, S, d), positions (B, S) — prefill; fills
                   ``cache`` (if given) for the decode steps after it.
  * mode="decode": x (B, 1, d), positions (B,) — one token against the
                   cache.

Sliding-window layers keep a ring-buffer cache of ``window`` slots with
an explicit per-slot absolute-position array (keys are roped when they
are written, so RoPE stays consistent across the ring's wraparound).

Where the JAX package returns a new cache, these functions write the new
K/V, ring positions and recurrent states **in place** into the tensors
of the cache dict they are given, cast to the cache's dtype, and return
that dict.  JAX drops the ring writes of all
but the last ``window`` prompt tokens with ``mode="drop"``; here only
those last ``window`` rows are selected and written.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import config as C
from repro_torch.models import layers, mla, moe, ssm

LAYER_TYPES = (C.DENSE, C.SWA, C.MOE, C.MLA_DENSE, C.MLA_MOE, C.HYMBA,
               C.HYMBA_GLOBAL, C.MLSTM, C.SLSTM)
# the recurrent states, which ``alloc_cache`` keeps in float32
STATE_FIELDS = ("C", "n", "m", "h", "c")


def _check_type(ltype: str) -> None:
    if ltype not in LAYER_TYPES:
        raise ValueError(f"unknown layer type {ltype}")


# ------------------------------------------------------------------ specs
def layer_specs(cfg: C.ModelConfig, ltype: str) -> dict:
    _check_type(ltype)
    d = cfg.d_model
    ln = layers.norm_spec(d)
    if ltype in (C.HYMBA, C.HYMBA_GLOBAL):
        return {"ln1": ln, "attn": layers.attn_specs(cfg),
                "mamba": ssm.mamba_specs(cfg),
                "ln2": ln, "mlp": layers.mlp_specs(d, cfg.d_ff)}
    if ltype == C.MLSTM:
        return {"ln1": ln, "mlstm": ssm.mlstm_specs(cfg)}
    if ltype == C.SLSTM:
        f = int(cfg.xlstm.slstm_proj_factor * d)
        return {"ln1": ln, "slstm": ssm.slstm_specs(cfg),
                "ln2": ln, "mlp": layers.mlp_specs(d, f)}
    mixer = ({"mla": mla.mla_specs(cfg)} if ltype in C.MLA_LAYER_TYPES
             else {"attn": layers.attn_specs(cfg)})
    if ltype in (C.MOE, C.MLA_MOE):
        ffn = {"moe": moe.moe_specs(d, cfg.moe,
                                    cfg.inference_weight_layout)}
    elif ltype == C.MLA_DENSE:
        # deepseek-v2 layer 0: dense FFN sized like shared+routed width
        f = cfg.d_ff if cfg.d_ff else cfg.moe.d_expert * 4
        ffn = {"mlp": layers.mlp_specs(d, f)}
    else:
        ffn = {"mlp": layers.mlp_specs(d, cfg.d_ff)}
    return {"ln1": ln, **mixer, "ln2": ln, **ffn}


# ------------------------------------------------------------------ caches
def _kv_cache(cfg, batch, length) -> Dict[str, Tuple[tuple, tuple]]:
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    axes = ("batch", "cache_seq", "kv_heads", None)
    return {"k": ((batch, length, hkv, hd), axes),
            "v": ((batch, length, hkv, hd), axes)}


def _window_cache(cfg, batch) -> Dict[str, Tuple[tuple, tuple]]:
    w = cfg.sliding_window
    c = _kv_cache(cfg, batch, w)
    c["pos"] = ((batch, w), ("batch", None))
    return c


def cache_shape(cfg: C.ModelConfig, ltype: str, batch: int,
                cache_len: int) -> Dict[str, Tuple[tuple, tuple]]:
    """dict of cache field -> ((shape), (logical axes))."""
    _check_type(ltype)
    if ltype in (C.DENSE, C.MOE):
        return _kv_cache(cfg, batch, cache_len)
    if ltype == C.SWA:
        return _window_cache(cfg, batch)
    if ltype in C.MLA_LAYER_TYPES:
        m = cfg.mla
        return {"c_kv": ((batch, cache_len, m.kv_lora_rank),
                         ("batch", "cache_seq", None)),
                "k_rope": ((batch, cache_len, m.qk_rope_head_dim),
                           ("batch", "cache_seq", None))}
    if ltype == C.HYMBA:
        return {**_window_cache(cfg, batch),
                **ssm.mamba_state_shape(cfg, batch)}
    if ltype == C.HYMBA_GLOBAL:
        return {**_kv_cache(cfg, batch, cache_len),
                **ssm.mamba_state_shape(cfg, batch)}
    if ltype == C.MLSTM:
        return ssm.mlstm_state_shape(cfg, batch)
    return ssm.slstm_state_shape(cfg, batch)


def alloc_cache(shapes: Dict[str, Tuple[tuple, tuple]], dtype,
                device) -> dict:
    """Zeroed fields: ring positions of -1 (int32), the recurrent states
    (``STATE_FIELDS``) in float32, as the JAX package's
    ``models.model.init_cache`` keeps them, the rest (K/V, latents, conv
    buffers) in ``dtype``."""
    def zeros(name, shape):
        dt = torch.float32 if name in STATE_FIELDS else dtype
        return torch.zeros(shape, dtype=dt, device=device)
    return {name: (torch.full(shape, -1, dtype=torch.int32, device=device)
                   if name == "pos" else zeros(name, shape))
            for name, (shape, _axes) in shapes.items()}


# ------------------------------------------------------------------ attention paths
def _attn_full(p, cfg, x, positions, cache, window: int, impl: str):
    """Full-sequence attention (prefill or training); optionally fills
    the cache."""
    s = x.shape[1]
    q, k, v = layers.attn_qkv(p, cfg, x, positions)
    if impl == "train":
        o = layers.attn_causal_plain(q, k, v, window=window,
                                     softcap=cfg.attn_logit_softcap)
    else:
        o = layers.attn_causal(q, k, v, window=window,
                               softcap=cfg.attn_logit_softcap, impl=impl)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        if "pos" in cache:  # ring buffer: only the last `window` tokens
            keep_from = max(s - cfg.sliding_window, 0)
            pos = positions[:, keep_from:]
            slots = pos.long() % cfg.sliding_window              # (B, w)
            bidx = torch.arange(x.shape[0], device=x.device)[:, None]
            ck[bidx, slots] = k[:, keep_from:].to(ck.dtype)
            cv[bidx, slots] = v[:, keep_from:].to(cv.dtype)
            cache["pos"][bidx, slots] = pos.to(torch.int32)
        else:
            ck[:, :s] = k
            cv[:, :s] = v
    return layers.attn_out(p, o), cache


def _attn_decode(p, cfg, x, positions, cache, window: int):
    """One-token decode against a (possibly ring-buffer) cache, in plain
    torch over the whole cache, as the JAX package computes it."""
    q, k, v = layers.attn_qkv(p, cfg, x, positions[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    ck, cv = cache["k"], cache["v"]
    if "pos" in cache:
        w = cfg.sliding_window
        slot = positions.long() % w
        ck[bidx, slot] = k[:, 0].to(ck.dtype)
        cv[bidx, slot] = v[:, 0].to(cv.dtype)
        cache["pos"][bidx, slot] = positions.to(torch.int32)
        kpos = cache["pos"]                                    # (B, w)
        cur = positions[:, None]
        mask = ((kpos >= 0) & (kpos <= cur) & (kpos > cur - w))[:, None, :]
    else:
        ck[bidx, positions.long()] = k[:, 0].to(ck.dtype)
        cv[bidx, positions.long()] = v[:, 0].to(cv.dtype)
        mask = layers.decode_mask(positions, ck.shape[1], window=window)
    o = layers.attention(q, ck, cv, mask, softcap=cfg.attn_logit_softcap)
    return layers.attn_out(p, o), cache


# ------------------------------------------------------------------ apply
def _store(cache: Optional[dict], new: dict) -> None:
    """Write new recurrent states into the cache's tensors, in place,
    cast to the cache's dtype (the reference's scan writes them back as
    ``new.astype(cache.dtype)``)."""
    if cache is not None:
        for name, t in new.items():
            cache[name].copy_(t)


def apply_layer(p: dict, cfg: C.ModelConfig, ltype: str, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict], mode: str,
                impl: str = "kernel"
                ) -> Tuple[torch.Tensor, Optional[dict],
                           Optional[moe.Routing]]:
    """Residual block.  Returns (x, cache, routing): the MoE FFN's
    routing, from which ``moe.aux_losses`` computes the reference's
    auxiliary losses, None for the other layers.  ``impl`` routes the
    full-mode GQA attention (Hymba's included): "kernel" to the
    ``flash_prefill`` kernel, "ref" to its plain version (both for
    serving), "train" to the trainer's differentiable
    ``layers.attn_causal_plain``, the JAX package's ``attn_causal``
    (MLA has no kernel and always takes it)."""
    _check_type(ltype)
    if mode not in ("full", "decode"):
        raise ValueError(f"mode must be 'full' or 'decode', got {mode!r}")
    full = mode == "full"
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if ltype in C.MLA_LAYER_TYPES:
        mix = mla.mla_full if full else mla.mla_decode
        a, cache = mix(p["mla"], cfg, h, positions, cache,
                       absorb=cfg.mla_absorb)
    elif ltype in (C.HYMBA, C.HYMBA_GLOBAL):
        window = cfg.sliding_window if ltype == C.HYMBA else 0
        attn_cache = state = None
        if cache is not None:
            attn_cache = {k: cache[k] for k in ("k", "v", "pos")
                          if k in cache}
            state = {k: cache[k] for k in ("conv", "h")}
        if full:
            a, _ = _attn_full(p["attn"], cfg, h, positions, attn_cache,
                              window, impl)
            m_out, new = ssm.mamba_seq(p["mamba"], cfg, h,
                                       state or _fresh_mamba(cfg, h))
        else:
            a, _ = _attn_decode(p["attn"], cfg, h, positions, attn_cache,
                                window)
            m_out, new = ssm.mamba_step(p["mamba"], cfg, h[:, 0], state)
            m_out = m_out[:, None, :]
        _store(cache, new)
        a = 0.5 * (a + m_out)
    elif ltype in (C.MLSTM, C.SLSTM):
        name, fresh = (("mlstm", _fresh_mlstm) if ltype == C.MLSTM
                       else ("slstm", _fresh_slstm))
        seq, step = ((ssm.mlstm_seq, ssm.mlstm_step) if ltype == C.MLSTM
                     else (ssm.slstm_seq, ssm.slstm_step))
        st = cache if cache else fresh(cfg, h)
        if full:
            a, new = seq(p[name], cfg, h, st)
        else:
            a, new = step(p[name], cfg, h[:, 0], st)
            a = a[:, None, :]
        _store(cache, new)
        if ltype == C.MLSTM:
            return x + a, cache, None             # no FFN sublayer
    else:
        window = cfg.sliding_window if ltype == C.SWA else 0
        if full:
            a, cache = _attn_full(p["attn"], cfg, h, positions, cache,
                                  window, impl)
        else:
            a, cache = _attn_decode(p["attn"], cfg, h, positions, cache,
                                    window)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, routing, _ = moe.moe_ffn(p["moe"], cfg.moe, h, cfg.act)
        return x + f, cache, routing
    return x + layers.mlp(p["mlp"], h, cfg.act), cache, None


def _fresh_mamba(cfg, x):
    return alloc_cache(ssm.mamba_state_shape(cfg, x.shape[0]), x.dtype,
                       x.device)


def _fresh_mlstm(cfg, x):
    return alloc_cache(ssm.mlstm_state_shape(cfg, x.shape[0]),
                       torch.float32, x.device)


def _fresh_slstm(cfg, x):
    return alloc_cache(ssm.slstm_state_shape(cfg, x.shape[0]),
                       torch.float32, x.device)
