"""Per-layer-type blocks, the PyTorch counterpart of
``repro/models/blocks.py``: parameter specs, cache shapes and the residual
block forward.

Ported: DENSE and SWA (sliding-window) layers, MOE (GQA attention and
the mixture-of-experts FFN), and MLA_DENSE and MLA_MOE (multi-head
latent attention, whose caches hold the latents ``c_kv`` and
``k_rope``).  The Hymba and xLSTM types raise ``NotImplementedError``
naming their ROADMAP item.

``apply_layer`` runs in two modes:
  * mode="full":   x (B, S, d), positions (B, S) — prefill; fills
                   ``cache`` (if given) for the decode steps after it.
  * mode="decode": x (B, 1, d), positions (B,) — one token against the
                   cache.

Sliding-window layers keep a ring-buffer cache of ``window`` slots with
an explicit per-slot absolute-position array (keys are roped when they
are written, so RoPE stays consistent across the ring's wraparound).

Where the JAX package returns a new cache, these functions write the new
K/V (and ring positions) **in place** into the tensors of the cache dict
they are given, and return that dict.  JAX drops the ring writes of all
but the last ``window`` prompt tokens with ``mode="drop"``; here only
those last ``window`` rows are selected and written.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import config as C
from repro_torch.models import layers, mla, moe

UNPORTED = {
    C.HYMBA: "C1b (Hymba, models/ssm.py)",
    C.HYMBA_GLOBAL: "C1b (Hymba, models/ssm.py)",
    C.MLSTM: "C1b (xLSTM, models/ssm.py)",
    C.SLSTM: "C1b (xLSTM, models/ssm.py)",
}


def _check_ported(cfg: C.ModelConfig, ltype: str) -> None:
    if ltype in UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: layer type {ltype!r} is not ported yet (ROADMAP "
            f"{UNPORTED[ltype]})")
    if ltype not in (C.DENSE, C.SWA, C.MOE, C.MLA_DENSE, C.MLA_MOE):
        raise ValueError(f"unknown layer type {ltype}")


# ------------------------------------------------------------------ specs
def layer_specs(cfg: C.ModelConfig, ltype: str) -> dict:
    _check_ported(cfg, ltype)
    d = cfg.d_model
    ln = layers.norm_spec(d)
    mixer = ({"mla": mla.mla_specs(cfg)} if ltype in C.MLA_LAYER_TYPES
             else {"attn": layers.attn_specs(cfg)})
    if ltype in (C.MOE, C.MLA_MOE):
        ffn = {"moe": moe.moe_specs(d, cfg.moe)}
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
    _check_ported(cfg, ltype)
    if ltype in (C.DENSE, C.MOE):
        return _kv_cache(cfg, batch, cache_len)
    if ltype in C.MLA_LAYER_TYPES:
        m = cfg.mla
        return {"c_kv": ((batch, cache_len, m.kv_lora_rank),
                         ("batch", "cache_seq", None)),
                "k_rope": ((batch, cache_len, m.qk_rope_head_dim),
                           ("batch", "cache_seq", None))}
    return _window_cache(cfg, batch)


def alloc_cache(shapes: Dict[str, Tuple[tuple, tuple]], dtype,
                device) -> dict:
    """Zeroed K/V of ``dtype`` and ring positions of -1 (int32)."""
    return {name: (torch.full(shape, -1, dtype=torch.int32, device=device)
                   if name == "pos" else
                   torch.zeros(shape, dtype=dtype, device=device))
            for name, (shape, _axes) in shapes.items()}


def init_cache(cfg: C.ModelConfig, ltype: str, batch: int, cache_len: int,
               dtype=torch.float32, device=None) -> dict:
    """One layer's cache on ``device`` (the card unless one is named)."""
    return alloc_cache(cache_shape(cfg, ltype, batch, cache_len), dtype,
                       resolve_device(device))


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
def apply_layer(p: dict, cfg: C.ModelConfig, ltype: str, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict], mode: str,
                impl: str = "kernel"
                ) -> Tuple[torch.Tensor, Optional[dict],
                           Optional[moe.Routing]]:
    """Residual block.  Returns (x, cache, routing): the MoE FFN's
    routing, from which ``moe.aux_losses`` computes the reference's
    auxiliary losses, None for the other layers.  ``impl`` routes the
    full-mode GQA attention: "kernel" to the ``flash_prefill`` kernel,
    "ref" to its plain version (both for serving), "train" to the
    trainer's differentiable ``layers.attn_causal_plain``, the JAX
    package's ``attn_causal`` (MLA has no kernel and always takes it)."""
    _check_ported(cfg, ltype)
    if mode not in ("full", "decode"):
        raise ValueError(f"mode must be 'full' or 'decode', got {mode!r}")
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if ltype in C.MLA_LAYER_TYPES:
        mix = mla.mla_full if mode == "full" else mla.mla_decode
        a, cache = mix(p["mla"], cfg, h, positions, cache,
                       absorb=cfg.mla_absorb)
    else:
        window = cfg.sliding_window if ltype == C.SWA else 0
        if mode == "full":
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
