"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), the
PyTorch counterpart of ``repro/models/mla.py``.

KV is compressed to a per-token latent ``c_kv`` of rank ``kv_lora_rank``
plus a shared roped key ``k_rope``; the decode cache stores only
(c_kv, k_rope).

Two decode paths, as in the JAX package:
  * ``absorb=False``: expand K/V from the latent every step and run
    standard multi-head attention.
  * ``absorb=True``: fold W_uk into the query and W_uv into the output,
    so attention runs in latent space and no (S, H, d) tensors are made.

All of it is plain torch: the JAX package computes MLA outside any
Pallas kernel, and its prefill attention (``layers.attn_causal``, a
query/key width of 192 and a value width of 128 at deepseek-v2's sizes)
is ``layers.attn_causal_plain`` here.  Caches are written in place, as
everywhere in the port's full forward.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import MLAConfig, ModelConfig
from repro_torch.models.params import Spec


def mla_specs(cfg: ModelConfig) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    em = "embed"
    specs = {
        "w_dkv": Spec((d, m.kv_lora_rank), (em, None), "scaled", 0),
        "kv_norm": layers.norm_spec(m.kv_lora_rank),
        "w_krope": Spec((d, m.qk_rope_head_dim), (em, None), "scaled", 0),
        "w_uk": Spec((m.kv_lora_rank, h, m.qk_nope_head_dim),
                     (None, "heads", None), "scaled", 0),
        "w_uv": Spec((m.kv_lora_rank, h, m.v_head_dim),
                     (None, "heads", None), "scaled", 0),
        "w_o": Spec((h, m.v_head_dim, d), ("heads", None, em), "scaled", 0),
    }
    if m.q_lora_rank:
        specs["w_dq"] = Spec((d, m.q_lora_rank), (em, None), "scaled", 0)
        specs["q_norm"] = layers.norm_spec(m.q_lora_rank)
        specs["w_uq"] = Spec((m.q_lora_rank, h, qk),
                             (None, "heads", None), "scaled", 0)
    else:
        specs["w_q"] = Spec((d, h, qk), (em, "heads", None), "scaled", 0)
    return specs


def _queries(p, cfg, x, positions):
    """-> q_nope (B,S,H,dn), q_rope (B,S,H,dr)."""
    m = cfg.mla
    if m.q_lora_rank:
        cq = layers.rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
        q = layers._proj(cq, p["w_uq"])
    else:
        q = layers._proj(x, p["w_q"])
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    sin, cos = layers.rope_freqs(positions, m.qk_rope_head_dim,
                                 cfg.rope_theta)
    return q_nope, layers.apply_rope(q_rope, sin, cos)


def _latents(p, cfg, x, positions):
    """-> c_kv (B,S,rank), k_rope (B,S,dr): the decode cache's contents."""
    m = cfg.mla
    c_kv = layers.rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = x @ p["w_krope"]
    sin, cos = layers.rope_freqs(positions, m.qk_rope_head_dim,
                                 cfg.rope_theta)
    k_rope = layers.apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0, :]
    return c_kv, k_rope


def _expand(p, cfg, c_kv, k_rope):
    """Latents -> per-head keys (B,Sk,H,dn+dr) and values (B,Sk,H,dv)."""
    k_nope = torch.einsum("bkr,rhn->bkhn", c_kv, p["w_uk"])
    v = torch.einsum("bkr,rhv->bkhv", c_kv, p["w_uv"])
    k_rope_b = k_rope[:, :, None, :].expand(
        -1, -1, cfg.n_heads, cfg.mla.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def _scale(m: MLAConfig) -> float:
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _out(p, o):
    """o (B,S,H,dv) -> (B,S,d)."""
    h, dv, d = p["w_o"].shape
    return o.flatten(-2) @ p["w_o"].reshape(h * dv, d)


def mla_attention(p, cfg: ModelConfig, x, positions, c_kv, k_rope, mask,
                  *, absorb: bool = False):
    """Attention of queries from ``x`` against latents (c_kv, k_rope).

    c_kv: (B, Sk, rank); k_rope: (B, Sk, dr); mask: (B, Sq, Sk).
    """
    scale = _scale(cfg.mla)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    if absorb:
        # fold W_uk into q:  logits = (q W_uk^T) c_kv + q_rope k_rope
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"])
        logits = (torch.einsum("bshr,bkr->bhsk", q_lat, c_kv)
                  + torch.einsum("bshr,bkr->bhsk", q_rope, k_rope))
        logits = (logits * scale).float()
        logits = logits.masked_fill(~mask[:, None], layers.NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        ctx_lat = torch.einsum("bhsk,bkr->bshr", probs.to(x.dtype), c_kv)
        o = torch.einsum("bshr,rhv->bshv", ctx_lat, p["w_uv"])
    else:
        k, v = _expand(p, cfg, c_kv, k_rope)
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = layers.attention(q, k, v, mask, scale=scale)
    return _out(p, o)


def mla_full(p, cfg, x, positions, cache=None, *, absorb=False):
    """Prefill: latents from ``x``, attention over the expanded K/V
    (``layers.attn_causal_plain``); fills the cache's first S rows in
    place if one is given.  ``absorb`` changes only the decode path."""
    c_kv, k_rope = _latents(p, cfg, x, positions)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    k, v = _expand(p, cfg, c_kv, k_rope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = layers.attn_causal_plain(q, k, v, scale=_scale(cfg.mla))
    if cache is not None:
        s = c_kv.shape[1]
        cache["c_kv"][:, :s] = c_kv
        cache["k_rope"][:, :s] = k_rope
    return _out(p, o), cache


def mla_decode(p, cfg, x, positions, cache, *, absorb=False):
    """One-token decode: write the latent at ``positions`` (B,) in place,
    attend over the whole cache."""
    c_new, kr_new = _latents(p, cfg, x, positions[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    pos = positions.long()
    cache["c_kv"][bidx, pos] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][bidx, pos] = kr_new[:, 0].to(cache["k_rope"].dtype)
    mask = layers.decode_mask(positions, cache["c_kv"].shape[1])
    out = mla_attention(p, cfg, x, positions[:, None], cache["c_kv"],
                        cache["k_rope"], mask, absorb=absorb)
    return out, cache
