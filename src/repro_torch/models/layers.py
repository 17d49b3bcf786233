"""Shared building blocks, the PyTorch counterpart of
``repro/models/layers.py``: norms, RoPE, masks, GQA attention (dense,
causal/windowed through the ``flash_prefill`` kernel, and the plain
causal path with ``_blockwise`` that MLA calls), projections and the
gated MLP.  ``mlstm_parallel`` (xLSTM) is not ported yet.

Plain functions on tensors; parameters arrive as dicts built from
``repro_torch.models.params.Spec`` trees in ``repro``'s layouts
(``wq`` is ``(d, H, D)``, ``wo`` is ``(H, D, d)``), so weights carry
over between the packages unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.params import Spec


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32; weights are zero-initialized and
    scale by ``1 + scale``."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def norm_spec(d: int) -> Spec:
    return Spec((d,), (None,), "zeros")


# ---------------------------------------------------------------- RoPE
def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """(sin, cos) of shape positions.shape + (head_dim//2,)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # torch.full fills on the device; torch.tensor(theta, device=...)
    # would copy from the host and wait for the device's queue
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                     device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); sin/cos: (..., S, D//2) broadcast over heads.
    Rotates split halves of the head, not interleaved pairs."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------- masks
def causal_mask(sq: int, sk: int, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(sq, sk) boolean mask.  ``q_offset`` shifts query positions
    (chunked prefill); ``window`` > 0 restricts to a sliding window."""
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    m = kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def decode_mask(positions: torch.Tensor, sk: int,
                window: int = 0) -> torch.Tensor:
    """(B, 1, sk) mask for decoding one token at ``positions`` (B,)."""
    kpos = torch.arange(sk, device=positions.device)
    m = kpos[None, :] <= positions[:, None]
    if window:
        m &= kpos[None, :] > (positions[:, None] - window)
    return m[:, None, :]


# ---------------------------------------------------------------- attention
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, *, softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention core, softmax in float32.

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); mask (Sq, Sk) or
    (B, Sq, Sk).  Returns (B, Sq, H, D).  A fully masked row averages V
    uniformly, as in the JAX package.
    """
    b, sq, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    qf = (q.float() * scale).reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    mask_b = (mask[:, None, None] if mask.dim() == 3
              else mask[None, None, None])
    logits = logits.masked_fill(~mask_b, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, h, dv).to(q.dtype)


def attn_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int = 0, softcap: float = 0.0,
                scale: Optional[float] = None, q_offset: int = 0,
                impl: str = "kernel") -> torch.Tensor:
    """Causal (optionally windowed) attention over every key of k/v:
    the ``flash_prefill`` kernel for CUDA tensors, its plain version for
    CPU tensors (``impl="ref"``: the plain version on any device).

    The kernel takes the default scale and no logit softcap, so both are
    refused here rather than computed elsewhere; MLA, which passes a
    scale, calls ``attn_causal_plain`` by name.
    """
    if softcap or scale is not None:
        raise NotImplementedError(
            "the flash_prefill kernel takes no logit softcap and no "
            "explicit scale (ROADMAP Queue 2, K3); attn_causal_plain "
            "takes an explicit scale")
    lengths = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                         device=q.device)
    return kops.flash_attention(q, k, v, lengths, window=window,
                                q_offset=q_offset, impl=impl)


def attn_causal_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, scale: Optional[float] = None, block_q: int = 512,
                      block_k: int = 512,
                      force_blockwise: bool = False) -> torch.Tensor:
    """The JAX package's ``attn_causal`` with an explicit scale and no
    window, softcap or offset, in plain torch: the dense masked
    ``attention`` when Sq*Sk <= 2048**2, else ``_blockwise``, an online
    softmax over (block_q, block_k) tiles that never holds the (Sq, Sk)
    scores.  Q/K and V may differ in width (MLA: 192 and 128).  No
    kernel is involved, on any device."""
    sq, sk = q.shape[1], k.shape[1]
    if sq * sk <= 2048 * 2048 and not force_blockwise:
        mask = causal_mask(sq, sk, device=q.device)[None]
        return attention(q, k, v, mask, scale=scale)
    return _blockwise(q, k, v, scale=scale, block_q=block_q,
                      block_k=block_k)


def _blockwise(q, k, v, *, scale, block_q=512, block_k=512):
    """``repro.models.layers._blockwise`` with the softmax norm: every
    (q block, k block) pair is visited in order, as the reference's
    scans do, with the running max, sum and accumulator in float32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    bq, bk = min(block_q, sq), min(block_k, sk)
    sq_p, sk_p = -(-sq // bq) * bq, -(-sk // bk) * bk
    q = F.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    k = F.pad(k, (0, 0, 0, 0, 0, sk_p - sk))
    v = F.pad(v, (0, 0, 0, 0, 0, sk_p - sk))
    dev = q.device
    outs = []
    for qi in range(sq_p // bq):
        q32 = q[:, qi * bq:(qi + 1) * bq].float().reshape(
            b, bq, hkv, g, d) * scale
        qpos = qi * bq + torch.arange(bq, device=dev)
        acc = torch.zeros(b, hkv, g, bq, dv, device=dev)
        m = torch.full((b, hkv, g, bq), NEG_INF, device=dev)
        den = torch.zeros(b, hkv, g, bq, device=dev)
        for ki in range(sk_p // bk):
            k32 = k[:, ki * bk:(ki + 1) * bk].float()
            v32 = v[:, ki * bk:(ki + 1) * bk].float()
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q32, k32)
            kpos = ki * bk + torch.arange(bk, device=dev)
            mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < sk)
            score = logits.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, score.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(score - m_new[..., None]).masked_fill(~mask, 0.0)
            den = den * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v32)
            m = m_new
        outs.append(acc / torch.clamp(den, min=1e-30)[..., None])
    out = torch.stack(outs)                      # (nq, b, hkv, g, bq, dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq_p, h, dv)
    return out[:, :sq].to(q.dtype)


def attn_specs(cfg) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    em = "embed"
    specs = {
        "wq": Spec((d, h, hd), (em, "heads", None), "scaled", 0),
        "wk": Spec((d, hkv, hd), (em, "kv_heads", None), "scaled", 0),
        "wv": Spec((d, hkv, hd), (em, "kv_heads", None), "scaled", 0),
        "wo": Spec((h, hd, d), ("heads", None, em), "scaled", 0),
    }
    if cfg.qkv_bias:
        specs["bq"] = Spec((h, hd), ("heads", None), "zeros")
        specs["bk"] = Spec((hkv, hd), ("kv_heads", None), "zeros")
        specs["bv"] = Spec((hkv, hd), ("kv_heads", None), "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = norm_spec(hd)
        specs["k_norm"] = norm_spec(hd)
    return specs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) times w: (d, H, D) -> (B, S, H, D)."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def attn_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Project to roped (q, k, v).  x: (B, S, d); positions: (B, S).
    Bias first, then ``qk_norm``, then RoPE."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    sin, cos = rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def attn_out(p: dict, o: torch.Tensor) -> torch.Tensor:
    """o: (B, S, H, D) -> (B, S, d)."""
    h, hd, d = p["wo"].shape
    return o.flatten(-2) @ p["wo"].reshape(h * hd, d)


# ---------------------------------------------------------------- MLP
def mlp_specs(d: int, f: int) -> dict:
    return {
        "w_gate": Spec((d, f), ("embed", "mlp"), "scaled", 0),
        "w_in": Spec((d, f), ("embed", "mlp"), "scaled", 0),
        "w_out": Spec((f, d), ("mlp", "embed"), "scaled", 0),
    }


def activation(act: str, x: torch.Tensor) -> torch.Tensor:
    """silu, or gelu with the tanh approximation (jax.nn.gelu's
    default)."""
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = activation(act, x @ p["w_gate"])
    return (g * (x @ p["w_in"])) @ p["w_out"]
