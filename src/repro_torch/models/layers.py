"""Shared building blocks, the PyTorch counterpart of
``repro/models/layers.py``: norms, RoPE, masks, GQA attention (dense,
causal/windowed through the ``flash_prefill`` kernel, and the plain
causal path with ``_blockwise`` that the trainer and MLA call),
``mlstm_parallel`` (xLSTM's parallel form, ``_blockwise``'s mLSTM
norm), projections and the gated MLP.

Plain functions on tensors; parameters arrive as dicts built from
``repro_torch.models.params.Spec`` trees in ``repro``'s layouts
(``wq`` is ``(d, H, D)``, ``wo`` is ``(H, D, d)``), so weights carry
over between the packages unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import sharding
from repro_torch.models.params import Spec
from repro_torch.tree import tree_leaves


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
                      *, window: int = 0, softcap: float = 0.0,
                      scale: Optional[float] = None, block_q: int = 512,
                      block_k: int = 512,
                      force_blockwise: bool = False) -> torch.Tensor:
    """The JAX package's ``attn_causal`` (at ``q_offset`` 0) in plain
    torch, the trainer's attention and MLA's: the dense masked
    ``attention`` when Sq*Sk <= 2048**2, else ``_blockwise``, an online
    softmax over (block_q, block_k) tiles that never holds the (Sq, Sk)
    scores.  ``window`` > 0 keeps the keys ``kpos > qpos - window``;
    ``softcap`` > 0 caps the logits with ``tanh``.  Q/K and V may differ
    in width (MLA: 192 and 128).  No kernel is involved, on any device,
    so autograd differentiates it."""
    sq, sk = q.shape[1], k.shape[1]
    if sq * sk <= 2048 * 2048 and not force_blockwise:
        mask = causal_mask(sq, sk, window=window, device=q.device)[None]
        return attention(q, k, v, mask, softcap=softcap, scale=scale)
    return _blockwise(q, k, v, scale=scale, window=window, softcap=softcap,
                      block_q=block_q, block_k=block_k)


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias_q: torch.Tensor, bias_k: torch.Tensor,
                   block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Parallel (quadratic) mLSTM form: gate-biased blockwise attention
    with signed-sum normalization (xLSTM eq. 25-27).  bias_q = F_t
    (cumulative log-forget), bias_k = i_s - F_s; entry bias = F_t-F_s+i_s.
    k must arrive pre-scaled by 1/sqrt(dh) (as in the recurrent form).
    q, k, v: (B, S, H, dh); bias_q, bias_k: (B, S, H)."""
    return _blockwise(q, k, v, scale=1.0, norm="mlstm", bias_q=bias_q,
                      bias_k=bias_k, block_q=block_q, block_k=block_k)


def recording(*trees) -> bool:
    """Whether autograd records through a tensor among ``trees``: then a
    blockwise sweep or a scan's chunk runs under
    ``torch.utils.checkpoint``, as the reference rematerializes it."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree_leaves(trees))


def _blockwise(q, k, v, *, scale, window=0, softcap=0.0, norm="softmax",
               bias_q=None, bias_k=None, block_q=512, block_k=512):
    """``repro.models.layers._blockwise``: every (q block, k block) pair
    is visited in order, as the reference's scans do, with the running
    max, sum and accumulator in float32.

    ``norm="softmax"``: an online softmax of the (optionally capped)
    logits.  ``norm="mlstm"``: each entry's weight is its logit times
    ``exp(bias_q[t] + bias_k[s] - m)``, signed, where the running max
    ``m`` is taken over the masked bias, not the logits; the sum is
    normalized by ``max(|l|, 1)``.  Padded keys carry ``bias_k =
    NEG_INF``, padded queries ``bias_q = 0``.

    While autograd records, each q block's sweep runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward, as the
    reference rematerializes it: otherwise the backward would keep the
    accumulators of every (q block, k block) pair, O(Sq*Sk) memory."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    mlstm = norm == "mlstm"
    bq, bk = min(block_q, sq), min(block_k, sk)
    sq_p, sk_p = -(-sq // bq) * bq, -(-sk // bk) * bk
    q = F.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    k = F.pad(k, (0, 0, 0, 0, 0, sk_p - sk))
    v = F.pad(v, (0, 0, 0, 0, 0, sk_p - sk))
    if mlstm:
        bias_q = F.pad(bias_q.float(), (0, 0, 0, sq_p - sq))
        bias_k = F.pad(bias_k.float(), (0, 0, 0, sk_p - sk), value=NEG_INF)
        bias_q = bias_q.reshape(b, sq_p, hkv, g)
    # the reference's constraints: heads over model when the count
    # divides, else sequence-sharded q blocks (no-ops on plain tensors)
    nq, nk = sq_p // bq, sk_p // bk
    q = sharding.constrain(q.reshape(b, nq, bq, hkv, g, d), (
        "batch", None, "seq", "kv_heads", None, None)).reshape(q.shape)
    k = sharding.constrain(k.reshape(b, nk, bk, hkv, d), (
        "batch", None, None, "kv_heads", None)).reshape(k.shape)
    v = sharding.constrain(v.reshape(b, nk, bk, hkv, dv), (
        "batch", None, None, "kv_heads", None)).reshape(v.shape)
    dev = q.device

    def sweep(q_blk, bq_blk, k, v, bias_k, qi):
        q32 = q_blk.float().reshape(b, bq, hkv, g, d) * scale
        qpos = qi * bq + torch.arange(bq, device=dev)
        acc = torch.zeros(b, hkv, g, bq, dv, device=dev)
        m = torch.full((b, hkv, g, bq), NEG_INF, device=dev)
        den = torch.zeros(b, hkv, g, bq, device=dev)
        for ki in range(nk):
            k32 = k[:, ki * bk:(ki + 1) * bk].float()
            v32 = v[:, ki * bk:(ki + 1) * bk].float()
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q32, k32)
            if softcap:
                logits = torch.tanh(logits / softcap) * softcap
            kpos = ki * bk + torch.arange(bk, device=dev)
            mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < sk)
            if window:
                mask &= kpos[None, :] > qpos[:, None] - window
            if mlstm:
                bk_blk = bias_k[:, ki * bk:(ki + 1) * bk]      # (b, bk, hkv)
                bias = (bq_blk.permute(0, 2, 3, 1)[..., :, None]
                        + bk_blk.permute(0, 2, 1)[:, :, None, None, :])
                bias = bias.masked_fill(~mask, NEG_INF)
                m_new = torch.maximum(m, bias.amax(-1))
                p = (logits * torch.exp(bias - m_new[..., None])
                     ).masked_fill(~mask, 0.0)
            else:
                score = logits.masked_fill(~mask, NEG_INF)
                m_new = torch.maximum(m, score.amax(-1))
                p = torch.exp(score - m_new[..., None]).masked_fill(~mask,
                                                                    0.0)
            alpha = torch.exp(m - m_new)
            den = den * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v32)
            m = m_new
        if mlstm:
            return acc / torch.clamp(den.abs(), min=1.0)[..., None]
        return acc / torch.clamp(den, min=1e-30)[..., None]

    remat = recording(q, k, v, bias_q, bias_k)
    outs = []
    for qi in range(nq):
        rows = slice(qi * bq, (qi + 1) * bq)
        args = (q[:, rows], bias_q[:, rows] if mlstm else None, k, v,
                bias_k, qi)
        outs.append(checkpoint(sweep, *args, use_reentrant=False)
                    if remat else sweep(*args))
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
