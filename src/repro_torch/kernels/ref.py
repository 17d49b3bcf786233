"""Plain PyTorch versions of the port's kernels.

The attention references compute, with dense gathers and a full
softmax in float32, what the CUDA kernels compute with tiled,
online-softmax loops; shapes as in ``repro/kernels/ref.py``.  The
elementwise references are the chains of ``models.layers`` ops
(``rms_norm``, ``apply_rope``, ``activation``) that the fused kernels
replace, op for op.  The CPU tests hold them against the JAX package
and ``models.layers``, the kernel wrappers take them for CPU tensors,
and ``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    q: (B, H, D); k_pages/v_pages: (P, page, Hkv, D); block_tables:
    (B, NB) int32; lengths: (B,) int32 tokens in cache.  Returns
    (B, H, D).  A length-0 row gives zeros, as the kernels do (the JAX
    oracle averages V uniformly there instead).
    """
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    g = h // hkv
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, nb * page, hkv, d).float()
    v = v_pages[bt].reshape(b, nb * page, hkv, d).float()
    qf = (q.float() * d ** -0.5).reshape(b, hkv, g, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k)
    pos = torch.arange(nb * page, device=q.device)
    valid = pos[None] < lengths[:, None]                        # (B, K)
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * (lengths > 0)[:, None, None, None]
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v)
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              lengths: torch.Tensor,
                              pages_per_split: int) -> torch.Tensor:
    """The arithmetic of the split ``paged_attention`` kernel, in plain
    float32: each split of ``pages_per_split`` pages gives its running
    max ``m``, sum ``l`` and accumulator over its live keys; the splits
    merge in split order, weighted by ``exp(m - max m)``; a length-0 row
    gives zeros.  Shapes as ``paged_attention_ref``, which it equals up
    to rounding.  A yardstick for the kernel's split; the main path
    never calls it."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    g = h // hkv
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, nb * page, hkv, d).float()
    v = v_pages[bt].reshape(b, nb * page, hkv, d).float()
    qf = (q.float() * d ** -0.5).reshape(b, hkv, g, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k)
    valid = torch.arange(nb * page, device=q.device)[None] < lengths[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    span = pages_per_split * page
    parts = []
    for lo in range(0, nb * page, span):
        lg, live = logits[..., lo:lo + span], valid[:, lo:lo + span]
        m = lg.max(-1).values                                   # (B,Hkv,G)
        p = torch.exp(lg - m[..., None]) * live[:, None, None, :]
        parts.append((m, p.sum(-1),
                      torch.einsum("bhgk,bkhd->bhgd", p, v[:, lo:lo + span])))
    top = torch.stack([m for m, _, _ in parts]).max(0).values
    den = torch.zeros_like(top)
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:                                     # split order
        w = torch.exp(m - top)
        den = den + l * w
        num = num + acc * w[..., None]
    out = num / den.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def paged_prefill_ref(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_tables: torch.Tensor,
                      ctx_lens: torch.Tensor,
                      chunk_lens: torch.Tensor) -> torch.Tensor:
    """Chunked-prefill attention over a paged KV cache.

    q: (B, S, H, D), row j of request b at absolute position
    ``ctx_lens[b] + j``; the chunk's own K/V are already in the pages.
    Rows ``>= chunk_lens[b]`` are zero.  Returns (B, S, H, D).
    """
    b, s, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    g = h // hkv
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, nb * page, hkv, d).float()
    v = v_pages[bt].reshape(b, nb * page, hkv, d).float()
    rows = torch.arange(s, device=q.device)
    qpos = ctx_lens[:, None] + rows[None]                       # (B, S)
    kpos = torch.arange(nb * page, device=q.device)
    total = (ctx_lens + chunk_lens)[:, None, None]
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < total)
            & (rows[None, :, None] < chunk_lens[:, None, None]))
    qf = (q.float() * d ** -0.5).reshape(b, s, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * mask.any(-1)[:, None, None, :, None]
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, s, h, d).to(q.dtype)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, *, window: int = 0,
                      q_offset: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) prefill attention over dense
    K/V.

    q: (B, Sq, H, D), row i at absolute position ``q_offset + i``; k, v:
    (B, Sk, Hkv, D); lengths: (B,) int32 valid keys.  A row with no
    valid key (``qpos >= lengths`` under a window) is zero.  Returns
    (B, Sq, H, D).
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    mask = mask[None] & (kpos[None, None, :] < lengths[:, None, None])
    qf = (q.float() * d ** -0.5).reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * mask.any(-1)[:, None, None, :, None]
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


# ------------------------------------------------------------ elementwise
def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    """``layers.rms_norm`` of whole rows: float32, scaled by 1 + scale."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dtype)


def _rope(x: torch.Tensor, sin: torch.Tensor,
          cos: torch.Tensor) -> torch.Tensor:
    """``layers.apply_rope``: split halves rotated in float32; x: (..., S,
    H, D), sin/cos: (..., S, D // 2)."""
    dtype = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    sin, cos = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dtype)


def add_rms_norm_ref(x: torch.Tensor, delta: Optional[torch.Tensor],
                     scale: torch.Tensor, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + delta, rms_norm(x + delta)); without delta, (x, rms_norm(x))."""
    if delta is not None:
        x = x + delta
    return x, _rms_norm(x, scale, eps)


def rope_write_kv_ref(q, k, v, sin, cos, k_pages, v_pages, rows, pidx,
                      slot, dq=None, dv=None) -> torch.Tensor:
    """RoPE of q and k, q + rope(dq) and v + dv where deltas are given,
    then ``pages[pidx[i], slot[i]] = k/v[rows[i]]``.  Returns q, roped in
    place."""
    roped = _rope(q, sin, cos)
    k = _rope(k, sin, cos)
    if dq is not None:
        roped = roped + _rope(dq, sin, cos)
    if dv is not None:
        v = v + dv
    hkv, d = k.shape[-2:]
    k_pages[pidx, slot] = k.reshape(-1, hkv, d)[rows].to(k_pages.dtype)
    v_pages[pidx, slot] = v.reshape(-1, hkv, d)[rows].to(v_pages.dtype)
    return q.copy_(roped)


def gated_act_ref(gate: torch.Tensor, up: torch.Tensor,
                  act: str) -> torch.Tensor:
    """act(gate) * up: silu, or gelu with the tanh approximation."""
    g = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return g * up
