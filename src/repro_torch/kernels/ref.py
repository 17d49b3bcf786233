"""Plain PyTorch versions of the port's attention kernels.

They compute, with dense gathers and a full softmax in float32, what
the CUDA kernels compute with paged, online-softmax loops.  The CPU
tests hold them against the JAX package, the kernel wrappers take them
for CPU tensors, and ``chip_smoke.py`` holds each kernel against them
on the card.  Shapes as in ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch

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
