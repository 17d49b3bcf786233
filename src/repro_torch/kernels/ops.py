"""Kernel dispatch, the counterpart of ``repro/kernels/ops.py``.

``impl="kernel"`` goes to the kernel wrappers (the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors); ``impl="ref"`` goes
straight to the plain versions on any device, so a caller can hold one
against the other.  ``paged_prefill`` pads the chunk to a block
multiple as the JAX wrapper does (``paged_verify``, its speculative
lanes, to a multiple of 8); ``flash_attention`` pads nothing (the kernel
masks the ragged edges itself).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import flash_prefill as _flash
from repro_torch.kernels.paged_attention import paged_attention as _paged
from repro_torch.kernels.paged_prefill import paged_prefill as _paged_pre

IMPLS = ("kernel", "ref")
BLOCK_Q = 128   # the JAX wrapper's default q block, kept for its padding


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    *, impl: str = "kernel") -> torch.Tensor:
    """Decode attention over paged KV.  See kernels/ref.py for shapes."""
    _check_impl(impl)
    if impl == "ref":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       lengths)
    return _paged(q, k_pages, v_pages, block_tables, lengths)


def paged_prefill(q, k_pages, v_pages, block_tables, ctx_lens, chunk_lens,
                  *, impl: str = "kernel") -> torch.Tensor:
    """Chunked-prefill attention directly over paged KV (chunk K/V must
    already be in the pages).  Pads the chunk dim to a multiple of the
    q block; see kernels/ref.py for shapes."""
    _check_impl(impl)
    if impl == "ref":
        return ref.paged_prefill_ref(q, k_pages, v_pages, block_tables,
                                     ctx_lens, chunk_lens)
    s = q.shape[1]
    bq = min(BLOCK_Q, _round_up(s, 8))
    s_p = _round_up(s, bq)
    if s_p != s:
        q = F.pad(q, (0, 0, 0, 0, 0, s_p - s))
    out = _paged_pre(q.contiguous(), k_pages, v_pages, block_tables,
                     ctx_lens, chunk_lens)
    return out[:, :s]


def paged_verify(q, k_pages, v_pages, block_tables, ctx_lens, draft_lens,
                 *, impl: str = "kernel") -> torch.Tensor:
    """Speculative-verification attention: each decode row is a short
    multi-query chunk ``[last_token, draft_1..draft_d]`` at a dynamic
    context offset, the paged-prefill shape, so the lanes ride
    :func:`paged_prefill` (the lane width padded to a multiple of 8, as
    the JAX wrapper's one small q block pads it).  ``draft_lens`` counts
    valid rows per lane (1 + drafts; 0 marks an idle lane, whose rows
    come out as zeros)."""
    return paged_prefill(q, k_pages, v_pages, block_tables, ctx_lens,
                         draft_lens, impl=impl)


def flash_attention(q, k, v, lengths, *, window: int = 0, q_offset: int = 0,
                    impl: str = "kernel") -> torch.Tensor:
    """Causal/windowed prefill attention over dense K/V.  See
    kernels/ref.py for shapes."""
    _check_impl(impl)
    if impl == "ref":
        return ref.flash_prefill_ref(q, k, v, lengths, window=window,
                                     q_offset=q_offset)
    return _flash(q.contiguous(), k.contiguous(), v.contiguous(), lengths,
                  window=window, q_offset=q_offset)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m
