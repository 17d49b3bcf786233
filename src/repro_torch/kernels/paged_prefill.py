"""Chunked-prefill attention straight over a paged KV cache: the wrapper
of the CUDA kernel in ``csrc/paged_prefill.cu``, which replaces the
Pallas TPU kernel ``repro/kernels/paged_prefill.py::paged_prefill``.

For tensors on the CPU the wrapper computes the plain version
(``ref.paged_prefill_ref``); for CUDA tensors it launches the kernel or
raises.  On every device it refuses inputs that require grad while
autograd records: the kernel has no backward.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.ref import paged_prefill_ref

launches = 0


@functools.cache
def _fn():
    fn = build.load("paged_prefill").paged_prefill_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, block_tables: torch.Tensor,
                  ctx_lens: torch.Tensor,
                  chunk_lens: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, S, H, D) chunk queries; k_pages/v_pages: (P, page, Hkv,
    D), already holding the chunk's K/V; block_tables: (B, NB) int32;
    ctx_lens/chunk_lens: (B,) int32.  Returns (B, S, H, D) with rows
    ``>= chunk_lens[b]`` zeroed, written into ``out`` where one is
    given."""
    common.refuse_autograd("paged_prefill", q, k_pages, v_pages)
    if common.on_cpu(q, k_pages, v_pages, block_tables, ctx_lens,
                     chunk_lens):
        return common.into(out, paged_prefill_ref(
            q, k_pages, v_pages, block_tables, ctx_lens, chunk_lens))
    b, s, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    common.check_inputs(q, k_pages, v_pages, h)
    common.check_tile_head_dim(q)
    common.check_index(block_tables, (b, nb), "block_tables")
    common.check_index(ctx_lens, (b,), "ctx_lens")
    common.check_index(chunk_lens, (b,), "chunk_lens")
    out = common.output_like(q, out)
    if b == 0 or s == 0:        # nothing to launch, nothing to count
        return out
    err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), ctx_lens.data_ptr(),
                chunk_lens.data_ptr(), out.data_ptr(), b, s, h, hkv, d, page,
                nb, d ** -0.5, common.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    common.raise_on_error(err, "paged_prefill")
    global launches
    launches += 1
    return out
