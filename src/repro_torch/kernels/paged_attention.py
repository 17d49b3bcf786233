"""Decode attention over a paged KV cache: the wrapper of the CUDA kernel
in ``csrc/paged_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_attention``.

For tensors on the CPU the wrapper computes the plain version
(``ref.paged_attention_ref``); for CUDA tensors it launches the kernel
or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.ref import paged_attention_ref

launches = 0


@functools.cache
def _fn():
    fn = build.load("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (P, page, Hkv, D); block_tables:
    (B, NB) int32; lengths: (B,) int32 -> (B, H, D)."""
    if common.on_cpu(q, k_pages, v_pages, block_tables, lengths):
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths)
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    common.check_inputs(q, k_pages, v_pages, h)
    common.check_index(block_tables, (b, nb), "block_tables")
    common.check_index(lengths, (b,), "lengths")
    out = torch.empty_like(q)
    if b == 0:                  # nothing to launch, nothing to count
        return out
    err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                b, h, hkv, d, page, nb, d ** -0.5, common.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    common.raise_on_error(err, "paged_attention")
    global launches
    launches += 1
    return out
