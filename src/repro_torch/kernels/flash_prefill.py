"""Causal, optionally sliding-window, flash attention over dense K/V: the
wrapper of the CUDA kernel in ``csrc/flash_prefill.cu``, which replaces
the Pallas TPU kernel ``repro/kernels/flash_prefill.py::flash_prefill``.

For tensors on the CPU the wrapper computes the plain version
(``ref.flash_prefill_ref``); for CUDA tensors it launches the kernel or
raises.  On every device it refuses inputs that require grad while
autograd records: the kernel has no backward.  ``launches`` counts kernel
launches, and ``launches_by_window`` counts them by their ``window``
(0: none).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.ref import flash_prefill_ref

launches = 0
launches_by_window: dict = {}


@functools.cache
def _fn():
    fn = build.load("flash_prefill").flash_prefill_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, *, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D), row i at absolute position ``q_offset + i``;
    k, v: (B, Sk, Hkv, D); lengths: (B,) int32 valid keys; ``window``
    > 0 keeps the keys ``kpos > qpos - window``.  Returns (B, Sq, H, D);
    a row that sees no key is zero."""
    if window < 0 or q_offset < 0:
        raise ValueError(f"window ({window}) and q_offset ({q_offset}) "
                         "must be >= 0")
    common.refuse_autograd("flash_prefill", q, k, v)
    if common.on_cpu(q, k, v, lengths):
        return flash_prefill_ref(q, k, v, lengths, window=window,
                                 q_offset=q_offset)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    common.check_dense(q, k, v)
    common.check_tile_head_dim(q)
    common.check_index(lengths, (b,), "lengths")
    out = torch.empty_like(q)
    if b == 0 or sq == 0:       # nothing to launch, nothing to count
        return out
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), b, sq, sk, h, hkv, d, window, q_offset,
                d ** -0.5, common.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    common.raise_on_error(err, "flash_prefill")
    global launches
    launches += 1
    launches_by_window[window] = launches_by_window.get(window, 0) + 1
    return out
