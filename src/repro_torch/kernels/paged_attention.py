"""Decode attention over a paged KV cache: the wrapper of the CUDA kernel
in ``csrc/paged_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_attention``.

For tensors on the CPU the wrapper computes the plain version
(``ref.paged_attention_ref``); for CUDA tensors it launches the kernel
or raises.  On every device it refuses inputs that require grad while
autograd records: the kernel has no backward.  ``launches`` counts
kernel launches: one a call, the combine of the splits included.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.ref import paged_attention_ref

launches = 0

MAX_GROUP = 16          # query heads a KV head (glm4-9b's 16)
MAX_HEAD_DIM = 256
WAVES = 2               # blocks the planner aims for, in multiples of SMs
MIN_SPLIT_TOKENS = 64   # the least work a split gets (4 pages of 16)
MAX_SPLITS = 128        # the kernel's combine holds 4 splits a lane


def split_plan(batch: int, kv_heads: int, nb: int, page: int,
               num_sms: int = 132) -> tuple:
    """How the kernel splits each sequence's pages across blocks:
    ``(pages_per_split, n_splits)``, from shapes the host knows without
    a sync.  The grid is ``(batch, kv_heads, n_splits)``; split ``s``
    covers pages ``[s * pps, (s + 1) * pps)`` of the block table.

    One split (``pps = nb``) when ``batch * kv_heads`` blocks already
    fill the card or the table is too narrow to split; else enough
    splits for about ``WAVES`` blocks an SM, each of at least
    ``MIN_SPLIT_TOKENS`` tokens, and at most ``MAX_SPLITS`` splits.
    Splits past a row's live pages return at once in the kernel, which
    computes the live count from ``lengths`` on the device."""
    min_pps = max(1, -(-MIN_SPLIT_TOKENS // page))
    blocks = batch * kv_heads
    if blocks >= num_sms or nb <= min_pps:
        return max(nb, 1), 1
    target = -(-WAVES * num_sms // blocks)
    pps = max(min_pps, -(-nb // target), -(-nb // MAX_SPLITS))
    return pps, -(-nb // pps)


@functools.cache
def _fn():
    fn = build.load("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The split combine's ticket counters, one int32 per (row, KV head), a
# buffer per device, zeroed when it is made or grown and left at zero by
# every launch (the last split of a row resets its counter).  Calls share
# it, so they must run on one stream at a time, as the engine's do.
_counters: dict = {}


def _ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (P, page, Hkv, D); block_tables:
    (B, NB) int32; lengths: (B,) int32 -> (B, H, D), written into
    ``out`` where one is given."""
    common.refuse_autograd("paged_attention", q, k_pages, v_pages)
    if common.on_cpu(q, k_pages, v_pages, block_tables, lengths):
        return common.into(out, paged_attention_ref(
            q, k_pages, v_pages, block_tables, lengths))
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    common.check_inputs(q, k_pages, v_pages, h)
    common.check_index(block_tables, (b, nb), "block_tables")
    common.check_index(lengths, (b,), "lengths")
    g = h // hkv
    if g > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention kernel takes H / Hkv <= "
                         f"{MAX_GROUP} and head_dim <= {MAX_HEAD_DIM}, got "
                         f"{g} and {d}")
    out = common.output_like(q, out)
    if b == 0:                  # nothing to launch, nothing to count
        return out
    pps, n_splits = split_plan(b, hkv, nb, page, _num_sms(q.device.index))
    ws = counters = None
    if n_splits > 1:
        ws = torch.empty((b, hkv, n_splits, g, d + 2), dtype=torch.float32,
                         device=q.device)
        counters = _ticket_counters(q.device, b * hkv)
    err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                ws.data_ptr() if ws is not None else None,
                counters.data_ptr() if counters is not None else None,
                b, h, hkv, d, page, nb, pps, n_splits, d ** -0.5,
                common.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    common.raise_on_error(err, "paged_attention")
    global launches
    launches += 1
    return out
