"""Input checks shared by the CUDA kernel wrappers.

The kernels take raw pointers, so everything they assume — device,
dtype, shape, contiguity — is checked here before a launch.
"""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then computes
    the plain version), False when all lie on one CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def check_inputs(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, n_heads: int) -> None:
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"pages must be (P, page, Hkv, D), got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    hkv, d = k_pages.shape[2], k_pages.shape[3]
    if q.shape[-1] != d or n_heads % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernels read K/V rows as 16-byte vectors
    if (d * q.element_size()) % 16 or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError(f"head_dim {d} in {q.dtype} is not a whole number "
                         "of 16-byte vectors, or the pages are unaligned")


def check_index(t: torch.Tensor, shape: tuple, name: str) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor of "
                         f"shape {shape}, got {t.dtype} {tuple(t.shape)}")


def dtype_code(t: torch.Tensor) -> int:
    return DTYPE_CODES[t.dtype]


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err}")
