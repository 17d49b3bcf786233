"""Input checks shared by the CUDA kernel wrappers.

The kernels take raw pointers, so everything they assume — device,
dtype, shape, contiguity — is checked here before a launch.
"""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def refuse_autograd(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise, on any device, when autograd would record through the
    wrapper: a kernel's output has no ``grad_fn``, so a loss through it
    would give zero gradients to everything before it, silently.  The
    CPU raises too, though the plain version there could differentiate,
    so that a CPU run shows what the card would do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward, and an input requires "
            "grad; train through the plain attention (models.model."
            "forward(..., impl='train'), as loss_fn does) or call under "
            "torch.no_grad()")


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


def _check_operands(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> None:
    """dtype, contiguity and alignment, shared by every kernel."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernels read K/V rows as 16-byte vectors
    d = q.shape[-1]
    if (d * q.element_size()) % 16 or k.data_ptr() % 16 \
            or v.data_ptr() % 16:
        raise ValueError(f"head_dim {d} in {q.dtype} is not a whole number "
                         "of 16-byte vectors, or K/V are unaligned")


def check_inputs(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, n_heads: int) -> None:
    """q (..., H, D) against K/V pages (P, page, Hkv, D)."""
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"pages must be (P, page, Hkv, D), got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    hkv, d = k_pages.shape[2], k_pages.shape[3]
    if q.shape[-1] != d or n_heads % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    _check_operands(q, k_pages, v_pages)


def check_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q (B, Sq, H, D) against dense K/V (B, Sk, Hkv, D)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, Hkv, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    _check_operands(q, k, v)


def check_tile_head_dim(q: torch.Tensor) -> None:
    """Both bodies of the prefill kernels run on the tensor cores, with
    at most 256 columns of D: bf16 in steps of 16 along D (wgmma), D a
    multiple of 16; float32 in steps of 8 (mma.sync m16n8k8, 3xTF32), D
    a multiple of 8.  Any other D raises: no other body is left to take
    it."""
    d = q.shape[-1]
    step = 16 if q.dtype == torch.bfloat16 else 8
    if d % step or d > 256:
        raise ValueError(f"head_dim {d} in {str(q.dtype)[6:]} must be a "
                         f"multiple of {step} and at most 256")


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
