"""The elementwise gaps between the paged step's GEMMs, one kernel each:
the wrappers of the CUDA kernels in ``csrc/fused_elementwise.cu``, which
replace no TPU kernel (XLA fuses these chains there).

- ``add_rms_norm``: a residual add and the RMSNorm after it.
- ``rope_write_kv``: RoPE of q, and of k with v written straight into
  the K/V pages for the valid rows.
- ``gated_act``: ``act(gate) * up`` between the MLP's products.

For tensors on the CPU each wrapper computes the plain composition
that the paged model ran before these kernels (``ref.*_ref``); for
CUDA tensors it launches the kernel or raises.  On every device it
refuses inputs that require grad while autograd records: the kernels
have no backward.  ``launches`` counts kernel launches by kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, common, ref

launches = {"add_rms_norm": 0, "rope_write_kv": 0, "gated_act": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn(name: str):
    fn = getattr(build.load("fused_elementwise"), f"{name}_launch")
    fn.argtypes = {
        "add_rms_norm": [_P] * 5 + [_I, _I, ctypes.c_float, _I, _I, _P],
        "rope_write_kv": [_P] * 10 + [_I] * 8 + [_P],
        "gated_act": [_P] * 3 + [ctypes.c_longlong, _I, _I, _I, _P],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _vec(width: int, *tensors: torch.Tensor) -> bool:
    """True when ``width`` elements are whole 16-byte vectors and every
    tensor starts on a 16-byte boundary: the kernels then move 16 bytes
    a thread."""
    return (width * tensors[0].element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def _check_dtype(name: str, ref: torch.Tensor, *others: torch.Tensor):
    if ref.dtype not in common.DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {ref.dtype}")
    if any(t.dtype != ref.dtype for t in others):
        raise TypeError(f"{name}: every operand must be {ref.dtype}")


def _launched(name: str, err: int) -> None:
    common.raise_on_error(err, name)
    launches[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------ add + norm
def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor],
                 scale: torch.Tensor, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, delta: (..., d); scale: (d,).  Returns (x + delta rounded to
    x's dtype, its RMSNorm scaled by ``1 + scale``); without delta x
    itself and its norm."""
    operands = [t for t in (x, delta, scale) if t is not None]
    common.refuse_autograd("add_rms_norm", *operands)
    if common.on_cpu(*operands):
        return ref.add_rms_norm_ref(x, delta, scale, eps)
    d = x.shape[-1]
    _check_dtype("add_rms_norm", x, *operands)
    if delta is not None and delta.shape != x.shape:
        raise ValueError(f"delta {tuple(delta.shape)} is not x's "
                         f"{tuple(x.shape)}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    x = x.contiguous()
    delta = delta.contiguous() if delta is not None else None
    scale = scale.contiguous()
    h = torch.empty_like(x)
    x_out = x if delta is None else torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return x_out, h
    err = _fn("add_rms_norm")(
        x.data_ptr(), delta.data_ptr() if delta is not None else None,
        scale.data_ptr(), x_out.data_ptr(), h.data_ptr(), rows, d, eps,
        common.dtype_code(x), _vec(d, x_out, h, *operands), _stream(x))
    _launched("add_rms_norm", err)
    return x_out, h


# ------------------------------------------------------ RoPE + K/V write
def rope_write_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sin: torch.Tensor, cos: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  rows: torch.Tensor, pidx: torch.Tensor, slot: torch.Tensor,
                  dq: Optional[torch.Tensor] = None,
                  dv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (..., H, D) and k, v: (..., Hkv, D) over the same T rows, before
    RoPE; sin, cos: float32 (..., D // 2), a row each; k_pages, v_pages:
    (P, page, Hkv, D), written in place; rows, pidx, slot: (N,) integer:
    the valid row ``rows[i]``'s K/V go to slot ``slot[i]`` of page
    ``pidx[i]``, and no other slot is written.  dq, dv: LoRA deltas of q
    and v (RoPE is linear: q + dq is roped as a whole on the card, q and
    dq apart on the CPU).  Returns q, roped in place (q must be
    contiguous on the card)."""
    operands = [t for t in (q, k, v, sin, cos, k_pages, v_pages, rows, pidx,
                            slot, dq, dv) if t is not None]
    common.refuse_autograd("rope_write_kv", *operands)
    if common.on_cpu(*operands):
        return ref.rope_write_kv_ref(q, k, v, sin, cos, k_pages, v_pages,
                                     rows, pidx, slot, dq, dv)
    if not q.is_contiguous():
        raise ValueError("rope_write_kv: q must be contiguous (roped in "
                         "place)")
    h, d = q.shape[-2:]
    hkv = k.shape[-2]
    n_rows = q.numel() // (h * d) if h * d else 0
    _check_dtype("rope_write_kv", q, k, v, k_pages, v_pages,
                 *[t for t in (dq, dv) if t is not None])
    if (dq is not None and dq.shape != q.shape) \
            or (dv is not None and dv.shape != v.shape):
        raise ValueError("rope_write_kv: the deltas must be shaped as q "
                         "and v")
    if sin.dtype != torch.float32 or cos.dtype != torch.float32:
        raise TypeError("rope_write_kv: sin and cos must be float32")
    if d % 2 or k.shape != v.shape or k.shape[-1] != d \
            or k.numel() != n_rows * hkv * d \
            or sin.numel() != n_rows * (d // 2) or cos.shape != sin.shape:
        raise ValueError(f"rope_write_kv: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} and sin "
                         f"{tuple(sin.shape)} are not T rows of even D")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or tuple(k_pages.shape[2:]) != (hkv, d) \
            or not k_pages.is_contiguous() or not v_pages.is_contiguous():
        raise ValueError(f"pages must be contiguous (P, page, {hkv}, {d}), "
                         f"got {tuple(k_pages.shape)}")
    n_valid = rows.numel()
    if rows.dim() != 1 or pidx.shape != rows.shape \
            or slot.shape != rows.shape:
        raise ValueError("rows, pidx and slot must be (N,)")
    if dq is not None:
        q.add_(dq)
    if dv is not None:
        v = v + dv
    k, v, sin, cos = (t.contiguous() for t in (k, v, sin, cos))
    rows, pidx, slot = (t.long().contiguous() for t in (rows, pidx, slot))
    if n_rows + n_valid == 0:
        return q
    err = _fn("rope_write_kv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sin.data_ptr(),
        cos.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        rows.data_ptr(), pidx.data_ptr(), slot.data_ptr(), n_rows, n_valid,
        h, hkv, d, k_pages.shape[1], common.dtype_code(q),
        _vec(d // 2, q, k, v, k_pages, v_pages, sin, cos), _stream(q))
    _launched("rope_write_kv", err)
    return q


# ------------------------------------------------------ gated activation
def gated_act(gate: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    """act(gate) * up (act: "silu", else gelu with the tanh
    approximation, as ``layers.activation``), in float32, rounded once."""
    common.refuse_autograd("gated_act", gate, up)
    if common.on_cpu(gate, up):
        return ref.gated_act_ref(gate, up, act)
    _check_dtype("gated_act", gate, up)
    if gate.shape != up.shape:
        raise ValueError(f"gate {tuple(gate.shape)} and up "
                         f"{tuple(up.shape)} differ")
    gate, up = gate.contiguous(), up.contiguous()
    out = torch.empty_like(gate)
    n = gate.numel()
    if n == 0:
        return out
    err = _fn("gated_act")(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), n,
        int(act != "silu"), common.dtype_code(gate), _vec(n, gate, up, out),
        _stream(gate))
    _launched("gated_act", err)
    return out
