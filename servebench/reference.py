"""The plain reference: a full causal forward pass in plain PyTorch.

No cache, no pages, no batching and no kernel of the program: the
published model over one whole sequence, layer by layer, from the
configuration file and the weights the benchmark drew.  It imports
nothing of the program.  ``Reference`` holds what decoder families
share (the embedding, RMSNorm, the precision of every linear layer, RoPE
on split halves, causal attention over blocks, the final norm and an
untied head); each family's module (``servebench/families/<family>.py``)
subclasses it with its ``layer``, and ``build`` picks the one that a
configuration's ``family`` names.

``precision="float32"`` is the yardstick: every product in float32 with
TF32 off, the weights widened from their served dtype.  ``"fp8"`` is the
control: the same pass with the inputs of every linear layer (per row)
and its weights (per output column) rounded to float8 e4m3 with a scale
each, and the keys and values (per token and head) too, as an fp8
serving path would store and multiply them; sums stay in float32.

Memory stays bounded at any length: attention runs over blocks of query
rows against the keys they may see, a family's MLP over blocks of rows
(``row_block``), and only the rows whose logits are asked for reach the
head.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

PRECISIONS = ("float32", "fp8")
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(FP8).float() * scale


def build(cfg: dict, weights: Dict, precision: str = "float32",
          **blocks) -> "Reference":
    """The reference of ``cfg``'s family."""
    from servebench.families import family
    return family(cfg).Reference(cfg, weights, precision, **blocks)


class Reference:
    """Logits of a configuration's model for whole token sequences; a
    family defines ``layer``."""

    def __init__(self, cfg: dict, weights: Dict, precision: str = "float32",
                 q_block: int = 512, row_block: int = 8192):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.cfg, self.w, self.precision = cfg, weights, precision
        self.q_block, self.row_block = q_block, row_block

    # ------------------------------------------------------------ pieces
    def _rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.cfg["rms_norm_eps"]) * (
            1.0 + scale.float())

    def _linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (N, din) times w (din, dout), w in its served dtype."""
        w = w.float()
        if self.precision == "fp8":
            x, w = fp8_round(x, -1), fp8_round(w, 0)
        return x @ w

    def _rope_tables(self, n: int, device) -> tuple:
        hd = self.cfg["head_dim"]
        half = hd // 2
        inv = float(self.cfg["rope_theta"]) ** (
            -torch.arange(half, dtype=torch.float64, device=device) / half)
        ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] \
            * inv[None]
        return torch.sin(ang).float(), torch.cos(ang).float()

    @staticmethod
    def _rope(x: torch.Tensor, sin: torch.Tensor,
              cos: torch.Tensor) -> torch.Tensor:
        """x (S, H, D): the halves of each head rotated by position."""
        x1, x2 = x.chunk(2, dim=-1)
        s, c = sin[:, None], cos[:, None]
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)

    def _attend(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """Causal attention of q (S, H, D) over k, v (S, Hkv, D)."""
        n, h, hd = q.shape
        hkv = k.shape[1]
        g = h // hkv
        kt = k.permute(1, 2, 0)                    # (Hkv, D, S)
        vv = v.permute(1, 0, 2)                    # (Hkv, S, D)
        pos = torch.arange(n, device=q.device)
        out = torch.empty_like(q)
        for a in range(0, n, self.q_block):
            b = min(a + self.q_block, n)
            m = b - a
            qb = q[a:b].reshape(m, hkv, g, hd).permute(1, 2, 0, 3)
            s = (qb.reshape(hkv, g * m, hd) @ kt[:, :, :b]) * hd ** -0.5
            s = s.view(hkv, g, m, b)
            s.masked_fill_(pos[None, :b] > pos[a:b, None], float("-inf"))
            p = torch.softmax(s, dim=-1).view(hkv, g * m, b)
            o = (p @ vv[:, :b]).view(hkv, g, m, hd)
            out[a:b] = o.permute(2, 0, 1, 3).reshape(m, h, hd)
        return out

    def layer(self, x: torch.Tensor, l: int, sin, cos) -> torch.Tensor:
        """Layer ``l`` over the rows x (S, d), in float32."""
        raise NotImplementedError

    # ------------------------------------------------------------- entry
    @torch.no_grad()
    def logits(self, tokens: List[int], first: int) -> torch.Tensor:
        """float32 logits (len(tokens) - first, V) at positions ``first``
        onwards of one causal pass over ``tokens``."""
        dev = self.w["embedding"].device
        ids = torch.tensor(tokens, dtype=torch.long, device=dev)
        with exact_float32():
            x = self.w["embedding"][ids].float()
            sin, cos = self._rope_tables(len(tokens), dev)
            for l in range(self.cfg["num_hidden_layers"]):
                x = self.layer(x, l, sin, cos)
            x = self._rms(x[first:], self.w["final_norm"])
            return self._linear(x, self.w["lm_head"])
