"""Token sampling, the counterpart of ``repro/engine/sampling.py``:
greedy / temperature / top-k / top-p, batched, with the JAX package's
PRNG written out in torch so that both packages draw the same tokens.

The JAX package keys its draws with ``jax.random`` and samples by the
Gumbel-max trick.  ``repro_torch.random`` ports the PRNG (threefry2x32,
keys, bits, ``uniform``, XLA's CPU ``exp`` and ``log``); this module
ports the rest bit for bit, on the logits' device:

- ``gumbel`` (mode ``"low"``) and ``categorical``;
- ``row_keys`` and ``sample``, the JAX package's two keying modes (a
  batch split of one key, or one key per (seed, absolute position));
- sums and cumulative sums in the orders XLA's rewriters give them
  (``_xla_sum``: a tree of 32-wide windows; ``_xla_cumsum``: 16-wide
  tiles scanned recursively), each window added in order from zero.

Each of these is a chain of elementwise torch operations, so the CPU
and a CUDA card give the same bits.  The nucleus filter keeps the
reference's behaviour at ``top_p = 1.0``: where the float32 cumulative
probability stays below 1.0 at every index, the cutoff index falls off
the end, the cutoff reads NaN, every logit is masked and the draw is
token 0 (the JAX package's fault, reproduced so the two agree).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.random import (_TINY, _exp, _ftz, _log, fold_in,  # noqa: F401
                                prng_key, random_bits, split, threefry2x32,
                                uniform)


# --------------------------------------------------------------- draws
def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """float32 ``jax.random.gumbel`` (mode ``"low"``) over n for each of
    keys (..., 2): -log(-log(u)) for u uniform in [tiny, 1)."""
    return -_log(-_log(uniform(keys, n, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` row by row: keys (B, 2), logits (B, V)
    float32 -> (B,) int64, the first index of the maximum of
    logits + gumbel noise."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(_ftz(g + logits), dim=-1)


# ------------------------------------------- XLA's CPU reduction orders
def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of (B, n) float32 in XLA's CPU order: while n > 32, pad
    to a multiple of 32 (half the zeros in front) and sum each 32-wide
    window in order; then sum what is left in order."""
    while x.shape[1] > 32:
        pad = -x.shape[1] % 32
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _sum_in_order(x.reshape(x.shape[0], -1, 32))
    return _sum_in_order(x)


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum the last axis from zero, one element at a time."""
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive row cumsum of (B, n) float32 in XLA's CPU order: 16-wide
    tiles scanned in order, each tile then offset by the (recursively
    scanned) sum of the tiles before it."""
    b, n = x.shape
    if n <= 16:
        return _scan_in_order(x)
    t = -(-n // 16)
    tiles = torch.nn.functional.pad(x, (0, t * 16 - n)).reshape(b, t, 16)
    local = _scan_in_order(tiles)                       # (B, T, 16)
    totals = local[..., -1]                             # (B, T)
    if t <= 16:
        before = _scan_in_order(totals)[:, :-1]
    else:
        before = _xla_cumsum(totals)[:, :-1]
    before = torch.nn.functional.pad(before, (1, 0))
    return (local + before[..., None]).reshape(b, t * 16)[:, :n]


def _scan_in_order(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of the last axis, one element at a time."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


# ---------------------------------------------------------------- keys
def row_keys(seeds, positions) -> torch.Tensor:
    """One key per row: fold the request's sampling seed, then the
    absolute token position, into ``PRNGKey(0)``.  seeds, positions:
    (B,) integers (tensors, arrays or lists) -> (B, 2)."""
    positions = torch.as_tensor(positions)
    seeds = torch.as_tensor(seeds, device=positions.device)
    root = prng_key(0, positions.device).expand(seeds.shape[0], 2)
    return fold_in(fold_in(root, seeds), positions)


# -------------------------------------------------------------- sample
def sample(logits: torch.Tensor, key: Optional[torch.Tensor],
           temperature: Union[torch.Tensor, Sequence[float]],
           top_k: int = 0, top_p=None,
           keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V); temperature (B,), <= 0 is greedy; top_p (B,) or
    None.  ``keys`` (B, 2), e.g. from :func:`row_keys`, overrides the
    batch-order-dependent ``split(key, B)``.  Returns (B,) int32 on the
    logits' device.

    Greedy rows take the first index of the float32 maximum; the other
    rows are drawn as the JAX package draws them (the greedy-only
    batch skips the draw: its tokens do not depend on it)."""
    b, v = logits.shape
    dev = logits.device
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    # which rows sample is decided on the host: a greedy batch costs one
    # argmax on the device
    temperature = torch.as_tensor(temperature, dtype=torch.float32
                                  ).reshape(b).cpu()
    rows_h = torch.nonzero(temperature > 0).squeeze(1)
    if rows_h.numel() == 0:
        return greedy.to(torch.int32)
    if keys is None:
        keys = split(key, b)
    # what the host made goes over with non_blocking copies, which do
    # not wait for the device's queue (the async loop's dispatch samples)
    keys = keys[rows_h.to(keys.device, non_blocking=True)].to(
        dev, non_blocking=True)
    t = torch.clamp_min(temperature[rows_h], 1e-4)[:, None].to(
        dev, non_blocking=True)
    rows = rows_h.to(dev, non_blocking=True)
    scaled = _ftz(_ftz(logits[rows]) / t)
    if top_k:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled >= kth, scaled, -torch.inf)
    if top_p is not None:
        top_p = torch.as_tensor(top_p, dtype=torch.float32).reshape(b)
        top_p = top_p[rows_h.to(top_p.device, non_blocking=True)].to(
            dev, non_blocking=True)
        sorted_ = torch.sort(scaled, dim=-1, descending=True).values
        un = _exp(_ftz(sorted_ - sorted_[:, :1]))
        probs = _ftz(un / _xla_sum(un)[:, None])
        csum = _xla_cumsum(probs)
        cutoff_idx = torch.sum(csum < top_p[:, None], dim=-1)
        # an index past the end reads NaN (jnp.take_along_axis's fill),
        # which masks every logit: the reference's top_p = 1.0 fault
        cutoff = torch.gather(
            sorted_, 1, torch.clamp_max(cutoff_idx, v - 1)[:, None])
        cutoff = torch.where(cutoff_idx[:, None] >= v, torch.nan, cutoff)
        scaled = torch.where(scaled >= cutoff, scaled, -torch.inf)
    out = greedy.clone()
    out[rows] = categorical(keys, scaled)
    return out.to(torch.int32)
