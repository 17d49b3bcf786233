"""Token sampling, the counterpart of ``repro/engine/sampling.py``:
greedy / temperature / top-k / top-p, batched, with the JAX package's
PRNG written out in torch so that both packages draw the same tokens.

The JAX package keys its draws with ``jax.random`` (threefry2x32, the
partitionable counter layout that ``jax_threefry_partitionable=True``
selects) and samples by the Gumbel-max trick.  This module ports each
step bit for bit, on the logits' device:

- ``threefry2x32``, ``prng_key`` (``jax.random.PRNGKey``), ``fold_in``,
  ``split``, ``random_bits`` (32-bit), ``uniform``, ``gumbel`` (mode
  ``"low"``) and ``categorical``;
- ``row_keys`` and ``sample``, the JAX package's two keying modes (a
  batch split of one key, or one key per (seed, absolute position)).

Integer arithmetic is done in int64 masked to 32 bits (torch's uint32
supports few operations).  The float steps round as XLA's CPU backend
rounds them, since that is where the JAX package's draws were made:

- ``exp`` and ``log`` are XLA's Cephes polynomials with fused
  multiply-adds (``_exp``, ``_log``), not the platform's libm;
- sums and cumulative sums follow the orders XLA's rewriters give them
  (``_xla_sum``: a tree of 32-wide windows; ``_xla_cumsum``: 16-wide
  tiles scanned recursively), each window added in order from zero;
- denormal inputs read as zero and denormal results are flushed, as
  XLA's CPU threads run.

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

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = 1.1754943508222875e-38      # float32's smallest normal


# ------------------------------------------------------------ threefry
def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters (x1, x2) under key
    (k1, k2): int64 tensors holding uint32 values, broadcast together.
    Returns the two uint32 output words as int64 tensors."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x = [(x1 + k1) & MASK, (x2 + k2) & MASK]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x[0], x[1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: a (2,) int64 key [hi, lo] of the
    seed (a 32-bit seed has hi 0, as in JAX without 64-bit mode)."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data (...) integers ->
    (..., 2): the hash of the counter pair (0, data)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y1, y2], -1)


def _counts(n: int, device) -> torch.Tensor:
    """The low words of the flat counter iota (the high words are 0
    below 2**32 elements)."""
    if n >= 1 << 32:
        raise ValueError("at most 2**32 random words per key")
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one (2,) key -> (num, 2): key i is the
    hash of the counter pair (0, i)."""
    i = _counts(num, key.device)
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y1, y2], -1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``random_bits`` for each of keys (..., 2) over a flat shape
    of n -> (..., n) int64 uint32 values: word j is the xor of the hash
    of the counter pair (0, j)."""
    j = _counts(n, keys.device)
    k1, k2 = keys[..., 0, None], keys[..., 1, None]
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(j), j)
    return y1 ^ y2


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 denormals to (signed) zero."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` over a flat shape of n for each of
    keys (..., 2): the top 23 bits as a mantissa in [1, 2), minus 1,
    scaled, and held at or above ``minval``."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _r32(minval, maxval)
    span = _r32(hi - lo)            # a float32 subtraction, rounded once
    return torch.clamp_min(_ftz(floats * span + lo), lo)


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


# ------------------------------------------ XLA's CPU float32 arithmetic
def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add a * b + c, rounded once (a, b, c
    float32 tensors or float32-exact Python floats, one of a and b a
    tensor): the product is exact in float64, the sum's rounding error
    is recovered exactly (two-sum) and folded in by rounding to odd, so
    the final rounding to float32 is the correct one."""
    p = _f64(a) * _f64(b)
    c = _f64(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    sb = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    sb = torch.where((err != 0) & (sb & 1 == 0), sb + step, sb)
    return sb.view(torch.float64).float()


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else x


def _r32(*vs: float):
    """Constants rounded to float32, as XLA's emitter rounds them."""
    out = tuple(torch.tensor(vs, dtype=torch.float32).tolist())
    return out if len(out) > 1 else out[0]


_EXP_LO, _EXP_HI = _r32(-88.3762626647949, 88.3762626647950)
_LOG2E, _LN2_HI, _LN2_LO = _r32(1.44269504088896341, 0.693359375,
                                -2.12194440e-4)
_SQRT_HALF = _r32(0.707106781186547524)
_EXP_P = _r32(1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
              4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_LOG_P = _r32(7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
              -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
              2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA's CPU backend computes it (Cephes, FMAs)."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    fx = torch.floor(_fma(x, _LOG2E, 0.5))
    r = _fma(-fx, _LN2_HI, x)
    r = _fma(-fx, _LN2_LO, r)
    z = r * r
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = _fma(y, r, p)
    y = _fma(y, z, r) + 1.0
    pow2n = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * pow2n)


def _log(x: torch.Tensor) -> torch.Tensor:
    """float32 log of positive normal x as XLA's CPU backend computes it
    (Cephes, FMAs)."""
    x = torch.clamp_min(x, _TINY)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    m = m - 1.0 + torch.where(small, m, 0.0)
    e = e - small.float()
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, m3, y1)
    y = _fma(y, m3, y2)
    y = _fma(y, m3, e * _LN2_LO)
    m = m - m2 * 0.5
    return (m + y) + e * _LN2_HI


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
    rows = torch.nonzero(temperature > 0).squeeze(1)
    if rows.numel() == 0:
        return greedy.to(torch.int32)
    if keys is None:
        keys = split(key, b)
    keys = keys[rows.to(keys.device)].to(dev)
    t = torch.clamp_min(temperature[rows], 1e-4)[:, None].to(dev)
    rows = rows.to(dev)
    scaled = _ftz(_ftz(logits[rows]) / t)
    if top_k:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled >= kth, scaled, -torch.inf)
    if top_p is not None:
        top_p = torch.as_tensor(top_p, dtype=torch.float32).reshape(b)
        top_p = top_p[rows.to(top_p.device)].to(dev)
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
