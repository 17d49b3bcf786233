"""The JAX package's PRNG written out in torch: ``jax.random``'s
threefry2x32 (the partitionable counter layout that
``jax_threefry_partitionable=True`` selects), its keys, bits, uniform,
normal and truncated-normal draws, bit for bit on any device.

Integer arithmetic is done in int64 masked to 32 bits (torch's uint32
supports few operations).  The float steps round as XLA's CPU backend
rounds them, since that is where the JAX package's draws are made:

- ``exp``, ``log`` and ``log1p`` are XLA's Cephes polynomials with
  fused multiply-adds (``_exp``, ``_log``, ``_log1p``), not the
  platform's libm; ``erf_inv`` is the polynomial the CHLO ``erf_inv``
  expands to, its products contracted into FMAs as LLVM contracts them;
- ``sqrt`` and quotients are taken in float64 and rounded once to
  float32, which gives the correctly rounded float32 result (torch's
  vectorized float32 ``sqrt`` on the CPU is not correctly rounded);
- denormal inputs read as zero and denormal results are flushed, as
  XLA's CPU threads run.

Each of these is a chain of elementwise torch operations, so the CPU
and a CUDA card give the same bits.  ``engine.sampling`` draws tokens
with it and ``models.params`` the weights.

Two things keep a large draw cheap without changing a bit: threefry
runs on int32 bit patterns (wrapping adds, masked right shifts), and a
float32 draw of at least ``TABLE_MIN`` values reads its result from a
table of the 2**23 values the top 23 random bits can give (a bfloat16
draw, 8 bits a value, from one of 256), built once per device and
bounds by the same elementwise chain.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = 1.1754943508222875e-38      # float32's smallest normal


# ------------------------------------------------------------ threefry
def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensors of uint32 values -> int32 tensors of the same bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 tensors of their uint32 values."""
    return x.long() & MASK


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry32(k1, k2, x1, x2):
    """Threefry-2x32 on int32 bit patterns: int32 adds wrap as uint32
    adds do, and the rotation masks the sign bits an arithmetic right
    shift brings in."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x = [x1 + k1, x2 + k2]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl32(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + (ks[(i + 2) % 3] + (i + 1))
    return x[0], x[1]


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters (x1, x2) under key
    (k1, k2): int64 tensors holding uint32 values, broadcast together.
    Returns the two uint32 output words as int64 tensors."""
    y1, y2 = _threefry32(*(_i32(t) for t in (k1, k2, x1, x2)))
    return _u32(y1), _u32(y2)


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


def _counts(n: int, device, offset: int = 0) -> torch.Tensor:
    """The low words of the flat counter iota from ``offset`` (the high
    words are 0 below 2**32 elements)."""
    if offset + n > 1 << 32:
        raise ValueError("at most 2**32 random words per key")
    return torch.arange(offset, offset + n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one (2,) key -> (num, 2): key i is the
    hash of the counter pair (0, i)."""
    i = _counts(num, key.device)
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y1, y2], -1)


def _bits32(keys: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """``random_bits`` as int32 bit patterns."""
    j = _i32(_counts(n, keys.device, offset))
    k = _i32(keys)
    y1, y2 = _threefry32(k[..., 0, None], k[..., 1, None],
                         torch.zeros_like(j), j)
    return y1 ^ y2


def random_bits(keys: torch.Tensor, n: int, offset: int = 0
                ) -> torch.Tensor:
    """32-bit ``random_bits`` for each of keys (..., 2) over a flat shape
    of n -> (..., n) int64 uint32 values: word j is the xor of the hash
    of the counter pair (0, j).  ``offset`` draws words offset..offset+n
    of a larger shape."""
    return _u32(_bits32(keys, n, offset))


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 denormals to (signed) zero."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0, offset: int = 0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` over a flat shape of n for each of
    keys (..., 2): the top 23 bits as a mantissa in [1, 2), minus 1,
    scaled (one FMA, as XLA contracts it), and held at or above
    ``minval``.  ``offset`` as in :func:`random_bits`."""
    return _uniform23((_bits32(keys, n, offset) >> 9) & 0x7FFFFF, minval,
                      maxval)


def _uniform23(mant: torch.Tensor, minval: float,
               maxval: float) -> torch.Tensor:
    """``uniform``'s values from the top 23 random bits (int32)."""
    floats = (mant | 0x3F800000).view(torch.float32) - 1.0
    lo, hi = _r32(minval, maxval)
    span = _r32(hi - lo)            # a float32 subtraction, rounded once
    return torch.clamp_min(_ftz(_fma(floats, span, lo)), lo)



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


# ------------------------------------------------ erf_inv, normal draws
_LOG1P_NUM = _r32(4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                  6.5787325942061044846969e0, 2.9911919328553073277375e1,
                  6.0949667980987787057556e1, 5.7112963590585538103336e1,
                  2.0039553499201281259648e1)
_LOG1P_DEN = _r32(1.0, 1.5062909083469192043167e1,
                  8.3047565967967209469434e1, 2.2176239823732856465394e2,
                  3.0909872225312059774938e2, 2.1642788614495947685003e2,
                  6.0118660497603843919306e1)
# Giles' single-precision erf_inv, w < 5 and w >= 5, highest power first
_ERF_INV_LO = _r32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_HI = _r32(-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = _r32(math.sqrt(2.0))
# per dtype, recorded from jax 0.9: normal's lower uniform bound
# nextafter(-1, 0); erf(-2 / sqrt 2) and erf(2 / sqrt 2) as XLA's CPU erf
# gives them (float32 bits 0xbf745a18, 0x3f745a18), the uniform range of
# truncated_normal(-2, 2); and its clip, nextafter(-2, inf) and
# nextafter(2, -inf)
_BOUNDS = {
    torch.float32: dict(next_m1=-0.9999999403953552,
                        erf=(-0.9544997215270996, 0.9544997215270996),
                        clip=(-1.9999998807907104, 1.9999998807907104)),
    torch.bfloat16: dict(next_m1=-0.99609375, erf=(-0.953125, 0.953125),
                         clip=(-1.9921875, 1.9921875)),
}


def _horner(x: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    """sum(c_i x^(n-i)), highest power first, one FMA a step."""
    r = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        r = _fma(r, x, c)
    return r


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a / b, correctly rounded on every device."""
    return (a.double() / b.double()).float()


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p of x > -1 as XLA's CPU backend computes it: a
    Cephes rational below |x| = sqrt(2) - 1, else log(1 + x)."""
    x2 = x * x
    small = _fma(x2, -0.5, (x * x2) * _div(_horner(x, _LOG1P_NUM),
                                           _horner(x, _LOG1P_DEN)))
    return torch.where(x.abs() < 0.41421356237309504880, x + small,
                       _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``lax.erf_inv`` of x in [-1, 1] as XLA's CPU backend
    computes it (``torch.erfinv`` rounds otherwise)."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERF_INV_LO[0], _ERF_INV_HI[0])
    for lo, hi in zip(_ERF_INV_LO[1:], _ERF_INV_HI[1:]):
        p = _fma(p, t, torch.where(lt, lo, hi))
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bfloat16 and back (one XLA bf16 op's result)."""
    return x.bfloat16().float()


def _uniform_bf16(bits: torch.Tensor, lo: float, hi: float
                  ) -> torch.Tensor:
    """bfloat16 ``jax.random.uniform`` (as float32 values) from the low 8
    random bits (int32) a value (bf16 has 7 mantissa bits, under jax's
    minimum of 8): the top 7 as the mantissa, every step rounded to
    bfloat16."""
    floats = _bf16(((bits >> 1) << 16 | 0x3F800000).view(torch.float32)
                   - 1.0)
    lo, hi = _bf16(torch.tensor([lo, hi])).tolist()
    span = _bf16(torch.tensor(hi - lo)).item()
    return torch.clamp_min(_bf16(_bf16(floats * span) + lo), lo)


# a float32 draw of at least this many values reads a table
TABLE_MIN = 1 << 20
_TABLES: dict = {}


def _values(idx: torch.Tensor, dtype, lo: float, hi: float, clip
            ) -> torch.Tensor:
    """sqrt(2) * erf_inv(uniform(lo, hi)), optionally clipped, as jax
    computes it in ``dtype``, of the random bits that decide a value:
    the top 23 (float32) or the low 8 (bfloat16), as int32."""
    if dtype == torch.bfloat16:
        y = _bf16(_bf16(erf_inv(_uniform_bf16(idx, lo, hi)))
                  * _bf16(torch.tensor(_SQRT2)).item())
    else:
        y = erf_inv(_uniform23(idx, lo, hi)) * _SQRT2
    return y if clip is None else torch.clamp(y, *clip)


def _table(device, dtype, lo: float, hi: float, clip,
           chunk: int = 1 << 21) -> torch.Tensor:
    """``_values`` of every index, built once per device and bounds."""
    k = (str(device), dtype, lo, hi, clip)
    if k not in _TABLES:
        n = 256 if dtype == torch.bfloat16 else 1 << 23
        idx = torch.arange(n, dtype=torch.int32, device=device)
        _TABLES[k] = torch.cat([_values(idx[s:s + chunk], dtype, lo, hi,
                                        clip)
                                for s in range(0, n, chunk)]).to(dtype)
    return _TABLES[k]


def _draw(key: torch.Tensor, shape, dtype, lo: float, hi: float,
          clip=None, chunk: int = 1 << 24) -> torch.Tensor:
    """sqrt(2) * erf_inv(uniform(lo, hi)) over ``shape``, optionally
    clipped, in float32 or bfloat16 as jax computes each, on the key's
    device.  The counters run over the whole flat shape; they are drawn
    ``chunk`` at a time, so the temporaries of a large leaf stay a few
    hundred MB.  Each value is a function of a few of its random bits:
    a bfloat16 draw, or a float32 draw of at least ``TABLE_MIN`` values,
    looks it up in ``_table``."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=key.device)
    table = (_table(key.device, dtype, lo, hi, clip)
             if dtype == torch.bfloat16 or n >= TABLE_MIN else None)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        bits = _bits32(key, m, s)
        idx = (bits & 0xFF if dtype == torch.bfloat16
               else (bits >> 9) & 0x7FFFFF)
        out[s:s + m] = (table[idx] if table is not None
                        else _values(idx, dtype, lo, hi, clip))
    return out.reshape(shape)


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: sqrt(2) times erf_inv
    of a uniform draw in [nextafter(-1, 0), 1)."""
    return _draw(key, tuple(shape), dtype, _bounds(dtype)["next_m1"], 1.0)


def truncated_normal(key: torch.Tensor, lower: float, upper: float, shape,
                     dtype=torch.float32) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, dtype)``
    for (lower, upper) = (-2, 2), the bounds the JAX package draws with:
    erf_inv of a uniform draw in [erf(-sqrt 2), erf(sqrt 2)), clipped to
    the open interval."""
    if (lower, upper) != (-2.0, 2.0):
        raise ValueError("truncated_normal is recorded for (-2, 2) only")
    b = _bounds(dtype)
    return _draw(key, tuple(shape), dtype, *b["erf"], b["clip"])


def _bounds(dtype) -> dict:
    if dtype not in _BOUNDS:
        raise TypeError(f"normal draws in float32 or bfloat16, not {dtype}")
    return _BOUNDS[dtype]
