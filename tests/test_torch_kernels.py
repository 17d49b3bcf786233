"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their plain versions; the JAX
kernels run in interpret mode, as ``repro.kernels.ops`` runs them here.
Both see the same seeded numpy inputs.  Tolerances are the JAX tests':
float32 2e-5 (decode) / 3e-5 (prefill), bfloat16 2e-2 / 3e-2.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py`` (this file imports JAX, which the machine with
the card does not have).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jpaged  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import paged_prefill as pp_mod  # noqa: E402

torch.set_num_threads(1)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

PAGED_CASES = [
    # (B, H, Hkv, D, page, NB, dtype) — tests/test_kernels.py:21
    (4, 8, 4, 64, 16, 8, "float32"),
    (2, 8, 8, 128, 16, 4, "float32"),     # MHA
    (3, 16, 2, 64, 32, 4, "float32"),     # high group ratio
    (1, 4, 1, 256, 16, 8, "float32"),     # MQA, big head
    (4, 8, 4, 64, 16, 8, "bfloat16"),     # serving dtype
]

PREFILL_CASES = [
    # (B, H, Hkv, D, page) — tests/test_paged_prefill.py:27
    (2, 4, 4, 32, 8),
    (1, 8, 4, 64, 16),
    (2, 8, 2, 32, 16),
    (1, 4, 4, 64, 64),
    (2, 8, 2, 64, 64),
    (1, 8, 4, 32, 8),
]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (rounded once)."""
    j = jnp.asarray(a, JAX_DTYPES[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DTYPES[dtype])
    return j, t


def _ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def _decode_inputs(rng, b, h, hkv, d, page, nb, dtype, lengths=None):
    p = b * nb + 3
    q = _pair(rng.normal(size=(b, h, d)), dtype)
    kp = _pair(rng.normal(size=(p, page, hkv, d)), dtype)
    vp = _pair(rng.normal(size=(p, page, hkv, d)), dtype)
    bt = _ints(rng.permutation(p)[:b * nb].reshape(b, nb))
    if lengths is None:
        lengths = rng.integers(1, nb * page + 1, b)
    return q, kp, vp, bt, _ints(lengths)


def _prefill_inputs(rng, b, h, hkv, d, page, s=24, cap=192):
    nb = cap // page
    p = b * nb + 3
    kp = _pair(rng.normal(size=(p, page, hkv, d)), "float32")
    vp = _pair(rng.normal(size=(p, page, hkv, d)), "float32")
    bt = _ints(rng.permutation(p)[:b * nb].reshape(b, nb))
    ctx = _ints(rng.integers(0, cap - s + 1, b))
    chunk = _ints(rng.integers(1, s + 1, b))
    q = _pair(rng.normal(size=(b, s, h, d)), "float32")
    return q, kp, vp, bt, ctx, chunk


@pytest.mark.parametrize("b,h,hkv,d,page,nb,dtype", PAGED_CASES)
def test_paged_attention_matches_jax(b, h, hkv, d, page, nb, dtype):
    rng = np.random.default_rng(0)
    args = _decode_inputs(rng, b, h, hkv, d, page, nb, dtype)
    out = pa_mod.paged_attention(*(t for _, t in args))
    _close(out, jpaged(*(j for j, _ in args)),
           2e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("lengths", [[1, 1], [0, 37]],
                         ids=["length_one", "length_zero_row"])
def test_paged_attention_short_rows_match_jax(lengths):
    """A single-token cache, and an idle row (length 0) that the Pallas
    kernel and the port both answer with zeros."""
    rng = np.random.default_rng(1)
    args = _decode_inputs(rng, 2, 4, 2, 64, 16, 4, "float32", lengths)
    out = pa_mod.paged_attention(*(t for _, t in args))
    _close(out, jpaged(*(j for j, _ in args)), 2e-5)
    if lengths[0] == 0:
        assert torch.all(out[0] == 0)


@pytest.mark.parametrize("b,h,hkv,d,page", PREFILL_CASES)
def test_paged_prefill_matches_jax(b, h, hkv, d, page):
    rng = np.random.default_rng(7)
    args = _prefill_inputs(rng, b, h, hkv, d, page)
    out = ops.paged_prefill(*(t for _, t in args))
    _close(out, jops.paged_prefill(*(j for j, _ in args)), 3e-5)


def test_paged_prefill_zero_ctx_matches_jax_and_flash():
    """A first chunk (ctx=0): the port equals the Pallas kernel and the
    JAX package's contiguous flash-prefill oracle."""
    rng = np.random.default_rng(8)
    b, s, h, hkv, d, page = 1, 32, 4, 2, 32, 8
    nb = s // page
    kp = _pair(rng.normal(size=(nb + 1, page, hkv, d)), "float32")
    vp = _pair(rng.normal(size=(nb + 1, page, hkv, d)), "float32")
    q = _pair(rng.normal(size=(b, s, h, d)), "float32")
    bt, ctx, chunk = _ints([range(nb)]), _ints([0]), _ints([s])
    args = (q, kp, vp, bt, ctx, chunk)
    out = ops.paged_prefill(*(t for _, t in args))
    _close(out, jops.paged_prefill(*(j for j, _ in args)), 3e-5)
    flash = jref.flash_prefill_ref(
        q[0], kp[0][:nb].reshape(1, s, hkv, d),
        vp[0][:nb].reshape(1, s, hkv, d), jnp.full(b, s, jnp.int32))
    _close(out, flash, 3e-5)


def test_paged_prefill_padding_rows_are_zero():
    rng = np.random.default_rng(9)
    b, s, h, hkv, d, page, nb = 2, 16, 4, 2, 32, 8, 4
    kp = _pair(rng.normal(size=(b * nb + 1, page, hkv, d)), "float32")
    vp = _pair(rng.normal(size=(b * nb + 1, page, hkv, d)), "float32")
    q = _pair(rng.normal(size=(b, s, h, d)), "float32")
    bt = _ints(np.arange(b * nb).reshape(b, nb))
    args = (q, kp, vp, bt, _ints([8, 0]), _ints([5, 12]))
    out = ops.paged_prefill(*(t for _, t in args))
    _close(out, jops.paged_prefill(*(j for j, _ in args)), 3e-5)
    for i, c in enumerate([5, 12]):
        assert torch.all(out[i, c:] == 0)
        assert torch.any(out[i, :c] != 0)


def test_paged_prefill_bf16_matches_jax():
    rng = np.random.default_rng(10)
    b, h, hkv, d, page, s, nb = 2, 8, 4, 64, 16, 24, 12
    p = b * nb + 3
    kp = _pair(rng.normal(size=(p, page, hkv, d)), "bfloat16")
    vp = _pair(rng.normal(size=(p, page, hkv, d)), "bfloat16")
    q = _pair(rng.normal(size=(b, s, h, d)), "bfloat16")
    bt = _ints(rng.permutation(p)[:b * nb].reshape(b, nb))
    args = (q, kp, vp, bt, _ints([40, 0]), _ints([24, 17]))
    out = ops.paged_prefill(*(t for _, t in args))
    _close(out, jops.paged_prefill(*(j for j, _ in args)), 3e-2)


def test_cpu_wrappers_take_plain_version_without_launching():
    rng = np.random.default_rng(11)
    args = _decode_inputs(rng, 2, 4, 2, 32, 8, 4, "float32")
    before = (pa_mod.launches, pp_mod.launches)
    out = ops.paged_attention(*(t for _, t in args))
    torch.testing.assert_close(
        out, ref.paged_attention_ref(*(t for _, t in args)))
    pre = _prefill_inputs(rng, 1, 4, 2, 32, 8)
    ops.paged_prefill(*(t for _, t in pre))
    assert (pa_mod.launches, pp_mod.launches) == before


def test_ops_rejects_unknown_impl():
    rng = np.random.default_rng(12)
    args = _decode_inputs(rng, 1, 4, 2, 32, 8, 2, "float32")
    with pytest.raises(ValueError, match="impl"):
        ops.paged_attention(*(t for _, t in args), impl="pallas")

