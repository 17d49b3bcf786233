"""The port's paged step functions against the JAX package's, on the same
weights and the same KV pool (carried over through ``repro_torch.bridge``).

The JAX side runs its Pallas kernels as ``repro.kernels.ops`` runs them
on the CPU (interpret mode); the port's kernel wrappers take their plain
versions for CPU tensors.  Logits and pools are compared at atol/rtol
1e-5: both sides compute in float32, but XLA and PyTorch sum the
d_model-wide products and the softmax in different orders; through the
two layers the differences reach about 1e-6 on logits of order 1.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.engine import paged_model as JPM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import paged_model as PM  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 8
NUM_PAGES = 24                 # + 1 scratch page, as the runner allocates

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced("qwen3-0.6b")
    cfg = get_reduced_config("qwen3-0.6b")
    jparams = JM.init(jcfg, jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, jparams)
    params = bridge.params_from_numpy(np_params, cfg, device="cpu")
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, NUM_PAGES + 1, PAGE, cfg.n_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return jcfg, cfg, jparams, params, k, v, rng


def _check_pools(jpool, pool, k0):
    jk, jv = np.asarray(jpool.k), np.asarray(jpool.v)
    np.testing.assert_allclose(pool.k.numpy(), jk, **TOL)
    np.testing.assert_allclose(pool.v.numpy(), jv, **TOL)
    assert not np.array_equal(jk, k0)          # the step wrote new K/V


def test_mixed_step_matches_jax(setup):
    jcfg, cfg, jparams, params, k0, v0, rng = setup
    # two decode rows (one idle slot) and two chunks (one partial, one
    # idle) over permuted pages with earlier context already in them
    dec_tokens = np.array([5, 77, 0], np.int32)
    dec_pos = np.array([13, 30, 0], np.int32)
    dec_active = np.array([True, True, False])
    dec_bt = np.array([[3, 7, 11, 2], [9, 1, 4, 8], [NUM_PAGES] * 4],
                      np.int32)
    pre_tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    pre_ctx = np.array([10, 0], np.int32)
    pre_chunk = np.array([11, 0], np.int32)
    pre_bt = np.array([[15, 6, 20, 12], [NUM_PAGES] * 4], np.int32)

    jd, jp, jpool = JPM.mixed_step(
        jparams, JPM.PagePool(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.asarray(dec_tokens), jnp.asarray(dec_pos), jnp.asarray(dec_bt),
        jnp.asarray(dec_active), jnp.asarray(pre_tokens),
        jnp.asarray(pre_bt), jnp.asarray(pre_ctx), jnp.asarray(pre_chunk),
        cfg=jcfg, page_size=PAGE)
    pool = bridge.pool_from_numpy(k0, v0, device="cpu")
    t = torch.from_numpy
    d, p, pool = PM.mixed_step(
        params, pool, t(dec_tokens), t(dec_pos), t(dec_bt), t(dec_active),
        t(pre_tokens), t(pre_bt), t(pre_ctx), t(pre_chunk), cfg=cfg,
        page_size=PAGE)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    # the idle chunk's row is unembedded on both sides; compare all rows
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), **TOL)
    _check_pools(jpool, pool, k0)


def test_prefill_step_matches_jax(setup):
    jcfg, cfg, jparams, params, k0, v0, rng = setup
    tokens = rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    bt = np.array([[4, 17, 9, NUM_PAGES]], np.int32)
    ctx, chunk = 8, 13
    jl, jpool = JPM.prefill_step(
        jparams, JPM.PagePool(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.asarray(tokens), jnp.asarray(bt), jnp.int32(ctx),
        jnp.int32(chunk), cfg=jcfg, page_size=PAGE)
    logits, pool = PM.prefill_step(
        params, bridge.pool_from_numpy(k0, v0, device="cpu"),
        torch.from_numpy(tokens), torch.from_numpy(bt), ctx, chunk, cfg=cfg, page_size=PAGE)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _check_pools(jpool, pool, k0)


def test_decode_batch_matches_jax(setup):
    jcfg, cfg, jparams, params, k0, v0, rng = setup
    tokens = np.array([3, 400, 9, 0], np.int32)
    pos = np.array([0, 17, 31, 0], np.int32)
    active = np.array([True, True, True, False])
    bt = np.array([[5, NUM_PAGES, NUM_PAGES, NUM_PAGES], [14, 2, 21, 0],
                   [1, 10, 19, 23], [NUM_PAGES] * 4], np.int32)
    jl, jpool = JPM.decode_batch(
        jparams, JPM.PagePool(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(bt),
        jnp.asarray(active), cfg=jcfg, page_size=PAGE)
    t = torch.from_numpy
    logits, pool = PM.decode_batch(
        params, bridge.pool_from_numpy(k0, v0, device="cpu"), t(tokens),
        t(pos), t(bt), t(active), cfg=cfg, page_size=PAGE)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _check_pools(jpool, pool, k0)


def test_masked_rows_write_no_page(setup):
    """Inactive decode rows and chunk padding write nowhere, the scratch
    page included (JAX drops them with mode="drop")."""
    _, cfg, _, params, k0, v0, rng = setup
    pool = bridge.pool_from_numpy(k0, v0, device="cpu")
    t = torch.from_numpy
    PM.mixed_step(
        params, pool, t(np.array([1, 2], np.int32)),
        t(np.array([4, 0], np.int32)),
        t(np.array([[2, NUM_PAGES], [NUM_PAGES, NUM_PAGES]], np.int32)),
        t(np.array([True, False])),
        t(rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)),
        t(np.array([[7, NUM_PAGES, NUM_PAGES, NUM_PAGES]], np.int32)),
        t(np.array([0], np.int32)), t(np.array([3], np.int32)), cfg=cfg,
        page_size=PAGE)
    changed = np.nonzero(np.any(pool.k.numpy() != k0, axis=(0, 2, 3, 4)))[0]
    assert changed.tolist() == [2, 7]
    written = np.any(pool.k.numpy()[:, 7] != k0[:, 7], axis=(0, 2, 3))
    assert written.tolist() == [True] * 3 + [False] * 5


def test_bf16_mixed_step_runs(setup):
    """The serving dtype end to end: finite logits and a bf16 pool."""
    _, cfg, _, params, k0, v0, rng = setup
    p16 = jax.tree.map(lambda x: x.to(torch.bfloat16), params)
    pool = bridge.pool_from_numpy(k0, v0, dtype=torch.bfloat16,
                                  device="cpu")
    t = torch.from_numpy
    d, p, pool = PM.mixed_step(
        p16, pool, t(np.array([1], np.int32)), t(np.array([9], np.int32)),
        t(np.array([[3, 7]], np.int32)), t(np.array([True])),
        t(rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)),
        t(np.array([[11, 12]], np.int32)), t(np.array([0], np.int32)),
        t(np.array([16], np.int32)), cfg=cfg, page_size=PAGE)
    assert d.dtype == p.dtype == torch.bfloat16
    assert pool.k.dtype == torch.bfloat16
    assert torch.isfinite(d.float()).all() and torch.isfinite(p.float()).all()
