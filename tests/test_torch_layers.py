"""The port's layer math, embedding and head against the JAX package's,
on the same seeded numpy inputs and weights, at atol/rtol 1e-5 in
float32; and the weight bridge that carries the JAX params over."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# qwen3: qk_norm, no bias, tied head; qwen2: qkv bias; glm4: untied head
ARCHS = ["qwen3-0.6b", "qwen2-1.5b", "glm4-9b"]

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _params(arch, seed=0):
    jcfg, cfg = jax_reduced(arch), get_reduced_config(arch)
    jp = JM.init(jcfg, jax.random.PRNGKey(seed))
    # give the zero-initialized norms and biases values, so the tests
    # see them; both packages get the same numbers
    rng = np.random.default_rng(seed)
    np_p = jax.tree.map(lambda x: np.asarray(x) if np.asarray(x).any()
                        else rng.normal(size=x.shape).astype(np.float32)
                        * 0.1, jp)
    jp = jax.tree.map(jnp.asarray, np_p)
    return jcfg, cfg, jp, bridge.params_from_numpy(np_p, cfg, device="cpu")


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.2
    _close(L.rms_norm(_t(x), _t(scale), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, (2, 7))
    x = rng.normal(size=(2, 7, 4, 64)).astype(np.float32)
    sin, cos = L.rope_freqs(torch.from_numpy(pos), 64, 1e6)
    jsin, jcos = JL.rope_freqs(jnp.asarray(pos), 64, 1e6)
    _close(sin, jsin)
    _close(cos, jcos)
    _close(L.apply_rope(_t(x), sin, cos),
           JL.apply_rope(jnp.asarray(x), jsin, jcos))


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_and_mlp_match_jax(arch):
    jcfg, cfg, jp, p = _params(arch)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 6))
    jl0 = jax.tree.map(lambda a: a[0], jp["run_0"])
    l0 = jax.tree.map(lambda a: a[0], p["run_0"])
    qkv = L.attn_qkv(l0["attn"], cfg, _t(x), torch.from_numpy(pos))
    jqkv = JL.attn_qkv(jl0["attn"], jcfg, jnp.asarray(x), jnp.asarray(pos))
    for a, b in zip(qkv, jqkv):
        _close(a, b)
    o = rng.normal(size=(2, 6, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    _close(L.attn_out(l0["attn"], _t(o)),
           JL.attn_out(jl0["attn"], jnp.asarray(o)))
    _close(L.mlp(l0["mlp"], _t(x), cfg.act),
           JL.mlp(jl0["mlp"], jnp.asarray(x), jcfg.act))


def test_gelu_mlp_matches_jax():
    """GeGLU configs (gemma): jax.nn.gelu's tanh approximation."""
    jcfg, cfg, jp, p = _params("qwen3-0.6b")
    x = np.random.default_rng(3).normal(size=(1, 4, cfg.d_model)).astype(
        np.float32)
    jl0 = jax.tree.map(lambda a: a[0], jp["run_0"])
    l0 = jax.tree.map(lambda a: a[0], p["run_0"])
    _close(L.mlp(l0["mlp"], _t(x), "gelu"),
           JL.mlp(jl0["mlp"], jnp.asarray(x), "gelu"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "glm4-9b"])
def test_embed_unembed_match_jax(arch):
    jcfg, cfg, jp, p = _params(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    _close(M.embed(p, cfg, torch.from_numpy(toks)),
           JM.embed(jp, jcfg, jnp.asarray(toks)))
    _close(M.unembed(p, cfg, _t(x)), JM.unembed(jp, jcfg, jnp.asarray(x)))


def test_port_init_matches_jax_shapes_and_count():
    """The port's own init follows the same spec tree as the JAX
    package: same leaves, shapes and parameter count."""
    cfg, jcfg = get_reduced_config("qwen3-0.6b"), jax_reduced("qwen3-0.6b")
    p = M.init(cfg, seed=0, device="cpu")
    jp = JM.init(jcfg, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), p)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes == jshapes
    assert cfg.param_count() == jcfg.param_count()
    assert M.init(cfg, seed=0, device="cpu")["run_0"]["attn"]["wq"].equal(
        p["run_0"]["attn"]["wq"])                          # deterministic


def test_bridge_round_trips_dtypes_and_rejects_mismatch():
    jcfg, cfg = jax_reduced("qwen3-0.6b"), get_reduced_config("qwen3-0.6b")
    jp = JM.init(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    np_p = jax.tree.map(np.asarray, jp)
    p = bridge.params_from_numpy(np_p, cfg, device="cpu")
    assert p["embedding"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        p["embedding"].float().numpy(),
        np.asarray(jp["embedding"].astype(jnp.float32)))
    assert bridge.params_from_numpy(np_p, cfg, dtype=torch.float32,
                                    device="cpu")[
        "final_norm"].dtype == torch.float32
    bad = dict(np_p, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        bridge.params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_numpy({k: v for k, v in np_p.items()
                                  if k != "final_norm"}, cfg, device="cpu")
    k = np.zeros((2, 3, 8, 2, 64), np.float32)
    pool = bridge.pool_from_numpy(k, k + 1, device="cpu")
    assert pool.k.shape == (2, 3, 8, 2, 64) and float(pool.v[0, 0, 0, 0, 0]) == 1


def _qkv(rng, b, sq, sk, h, hkv, d):
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("mask_dims,softcap", [(2, 0.0), (3, 0.0),
                                               (3, 30.0)])
def test_attention_matches_jax(mask_dims, softcap):
    rng = np.random.default_rng(20)
    q, k, v = _qkv(rng, 2, 5, 9, 4, 2, 32)
    if mask_dims == 2:
        jmask = JL.causal_mask(5, 9, q_offset=4, window=3)
        mask = L.causal_mask(5, 9, q_offset=4, window=3)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    else:
        jmask = JL.decode_mask(jnp.asarray([3, 8]), 9, window=4)
        mask = L.decode_mask(torch.tensor([3, 8]), 9, window=4)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        q = q[:, :1]
    _close(L.attention(_t(q), _t(k), _t(v), mask, softcap=softcap),
           JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jmask, softcap=softcap))


@pytest.mark.parametrize("window,q_offset", [(0, 0), (64, 0), (0, 37),
                                             (64, 37)])
def test_attn_causal_matches_jax(window, q_offset):
    """The port's attn_causal (the flash_prefill wrapper, its plain
    version on the CPU) against the JAX package's."""
    rng = np.random.default_rng(21)
    q, k, v = _qkv(rng, 2, 150, 150 + q_offset, 4, 2, 32)
    _close(L.attn_causal(_t(q), _t(k), _t(v), window=window,
                         q_offset=q_offset),
           JL.attn_causal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          window=window, q_offset=q_offset))


@pytest.mark.parametrize("kw", [dict(softcap=30.0), dict(scale=0.1)],
                         ids=["softcap", "scale"])
def test_attn_causal_refuses_softcap_and_scale(kw):
    x = torch.zeros(1, 4, 2, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.attn_causal(x, x, x, **kw)
