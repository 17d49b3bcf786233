"""The port's mixture-of-experts FFN and its MoE serving paths against the
JAX package's.

``repro_torch.models.moe.moe_ffn`` is held to ``repro.models.moe.moe_ffn``
on the same weights and inputs (output and both auxiliary losses, f32 at
1e-5): dropless, at capacity factors 1.25 and 1.0 where tokens are
dropped, with and without a shared expert, silu and gelu, and with a
zero router whose probabilities all tie.  Reduced granite-moe-3b-a800m
(one run of MOE layers) then goes through the five paged step functions
(logits and pools) and through both engines (greedy tokens), dropless and
at capacity factor 1.25, and with 6 query heads over 2 KV heads (G 3);
its full forward (``forward``, ``prefill``, ``decode_step``) is compared
with the JAX model's, logits and aux.  The JAX side runs its Pallas
kernels in interpret mode, the port its kernels' plain versions (CPU
tensors).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.engine as J  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.engine import paged_model as JPM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                Request, SamplingParams)
from repro_torch.engine import paged_model as PM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ECFG = dict(page_size=8, num_pages=64, max_batch=4, max_pages_per_seq=16,
            chunk_size=16)                  # tests/test_paged_prefill.py:90
PROMPT_LENS = (22, 35, 9, 28)               # tests/test_paged_prefill.py:103
PAGE, NUM_PAGES = 8, 24
ARCH = "granite-moe-3b-a800m"

torch.set_num_threads(1)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


# ------------------------------------------------------------ moe_ffn
D, E, K, F_EXP, T_ROWS = 64, 8, 2, 32, (2, 12)


def _moe_case(seed, capacity_factor, shared, zero_router=False):
    """JAX and port params of one MoE FFN (8 experts, top-2, d 64) and an
    input of 2 x 12 rows.  Expert 0's router column is raised so that it
    draws more than its share and capacity drops tokens."""
    kw = dict(num_experts=E, top_k=K, d_expert=F_EXP,
              num_shared_experts=shared, d_shared_expert=F_EXP if shared
              else 0, capacity_factor=capacity_factor)
    jm, m = JMoEConfig(**kw), MoEConfig(**kw)
    p = jax.tree.map(np.asarray, jax_init(JMOE.moe_specs(D, jm),
                                          jax.random.PRNGKey(seed)))
    p["router"] = p["router"].copy()
    if zero_router:
        p["router"][:] = 0.0
    else:
        p["router"][:, 0] += 0.15
    x = np.random.default_rng(seed).normal(size=T_ROWS + (D,)).astype(
        np.float32)
    return jm, m, p, x


def _port_moe(p, m, x, act):
    tp = _tree(p, lambda a: torch.from_numpy(np.array(a)))
    out, r, pl = moe.moe_ffn(tp, m, torch.from_numpy(x), act)
    return out, moe.aux_losses(r, m), r, pl.keep


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("capacity", ["dropless", 1.25, 1.0])
def test_moe_ffn_matches_jax(capacity, shared, act):
    cf = E / K if capacity == "dropless" else capacity
    jm, m, p, x = _moe_case(40, cf, shared)
    jout, jaux = JMOE.moe_ffn(jax.tree.map(jnp.asarray, p), jm,
                              jnp.asarray(x), act)
    out, aux, _, keep = _port_moe(p, m, x, act)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert set(aux) == set(jaux) == {"moe_load_balance", "moe_router_z"}
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   **TOL)
    drops = int((~keep).sum())
    assert (drops == 0) if capacity == "dropless" else (drops > 0)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_all_ties_route_as_jax(shared):
    """A zero router makes every probability 1/E: top-k takes experts
    0..k-1 for every token, as jax.lax.top_k does, and capacity drops
    all but the first rows."""
    jm, m, p, x = _moe_case(41, 1.25, shared, zero_router=True)
    jout, jaux = JMOE.moe_ffn(jax.tree.map(jnp.asarray, p), jm,
                              jnp.asarray(x), "silu")
    out, aux, r, keep = _port_moe(p, m, x, "silu")
    assert (r.expert_ids == torch.arange(K)).all()
    assert int((~keep).sum()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   **TOL)


def test_topk_ties_take_the_lower_expert_id():
    """40 equal probabilities (granite's E, top-8) and rows with partial
    ties: the same ids as jax.lax.top_k, which torch.topk does not
    promise."""
    probs = np.full((3, 40), 1 / 40, np.float32)
    probs[1, [3, 17, 30]] = 0.5
    probs[2, ::2] = 0.25
    _, want = jax.lax.top_k(jnp.asarray(probs), 8)
    logits = torch.from_numpy(np.log(probs))
    eye = torch.eye(40)
    got = moe.route(eye, MoEConfig(num_experts=40, top_k=8, d_expert=1),
                    logits).expert_ids
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), np.arange(8))


@pytest.mark.parametrize("t,cap", [(8, 8), (136, 34), (64, 16), (40, 10)])
def test_capacity_at_granite_serving_shapes(t, cap):
    """The capacity of a decode step of 8 rows (the top-k floor), a mixed
    step of 8 + 2 x 64 rows, a 64-token chunk and 8 spec lanes of 5, as
    the reference computes it."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    assert moe._capacity(t, get_config(ARCH).moe) == cap
    assert JMOE._capacity(t, jax_config(ARCH).moe) == cap


# ------------------------------------------------------------ granite
def _configs(variant):
    """(JAX, port) reduced granite: as ``reduced`` makes it (dropless),
    at capacity factor 1.25, or at 1.25 with 6 query heads over 2 KV
    heads (G 3)."""
    jcfg, cfg = jax_reduced(ARCH), get_reduced_config(ARCH)
    if variant == "dropless":
        return jcfg, cfg
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=1.25))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    if variant == "g3":
        jcfg = jcfg.replace(n_heads=6, n_kv_heads=2)
        cfg = cfg.replace(n_heads=6, n_kv_heads=2)
    return jcfg, cfg


@pytest.fixture(scope="module", params=["dropless", "cf1.25", "g3"])
def granite(request):
    jcfg, cfg = _configs(request.param)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return request.param, jcfg, cfg, jparams, params


def _step_args(cfg, rng, step):
    """A step's inputs over a random pool with context in it: decode rows
    (one idle), chunks (one partial, one idle), spec lanes of 5, 2 and 0
    rows; no two written rows share a slot."""
    n = NUM_PAGES
    vocab = cfg.vocab_size
    dec = [np.array([5, 77, 0], np.int32), np.array([13, 30, 0], np.int32),
           np.array([[3, 7, 11, 2], [9, 1, 4, 8], [n] * 4], np.int32),
           np.array([True, True, False])]
    pre = [rng.integers(0, vocab, (2, 16)).astype(np.int32),
           np.array([[15, 6, 20, 12], [n] * 4], np.int32),
           np.array([10, 0], np.int32), np.array([11, 0], np.int32)]
    spec = [rng.integers(0, vocab, (3, 5)).astype(np.int32),
            np.array([13, 22, 0], np.int32), np.array([5, 2, 0], np.int32),
            np.array([[3, 7, 11, n], [9, 1, 4, 8], [n] * 4], np.int32)]
    return {"mixed_step": dec + pre, "decode_batch": dec,
            "prefill_step": [pre[0][:1], pre[1][:1], 10, 11],
            "spec_decode_step": spec, "spec_mixed_step": spec + pre}[step]


@pytest.mark.parametrize("step", ["mixed_step", "prefill_step",
                                  "decode_batch", "spec_decode_step",
                                  "spec_mixed_step"])
def test_paged_step_matches_jax(granite, step):
    variant, jcfg, cfg, jparams, params = granite
    rng = np.random.default_rng(50)
    shape = (cfg.n_layers, NUM_PAGES + 1, PAGE, cfg.n_kv_heads,
             cfg.head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    args = _step_args(cfg, rng, step)
    jout = getattr(JPM, step)(
        jparams, JPM.PagePool(jnp.asarray(k0), jnp.asarray(v0)),
        *[jnp.asarray(a) for a in args], cfg=jcfg, page_size=PAGE)
    out = getattr(PM, step)(
        params, bridge.pool_from_numpy(k0, v0, device="cpu"),
        *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args], cfg=cfg, page_size=PAGE)
    for got, want in zip(out[:-1], jout[:-1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in ((out[-1].k, jout[-1].k), (out[-1].v, jout[-1].v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.array_equal(out[-1].k.numpy(), k0)


def _serve(engine, request_cls, sampling_cls, prompts):
    reqs = [request_cls(prompt_tokens=list(p),
                        sampling=sampling_cls(max_new_tokens=5))
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    assert engine.alloc.num_free == engine.alloc.num_pages     # no leak
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("mixed", [True, False],
                         ids=["mixed_batching", "two_phase"])
def test_engine_tokens_match_jax_engine(granite, mixed, monkeypatch):
    """Four prompts through both engines: the same greedy tokens.  At
    capacity factor 1.25 the port's MoE layers drop (token, expert)
    pairs in some step, so co-batched rows change each other's output
    there, as in the reference."""
    variant, jcfg, cfg, jparams, params = granite
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    drops = []
    plan = moe.plan

    def counting_plan(expert_ids, num_experts, cap):
        out = plan(expert_ids, num_experts, cap)
        drops.append(int((~out.keep).sum()))
        return out

    monkeypatch.setattr(moe, "plan", counting_plan)
    jeng = J.InferenceEngine(jcfg, J.EngineConfig(
        mixed_batching=mixed, max_prefills=2, **ECFG), params=jparams)
    eng = InferenceEngine(cfg, EngineConfig(
        mixed_batching=mixed, max_prefills=2, **ECFG), params=params,
        device="cpu")
    jtoks = _serve(jeng, J.Request, J.SamplingParams, prompts)
    toks = _serve(eng, Request, SamplingParams, prompts)
    assert toks == jtoks
    assert drops and (sum(drops) == 0) == (variant == "dropless")


# ------------------------------------------------------------ full forward
def test_full_forward_matches_jax():
    """Reduced granite (at capacity factor 1.25) through ``forward``
    (hidden states and the summed aux losses), ``prefill`` and three
    ``decode_step``s, caches included."""
    jcfg, cfg = _configs("cf1.25")
    jp = JM.init(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    np_p = jax.tree.map(lambda a: np.asarray(a) if np.asarray(a).any()
                        else rng.normal(size=a.shape).astype(np.float32)
                        * 0.1, jp)
    jp = jax.tree.map(jnp.asarray, np_p)
    p = bridge.params_from_numpy(np_p, cfg, device="cpu")
    b, s, cache_len = 2, 40, 48
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    jx, _, jaux = JM.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    x, _, aux = M.forward(p, cfg, torch.from_numpy(toks).int())
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    assert set(aux) == set(jaux) == {"moe_load_balance", "moe_router_z"}
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   **TOL)
    jc = JM.init_cache(jcfg, b, cache_len)
    c = M.init_cache(cfg, b, cache_len, device="cpu")
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), jc)
    lg, c = M.prefill(p, cfg, torch.from_numpy(toks).int(), c)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    pos = np.full(b, s, np.int32)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        lg, c = M.decode_step(p, cfg, c, torch.from_numpy(nxt),
                              torch.from_numpy(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(c[0][name].numpy(),
                                   np.asarray(jc[0][name]), **TOL)
