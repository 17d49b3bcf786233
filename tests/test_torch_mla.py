"""The port's multi-head latent attention and deepseek-v2's layers
(MLA_DENSE, then MLA_MOE with a shared expert) against the JAX package's.

Same weights (the JAX params, zero-initialized norms given values,
carried over with ``repro_torch.bridge``) and the same seeded tokens go
through ``repro.models.model`` / ``repro.engine.slot_engine`` and their
ports: ``forward`` (hidden states and aux losses), ``prefill`` and
``decode_step`` (logits and the c_kv / k_rope caches) at f32 1e-5, and
greedy ``SlotEngine`` serves token for token; each with the expanded and
the absorbed decode path, and with a dense and a low-rank (32) query
projection.  ``layers.attn_causal_plain`` is held to the JAX
``attn_causal`` on its dense and blockwise paths, and ``count_params``
to the reference's for every config.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.engine import slot_engine as JS  # noqa: E402
from repro.engine.request import Request as JRequest  # noqa: E402
from repro.engine.request import SamplingParams as JSampling  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import _MODULES, get_config  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import (Request, RequestState,  # noqa: E402
                                SamplingParams, SlotEngine, SlotEngineConfig)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "deepseek-v2-236b"
VARIANTS = ["expand", "absorb", "q_lora", "q_lora_absorb"]

torch.set_num_threads(1)


def _configs(variant):
    jcfg, cfg = jax_reduced(ARCH), get_reduced_config(ARCH)
    kw = {}
    if "absorb" in variant:
        kw["mla_absorb"] = True
    if "q_lora" in variant:
        kw["mla"] = dataclasses.replace(cfg.mla, q_lora_rank=32)
    jkw = dict(kw)
    if "mla" in kw:
        jkw["mla"] = dataclasses.replace(jcfg.mla, q_lora_rank=32)
    return jcfg.replace(**jkw), cfg.replace(**kw)


def _weights(variant, seed=0):
    jcfg, cfg = _configs(variant)
    jp = JM.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    np_p = jax.tree.map(lambda x: np.asarray(x) if np.asarray(x).any()
                        else rng.normal(size=x.shape).astype(np.float32)
                        * 0.1, jp)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, np_p),
            bridge.params_from_numpy(np_p, cfg, device="cpu"))


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


def _caches_close(caches, jcaches):
    assert len(caches) == len(jcaches)
    for run, jrun in zip(caches, jcaches):
        assert set(run) == set(jrun) == {"c_kv", "k_rope"}
        for name in run:
            _close(run[name], jrun[name])


@pytest.mark.parametrize("variant", VARIANTS[:3])
def test_forward_prefill_decode_match_jax(variant):
    jcfg, cfg, jp, p = _weights(variant)
    assert cfg.layer_runs == (("mla_dense", 1), ("mla_moe", 1))
    b, s, cache_len = 2, 40, 48
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    jx, _, jaux = JM.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    x, _, aux = M.forward(p, cfg, torch.from_numpy(toks).int())
    _close(x, jx)
    assert set(aux) == set(jaux) == {"moe_load_balance", "moe_router_z"}
    for k in aux:
        _close(aux[k], jaux[k])
    jc = JM.init_cache(jcfg, b, cache_len)
    c = M.init_cache(cfg, b, cache_len, device="cpu")
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), jc)
    lg, c = M.prefill(p, cfg, torch.from_numpy(toks).int(), c)
    _close(lg, jl)
    _caches_close(c, jc)
    pos = np.array([s, s - 3], np.int32)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        lg, c = M.decode_step(p, cfg, c, torch.from_numpy(nxt),
                              torch.from_numpy(pos))
        _close(lg, jl)
        _caches_close(c, jc)
        pos = pos + 1


def test_decode_from_jax_mla_caches_matches_jax():
    """caches_from_numpy takes the JAX package's prefilled c_kv and
    k_rope fields; one decode step from them agrees."""
    jcfg, cfg, jp, p = _weights("expand", seed=2)
    b, s, cache_len = 2, 24, 32
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s))
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                        JM.init_cache(jcfg, b, cache_len))
    c = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), cfg, b,
                                 cache_len, device="cpu")
    _caches_close(c, jc)
    nxt = np.array(jnp.argmax(jl, -1), np.int32)
    pos = np.full(b, s, np.int32)
    jl, _ = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos))
    lg, _ = M.decode_step(p, cfg, c, torch.from_numpy(nxt),
                          torch.from_numpy(pos))
    _close(lg, jl)


@pytest.mark.parametrize("variant", VARIANTS)
def test_slot_engine_token_identical_to_jax(variant):
    """Five requests through two slots (slots are reused): the same
    greedy tokens and finish order as the JAX slot engine."""
    jcfg, cfg, jp, p = _weights(variant, seed=3)
    ecfg = dict(max_slots=2, max_len=128)
    jeng = JS.SlotEngine(jcfg, JS.SlotEngineConfig(**ecfg), params=jp)
    eng = SlotEngine(cfg, SlotEngineConfig(**ecfg), params=p, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (70, 12, 90, 66, 30)]
    new = [6, 3, 5, 7, 4]
    jreqs = [JRequest(prompt_tokens=pr, sampling=JSampling(max_new_tokens=n))
             for pr, n in zip(prompts, new)]
    reqs = [Request(prompt_tokens=pr, sampling=SamplingParams(
        max_new_tokens=n)) for pr, n in zip(prompts, new)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    jeng.run_until_idle()
    eng.run_until_idle()
    assert [r.output_tokens for r in reqs] == [jr.output_tokens
                                               for jr in jreqs]
    order = {r.request_id: i for i, r in enumerate(reqs)}
    jorder = {r.request_id: i for i, r in enumerate(jreqs)}
    assert ([order[r.request_id] for r in eng.finished]
            == [jorder[r.request_id] for r in jeng.finished])
    assert all(r.state == RequestState.FINISHED for r in reqs)


@pytest.mark.parametrize("blockwise", [False, True],
                         ids=["dense", "blockwise"])
@pytest.mark.parametrize("scale,hkv", [(0.07, 4), (None, 2)],
                         ids=["mla-scale", "gqa-default-scale"])
def test_attn_causal_plain_matches_jax(scale, hkv, blockwise):
    """MLA's shapes (query/key width 48, value width 32, H = Hkv) with an
    explicit scale, and GQA (H 4 over Hkv 2) at the default scale; the
    blockwise path in tiles of 16 x 32 rows, with padding on both sides
    (Sq = Sk = 70)."""
    rng = np.random.default_rng(5)
    s = 70
    q = rng.normal(size=(2, s, 4, 48)).astype(np.float32)
    k = rng.normal(size=(2, s, hkv, 48)).astype(np.float32)
    v = rng.normal(size=(2, s, hkv, 32)).astype(np.float32)
    kw = dict(scale=scale, force_blockwise=blockwise, block_q=16,
              block_k=32)
    got = L.attn_causal_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    want = JL.attn_causal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **kw)
    assert got.shape == (2, s, 4, 32)
    _close(got, want)


@pytest.mark.parametrize("arch", sorted(_MODULES))
def test_count_params_matches_jax(arch):
    """Total and MoE-active parameter counts equal the reference's for
    every config the port builds; the Hymba and xLSTM layer types are
    not ported, and their configs are refused naming ROADMAP C1b."""
    cfg = get_config(arch)
    jcfg = jax_config(arch)
    if arch in ("hymba-1.5b", "xlstm-1.3b"):
        with pytest.raises(NotImplementedError, match="ROADMAP C1b"):
            M.count_params(cfg)
        return
    for active in (False, True):
        assert (M.count_params(cfg, active_only=active)
                == JM.count_params(jcfg, active_only=active))
    if cfg.moe is not None:
        assert M.count_params(cfg, True) < M.count_params(cfg)
