"""Multi-LoRA serving in the port against the JAX package.

The LoRA math (``_lora_delta``, the mixed step's grouped delta against
JAX's ``_qkv_lora_mixed``) and the three paged
step functions with an adapter bank are compared with the JAX functions
on the same weights at 1e-5 in float32.  The engine serves base and
adapter requests token-identically to ``repro.engine.InferenceEngine``,
and the pins of ``tests/test_lora_serving.py`` are replayed on both
engines with the same call sequence: byte identity across the bank's
tiers holds in the port, and its tokens and counters equal the JAX
engine's.  Adapter weights cannot be drawn alike in both packages (the
JAX package folds the name into a ``jax.random`` key), so the port is
handed the JAX package's own weights for each name when it first
registers it, through ``bridge.adapter_from_numpy``.
"""
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.engine as J  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.engine import paged_model as JPM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                Request, RequestState, SamplingParams)
from repro_torch.engine import paged_model as PM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ECFG = dict(page_size=8, num_pages=64, max_batch=4, max_pages_per_seq=16,
            chunk_size=16)
PAGE, NUM_PAGES, N_ADAPTERS, RANK = 8, 24, 4, 8

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced("qwen3-0.6b")
    cfg = get_reduced_config("qwen3-0.6b")
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    # the JAX runner's own name-keyed adapters (seed 0), for the port
    keys = J.InferenceEngine(jcfg, J.EngineConfig(**ECFG),
                             params=jparams).runner
    cache = {}

    def jax_adapter(name):
        if name not in cache:
            cache[name] = {k: np.asarray(v) for k, v in JPM.make_adapter(
                jcfg, RANK, keys._adapter_key(name)).items()}
        return cache[name]

    return SimpleNamespace(jcfg=jcfg, cfg=cfg, jparams=jparams,
                           params=params, jax_adapter=jax_adapter)


def _bank(cfg, rng):
    """A random bank of N_ADAPTERS slots, slot 0 zero as in the engines."""
    out = {}
    for k, spec in PM.lora_specs(cfg, N_ADAPTERS, RANK).items():
        w = (rng.normal(size=spec.shape) * 0.2).astype(np.float32)
        w[0] = 0.0
        out[k] = w
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


# ---------------------------------------------------------------- math
def test_lora_delta_and_qkv_mixed_match_jax(setup):
    s = setup
    rng = np.random.default_rng(20)
    jbank, bank = _bank(s.cfg, rng)
    x = rng.normal(size=(3, 5, s.cfg.d_model)).astype(np.float32)
    ids = np.array([2, 0, 3], np.int32)
    for which in ("q", "v"):
        np.testing.assert_allclose(
            PM._lora_delta(bank, which, torch.from_numpy(x),
                           torch.from_numpy(ids)).numpy(),
            np.asarray(JPM._lora_delta(jbank, which, jnp.asarray(x),
                                       jnp.asarray(ids))), **TOL)
    # the flattened mixed batch: 3 decode rows, 2 chunks of 6
    n_dec, n_pre, width = 3, 2, 6
    xf = rng.normal(size=(1, n_dec + n_pre * width, s.cfg.d_model)
                    ).astype(np.float32)
    pos = rng.integers(0, 200, (1, xf.shape[1])).astype(np.int32)
    dec_ids, pre_ids = np.array([1, 0, 3], np.int32), np.array([2, 0],
                                                               np.int32)
    jattn = jax.tree.map(lambda a: a[0], s.jparams["run_0"])["attn"]
    attn = M.layer_view(s.params["run_0"], 0)["attn"]
    want = JPM._qkv_lora_mixed(jattn, s.jcfg, jnp.asarray(xf),
                               jnp.asarray(pos), jbank,
                               jnp.asarray(dec_ids), jnp.asarray(pre_ids),
                               n_dec, n_pre, width)
    # the port's mixed step takes the grouped delta: decode rows are
    # chunks of width one
    groups = [(torch.from_numpy(dec_ids), n_dec, 1),
              (torch.from_numpy(pre_ids), n_pre, width)]
    got = PM._qkv_lora_groups(attn, s.cfg, torch.from_numpy(xf),
                              torch.from_numpy(pos), bank, groups)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    base = PM._qkv_lora_groups(attn, s.cfg, torch.from_numpy(xf),
                               torch.from_numpy(pos), None, groups)
    # rows of slot 0 are exactly the base projections, the others differ
    base_rows = [1] + list(range(n_dec + width, n_dec + 2 * width))
    for g, b_ in ((got[0], base[0]), (got[2], base[2])):
        assert torch.equal(g[0, base_rows], b_[0, base_rows])
        assert not torch.allclose(g[0, 0], b_[0, 0])
    assert torch.equal(got[1], base[1])         # k takes no delta


# ------------------------------------------------------ step functions
def _step_case(s, rng, step):
    """Inputs of one step over a random pool with context in it: decode
    rows and chunks with different adapters, some rows on the base."""
    shape = (s.cfg.n_layers, NUM_PAGES + 1, PAGE, s.cfg.n_kv_heads,
             s.cfg.head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    n = NUM_PAGES
    if step == "mixed_step":
        args = [np.array([5, 77, 0], np.int32), np.array([13, 30, 0],
                                                         np.int32),
                np.array([[3, 7, 11, 2], [9, 1, 4, 8], [n] * 4], np.int32),
                np.array([True, True, False]),
                rng.integers(0, s.cfg.vocab_size, (2, 16)).astype(np.int32),
                np.array([[15, 6, 20, 12], [10, 5, n, n]], np.int32),
                np.array([10, 0], np.int32), np.array([11, 16], np.int32)]
        ids = [np.array([2, 0, 1], np.int32), np.array([3, 0], np.int32)]
    elif step == "prefill_step":
        args = [rng.integers(0, s.cfg.vocab_size, (1, 16)).astype(np.int32),
                np.array([[4, 17, 9, n]], np.int32), 8, 13]
        ids = [np.array([2], np.int32)]
    else:
        args = [np.array([3, 400, 9, 0], np.int32),
                np.array([0, 17, 31, 0], np.int32),
                np.array([[5, n, n, n], [14, 2, 21, 0], [1, 10, 19, 23],
                          [n] * 4], np.int32),
                np.array([True, True, True, False])]
        ids = [np.array([1, 0, 3, 0], np.int32)]
    return k0, v0, args, ids


@pytest.mark.parametrize("step", ["mixed_step", "prefill_step",
                                  "decode_batch"])
def test_step_with_adapter_bank_matches_jax(setup, step):
    s = setup
    rng = np.random.default_rng(21)
    jbank, bank = _bank(s.cfg, rng)
    k0, v0, args, ids = _step_case(s, rng, step)

    def jarg(a):
        return jnp.int32(a) if isinstance(a, int) else jnp.asarray(a)

    def targ(a):
        return a if isinstance(a, int) else torch.from_numpy(a)

    jout = getattr(JPM, step)(
        s.jparams, JPM.PagePool(jnp.asarray(k0), jnp.asarray(v0)),
        *map(jarg, args), jbank, *map(jnp.asarray, ids), cfg=s.jcfg,
        page_size=PAGE)
    pool = bridge.pool_from_numpy(k0, v0, device="cpu")
    out = getattr(PM, step)(s.params, pool, *map(targ, args), bank,
                            *map(torch.from_numpy, ids), cfg=s.cfg,
                            page_size=PAGE)
    for got, want in zip(out[:-1], jout[:-1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(out[-1].k.numpy(), np.asarray(jout[-1].k),
                               **TOL)
    np.testing.assert_allclose(out[-1].v.numpy(), np.asarray(jout[-1].v),
                               **TOL)
    # the bank changed the step: LoRA-off logits differ
    off = getattr(PM, step)(s.params, bridge.pool_from_numpy(
        k0, v0, device="cpu"), *map(targ, args), cfg=s.cfg, page_size=PAGE)
    assert not np.allclose(off[0].numpy(), out[0].numpy(), atol=1e-3)


# ------------------------------------------------------------- engines
@dataclass
class Side:
    """One backend of a replayed pin: its request classes, an engine
    factory on the shared weights, and the weights it registers an
    adapter with the first time (None: the engine's own store)."""
    name: str
    ns: Any
    make: Callable[..., Any]
    first: Callable[[str], Any]

    def register(self, eng, name):
        return eng.register_adapter(name, weights=self.first(name))

    def gen(self, eng, prompt, adapter=None, n=4):
        r = self.ns.Request(prompt_tokens=list(prompt),
                            sampling=self.ns.SamplingParams(
                                max_new_tokens=n), lora_adapter=adapter)
        eng.submit(r)
        eng.run_until_idle()
        assert r.state == self.ns.RequestState.FINISHED
        return list(r.output_tokens)


def _sides(s):
    jns = SimpleNamespace(Request=J.Request, SamplingParams=J.SamplingParams,
                          RequestState=J.RequestState)
    tns = SimpleNamespace(Request=Request, SamplingParams=SamplingParams,
                          RequestState=RequestState)
    return [
        Side("jax", jns, lambda **kw: J.InferenceEngine(
            s.jcfg, J.EngineConfig(**dict(ECFG, **kw)), params=s.jparams),
            lambda name: None),
        Side("torch", tns, lambda **kw: InferenceEngine(
            s.cfg, EngineConfig(**dict(ECFG, **kw)), params=s.params,
            device="cpu"),
            lambda name: bridge.adapter_from_numpy(
                s.jax_adapter(name), s.cfg, RANK, device="cpu")),
    ]


def _counters(eng):
    m = eng.metrics()
    return dict(lora_miss=m.lora_miss, lora_shed=m.lora_shed,
                lora_cold_loads=m.lora_cold_loads,
                lora_evictions=m.lora_evictions,
                lora_host_hits=m.lora_host_hits,
                loaded=tuple(m.loaded_adapters),
                free_pages=eng.alloc.num_free)


def _replay(s, scenario):
    """Run ``scenario(side)`` on both backends; the port's result (tokens
    and counters) must equal the JAX engine's."""
    jax_out, torch_out = (scenario(side) for side in _sides(s))
    assert torch_out == jax_out


@pytest.mark.parametrize("mixed", [True, False],
                         ids=["mixed_batching", "two_phase"])
def test_engine_serves_base_and_adapters_like_jax(setup, mixed):
    s = setup
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, s.cfg.vocab_size, n).tolist()
               for n in (12, 21, 9, 30)]
    adapters = (None, "sql", "chat", "sql")

    def scenario(side):
        eng = side.make(mixed_batching=mixed)
        side.register(eng, "sql")
        side.register(eng, "chat")
        reqs = [side.ns.Request(prompt_tokens=list(p), lora_adapter=a,
                                sampling=side.ns.SamplingParams(
                                    max_new_tokens=5))
                for p, a in zip(prompts, adapters)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        assert eng.alloc.num_free == eng.alloc.num_pages
        return [list(r.output_tokens) for r in reqs], _counters(eng)

    _replay(s, scenario)
    # and the adapters change the tokens: the base model on the same
    # prompts gives others
    eng = _sides(s)[1].make(mixed_batching=mixed)
    assert _sides(s)[1].gen(eng, prompts[1], n=5) != \
        _sides(s)[1].gen(eng, prompts[1], "sql", n=5)


def test_reregister_is_byte_identical(setup):
    rng = np.random.default_rng(10)
    prompt = rng.integers(0, setup.cfg.vocab_size, 12).tolist()

    def scenario(side):
        eng = side.make()
        side.register(eng, "sql")
        first = side.gen(eng, prompt, "sql")
        eng.unregister_adapter("sql")
        assert "sql" not in eng.adapters
        eng.register_adapter("sql")             # back from the host tier
        assert eng.runner.adapter_host_hits == 1
        assert side.gen(eng, prompt, "sql") == first
        return first, _counters(eng)

    _replay(setup, scenario)


def test_slot_reuse_never_leaks_old_weights(setup):
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, setup.cfg.vocab_size, 12).tolist()

    def scenario(side):
        eng_a, eng_b = side.make(), side.make()
        side.register(eng_a, "a")
        side.gen(eng_a, prompt, "a")
        eng_a.unregister_adapter("a")
        side.register(eng_a, "b")               # reuses a's slot
        side.register(eng_b, "b")               # fresh slot, fresh engine
        out = side.gen(eng_a, prompt, "b")
        assert out == side.gen(eng_b, prompt, "b")
        return out, _counters(eng_a), _counters(eng_b)

    _replay(setup, scenario)


def test_lora_miss_is_loud_and_queues(setup):
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, setup.cfg.vocab_size, 8).tolist()

    def scenario(side):
        eng = side.make(lora_autoload=False)
        r = side.ns.Request(prompt_tokens=list(prompt),
                            sampling=side.ns.SamplingParams(
                                max_new_tokens=3), lora_adapter="ghost")
        eng.submit(r)
        for _ in range(3):
            eng.step()
        assert r.state == side.ns.RequestState.QUEUED
        assert not r.output_tokens
        queued = _counters(eng)
        assert queued["lora_miss"] == 1 and queued["lora_shed"] == 0
        side.register(eng, "ghost")
        eng.run_until_idle()
        assert r.state == side.ns.RequestState.FINISHED
        assert side.gen(eng, prompt, "ghost", n=3) == r.output_tokens
        return list(r.output_tokens), queued, _counters(eng)

    _replay(setup, scenario)


def test_lora_miss_sheds_after_timeout(setup):
    rng = np.random.default_rng(14)
    prompt = rng.integers(0, setup.cfg.vocab_size, 8).tolist()

    def scenario(side):
        eng = side.make(lora_autoload=False, lora_queue_timeout_s=1e-9)
        r = side.ns.Request(prompt_tokens=list(prompt),
                            sampling=side.ns.SamplingParams(
                                max_new_tokens=3), lora_adapter="ghost")
        eng.submit(r)
        eng.step()
        assert r.state == side.ns.RequestState.FAILED
        c = _counters(eng)
        assert c["lora_miss"] == 1 and c["lora_shed"] == 1
        return c

    _replay(setup, scenario)


def test_lru_eviction_cascades_to_host_tier(setup):
    rng = np.random.default_rng(15)
    prompt = rng.integers(0, setup.cfg.vocab_size, 12).tolist()

    def scenario(side):
        eng = side.make(max_adapters=3)         # slot 0 = base, 2 usable
        side.register(eng, "a")
        baseline = side.gen(eng, prompt, "a")
        side.register(eng, "b")
        side.register(eng, "c")                 # bank full: evicts LRU 'a'
        assert eng.runner.adapter_evictions == 1
        assert sorted(eng.adapters) == ["b", "c"]
        eng.register_adapter("a")               # back through the host tier
        assert eng.runner.adapter_host_hits >= 1
        assert side.gen(eng, prompt, "a") == baseline
        return baseline, _counters(eng)

    _replay(setup, scenario)


def test_unregister_defers_while_adapter_in_flight(setup):
    rng = np.random.default_rng(16)
    prompt = rng.integers(0, setup.cfg.vocab_size, 8).tolist()

    def scenario(side):
        eng = side.make()
        side.register(eng, "sql")
        r = side.ns.Request(prompt_tokens=list(prompt),
                            sampling=side.ns.SamplingParams(
                                max_new_tokens=6), lora_adapter="sql")
        eng.submit(r)
        eng.step()                              # prefill admits it
        eng.unregister_adapter("sql")
        assert "sql" in eng.adapters            # deferred, not yanked
        eng.run_until_idle()
        assert r.state == side.ns.RequestState.FINISHED
        eng.step()                              # idle step flushes it
        assert "sql" not in eng.adapters
        return list(r.output_tokens), _counters(eng)

    _replay(setup, scenario)


def test_autoloaded_adapter_reloads_byte_identically(setup):
    """The port's own artifact store: an adapter autoloaded at submit,
    evicted past a host tier of one slot and loaded again from its name
    gives the same tokens, on a fresh engine too."""
    side = _sides(setup)[1]
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, setup.cfg.vocab_size, 12).tolist()
    eng = side.make(max_adapters=2, host_adapter_slots=1)
    first = side.gen(eng, prompt, "x")          # autoloaded
    side.gen(eng, prompt, "y")                  # evicts x to the host tier
    side.gen(eng, prompt, "z")                  # evicts y; x drops out
    assert eng.runner.adapter_host_hits == 0
    assert side.gen(eng, prompt, "x") == first  # re-made from its name
    assert side.gen(side.make(), prompt, "x") == first
    c = _counters(eng)
    assert c["lora_cold_loads"] == 4 and c["lora_evictions"] == 3
