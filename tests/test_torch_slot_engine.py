"""The port's full forward and slot engine against the JAX package's.

Same weights (the JAX params carried over with ``repro_torch.bridge``)
and the same seeded prompts go through ``repro.models.model`` /
``repro.engine.slot_engine`` and their ports.  Reduced gemma3-4b keeps
one sliding-window layer (window 64) and one dense layer, so prompts
longer than 64 tokens wrap the ring buffer.  Step logits are compared at
atol/rtol 1e-5 in float32, caches (ring positions included) likewise;
greedy engine outputs must be token-identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.engine import slot_engine as JS  # noqa: E402
from repro.engine.request import Request as JRequest  # noqa: E402
from repro.engine.request import SamplingParams as JSampling  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import (Request, RequestState,  # noqa: E402
                                SamplingParams, SlotEngine, SlotEngineConfig)
from repro_torch.models import model as M  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ENGINE_ARCHS = ["gemma3-4b", "qwen3-0.6b", "musicgen-large"]

torch.set_num_threads(1)


def _weights(arch, seed=0):
    """JAX params with the zero-initialized norms given values, as numpy,
    and the same weights in both packages."""
    jcfg, cfg = jax_reduced(arch), get_reduced_config(arch)
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


def _caches_equal(caches, jcaches):
    assert len(caches) == len(jcaches)
    for run, jrun in zip(caches, jcaches):
        assert set(run) == set(jrun)
        for name in run:
            if name == "pos":
                np.testing.assert_array_equal(run[name].numpy(),
                                              np.asarray(jrun[name]))
            else:
                _close(run[name], jrun[name])


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    shape = (lambda n: (n, cfg.num_codebooks)) if cfg.num_codebooks else (
        lambda n: n)
    return [rng.integers(0, cfg.vocab_size, shape(int(n))).tolist()
            for n in lens]


@pytest.fixture(scope="module")
def gemma():
    return _weights("gemma3-4b")


def test_gemma3_prefill_and_decode_match_jax(gemma):
    """A 100-token prompt (the window is 64), then three decode steps:
    logits and caches equal after every step, ring positions included."""
    jcfg, cfg, jp, p = gemma
    assert cfg.layer_runs == (("swa", 1), ("dense", 1))
    assert cfg.sliding_window == 64
    b, s, cache_len = 2, 100, 128
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))
    jc = JM.init_cache(jcfg, b, cache_len)
    c = M.init_cache(cfg, b, cache_len, device="cpu")
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), jc)
    lg, c = M.prefill(p, cfg, torch.from_numpy(toks).int(), c)
    _close(lg, jl)
    _caches_equal(c, jc)
    pos = np.array([s, s], np.int32)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        lg, c = M.decode_step(p, cfg, c, torch.from_numpy(nxt),
                              torch.from_numpy(pos))
        _close(lg, jl)
        _caches_equal(c, jc)
        pos = pos + 1


def test_decode_from_jax_caches_matches_jax(gemma):
    """caches_from_numpy starts the port from the JAX package's prefilled
    slot caches; one decode step then agrees."""
    jcfg, cfg, jp, p = gemma
    b, s, cache_len = 2, 80, 96
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s))
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                        JM.init_cache(jcfg, b, cache_len))
    c = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), cfg, b,
                                 cache_len, device="cpu")
    _caches_equal(c, jc)
    assert c[0]["pos"].dtype == torch.int32
    nxt = np.array(jnp.argmax(jl, -1), np.int32)
    pos = np.full(b, s, np.int32)
    jl, _ = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos))
    lg, _ = M.decode_step(p, cfg, c, torch.from_numpy(nxt),
                          torch.from_numpy(pos))
    _close(lg, jl)
    bad = [dict(run) for run in jax.tree.map(np.asarray, jc)]
    bad[0]["pos"] = bad[0]["pos"][:, :, :3]
    with pytest.raises(ValueError, match="pos"):
        bridge.caches_from_numpy(bad, cfg, b, cache_len, device="cpu")


def test_codebook_embed_unembed_match_jax():
    jcfg, cfg, jp, p = _weights("musicgen-large")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 5, cfg.num_codebooks))
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    _close(M.embed(p, cfg, torch.from_numpy(toks)),
           JM.embed(jp, jcfg, jnp.asarray(toks)))
    _close(M.unembed(p, cfg, torch.from_numpy(x)),
           JM.unembed(jp, jcfg, jnp.asarray(x)))


def _finish_order(engine, requests):
    """Indices into ``requests`` in the order the engine finished them."""
    index = {r.request_id: i for i, r in enumerate(requests)}
    return [index[r.request_id] for r in engine.finished]


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_slot_engine_token_identical_to_jax(arch):
    """Five requests through two slots (slots are reused): the same
    tokens, the same finish order and the same metric counts."""
    jcfg, cfg, jp, p = _weights(arch)
    ecfg = dict(max_slots=2, max_len=128)
    jeng = JS.SlotEngine(jcfg, JS.SlotEngineConfig(**ecfg), params=jp)
    eng = SlotEngine(cfg, SlotEngineConfig(**ecfg), params=p, device="cpu")
    prompts = _prompts(cfg, [70, 12, 90, 66, 30], seed=4)
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
    assert _finish_order(eng, reqs) == _finish_order(jeng, jreqs)
    assert [r.output_tokens for r in reqs] == [
        [t if isinstance(t, int) else list(t) for t in jr.output_tokens]
        for jr in jreqs]
    assert all(r.state == RequestState.FINISHED for r in reqs)
    m, jm = eng.metrics(), jeng.metrics()
    for field in ("num_running", "num_waiting", "admitted_requests",
                  "finished_requests"):
        assert getattr(m, field) == getattr(jm, field), field
    assert m.finished_requests == len(reqs)


def test_slot_engine_rejects_oversized():
    cfg = get_reduced_config("gemma3-4b")
    eng = SlotEngine(cfg, SlotEngineConfig(max_slots=1, max_len=32),
                     device="cpu")
    r = Request(prompt_tokens=list(range(40)),
                sampling=SamplingParams(max_new_tokens=8))
    eng.submit(r)
    eng.step()
    assert r.state == RequestState.FAILED
    assert not eng.has_work


def test_slot_engine_refuses_temperature():
    """Refused before sampling was ported; a request at temperature > 0
    is now served (its tokens are held to the JAX slot engine's in
    tests/test_torch_speculative.py)."""
    eng = SlotEngine(get_reduced_config("gemma3-4b"),
                     SlotEngineConfig(max_slots=1, max_len=16), device="cpu")
    r = Request(prompt_tokens=[1, 2, 3],
                sampling=SamplingParams(temperature=0.7, max_new_tokens=2))
    eng.submit(r)
    eng.run_until_idle()
    assert r.state == RequestState.FINISHED and len(r.output_tokens) == 2


@pytest.mark.parametrize("entry", ["slot_engine", "init_cache",
                                   "caches_from_numpy"])
def test_slot_path_defaults_to_the_card(entry):
    """The engine, its caches and the cache bridge go to the card unless
    a device is named, and never silently to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    cfg = get_reduced_config("gemma3-4b")
    jc = jax.tree.map(np.asarray, JM.init_cache(jax_reduced("gemma3-4b"),
                                                1, 16))
    call = {
        "slot_engine": lambda **kw: SlotEngine(
            cfg, SlotEngineConfig(max_slots=1, max_len=16), **kw).caches,
        "init_cache": lambda **kw: M.init_cache(cfg, 1, 16, **kw),
        "caches_from_numpy": lambda **kw: bridge.caches_from_numpy(
            jc, cfg, 1, 16, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    caches = call(device="cpu")
    assert all(t.device.type == "cpu" for run in caches
               for t in run.values())
