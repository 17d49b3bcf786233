"""Speculative decoding and temperature sampling in the port against the
JAX package.

The two verification steps (``spec_decode_step``, ``spec_mixed_step``)
and the grouped LoRA delta are compared with the JAX functions on the
same weights at 1e-5 in float32, pools included; the engine pins of
``tests/test_speculative.py`` are replayed on a port and a JAX engine
with the same weights (tokens, spec counters, no page leak); and sampling
at temperature 0.8 with per-request seeds gives the JAX engines' tokens
in the paged engine (speculation off and on) and in the slot engine.
The config is the reduced qwen3-0.6b with the engine configuration of
``tests/test_paged_prefill.py``.
"""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.engine as J  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.engine import paged_model as JPM  # noqa: E402
from repro.engine import slot_engine as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                Request, SamplingParams, SlotEngine,
                                SlotEngineConfig)
from repro_torch.engine import paged_model as PM  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from test_torch_lora import _qkv_lora_mixed  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ECFG = dict(page_size=8, num_pages=64, max_batch=4, max_pages_per_seq=16,
            chunk_size=16)                  # tests/test_paged_prefill.py:90
PAGE, NUM_PAGES, N_ADAPTERS, RANK, SD = 8, 24, 4, 8, 5
REP_PROMPT = [5, 6, 7, 8] * 6               # tests/test_speculative.py:87

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced("qwen3-0.6b")
    cfg = get_reduced_config("qwen3-0.6b")
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return SimpleNamespace(jcfg=jcfg, cfg=cfg, jparams=jparams,
                           params=params)


def _bank(cfg, rng):
    out = {}
    for k, spec in PM.lora_specs(cfg, N_ADAPTERS, RANK).items():
        w = (rng.normal(size=spec.shape) * 0.2).astype(np.float32)
        w[0] = 0.0
        out[k] = w
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


# ---------------------------------------------------------------- math
def test_qkv_lora_groups_matches_jax(setup):
    s = setup
    rng = np.random.default_rng(30)
    jbank, bank = _bank(s.cfg, rng)
    groups = [(np.array([2, 0, 3], np.int32), 3, SD),
              (np.array([1, 0], np.int32), 2, 16)]
    n = sum(g[1] * g[2] for g in groups)
    x = rng.normal(size=(1, n, s.cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 200, (1, n)).astype(np.int32)
    jattn = jax.tree.map(lambda a: a[0], s.jparams["run_0"])["attn"]
    attn = M.layer_view(s.params["run_0"], 0)["attn"]
    want = JPM._qkv_lora_groups(jattn, s.jcfg, jnp.asarray(x),
                                jnp.asarray(pos), jbank,
                                [(jnp.asarray(a), b, c)
                                 for a, b, c in groups])
    got = _qkv_lora_mixed(attn, s.cfg, torch.from_numpy(x),
                          torch.from_numpy(pos), bank,
                          [(torch.from_numpy(a), b, c) for a, b, c in groups])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    base = layers.attn_qkv(attn, s.cfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    assert not torch.allclose(got[0], base[0], atol=1e-3)


# ------------------------------------------------------ step functions
def _spec_case(s, rng, step):
    """A random pool with context in it and verification lanes over it:
    lanes of 5, 2 and 0 (idle) valid rows, one crossing a page, one
    ending on a page boundary; with ``spec_mixed_step`` a live chunk and
    an idle one ride along.  No two written rows share a slot."""
    shape = (s.cfg.n_layers, NUM_PAGES + 1, PAGE, s.cfg.n_kv_heads,
             s.cfg.head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    n = NUM_PAGES
    args = [rng.integers(0, s.cfg.vocab_size, (3, SD)).astype(np.int32),
            np.array([13, 22, 0], np.int32), np.array([5, 2, 0], np.int32),
            np.array([[3, 7, 11, n], [9, 1, 4, 8], [n] * 4], np.int32)]
    ids = [np.array([2, 0, 1], np.int32)]
    if step == "spec_mixed_step":
        args += [rng.integers(0, s.cfg.vocab_size, (2, 16)).astype(
                     np.int32),
                 np.array([[15, 6, 20, 12], [n] * 4], np.int32),
                 np.array([10, 0], np.int32), np.array([11, 0], np.int32)]
        ids.append(np.array([3, 0], np.int32))
    return k0, v0, args, ids


@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("step", ["spec_decode_step", "spec_mixed_step"])
def test_spec_step_matches_jax(setup, step, lora):
    s = setup
    rng = np.random.default_rng(31)
    jbank, bank = _bank(s.cfg, rng)
    k0, v0, args, ids = _spec_case(s, rng, step)
    jl = (jbank, *map(jnp.asarray, ids)) if lora else ()
    tl = (bank, *map(torch.from_numpy, ids)) if lora else ()
    jout = getattr(JPM, step)(
        s.jparams, JPM.PagePool(jnp.asarray(k0), jnp.asarray(v0)),
        *map(jnp.asarray, args), *jl, cfg=s.jcfg, page_size=PAGE)
    out = getattr(PM, step)(
        s.params, bridge.pool_from_numpy(k0, v0, device="cpu"),
        *map(torch.from_numpy, args), *tl, cfg=s.cfg, page_size=PAGE)
    assert out[0].shape == (3, SD, s.cfg.vocab_size)
    for got, want in zip(out[:-1], jout[:-1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in ((out[-1].k, jout[-1].k), (out[-1].v, jout[-1].v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the idle lane wrote nothing: the scratch page is untouched
    assert np.array_equal(out[-1].k[:, NUM_PAGES].numpy(), k0[:, NUM_PAGES])


# -------------------------------------------------------------- engines
def _engines(s, **kw):
    ecfg = dict(ECFG, **kw)
    return (J.InferenceEngine(s.jcfg, J.EngineConfig(**ecfg),
                              params=s.jparams),
            InferenceEngine(s.cfg, EngineConfig(**ecfg), params=s.params,
                            device="cpu"))


def _run(eng, ns, prompts, max_new=10, stop=None, temperature=0.0,
         top_p=1.0):
    reqs = [ns.Request(request_id=f"r{i}", prompt_tokens=list(p),
                       sampling=ns.SamplingParams(
                           max_new_tokens=max_new, stop_token=stop,
                           temperature=temperature, top_p=top_p,
                           seed=100 + i))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert eng.alloc.num_free == eng.alloc.num_pages        # no leak
    m = eng.metrics()
    return ([list(r.output_tokens) for r in reqs],
            (m.spec_drafted_tokens, m.spec_accepted_tokens, m.spec_steps))


JNS = SimpleNamespace(Request=J.Request, SamplingParams=J.SamplingParams)
TNS = SimpleNamespace(Request=Request, SamplingParams=SamplingParams)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)              # tests/test_speculative.py
    return [REP_PROMPT, rng.integers(0, 64, 20).tolist(),
            [9, 9, 3, 9, 9, 3, 9, 9]]


def test_spec_greedy_byte_identical(setup, prompts):
    """tests/test_speculative.py:114 on both engines."""
    jeng, eng = _engines(setup, spec_tokens=4)
    jtoks, jcount = _run(jeng, JNS, prompts)
    toks, count = _run(eng, TNS, prompts)
    assert toks == jtoks and count == jcount
    assert count[0] > 0 and 0 < count[1] <= count[0]
    base, _ = _run(_engines(setup)[1], TNS, prompts)
    assert toks == base                         # spec on == spec off


def test_spec_stop_token_mid_draft(setup, prompts):
    """The spec-only case of tests/test_speculative.py:139."""
    base, _ = _run(_engines(setup)[1], TNS, prompts, max_new=12, stop=6)
    jeng, eng = _engines(setup, spec_tokens=4)
    jtoks, jcount = _run(jeng, JNS, prompts, max_new=12, stop=6)
    toks, count = _run(eng, TNS, prompts, max_new=12, stop=6)
    assert toks == jtoks == base and count == jcount


def test_spec_prefill_not_starved(setup):
    """tests/test_speculative.py:150: drafts spend step budget last, so
    prefill chunks progress (spec_mixed_step runs) and all finish."""
    long_prompt = ([3, 1, 4, 1, 5, 9, 2, 6] * 8)[:60]
    ps = [REP_PROMPT, REP_PROMPT, long_prompt]
    jeng, eng = _engines(setup, spec_tokens=4, chunk_size=8)
    modes = []
    run_spec = eng.runner.run_spec

    def recording(out):
        modes.append(any(w.chunk_len for w in out.prefills))
        return run_spec(out)

    eng.runner.run_spec = recording
    jtoks, jcount = _run(jeng, JNS, ps, max_new=8)
    toks, count = _run(eng, TNS, ps, max_new=8)
    assert toks == jtoks and count == jcount
    assert all(len(t) == 8 for t in toks)
    assert eng.metrics().finished_requests == 3
    assert True in modes                        # a fused spec + chunk step


@pytest.mark.parametrize("spec", [0, 4], ids=["spec_off", "spec_on"])
def test_temperature_sampling_matches_jax_engine(setup, prompts, spec):
    """Temperature 0.8, top_p 0.9, a seed per request: the port's tokens
    are the JAX engine's, and speculation changes none of them."""
    kw = dict(max_new=12, temperature=0.8, top_p=0.9)
    jeng, eng = _engines(setup, spec_tokens=spec)
    jtoks, jcount = _run(jeng, JNS, prompts, **kw)
    toks, count = _run(eng, TNS, prompts, **kw)
    assert toks == jtoks and count == jcount
    if spec:
        assert toks == _run(_engines(setup)[1], TNS, prompts, **kw)[0]
        assert count[0] > 0


def test_slot_engine_temperature_matches_jax(setup):
    """The slot engine splits its own key per sampled step (no top_p):
    the port draws the JAX slot engine's tokens at temperature 0.8."""
    s = setup
    jeng = JS.SlotEngine(s.jcfg, JS.SlotEngineConfig(max_slots=2,
                                                     max_len=64),
                         params=s.jparams, seed=4)
    eng = SlotEngine(s.cfg, SlotEngineConfig(max_slots=2, max_len=64),
                     params=s.params, seed=4, device="cpu")
    rng = np.random.default_rng(9)
    ps = [rng.integers(0, s.cfg.vocab_size, n).tolist() for n in (7, 12, 5)]
    outs = []
    for e, ns in ((jeng, JNS), (eng, TNS)):
        reqs = [ns.Request(prompt_tokens=p, sampling=ns.SamplingParams(
            max_new_tokens=6, temperature=t))
            for p, t in zip(ps, (0.8, 0.0, 0.8))]
        for r in reqs:
            e.submit(r)
        e.run_until_idle()
        outs.append([[int(t) for t in r.output_tokens] for r in reqs])
    assert outs[1] == outs[0]


def test_top_p_one_fault_in_both_engines(setup):
    """ROADMAP Queue 3, F2: at temperature 0.8 and the default top_p 1.0
    both engines draw token 0 on some rows where top_p 0.999999 draws
    others.  Which rows fault turns on the last bits of the float32
    cumulative probability, and the two packages' logits agree to ~1e-6,
    not bit for bit, so they fault on different rows; at 0.999999 their
    tokens are equal."""
    rng = np.random.default_rng(3)
    ps = [rng.integers(0, 64, 20).tolist() for _ in range(3)]
    kw = dict(max_new=12, temperature=0.8)
    runs = {}
    for top_p in (1.0, 0.999999):
        jeng, eng = _engines(setup)
        runs[top_p] = (_run(jeng, JNS, ps, top_p=top_p, **kw)[0],
                       _run(eng, TNS, ps, top_p=top_p, **kw)[0])
    assert runs[0.999999][0] == runs[0.999999][1]
    for side in (0, 1):
        faulty = [(i, j) for i, (a, b) in enumerate(zip(
            runs[1.0][side], runs[0.999999][side]))
            for j, (x, y) in enumerate(zip(a, b)) if x == 0 != y]
        assert faulty
