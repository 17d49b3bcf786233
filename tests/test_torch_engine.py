"""The port's engine against ``repro.engine.InferenceEngine``: with the
same weights (``params=`` on both), greedy outputs are token-identical,
both schedulers emit the same sequence of step modes, and no page leaks
after drain.  The JAX engine runs its Pallas kernels in interpret mode,
the port its kernels' plain versions (CPU tensors)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.engine as J  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                Request, SamplingParams)
from repro_torch.engine import paged_model as PM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

torch.set_num_threads(1)

ECFG = dict(page_size=8, num_pages=64, max_batch=4, max_pages_per_seq=16,
            chunk_size=16)
PROMPT_LENS = (22, 35, 9, 28)           # tests/test_paged_prefill.py:103


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = jax_reduced("qwen3-0.6b"), get_reduced_config("qwen3-0.6b")
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    return jcfg, cfg, jparams, params, prompts


def _serve(engine, request_cls, sampling_cls, prompts):
    modes = []
    schedule = engine.sched.schedule

    def recording(now):
        out = schedule(now)
        modes.append(out.mode)
        return out

    engine.sched.schedule = recording
    reqs = [request_cls(prompt_tokens=list(p),
                        sampling=sampling_cls(max_new_tokens=5))
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    assert engine.alloc.num_free == engine.alloc.num_pages     # no leak
    return [r.output_tokens for r in reqs], modes


@pytest.mark.parametrize("mixed", [True, False],
                         ids=["mixed_batching", "two_phase"])
def test_greedy_tokens_match_jax_engine(weights, mixed):
    jcfg, cfg, jparams, params, prompts = weights
    jeng = J.InferenceEngine(jcfg, J.EngineConfig(
        mixed_batching=mixed, max_prefills=2, **ECFG), params=jparams)
    eng = InferenceEngine(cfg, EngineConfig(
        mixed_batching=mixed, max_prefills=2, **ECFG), params=params,
        device="cpu")
    jtoks, jmodes = _serve(jeng, J.Request, J.SamplingParams, prompts)
    toks, modes = _serve(eng, Request, SamplingParams, prompts)
    assert toks == jtoks
    assert modes == jmodes
    assert {"decode", "mixed" if mixed else "prefill"} <= set(modes)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    cfg = get_reduced_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, EngineConfig(**ECFG))


@pytest.mark.parametrize("entry", [
    "model_init", "init_params", "init_pool", "params_from_numpy",
    "pool_from_numpy"])
def test_allocating_entry_points_default_to_the_card(weights, entry):
    """Params and pools made without a named device go to the card, as
    the engine's do, and never silently to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    _, cfg, jparams, _, _ = weights
    k = np.zeros((cfg.n_layers, 3, 8, cfg.n_kv_heads, cfg.head_dim),
                 np.float32)
    call = {
        "model_init": lambda **kw: M.init(cfg, seed=0, **kw),
        "init_params": lambda **kw: init_params(M.model_specs(cfg), 0, **kw),
        "init_pool": lambda **kw: PM.init_pool(cfg, 3, 8, **kw),
        "params_from_numpy": lambda **kw: bridge.params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, **kw),
        "pool_from_numpy": lambda **kw: bridge.pool_from_numpy(k, k, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    leaves = jax.tree.leaves(call(device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)


@pytest.mark.parametrize("field,value,attr", [
    ("host_cache_gb", 1.0, "host_pool"), ("ssd_cache_gb", 1.0, "ssd_pool"),
    ("role", "prefill", None), ("spec_tokens", 2, None),
    ("async_loop", True, None)])
def test_ported_tier_and_role_features_construct(tmp_path, field, value,
                                                 attr):
    """The KV tiers, P/D roles, speculative decoding and the async loop,
    refused before they were ported, now build an engine with the tier
    attached (the SSD tier sits under a host tier, as in the JAX
    engine)."""
    cfg = get_reduced_config("qwen3-0.6b")
    kw = {field: value}
    if field == "ssd_cache_gb":
        kw.update(host_cache_gb=0.01, ssd_dir=str(tmp_path))
    eng = InferenceEngine(cfg, EngineConfig(**ECFG, **kw), device="cpu")
    if attr is not None:
        assert getattr(eng, attr) is not None
    elif field == "async_loop":
        assert eng.ecfg.async_loop and eng._pending is None
    else:
        assert getattr(eng.sched.scfg, field) == value


def test_kernel_impl_required_on_cuda_and_requests_checked(weights):
    _, cfg, _, params, prompts = weights
    with pytest.raises(ValueError, match="impl"):
        InferenceEngine(cfg, EngineConfig(impl="ref", **ECFG),
                        params=params, device="cuda")
    eng = InferenceEngine(cfg, EngineConfig(**ECFG), params=params,
                          device="cpu")
    # a request naming an adapter is served: the adapter is autoloaded
    eng.submit(Request(prompt_tokens=prompts[0], lora_adapter="a"))
    assert eng.adapters == ["a"]
    # sampling at temperature > 0 is served, no longer refused
    r = Request(prompt_tokens=prompts[0],
                sampling=SamplingParams(temperature=0.7, max_new_tokens=2))
    eng.submit(r)
    eng.run_until_idle()
    assert len(r.output_tokens) == 2
