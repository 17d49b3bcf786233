"""The port's async overlapped loop against its sync loop and the JAX
package's async engine.

The engine pins of ``tests/test_speculative.py`` (the async loop alone
and with speculation, token-identical to the sync loop) are replayed on
a port engine and a JAX engine with the same weights, and extended:
sampling at temperature 0.8 (top-p 0.999999; top-p 1.0 is the
reference's fault F2, see ROADMAP), a stop token that lands while the
next step is already dispatched (the overshoot must be truncated), no
page leak after ``run_until_idle``, and the overlap metrics in range.
The config is the reduced qwen3-0.6b with the engine configuration of
``tests/test_speculative.py``; the JAX engine runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.
"""
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

torch.set_num_threads(1)

ECFG = dict(num_pages=128, max_batch=4, max_pages_per_seq=16,
            chunk_size=16)                  # tests/test_speculative.py:86
REP_PROMPT = [5, 6, 7, 8] * 6               # tests/test_speculative.py:81
SAMPLED = dict(temperature=0.8, top_p=0.999999)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_reduced("qwen3-0.6b"), get_reduced_config("qwen3-0.6b")
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [REP_PROMPT, rng.integers(0, 64, 20).tolist(),
               [9, 9, 3, 9, 9, 3, 9, 9]]
    return jcfg, cfg, jparams, params, prompts


def _serve(eng, req_cls, sp_cls, prompts, max_new=10, stop=None,
           sampling=None):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(
            request_id=f"r{i}", prompt_tokens=list(p),
            sampling=sp_cls(max_new_tokens=max_new, stop_token=stop,
                            seed=i, **(sampling or {}))))
    eng.run_until_idle()
    assert eng.alloc.num_free == eng.alloc.num_pages        # no leak
    return {r.request_id: list(r.output_tokens) for r in eng.finished}


def _port(setup, prompts=None, **kw):
    _, cfg, _, params, base_prompts = setup
    opts = {k: kw.pop(k) for k in ("max_new", "stop", "sampling")
            if k in kw}
    eng = InferenceEngine(cfg, EngineConfig(**ECFG, **kw), params=params,
                          device="cpu")
    return eng, _serve(eng, Request, SamplingParams,
                       prompts or base_prompts, **opts)


def _jax(setup, **kw):
    jcfg, _, jparams, _, prompts = setup
    opts = {k: kw.pop(k) for k in ("max_new", "stop", "sampling")
            if k in kw}
    eng = J.InferenceEngine(jcfg, J.EngineConfig(**ECFG, **kw),
                            params=jparams)
    outs = _serve(eng, J.Request, J.SamplingParams, prompts, **opts)
    return outs, eng.metrics()


@pytest.fixture(scope="module")
def greedy_sync(setup):
    _, outs = _port(setup)
    assert outs == _jax(setup)[0]
    return outs


@pytest.mark.parametrize("kw", [dict(async_loop=True),
                                dict(spec_tokens=4, async_loop=True)],
                         ids=["async", "spec_async"])
def test_async_greedy_matches_sync_and_jax_async(setup, greedy_sync, kw):
    """tests/test_speculative.py:125 and :133 on the port, and against
    the JAX async engine."""
    eng, outs = _port(setup, **kw)
    jouts, jm = _jax(setup, **kw)
    assert outs == greedy_sync
    assert outs == jouts
    m = eng.metrics()
    # drafts only at the loop's sync points: rows with a token in flight
    # are not drafted for, in both packages
    assert (m.spec_drafted_tokens, m.spec_accepted_tokens) == (
        jm.spec_drafted_tokens, jm.spec_accepted_tokens)


def test_async_sampled_matches_sync_and_jax_async(setup):
    _, sync = _port(setup, sampling=SAMPLED)
    _, outs = _port(setup, async_loop=True, sampling=SAMPLED)
    assert outs == sync
    assert outs == _jax(setup, async_loop=True, sampling=SAMPLED)[0]
    # the draw ran: sampled tokens are not the greedy ones
    _, greedy = _port(setup, async_loop=True)
    assert outs != greedy


def test_stop_token_in_flight_is_truncated(setup, greedy_sync):
    """A stop token read back after the next decode step was dispatched:
    the placeholder past it is dropped, and the streams are the sync
    loop's (and the JAX async engine's)."""
    # a token first produced at index 3 or later of a request's stream,
    # where the request is past its prefill and decoding asynchronously
    stop = next(toks[k] for toks in greedy_sync.values()
                for k in range(3, len(toks)) if toks[k] not in toks[:k])
    _, sync = _port(setup, stop=stop)
    assert any(len(t) < 10 and t[-1] == stop for t in sync.values())

    _, cfg, _, params, prompts = setup
    eng = InferenceEngine(cfg, EngineConfig(**ECFG, async_loop=True),
                          params=params, device="cpu")
    truncated = []
    resolve = eng._resolve_async

    def spy(rec):
        before = [len(r.output_tokens) for r in rec["reqs"]]
        resolve(rec)
        truncated.extend(r.request_id for r, n in zip(rec["reqs"], before)
                         if len(r.output_tokens) < n)
    eng._resolve_async = spy
    outs = _serve(eng, Request, SamplingParams, prompts, stop=stop)
    assert truncated                    # a dispatch was past the stop
    assert outs == sync
    assert outs == _jax(setup, async_loop=True, stop=stop)[0]


def test_async_run_until_idle_leaks_no_page_and_resolves_all(setup):
    eng, outs = _port(setup, async_loop=True, max_new=7)
    assert eng.alloc.num_free == eng.alloc.num_pages
    assert eng._pending is None
    assert all(len(t) == 7 and -1 not in t for t in outs.values())


@pytest.mark.parametrize("kw", [dict(), dict(async_loop=True)],
                         ids=["sync", "async"])
def test_overlap_metrics_in_range(setup, kw):
    eng, _ = _port(setup, **kw)
    m = eng.metrics()
    assert m.device_wait_s >= 0.0
    assert 0.0 <= m.host_overhead_frac <= 1.0
    assert eng.runner.device_wait_s <= eng.step_wall_s
