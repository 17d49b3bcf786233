"""The KV tiers in the port against the JAX package: host tier, SSD tier,
distributed pool with P/D roles, and the int8 wire.

Swap-preemption resume and host-tier prefix hits are replayed on both
engines with the same weights and give the same tokens and counters
(``tests/test_kv_tiers.py``); the port's ``compress_page`` is bit-equal
to ``repro``'s on float32 pages; P/D handoffs run port to port over
both wires, and across the backends (a JAX prefill engine publishes, a
port decode engine finishes); an SSD round trip with promotion runs in
a temporary directory.  bf16 pages leave the port as ``ml_dtypes``
bfloat16 arrays, which a JAX decode engine installs (port prefill -> JAX
decode, both wires, float32 and bf16); the ``tiers.BF16`` bit patterns
the port falls back to without ``ml_dtypes`` install too; both survive a
swap, keep 2 bytes an element and quantize by value.
"""
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.engine as J  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.core.kvcache import pool as jpool  # noqa: E402
from repro.core.kvcache import tiers as jtiers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core.kvcache import DistributedKVPool  # noqa: E402
from repro_torch.core.kvcache import tiers  # noqa: E402
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                Request, RequestState, SamplingParams)

ECFG = dict(page_size=8, num_pages=64, max_batch=4, max_pages_per_seq=16,
            chunk_size=16)

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


def _jax(s, **kw):
    extra = _split(kw)
    return J.InferenceEngine(s.jcfg, J.EngineConfig(**dict(ECFG, **kw)),
                             params=s.jparams, **extra)


def _port(s, params=None, **kw):
    extra = _split(kw)
    return InferenceEngine(s.cfg, EngineConfig(**dict(ECFG, **kw)),
                           params=s.params if params is None else params,
                           device="cpu", **extra)


def _split(kw):
    """Engine keyword arguments that are not EngineConfig fields."""
    return {k: kw.pop(k) for k in ("clock", "kv_pool_client", "engine_id")
            if k in kw}


def _serve(eng, req_cls, sp_cls, prompt, n, **kw):
    r = req_cls(prompt_tokens=list(prompt),
                sampling=sp_cls(max_new_tokens=n), **kw)
    eng.submit(r)
    eng.run_until_idle()
    return list(r.output_tokens)


def _both(s):
    return [(_jax, J.Request, J.SamplingParams, J.RequestState),
            (_port, Request, SamplingParams, RequestState)]


# ------------------------------------------------------- swap preemption
def test_swap_preemption_resume_matches_jax(setup):
    """tests/test_kv_tiers.py:50 on both engines: the preempted request's
    pages swap to the host tier and back, and it continues from where it
    stopped, with the JAX engine's tokens and counters."""
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, setup.cfg.vocab_size, 20).tolist()
    results = []
    for make, req_cls, sp_cls, state in _both(setup):
        eng = make(setup, host_cache_gb=0.25)
        req = req_cls(prompt_tokens=list(prompt),
                      sampling=sp_cls(max_new_tokens=8))
        eng.submit(req)
        while len(req.output_tokens) < 3:
            eng.step()
        generated = list(req.output_tokens)
        eng.sched.preempt(req, eng.clock())
        assert req.state is state.SWAPPED and req.page_ids == []
        assert len(eng.host_pool) > 0
        eng.run_until_idle()
        assert req.state is state.FINISHED
        assert req.output_tokens[:len(generated)] == generated
        m = eng.metrics()
        assert m.swap_out == m.swap_in == m.preemptions == 1
        results.append((list(req.output_tokens), m.kv_bytes_offloaded,
                        m.kv_bytes_fetched, eng.alloc.num_free))
    assert results[1] == results[0]
    ref = _port(setup)
    assert results[1][0] == _serve(ref, Request, SamplingParams, prompt, 8)


def test_host_tier_prefix_hit_matches_jax(setup):
    """tests/test_kv_tiers.py:171 on both engines: a prefix evicted from
    the device under page pressure is served from the host tier."""
    results = []
    for make, req_cls, sp_cls, _ in _both(setup):
        rng = np.random.default_rng(44)
        shared = rng.integers(0, setup.cfg.vocab_size, 24).tolist()
        eng = make(setup, host_cache_gb=0.25, num_pages=24)
        first = _serve(eng, req_cls, sp_cls, shared, 4)
        for _ in range(3):
            _serve(eng, req_cls, sp_cls,
                   rng.integers(0, setup.cfg.vocab_size, 120).tolist(), 2)
        assert eng.sched.alloc.stats["evictions"] > 0
        again = _serve(eng, req_cls, sp_cls, shared, 4)
        m = eng.metrics()
        assert m.host_hit_tokens >= eng.ecfg.page_size
        assert again == first
        results.append((first, m.host_hit_tokens, m.kv_bytes_fetched,
                        eng.host_pool.stats.puts))
    assert results[1] == results[0]


# ------------------------------------------------------------ int8 wire
@pytest.mark.parametrize("shape", [(2, 8, 2, 16), (4, 16, 1, 8)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_compress_page_bit_equal_to_reference(shape, scale):
    rng = np.random.default_rng(45)
    k = (rng.standard_normal(shape) * scale).astype(np.float32)
    v = (rng.standard_normal(shape) * scale).astype(np.float32)
    got, want = tiers.compress_page(k, v), jtiers.compress_page(k, v)
    for f in ("q_k", "q_v", "k_scale", "v_scale"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tiers.decompress_page(got), jtiers.decompress_page(want)):
        assert np.array_equal(a, b)
    assert tiers.payload_nbytes(got) == jtiers.payload_nbytes(want)
    assert tiers.INT8_WIRE_MAX_REL_ERR == jtiers.INT8_WIRE_MAX_REL_ERR


# ------------------------------------------------------------------ P/D
def _pd(prefill, decode, prompt, req_cls, sp_cls, n=6):
    """Drive a prefill engine and a decode engine in turns until the
    request, submitted to the prefill engine, is done."""
    req = req_cls(prompt_tokens=list(prompt),
                  sampling=sp_cls(max_new_tokens=n))
    prefill.submit(req)
    for _ in range(200):
        if not (prefill.has_work or decode.has_work):
            break
        if prefill.has_work:
            prefill.step()
        if decode.has_work:
            decode.step()
    return req


@pytest.mark.parametrize("wire", ["fp", "int8"])
def test_port_pd_handoff(setup, wire):
    """A port prefill engine publishes to the port's DistributedKVPool and
    hands the request to a port decode engine, which pulls the pages by
    block hash.  The raw wire gives the colocated engine's tokens; the
    int8 wire stores the compressed size."""
    t0 = time.monotonic()
    clock = lambda: time.monotonic() - t0    # noqa: E731
    pool = DistributedKVPool(capacity_bytes=1 << 30, metadata_lag=0.0,
                             clock=clock)
    pre = _port(setup, role="prefill", wire_dtype=wire, clock=clock,
                kv_pool_client=pool, engine_id="p0")
    dec = _port(setup, role="decode", wire_dtype=wire, clock=clock,
                kv_pool_client=pool, engine_id="d0")
    pre.handoff = dec.submit
    rng = np.random.default_rng(46)
    prompt = rng.integers(0, setup.cfg.vocab_size, 24).tolist()
    req = _pd(pre, dec, prompt, Request, SamplingParams)
    assert req.state is RequestState.FINISHED
    assert dec.metrics().remote_hit_tokens >= 16
    assert pre.alloc.num_free == pre.alloc.num_pages
    assert dec.alloc.num_free == dec.alloc.num_pages
    if wire == "fp":
        assert req.output_tokens == _serve(_port(setup), Request,
                                           SamplingParams, prompt, 6)
        assert pool.stats.bytes_stored == 3 * pre.runner.page_bytes
    else:
        assert len(req.output_tokens) == 6
        assert 0 < pool.stats.bytes_stored < 2 * pre.runner.page_bytes


def test_cross_backend_handoff_jax_prefill_port_decode(setup):
    """A JAX ``role="prefill"`` engine publishes to the JAX package's
    DistributedKVPool; a port ``role="decode"`` engine on the same weights
    takes the request (rebuilt as a port Request: the two packages'
    request states are distinct enums) and finishes it with the tokens of
    a JAX ``role="mixed"`` engine."""
    t0 = time.monotonic()
    clock = lambda: time.monotonic() - t0    # noqa: E731
    pool = jpool.DistributedKVPool(capacity_bytes=1 << 30,
                                   metadata_lag=0.0, clock=clock)
    pre = _jax(setup, role="prefill", clock=clock, kv_pool_client=pool,
               engine_id="p0")
    dec = _port(setup, role="decode", clock=clock, kv_pool_client=pool,
                engine_id="d0")
    handed = []

    def handoff(jreq):
        r = Request(prompt_tokens=list(jreq.prompt_tokens),
                    sampling=SamplingParams(
                        max_new_tokens=jreq.sampling.max_new_tokens),
                    lora_adapter=jreq.lora_adapter,
                    request_id=jreq.request_id)
        handed.append(r)
        dec.submit(r)

    pre.handoff = handoff
    rng = np.random.default_rng(47)
    prompt = rng.integers(0, setup.cfg.vocab_size, 30).tolist()
    _pd(pre, dec, prompt, J.Request, J.SamplingParams)
    (req,) = handed
    assert req.state is RequestState.FINISHED
    assert dec.metrics().remote_hit_tokens >= 24
    assert req.output_tokens == _serve(_jax(setup), J.Request,
                                       J.SamplingParams, prompt, 6)


class _JaxWire:
    """The JAX package's pool as a port engine's client: int8 pages cross
    as the JAX package's ``CompressedPage`` (the same four arrays; the
    two packages' classes are distinct, as their request enums are)."""

    def __init__(self, pool):
        self.pool = pool

    def publish(self, block_hash, payload, *args, **kw):
        if isinstance(payload, tiers.CompressedPage):
            payload = jtiers.CompressedPage(payload.q_k, payload.q_v,
                                            payload.k_scale,
                                            payload.v_scale)
        return self.pool.publish(block_hash, payload, *args, **kw)

    def __getattr__(self, name):
        return getattr(self.pool, name)


def _pd_to_jax(setup, make_prefill, req_cls, sp_cls, jparams, prompt,
               wire, dtype):
    """A prefill engine (``make_prefill(pool, clock)``) publishes to the
    JAX package's DistributedKVPool and a JAX ``role="decode"`` engine
    on ``jparams`` finishes the request (rebuilt as a JAX Request).
    Returns the decode engine and the finished request."""
    t0 = time.monotonic()
    clock = lambda: time.monotonic() - t0    # noqa: E731
    pool = jpool.DistributedKVPool(capacity_bytes=1 << 30,
                                   metadata_lag=0.0, clock=clock)
    pre = make_prefill(pool, clock)
    dec = J.InferenceEngine(
        setup.jcfg, J.EngineConfig(**dict(ECFG, role="decode",
                                          wire_dtype=wire, dtype=dtype)),
        params=jparams, clock=clock, kv_pool_client=pool, engine_id="d0")
    handed = []

    def handoff(req):
        r = J.Request(prompt_tokens=list(req.prompt_tokens),
                      sampling=J.SamplingParams(
                          max_new_tokens=req.sampling.max_new_tokens),
                      lora_adapter=req.lora_adapter,
                      request_id=req.request_id)
        handed.append(r)
        dec.submit(r)

    pre.handoff = handoff
    _pd(pre, dec, prompt, req_cls, sp_cls)
    (req,) = handed
    assert req.state is J.RequestState.FINISHED
    assert pre.alloc.num_free == pre.alloc.num_pages
    assert dec.alloc.num_free == dec.alloc.num_pages
    return dec, req


@pytest.mark.parametrize("wire", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_backend_handoff_port_prefill_jax_decode(setup, wire, dtype):
    """A port ``role="prefill"`` engine publishes to the JAX package's
    DistributedKVPool; a JAX ``role="decode"`` engine on the same weights
    installs its pages (bf16 pages as ``ml_dtypes.bfloat16`` arrays, the
    JAX engines' own payloads) and finishes the request.  On the raw
    wire it gives the tokens of a JAX ``role="mixed"`` engine; on the
    int8 wire those of a JAX prefill -> JAX decode handoff, whose
    quantized pages are the same bits."""
    jparams = jax.tree.map(lambda x: x.astype(getattr(jax.numpy, dtype)),
                           setup.jparams)
    params = jax.tree.map(lambda t: t.to(getattr(torch, dtype)),
                          setup.params)
    rng = np.random.default_rng(55)
    prompt = rng.integers(0, setup.cfg.vocab_size, 30).tolist()
    ecfg = dict(role="prefill", wire_dtype=wire, dtype=dtype)

    def port_prefill(pool, clock):
        return _port(setup, params=params, clock=clock, engine_id="p0",
                     kv_pool_client=_JaxWire(pool), **ecfg)

    def jax_prefill(pool, clock):
        return J.InferenceEngine(
            setup.jcfg, J.EngineConfig(**dict(ECFG, **ecfg)),
            params=jparams, clock=clock, kv_pool_client=pool,
            engine_id="p0")

    dec, req = _pd_to_jax(setup, port_prefill, Request, SamplingParams,
                          jparams, prompt, wire, dtype)
    assert dec.metrics().remote_hit_tokens >= 24
    if wire == "fp":
        want = _serve(J.InferenceEngine(
            setup.jcfg, J.EngineConfig(**dict(ECFG, dtype=dtype)),
            params=jparams), J.Request, J.SamplingParams, prompt, 6)
    else:
        want = _pd_to_jax(setup, jax_prefill, J.Request, J.SamplingParams,
                          jparams, prompt, wire, dtype)[1].output_tokens
    assert req.output_tokens == want


# ------------------------------------------------------------------ SSD
def test_ssd_round_trip_with_promotion(setup, tmp_path):
    """tests/test_sessions.py:508 on the port, its SSD tier in a
    temporary directory: a session's pages cascade device -> host -> SSD,
    ``promote_session`` reads them back on the promoter thread, and the
    next turn hits the host tier with the JAX engine's tokens."""
    page_bytes = _port(setup).runner.page_bytes
    eng = _port(setup, num_pages=24,
                host_cache_gb=8 * page_bytes / (1 << 30), ssd_cache_gb=0.1,
                ssd_dir=str(tmp_path))
    rng = np.random.default_rng(54)
    shared = rng.integers(0, setup.cfg.vocab_size, 24).tolist()
    first = _serve(eng, Request, SamplingParams, shared, 4,
                   session_id="conv0")
    for _ in range(6):
        _serve(eng, Request, SamplingParams,
               rng.integers(0, setup.cfg.vocab_size, 120).tolist(), 2)
    eng.ssd_pool.drain()
    assert any(tmp_path.iterdir())              # pickled pages on disk
    promotable = eng.sched.session_promotable("conv0")
    assert len(promotable) == 3
    assert eng.promote_session("conv0") == 3
    eng.drain_promotions()
    assert all(eng.host_pool.contains(k) for k in promotable)
    again = _serve(eng, Request, SamplingParams, shared, 4,
                   session_id="conv0")
    m = eng.metrics()
    assert m.promote_hits >= 2 and m.ssd_hit_tokens == 0
    assert m.host_hit_tokens >= 2 * eng.ecfg.page_size
    assert again == first == _serve(_jax(setup, num_pages=24), J.Request,
                                    J.SamplingParams, shared, 4)


# ------------------------------------------------------------- bf16 pages
def test_bf16_payloads(setup):
    """bf16 pages leave the device as ``ml_dtypes.bfloat16`` arrays of 2
    bytes an element (the JAX bf16 engine's page_bytes), come back bit
    for bit (from ``BF16`` bit patterns, the port's carriage without
    ``ml_dtypes``, too), and quantize by value within the wire's
    bound."""
    params = jax.tree.map(lambda t: t.to(torch.bfloat16), setup.params)
    eng = _port(setup, params=params, dtype="bfloat16")
    assert eng.runner.page_bytes == _jax(setup, dtype="bfloat16") \
        .runner.page_bytes
    gen = torch.Generator().manual_seed(0)
    eng.runner.pool.k[:, 3].normal_(generator=gen)
    eng.runner.pool.v[:, 3].normal_(generator=gen)
    k, v = eng.runner.page_payload(3)
    assert k.dtype == jax.numpy.bfloat16
    assert k.nbytes + v.nbytes == eng.runner.page_bytes
    assert tiers.payload_nbytes((k, v)) == eng.runner.page_bytes
    eng.runner.pool.k[:, 3] = 0                 # the payload is a copy
    assert tiers.as_float32(k).any()
    # back into other pages, as they came, as BF16 bit patterns and as
    # float32 values
    kf = tiers.as_float32(k)
    eng.runner.write_remote_page(4, k, v)
    eng.runner.write_remote_page(5, k.view(np.uint16).view(tiers.BF16),
                                 v.view(np.uint16).view(tiers.BF16))
    eng.runner.write_remote_page(6, kf, tiers.as_float32(v))
    for pid in (4, 5, 6):
        assert np.array_equal(eng.runner.pool.k[:, pid].float().numpy(), kf)
        assert np.array_equal(eng.runner.pool.v[:, pid].float().numpy(),
                              tiers.as_float32(v))
    cp = tiers.compress_page(k, v)
    dk, _ = tiers.decompress_page(cp)
    # half an int8 step of each layer's max-abs, plus the float32
    # rounding of the dequantized value: bf16 values are coarse enough to
    # sit exactly on half steps, where that rounding shows
    bound = tiers.INT8_WIRE_MAX_REL_ERR * np.max(
        np.abs(kf), axis=(1, 2, 3), keepdims=True)
    assert np.all(np.abs(kf - dk)
                  <= bound + 4 * np.finfo(np.float32).eps * np.abs(kf))
    assert np.abs(kf - dk).max() > 0.5 * bound.max()    # quantized values
    assert cp.nbytes < eng.runner.page_bytes // 2 + 64


def test_bf16_swap_resume_is_token_identical(setup):
    params = jax.tree.map(lambda t: t.to(torch.bfloat16), setup.params)
    rng = np.random.default_rng(48)
    prompt = rng.integers(0, setup.cfg.vocab_size, 20).tolist()
    ref = _serve(_port(setup, params=params, dtype="bfloat16"), Request,
                 SamplingParams, prompt, 8)
    eng = _port(setup, params=params, dtype="bfloat16", host_cache_gb=0.25)
    req = Request(prompt_tokens=list(prompt),
                  sampling=SamplingParams(max_new_tokens=8))
    eng.submit(req)
    while len(req.output_tokens) < 3:
        eng.step()
    n_pages = len(req.page_ids)
    eng.sched.preempt(req, eng.clock())
    assert req.state is RequestState.SWAPPED
    eng.run_until_idle()
    m = eng.metrics()
    assert m.swap_out == m.swap_in == 1
    assert m.kv_bytes_offloaded == n_pages * eng.runner.page_bytes
    assert req.output_tokens == ref
