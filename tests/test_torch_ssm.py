"""The port's recurrent mixers and the Hymba and xLSTM layers against the
JAX package's.

Every function of ``repro_torch.models.ssm`` is held to its twin in
``repro.models.ssm`` on the same numpy-seeded weights, inputs and
carried states, with sequences that are not a multiple of the scans'
128-step chunk; ``layers.mlstm_parallel`` at S 700 with 512-wide blocks
and with 64-wide ones; the parallel mLSTM prefill followed by recurrent
steps from its closed-form state; ``blocks.apply_layer`` for the four
layer types in full and decode mode; ``prefill`` + ``decode_step``
against ``forward``; the slot engine's greedy tokens (reduced xLSTM,
reduced Hymba past its 64-token window, and a reduced Hymba at the full
model's G 5); a JAX prefill decoded by the port through
``bridge.caches_from_numpy``; and ``examples/torch_long_context_ssm.py``
on the CPU.  Outputs and states agree within 1e-5 relative to each
tensor's largest magnitude (at least 1), in float32, on the CPU: the
scans' sums of products cancel, so an element near zero carries the
rounding of its larger terms.
"""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.engine import slot_engine as JS  # noqa: E402
from repro.engine.request import Request as JRequest  # noqa: E402
from repro.engine.request import SamplingParams as JSampling  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import (Request, RequestState,  # noqa: E402
                                SamplingParams, SlotEngine, SlotEngineConfig)
from repro_torch.models import blocks, layers, ssm  # noqa: E402
from repro_torch.models import config as C  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

RTOL = 1e-5
S = 150                          # > one 128-step chunk, not a multiple

torch.set_num_threads(1)


# ------------------------------------------------------------ helpers
def _configs(arch, **kw):
    jcfg, cfg = jax_reduced(arch), get_reduced_config(arch)
    if kw:
        jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    return jcfg, cfg


def _numpy_tree(jtree, seed):
    """numpy leaves, the zero-initialized ones (biases, norms) given
    small random values so that every parameter matters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) if np.asarray(x).any()
                        else (rng.normal(size=x.shape) * 0.1).astype(
                            np.float32), jtree)


def _weights(jcfg, cfg, seed=0):
    """The same random weights in both packages."""
    np_p = _numpy_tree(JM.init(jcfg, jax.random.PRNGKey(seed)), seed)
    return (jax.tree.map(jnp.asarray, np_p),
            bridge.params_from_numpy(np_p, cfg, device="cpu"))


def _specs_params(jspecs, seed):
    """One module's params from its JAX spec tree: (jax, torch)."""
    np_p = _numpy_tree(jax_init(jspecs, jax.random.PRNGKey(seed)), seed)
    return (jax.tree.map(jnp.asarray, np_p),
            jax.tree.map(torch.from_numpy, np_p))


def _state(shapes, seed, scale=0.5):
    """A random carried state for a ``*_state_shape`` dict: numpy."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, (s, _axes) in shapes.items()}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close(t, j):
    got, want = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= RTOL * scale, (err, scale)


def _trees_close(t, j):
    assert set(t) == set(j)
    for k in t:
        if k == "pos":
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        else:
            _close(t[k], j[k])


def _caches_close(caches, jcaches):
    assert len(caches) == len(jcaches)
    for run, jrun in zip(caches, jcaches):
        _trees_close(run, jrun)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ ssm.py
def _mamba_case(fn):
    jcfg, cfg = _configs("hymba-1.5b")
    jp, p = _specs_params(JSSM.mamba_specs(jcfg), 1)
    jst, st = _both(_state(JSSM.mamba_state_shape(jcfg, 2), 2))
    if fn == "mamba_step":
        x = _x(3, 2, cfg.d_model)
        return (JSSM.mamba_step(jp, jcfg, jnp.asarray(x), jst),
                ssm.mamba_step(p, cfg, torch.from_numpy(x), st))
    x = _x(3, 2, S, cfg.d_model)
    if fn == "mamba_seq":
        return (JSSM.mamba_seq(jp, jcfg, jnp.asarray(x), jst),
                ssm.mamba_seq(p, cfg, torch.from_numpy(x), st))
    # the core alone, on a conv output and the carried h
    di = cfg.ssm.expand * cfg.d_model
    xc = _x(4, 2, S, di)
    jy, jh = JSSM._mamba_core(jp, jcfg.ssm, jnp.asarray(xc), None, jst["h"])
    y, h = ssm._mamba_core(p, cfg.ssm, torch.from_numpy(xc), None, st["h"])
    return (jy, {"h": jh}), (y, {"h": h})


def _mlstm_case(fn):
    jcfg, cfg = _configs("xlstm-1.3b")
    jp, p = _specs_params(JSSM.mlstm_specs(jcfg), 5)
    jst, st = _both(_state(JSSM.mlstm_state_shape(jcfg, 2), 6))
    if fn == "mlstm_step":
        x = _x(7, 2, cfg.d_model)
        return (JSSM.mlstm_step(jp, jcfg, jnp.asarray(x), jst),
                ssm.mlstm_step(p, cfg, torch.from_numpy(x), st))
    x = _x(7, 2, S, cfg.d_model)
    parallel = fn == "mlstm_seq_parallel"
    return (JSSM.mlstm_seq(jp, jcfg, jnp.asarray(x), jst, parallel=parallel),
            ssm.mlstm_seq(p, cfg, torch.from_numpy(x), st,
                          parallel=parallel))


def _slstm_case(fn):
    """sLSTM from a state it can reach: its normalizer n is a sum of
    positive terms (a random n near 0 would divide by ~1e-6)."""
    jcfg, cfg = _configs("xlstm-1.3b")
    jp, p = _specs_params(JSSM.slstm_specs(jcfg), 8)
    state = _state(JSSM.slstm_state_shape(jcfg, 2), 9)
    state["n"] = np.abs(state["n"]) + 1.0
    jst, st = _both(state)
    if fn == "slstm_step":
        x = _x(10, 2, cfg.d_model)
        return (JSSM.slstm_step(jp, jcfg, jnp.asarray(x), jst),
                ssm.slstm_step(p, cfg, torch.from_numpy(x), st))
    x = _x(10, 2, S, cfg.d_model)
    if fn == "slstm_seq":
        return (JSSM.slstm_seq(jp, jcfg, jnp.asarray(x), jst),
                ssm.slstm_seq(p, cfg, torch.from_numpy(x), st))
    h, dh = cfg.xlstm.num_heads, cfg.d_model // cfg.xlstm.num_heads
    wx = _x(11, 2, S, 4, h, dh)
    return (JSSM._slstm_scan(jp, jcfg, jnp.asarray(wx), jst),
            ssm._slstm_scan(p, cfg, torch.from_numpy(wx), st))


SSM_CASES = {
    "mamba_seq": _mamba_case, "mamba_step": _mamba_case,
    "_mamba_core": _mamba_case,
    "mlstm_seq_parallel": _mlstm_case, "mlstm_seq_recurrent": _mlstm_case,
    "mlstm_step": _mlstm_case,
    "slstm_seq": _slstm_case, "slstm_step": _slstm_case,
    "_slstm_scan": _slstm_case,
}


@pytest.mark.parametrize("fn", sorted(SSM_CASES))
def test_ssm_function_matches_jax(fn):
    """Each sequence/step function (and the two chunked scans) from a
    random carried state: the output and every field of the new state.
    ``mlstm_seq_recurrent`` is ``parallel=False`` over S tokens, the
    reference's ``_mlstm_core`` scan."""
    (jout, jst), (out, st) = SSM_CASES[fn](fn)
    _close(out, jout)
    _trees_close(st, jst)
    assert all(v.dtype == torch.float32 for k, v in st.items()
               if k != "conv")


def test_causal_conv_matches_jax():
    """The depthwise causal conv over a sequence, and one step of it
    from a buffer of the previous inputs."""
    w, b = _x(12, 4, 32), _x(13, 32)
    x = _x(14, 2, S, 32)
    _close(ssm._causal_conv_seq(*map(torch.from_numpy, (x, w, b))),
           JSSM._causal_conv_seq(*map(jnp.asarray, (x, w, b))))
    buf, xt = _x(15, 2, 3, 32), _x(16, 2, 32)
    out, nbuf = ssm._causal_conv_step(*map(torch.from_numpy,
                                           (xt, buf, w, b)))
    jout, jbuf = JSSM._causal_conv_step(*map(jnp.asarray, (xt, buf, w, b)))
    _close(out, jout)
    _close(nbuf, jbuf)


@pytest.mark.parametrize("block", [512, 64])
def test_mlstm_parallel_matches_jax(block):
    """The parallel form at S 700: two 512-wide q and k blocks (the
    second ragged), or eleven 64-wide ones; log-forget gates from a
    cumulative sum as ``mlstm_seq`` builds them."""
    b, s, h, dh = 1, 700, 2, 16
    rng = np.random.default_rng(17)
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    k /= np.sqrt(dh)
    f_cum = np.cumsum(-np.abs(rng.normal(size=(b, s, h)) * 0.1),
                      axis=1).astype(np.float32)
    i_raw = rng.normal(size=(b, s, h)).astype(np.float32)
    args = (q, k, v, f_cum, i_raw - f_cum)
    got = layers.mlstm_parallel(*map(torch.from_numpy, args),
                                block_q=block, block_k=block)
    want = JL.mlstm_parallel(*map(jnp.asarray, args), block_q=block,
                             block_k=block)
    assert got.shape == (b, s, h, dh)
    _close(got, want)


def test_mlstm_parallel_prefill_then_recurrent_steps():
    """A parallel prefill of 300 tokens (the closed-form C, n, m), then
    four recurrent steps from that state: every output and state against
    the JAX package's prefill and steps."""
    jcfg, cfg = _configs("xlstm-1.3b")
    jp, p = _specs_params(JSSM.mlstm_specs(jcfg), 18)
    jst, st = _both({k: np.zeros(s, np.float32) for k, (s, _) in
                     JSSM.mlstm_state_shape(jcfg, 2).items()})
    x = _x(19, 2, 300, cfg.d_model)
    jout, jst = JSSM.mlstm_seq(jp, jcfg, jnp.asarray(x), jst)
    out, st = ssm.mlstm_seq(p, cfg, torch.from_numpy(x), st)
    _close(out, jout)
    _trees_close(st, jst)
    for i in range(4):
        xt = _x(20 + i, 2, cfg.d_model)
        jout, jst = JSSM.mlstm_step(jp, jcfg, jnp.asarray(xt), jst)
        out, st = ssm.mlstm_step(p, cfg, torch.from_numpy(xt), st)
        _close(out, jout)
        _trees_close(st, jst)


# ------------------------------------------------------------ blocks.py
LAYER_CASES = [("hymba-1.5b", C.HYMBA), ("hymba-1.5b", C.HYMBA_GLOBAL),
               ("xlstm-1.3b", C.MLSTM), ("xlstm-1.3b", C.SLSTM)]


@pytest.mark.parametrize("mode", ["full", "decode"])
@pytest.mark.parametrize("arch,ltype", LAYER_CASES,
                         ids=[t for _, t in LAYER_CASES])
def test_apply_layer_matches_jax(arch, ltype, mode):
    """One residual block from a random cache: Hymba's 100 tokens wrap
    its 64-slot ring (full mode) or decode into a ring of random
    positions; the output and every cache field, written in place."""
    jcfg, cfg = _configs(arch)
    jp, p = _specs_params(JB.layer_specs(jcfg, ltype), 21)
    b, cache_len = 2, 128
    shapes = JB.cache_shape(jcfg, ltype, b, cache_len)
    cache = _state(shapes, 22)
    if ltype == C.SLSTM:                    # a reachable normalizer
        cache["n"] = np.abs(cache["n"]) + 1.0
    if "pos" in cache:
        w = cfg.sliding_window
        cache["pos"] = np.broadcast_to(np.arange(w) + 40, (b, w)).astype(
            np.int32).copy()
        cache["pos"][:, w // 2:] -= w                   # a wrapped ring
    jc, c = _both(cache)
    if mode == "full":
        s = 100
        x = _x(23, b, s, cfg.d_model)
        pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    else:
        x = _x(23, b, 1, cfg.d_model)
        pos = np.array([103, 90], np.int32)
    jout, jc, _ = JB.apply_layer(jp, jcfg, ltype, jnp.asarray(x),
                                 jnp.asarray(pos), jc, mode)
    out, c_new, routing = blocks.apply_layer(
        p, cfg, ltype, torch.from_numpy(x), torch.from_numpy(pos), c, mode)
    assert c_new is c and routing is None
    _close(out, jout)
    _trees_close(c, jc)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b"])
def test_prefill_decode_matches_full_forward(arch):
    """The port's twin of test_arch_smoke's: decoding token S after a
    prefill of S tokens reproduces the full forward's logits (S = 100
    wraps reduced Hymba's 64-slot ring and spans sLSTM's chunk)."""
    cfg = get_reduced_config(arch)
    params = M.init(cfg, seed=2, device="cpu")
    b, s = 2, 100
    toks = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    x, _, _ = M.forward(params, cfg, toks)
    want = M.unembed(params, cfg, x[:, -1:])[:, 0]
    caches = M.init_cache(cfg, b, s + 8, device="cpu")
    M.prefill(params, cfg, toks[:, :s], caches)
    got, _ = M.decode_step(params, cfg, caches, toks[:, s],
                           torch.full((b,), s, dtype=torch.int32))
    assert (got - want).abs().max().item() < 5e-4


# ------------------------------------------------------------ engine
ENGINE_CASES = {
    "xlstm": ("xlstm-1.3b", {}, [70, 12, 90, 1, 30]),
    "hymba": ("hymba-1.5b", {}, [100, 12, 90, 66, 1]),
    "hymba_g5": ("hymba-1.5b", dict(n_heads=10, n_kv_heads=2),
                 [100, 30, 80]),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_slot_engine_token_identical_to_jax(case):
    """Requests through two slots (reused, and decoding beside empty
    ones): the same greedy tokens and finish order as the JAX slot
    engine.  Hymba's prompts of 66-100 tokens wrap its 64-slot ring; a
    1-token prompt takes the recurrent mLSTM path."""
    arch, kw, lens = ENGINE_CASES[case]
    jcfg, cfg = _configs(arch, **kw)
    if kw:
        assert cfg.n_heads // cfg.n_kv_heads == 5
    jp, p = _weights(jcfg, cfg, seed=3)
    ecfg = dict(max_slots=2, max_len=128)
    jeng = JS.SlotEngine(jcfg, JS.SlotEngineConfig(**ecfg), params=jp)
    eng = SlotEngine(cfg, SlotEngineConfig(**ecfg), params=p, device="cpu")
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    new = [6, 3, 5, 7, 4][:len(lens)]
    jreqs = [JRequest(prompt_tokens=pr, sampling=JSampling(max_new_tokens=n))
             for pr, n in zip(prompts, new)]
    reqs = [Request(prompt_tokens=pr, sampling=SamplingParams(
        max_new_tokens=n)) for pr, n in zip(prompts, new)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    jeng.run_until_idle()
    eng.run_until_idle()
    assert [r.output_tokens for r in reqs] == [
        [int(t) for t in jr.output_tokens] for jr in jreqs]
    index = {r.request_id: i for i, r in enumerate(reqs)}
    jindex = {r.request_id: i for i, r in enumerate(jreqs)}
    assert ([index[r.request_id] for r in eng.finished]
            == [jindex[r.request_id] for r in jeng.finished])
    assert all(r.state == RequestState.FINISHED for r in reqs)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b"])
def test_decode_from_jax_caches_matches_jax(arch):
    """A JAX prefill of 90 tokens, its caches (K/V, ring, conv buffers
    and recurrent states) carried to the port through numpy: four
    greedy decode steps give the JAX decode's tokens and logits."""
    jcfg, cfg = _configs(arch)
    jp, p = _weights(jcfg, cfg, seed=4)
    b, s, cache_len = 2, 90, 96
    toks = np.random.default_rng(26).integers(0, cfg.vocab_size, (b, s))
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                        JM.init_cache(jcfg, b, cache_len))
    c = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), cfg, b,
                                 cache_len, device="cpu")
    _caches_close(c, jc)
    nxt = np.array(jnp.argmax(jl, -1), np.int32)
    jtoks, toks_ = [], []
    for i in range(4):
        pos = np.full(b, s + i, np.int32)
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        lg, c = M.decode_step(p, cfg, c, torch.from_numpy(nxt),
                              torch.from_numpy(pos))
        _close(lg, jl)
        jtoks.append(np.array(jnp.argmax(jl, -1), np.int32))
        toks_.append(lg.argmax(-1).int().numpy())
        nxt = jtoks[-1]
    np.testing.assert_array_equal(np.stack(toks_), np.stack(jtoks))


def test_bf16_caches_keep_recurrent_states_in_float32():
    """``init_cache`` and ``caches_from_numpy`` in bfloat16: K/V and conv
    buffers take the dtype, the recurrent states stay float32 (the JAX
    package's ``init_cache``)."""
    for arch in ("hymba-1.5b", "xlstm-1.3b"):
        jcfg, cfg = _configs(arch)
        jc = JM.init_cache(jcfg, 1, 16, jnp.bfloat16)
        c = M.init_cache(cfg, 1, 16, torch.bfloat16, device="cpu")
        cb = bridge.caches_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jc), cfg, 1,
            16, dtype=torch.bfloat16, device="cpu")
        for run, jrun, brun in zip(c, jc, cb):
            for name, t in run.items():
                want = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                        "int32": torch.int32}[str(jrun[name].dtype)]
                assert t.dtype == want == brun[name].dtype, (arch, name)


def test_cache_struct_matches_jax():
    """Full-size hymba-1.5b and xlstm-1.3b: every cache field's shape
    and logical axes equal the reference's (the parameter counts are
    held in test_torch_mla.py)."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    for arch in ("hymba-1.5b", "xlstm-1.3b"):
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert M.cache_struct(cfg, 4, 4096) == JM.cache_struct(jcfg, 4,
                                                               4096)


def test_torch_long_context_ssm_runs_on_cpu(capsys):
    """examples/torch_long_context_ssm.py, the twin of
    examples/long_context_ssm.py: 700 tokens of context, 24 new ones."""
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "torch_long_context_ssm.py")
    spec = importlib.util.spec_from_file_location("torch_long_ctx", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    req = mod.main(["--torch-device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("torch_long_context_ssm OK")
    assert len(req.output_tokens) == 24
    assert "at 8 and at 1024 tokens of context" in out
