"""The port draws the JAX package's weights from a seed: ``repro_torch.
random``'s ``normal`` and ``truncated_normal`` against ``jax.random`` bit
for bit, ``models.model.init`` against ``repro.models.model.init`` leaf
for leaf for every reduced config, the name-keyed adapters, and what
follows from them with no weights carried over: an autoloaded adapter's
greedy tokens and the ``--debug`` launcher's loss history."""
import sys
import zlib
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.engine as J  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.engine import paged_model as JPM  # noqa: E402
from repro.engine.runner import ModelRunner as JRunner  # noqa: E402
from repro.launch import train as jax_launch_train  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.configs import _MODULES, get_reduced_config  # noqa: E402
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                Request, SamplingParams)
from repro_torch.engine import paged_model as PM  # noqa: E402
from repro_torch.engine.runner import ModelRunner  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

torch.set_num_threads(1)

_JAX = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bits(x) -> np.ndarray:
    """The raw bits of a float32 or bfloat16 array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16
                   else torch.int32).numpy()
        return x.view(np.uint16 if x.dtype == np.int16 else np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


# ----------------------------------------------------------------- draws
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1,), (7, 3), (1000,), ((1 << 20) + 5,)],
                         ids=["1", "7x3", "1000", "2^20+5"])
@pytest.mark.parametrize("kind", ["normal", "truncated_normal"])
def test_draws_match_jax_bit_for_bit(kind, shape, dtype):
    """Every element equal to jax 0.9's draw from the same key."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 12345)
    key = R.fold_in(R.prng_key(3), 12345)
    if kind == "normal":
        want = jax.random.normal(jkey, shape, _JAX[dtype])
        got = R.normal(key, shape, dtype)
    else:
        want = jax.random.truncated_normal(jkey, -2.0, 2.0, shape,
                                           _JAX[dtype])
        got = R.truncated_normal(key, -2.0, 2.0, shape, dtype)
    assert got.shape == shape and got.dtype == dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_chunked_draw_equals_one_chunk():
    """Drawing in chunks continues the flat counters: the chunk size does
    not change a value."""
    key = R.prng_key(5)
    whole = R._draw(key, (3000,), torch.float32, -0.5, 0.5)
    parts = R._draw(key, (3000,), torch.float32, -0.5, 0.5, chunk=1024)
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_table_draw_equals_elementwise_draw(monkeypatch, dtype):
    """A draw read from the table of every value the deciding random bits
    can give equals the elementwise chain on the same bits, and the
    int32 threefry gives the int64 masked words it replaced (the
    reference's rounds, written out here)."""
    key = R.fold_in(R.prng_key(7), 99)
    b = R._BOUNDS[dtype]
    direct = R._values((R._bits32(key, 5000) >> 9) & 0x7FFFFF
                       if dtype == torch.float32
                       else R._bits32(key, 5000) & 0xFF,
                       dtype, *b["erf"], b["clip"]).to(dtype)
    monkeypatch.setattr(R, "TABLE_MIN", 1)
    table = R.truncated_normal(key, -2.0, 2.0, (5000,), dtype)
    assert torch.equal(table.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                       direct.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32))
    mask, j = 0xFFFFFFFF, torch.arange(5000, dtype=torch.int64)
    k1, k2 = (int(v) for v in key)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(0 + k1) & mask, (j + k2) & mask]
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x[0] = (x[0] + x[1]) & mask
            x[1] = (((x[1] << r) | (x[1] >> (32 - r))) & mask) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & mask
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & mask
    assert torch.equal(R.random_bits(key, 5000), x[0] ^ x[1])


def test_erf_inv_matches_xla_on_every_uniform_value():
    """``erf_inv`` on all 2**23 float32 values ``uniform`` can give for
    ``normal`` (its whole domain, the sqrt branch near +-1 included):
    bit for bit with ``lax.erf_inv``."""
    floats = (np.arange(1 << 23, dtype=np.uint32) | 0x3F800000).view(
        np.float32) - np.float32(1.0)
    lo = np.float32(R._BOUNDS[torch.float32]["next_m1"])
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    got = R.erf_inv(torch.from_numpy(u))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_recorded_bounds_are_jax_s():
    """The per-dtype bounds ``random`` records are what jax computes."""
    for dtype, b in R._BOUNDS.items():
        jd = _JAX[dtype]
        sqrt2 = np.array(np.sqrt(2), jd)
        erf = jax.jit(lambda x: jax.lax.erf(x / sqrt2))
        assert (float(erf(jd(-2.0))), float(erf(jd(2.0)))) == b["erf"]
        assert float(np.nextafter(np.array(-1.0, jd),
                                  np.array(0.0, jd))) == b["next_m1"]
        assert float(jax.lax.nextafter(jd(-2.0), jd(np.inf))) == b["clip"][0]
        assert float(jax.lax.nextafter(jd(2.0), jd(-np.inf))) == b["clip"][1]


# ------------------------------------------------------------ parameters
@pytest.mark.parametrize("arch", sorted(_MODULES))
def test_init_matches_jax_leaf_for_leaf(arch):
    """``M.init(cfg, 0)`` equals ``repro``'s ``init(cfg, PRNGKey(0))``
    bit for bit, for all 11 reduced configs."""
    jparams = JM.init(jax_reduced(arch), jax.random.PRNGKey(0))
    want = {"/" + "/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = dict(tree_flatten(M.init(get_reduced_config(arch), 0,
                                   device="cpu")))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(_bits(t), _bits(want[path]),
                                      err_msg=path)


def test_init_casts_after_drawing_in_float32():
    """A bfloat16 init is the float32 draw cast, as the reference's."""
    cfg = get_reduced_config("qwen3-0.6b")
    f32 = dict(tree_flatten(M.init(cfg, 1, device="cpu")))
    bf16 = dict(tree_flatten(M.init(cfg, 1, torch.bfloat16, device="cpu")))
    for path, t in bf16.items():
        assert torch.equal(t, f32[path].to(torch.bfloat16)), path


# -------------------------------------------------------------- adapters
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["sql", "chat"])
def test_make_adapter_matches_jax(name, dtype):
    """The runner's name key and ``make_adapter``'s four draws equal the
    reference's, bit for bit."""
    jcfg, cfg = jax_reduced("qwen3-0.6b"), get_reduced_config("qwen3-0.6b")
    jkey = JRunner._adapter_key(
        SimpleNamespace(_adapter_base_key=jax.random.PRNGKey(0 + 2)), name)
    key = ModelRunner._adapter_key(SimpleNamespace(_seed=0), name)
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jkey).astype(np.int64))
    assert int(key[1]) != zlib.crc32(name.encode())     # folded, not raw
    want = JPM.make_adapter(jcfg, 8, jkey, _JAX[dtype])
    got = PM.make_adapter(cfg, 8, key, dtype)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == dtype
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


def test_autoloaded_adapter_tokens_match_jax_engine():
    """Both engines from seed 0 with nothing passed in: the base model's
    and two autoloaded adapters' greedy tokens are equal (the setup of
    ``tests/test_paged_prefill.py``'s engines, with LoRA)."""
    ecfg = dict(page_size=8, num_pages=64, max_batch=4,
                max_pages_per_seq=16, chunk_size=16)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 512, n).tolist() for n in (12, 21, 30)]
    adapters = (None, "sql", "chat")

    def run(eng, req_cls, sp_cls):
        reqs = [req_cls(prompt_tokens=list(p), lora_adapter=a,
                        sampling=sp_cls(max_new_tokens=6))
                for p, a in zip(prompts, adapters)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        return [list(r.output_tokens) for r in reqs]

    want = run(J.InferenceEngine(jax_reduced("qwen3-0.6b"),
                                 J.EngineConfig(**ecfg), seed=0),
               J.Request, J.SamplingParams)
    got = run(InferenceEngine(get_reduced_config("qwen3-0.6b"),
                              EngineConfig(**ecfg), seed=0, device="cpu"),
              Request, SamplingParams)
    assert got == want
    assert all(len(t) == 6 for t in want)


# -------------------------------------------------------------- launcher
def test_debug_launcher_loss_history_matches_jax(monkeypatch, capsys):
    """``repro_torch.launch.train --debug --torch-device cpu`` prints the
    JAX launcher's loss history for the same flags, from the same seed-0
    weights (within the trainer's 1e-4 relative)."""
    flags = ["--arch", "qwen3-0.6b", "--debug", "--steps", "11",
             "--batch", "4", "--seq", "32"]
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    jax_launch_train.main()
    rows = [eval(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{'step'")]
    hist = launch_train.main(flags + ["--torch-device", "cpu"])
    assert [h["step"] for h in hist] == [r["step"] for r in rows] == [0, 10]
    for h, r in zip(hist, rows):
        for k in ("loss", "grad_norm"):
            assert abs(h[k] - r[k]) <= 1e-4 * abs(r[k]), (h["step"], k)
