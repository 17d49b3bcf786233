"""The port's PRNG and sampler against ``jax.random`` and
``repro.engine.sampling``.

Keys (``PRNGKey``, ``fold_in``, ``split``, ``row_keys``), the 32-bit
words, ``uniform``, ``gumbel`` and ``categorical`` must be bit-exact
with jax's threefry under ``jax_threefry_partitionable``; ``sample``
must give the JAX sampler's tokens, top-p's 1.0 fault (token 0 where the
float32 cumulative probability never reaches 1.0) included.  The float
steps round as XLA's CPU backend does: its exp and log are checked
directly over the inputs the sampler gives them.  The properties of
``tests/test_sampling.py`` are replayed on the port.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                       # pragma: no cover
    from _hypothesis_fallback import given, settings, st

from repro.engine import sampling as R  # noqa: E402
from repro_torch.engine import sampling as S  # noqa: E402

torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    """uint32 words or float32 values as comparable uint32 bit patterns."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.uint32)
    return x.astype(np.int64).astype(np.uint32)


def test_partitionable_threefry_is_on():
    """The counter layout ported is the partitionable one."""
    assert jax.config.jax_threefry_partitionable


# ------------------------------------------------------------------- keys
@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 2**32 - 1))
def test_key_fold_in_split_bit_exact(seed, data):
    jk, tk = jax.random.PRNGKey(seed), S.prng_key(seed)
    assert np.array_equal(_bits(jk), _bits(tk))
    assert np.array_equal(_bits(jax.random.fold_in(jk, np.uint32(data))),
                          _bits(S.fold_in(tk, data)))
    assert np.array_equal(_bits(jax.random.split(jk, 7)),
                          _bits(S.split(tk, 7)))
    a, b = S.split(tk)
    ja, jb = jax.random.split(jk)
    assert np.array_equal(_bits(ja), _bits(a))
    assert np.array_equal(_bits(jb), _bits(b))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=6),
       st.integers(0, 200_000))
def test_row_keys_bit_exact(seeds, pos0):
    positions = [pos0 + 3 * i for i in range(len(seeds))]
    want = R.row_keys(jnp.asarray(seeds, jnp.int32),
                      jnp.asarray(positions, jnp.int32))
    assert np.array_equal(_bits(want), _bits(S.row_keys(seeds, positions)))


def test_row_keys_recorded_constant():
    """The constant chip_smoke.py holds the card to."""
    assert S.row_keys([1], [5]).tolist() == [[3006591476, 2914868775]]


def test_threefry_hash_bit_exact():
    from jax._src import prng
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x = rng.integers(0, 2**32, 64, dtype=np.uint32)
    want = prng.threefry_2x32(jnp.asarray(key), jnp.asarray(x))
    k = torch.from_numpy(key.astype(np.int64))
    x64 = torch.from_numpy(x.astype(np.int64))
    y1, y2 = S.threefry2x32(k[0], k[1], x64[:32], x64[32:])
    assert np.array_equal(_bits(want), _bits(torch.cat([y1, y2])))


# ------------------------------------------------------- words and floats
@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 3000))
def test_bits_uniform_gumbel_categorical_bit_exact(seed, n):
    jk, tk = jax.random.PRNGKey(seed), S.prng_key(seed)
    assert np.array_equal(_bits(jax.random.bits(jk, (n,), jnp.uint32)),
                          _bits(S.random_bits(tk, n)))
    assert np.array_equal(_bits(jax.random.uniform(jk, (n,))),
                          _bits(S.uniform(tk, n)))
    assert np.array_equal(_bits(jax.random.gumbel(jk, (n,))),
                          _bits(S.gumbel(tk, n)))
    logits = np.random.default_rng(seed).normal(size=(3, n)).astype(
        np.float32)
    keys = S.split(tk, 3)
    want = [int(jax.random.categorical(k, jnp.asarray(lg)))
            for k, lg in zip(jax.random.split(jk, 3), logits)]
    assert S.categorical(keys, torch.from_numpy(logits)).tolist() == want


def test_exp_and_log_round_as_xla_cpu():
    """Every 8th of the 2**23 values ``uniform`` can give, through both
    logs of ``gumbel``, and exp over softmax's range (to where it
    flushes to zero), bit for bit against jnp on the CPU."""
    m = np.arange(0, 1 << 23, 8, dtype=np.uint32)
    u = np.maximum((m | np.uint32(0x3F800000)).view(np.float32) - 1.0,
                   np.finfo(np.float32).tiny).astype(np.float32)
    log = jax.jit(jnp.log)
    l1 = S._log(torch.from_numpy(u))
    assert np.array_equal(_bits(log(u)), _bits(l1))
    assert np.array_equal(_bits(log(-np.asarray(log(u)))),
                          _bits(S._log(-l1)))
    x = -np.random.default_rng(1).random(1 << 18, np.float32) * 104.0
    x = np.concatenate([x, np.float32([0.0, -0.0, -np.inf, -88.0, -87.5])])
    assert np.array_equal(_bits(jax.jit(jnp.exp)(x)),
                          _bits(S._exp(torch.from_numpy(x))))


@pytest.mark.parametrize("n", [1, 16, 17, 64, 255, 256, 257, 1000, 4097,
                               151936])
def test_sum_and_cumsum_in_xla_cpu_order(n):
    x = np.random.default_rng(n).random((2, n), np.float32)
    x *= np.random.default_rng(n + 1).random((2, n), np.float32)
    t = torch.from_numpy(x)
    assert np.array_equal(_bits(jax.jit(lambda a: jnp.sum(a, -1))(x)),
                          _bits(S._xla_sum(t)))
    assert np.array_equal(_bits(jax.jit(lambda a: jnp.cumsum(a, -1))(x)),
                          _bits(S._xla_cumsum(t)))


# ----------------------------------------------------------------- sample
def _both(logits, temps, seed=3, top_k=0, top_p=None, keyed=None):
    """(JAX tokens, port tokens) for the same inputs; ``keyed`` = (seeds,
    positions) switches to per-row keys."""
    jkeys = keys = None
    if keyed is not None:
        jkeys = R.row_keys(jnp.asarray(keyed[0], jnp.int32),
                           jnp.asarray(keyed[1], jnp.int32))
        keys = S.row_keys(*keyed)
    jtp = None if top_p is None else jnp.asarray(top_p, jnp.float32)
    want = R.sample(jnp.asarray(logits), jax.random.PRNGKey(seed),
                    jnp.asarray(temps, jnp.float32), top_k=top_k,
                    top_p=jtp, keys=jkeys)
    got = S.sample(torch.from_numpy(logits), S.prng_key(seed), temps,
                   top_k=top_k, top_p=top_p, keys=keys)
    assert got.dtype == torch.int32
    return np.asarray(want).tolist(), got.tolist()


@pytest.mark.parametrize("case", ["greedy", "temperature", "top_k",
                                  "mixed", "keyed"])
def test_sample_matches_reference(case):
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(6, 300)) * 3).astype(np.float32)
    temps = {"greedy": [0.0] * 6, "mixed": [0.0, 0.8, 0.0, 1.5, 0.3, 0.0]
             }.get(case, [0.8, 1.0, 0.5, 1.3, 0.9, 2.0])
    kw = {"top_k": dict(top_k=7),
          "keyed": dict(keyed=([1, 2, 3, 4, 5, 6], [9, 9, 10, 11, 40, 0]))
          }.get(case, {})
    want, got = _both(logits, temps, **kw)
    assert got == want
    if case == "greedy":
        assert got == np.argmax(logits, -1).tolist()


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000), st.floats(0.05, 0.95))
def test_sample_top_p_matches_reference(seed, p):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(4, 64)) * rng.uniform(0.5, 4)).astype(
        np.float32)
    temps = [0.8, 1.0, 0.0, 0.6]
    tops = [p, 1.0 - p / 2, p, p / 2 + 0.4]
    want, got = _both(logits, temps, seed=seed, top_p=tops,
                      keyed=(rng.integers(0, 1 << 20, 4).tolist(),
                             rng.integers(0, 4096, 4).tolist()))
    assert got == want


@pytest.mark.parametrize("v", [64, 151936])
def test_top_p_one_token_zero_fault_reproduced(v):
    """At top_p = 1.0 the reference draws token 0 for the rows whose
    float32 cumulative probability stays below 1.0: the port draws the
    same tokens, those rows included, and some such rows exist here."""
    rng = np.random.default_rng(v)
    b = 8
    logits = (rng.normal(size=(b, v)) * 2).astype(np.float32)
    keyed = (list(range(b)), [17] * b)
    want, got = _both(logits, [0.8] * b, top_p=[1.0] * b, keyed=keyed)
    assert got == want
    free, _ = _both(logits, [0.8] * b, keyed=keyed)
    faulty = [i for i in range(b) if want[i] == 0 and free[i] != 0]
    assert faulty, "no row showed the top_p = 1.0 fault"


# ------------------------------------------ tests/test_sampling.py's pins
def test_greedy_is_argmax():
    logits = torch.tensor([[0.1, 3.0, -1.0], [5.0, 0.0, 4.9]])
    assert S.sample(logits, S.prng_key(0), [0.0, 0.0]).tolist() == [1, 0]


def test_top_k_restricts_support():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(4, 50)).astype(np.float32))
    top2 = torch.argsort(logits, dim=-1)[:, -2:]
    for seed in range(10):
        out = S.sample(logits, S.prng_key(seed), [1.5] * 4, top_k=2)
        for b in range(4):
            assert int(out[b]) in top2[b].tolist()


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 1000), st.floats(0.05, 0.95))
def test_top_p_never_picks_tail(seed, p):
    logits = torch.tensor([[10.0] + [0.0] * 20])
    out = S.sample(logits, S.prng_key(seed), [1.0], top_p=[p])
    assert int(out[0]) == 0


def test_mixed_batch_greedy_and_sampled():
    logits = torch.tensor([[0.0, 9.0], [9.0, 0.0]])
    out = S.sample(logits, S.prng_key(1), [0.0, 1.0])
    assert int(out[0]) == 1
    assert int(out[1]) in (0, 1)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000), st.integers(0, 4096), st.integers(2, 6))
def test_row_keys_batch_permutation_invariant(seed, pos, b):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.normal(size=(b, 32)).astype(np.float32))
    seeds = rng.integers(0, 1 << 20, b)
    positions = np.asarray([pos + i for i in range(b)])
    temps = [0.9] * b
    out = S.sample(logits, S.prng_key(0), temps,
                   keys=S.row_keys(seeds, positions))
    perm = rng.permutation(b)
    out_p = S.sample(logits[perm], S.prng_key(7), temps,
                     keys=S.row_keys(seeds[perm], positions[perm]))
    assert out[perm].tolist() == out_p.tolist()


def test_row_keys_verification_width_invariant():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    seeds, positions = [42] * 4, [10, 11, 12, 13]
    wide = S.sample(logits, S.prng_key(0), [1.0] * 4,
                    keys=S.row_keys(seeds, positions))
    for i in range(4):
        solo = S.sample(logits[i:i + 1], S.prng_key(i), [1.0],
                        keys=S.row_keys(seeds[i:i + 1], positions[i:i + 1]))
        assert int(solo[0]) == int(wide[i])
