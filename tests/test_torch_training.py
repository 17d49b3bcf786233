"""The port's trainer against the JAX package's.

``repro_torch.models.model.loss_fn`` and its gradients are held to
``jax.value_and_grad(repro.models.model.loss_fn)`` on the same weights
and batches (numpy seeds, carried across by the bridge) for reduced
qwen3-0.6b (dense), gemma3-4b (a sliding window of 64 under a 96-token
sequence), granite-moe-3b-a800m (MoE, aux losses), deepseek-v2 (MLA and
MoE), musicgen-large (codebooks), hymba-1.5b (windowed and full
attention beside Mamba) and xlstm-1.3b (mLSTM's parallel form, sLSTM's
scan), with remat off and on, on the
unchunked and the chunked cross-entropy paths: loss within 1e-5
relative, each gradient leaf within 1e-4 of the leaf's max |g|.  Then
the trainer's attention (window, softcap, the blockwise path against the
dense one), MoE gradients at capacity drops, ``lr_at``, ``adamw_update``
on the same gradients (1e-6), ``make_train_step`` trajectories with
``grad_accum`` 1 and 2 (1e-4), checkpoints crossing both ways, the data
pipeline bit for bit, the launcher, and the kernel wrappers' refusal of
autograd.  Everything is float32 on the CPU.
"""
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.training import checkpoint as JCK  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_loop as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.kernels import flash_prefill as FP  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import paged_prefill as PP  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402
from repro_torch.training import checkpoint as CK  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as T  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_map, tree_unflatten)

ARCHS = ("qwen3-0.6b", "gemma3-4b", "granite-moe-3b-a800m",
         "deepseek-v2-236b", "musicgen-large", "hymba-1.5b", "xlstm-1.3b")
B, S = 2, 96                    # S > gemma3's reduced window of 64
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6, grad_clip=0.5)

torch.set_num_threads(1)


# ------------------------------------------------------------ helpers
def _flat(tree, prefix=""):
    """path -> numpy leaf, for dicts and (named) tuples of either
    package's arrays."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", range(len(tree)))
        return {k2: v2 for k, v in zip(fields, tree)
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _batch(cfg, seed, b=B, s=S):
    """numpy tokens, labels and weights (a fifth of them zero)."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    return {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
            "weights": (rng.random((b, s)) > 0.2).astype(np.float32)}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _configs(arch):
    return jax_reduced(arch), get_reduced_config(arch)


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(seed)))


# Leaves the loss does not depend on.  mLSTM's parallel form adds the
# input gate's bias to every key's weight of its head, and the
# stabilized weights exp(bias - max bias) cancel any such constant, so
# both packages' gradients of ``igate_b`` are rounding noise (~1e-9):
# they are held to be negligible against the tree's largest gradient.
INVARIANT = ("/run_0/mlstm/igate_b",)
INVARIANT_TOL = 1e-6


def _assert_grads_close(got, want, tol=GRAD_TOL):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        if path in INVARIANT:
            assert max(np.abs(w).max(), np.abs(got[path]).max()) \
                <= INVARIANT_TOL * top, path
            continue
        scale = np.abs(w).max()
        assert scale > 0, f"{path}: zero gradient in the reference"
        assert np.abs(got[path]).max() > 0, f"{path}: zero gradient"
        err = np.abs(got[path] - w).max()
        assert err <= tol * scale, (path, err, scale)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ------------------------------------------------------------ loss_fn
@pytest.mark.parametrize("ce_chunk", [512, 32], ids=["unchunked",
                                                     "chunked"])
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat, ce_chunk):
    jcfg, cfg = _configs(arch)
    jp = _jax_params(jcfg)
    batch = _batch(cfg, 1)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, _jax_batch(batch), remat=remat,
                             ce_chunk=ce_chunk), has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    params = bridge.params_from_numpy(jp, cfg, device="cpu")
    tb = _torch_batch(batch)
    loss, met, grads = T.value_and_grad(params, cfg, tb, remat=remat) \
        if ce_chunk == 512 else _grads_chunked(params, cfg, tb, remat,
                                               ce_chunk)
    assert _rel(loss, jloss) <= LOSS_RTOL
    assert set(met) == set(jmet)
    for k in jmet:
        assert _rel(met[k], jmet[k]) <= LOSS_RTOL, k
    if cfg.moe is not None:
        assert set(met) == {"nll", "moe_load_balance", "moe_router_z"}
    _assert_grads_close(grads, jgrads)


def _grads_chunked(params, cfg, batch, remat, ce_chunk):
    """``value_and_grad`` through ``loss_fn(..., ce_chunk=)``."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in tree_flatten(params)}
    tree = tree_unflatten(params, leaves)
    loss, met = M.loss_fn(tree, cfg, batch, remat=remat, ce_chunk=ce_chunk)
    g = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in met.items()},
            tree_unflatten(params, dict(zip(leaves, g))))


def test_loss_weights_and_chunking_agree():
    """Chunked and unchunked CE give the same loss; zero weights drop
    their positions."""
    _, cfg = _configs("qwen3-0.6b")
    params = M.init(cfg, 3, device="cpu")
    tb = _torch_batch(_batch(cfg, 2))
    with torch.no_grad():
        a, _ = M.loss_fn(params, cfg, tb, remat=False, ce_chunk=512)
        b, _ = M.loss_fn(params, cfg, tb, remat=False, ce_chunk=16)
        assert _rel(b, a) <= 1e-6
        w = tb["weights"].clone()
        w[0] = 0.0
        c, _ = M.loss_fn(params, cfg, dict(tb, weights=w), remat=False)
        d, _ = M.loss_fn(params, cfg, {k: v[1:] for k, v in tb.items()},
                         remat=False)
        assert _rel(c, d) <= 1e-6


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0),
                                            (0, 5.0), (24, 5.0)])
def test_trainer_attention_matches_jax(window, softcap):
    """``attn_causal_plain`` dense and blockwise (blocks of 16 over 40
    queries, padded) against the reference's ``attn_causal`` both ways,
    outputs and the gradients of q, k and v."""
    rng = np.random.default_rng(7)
    b, s, h, hkv, d = 2, 40, 4, 2, 16
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32)
               for n in (h, hkv, hkv))
    cot = rng.normal(size=(b, s, h, d)).astype(np.float32)

    def jax_fn(force):
        def f(q, k, v):
            o = JL.attn_causal(q, k, v, window=window, softcap=softcap,
                               block_q=16, block_k=16, force_blockwise=force)
            return jnp.sum(o * cot), o
        return jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    def torch_fn(force):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        o = layers.attn_causal_plain(*ts, window=window, softcap=softcap,
                                     block_q=16, block_k=16,
                                     force_blockwise=force)
        g = torch.autograd.grad((o * torch.from_numpy(cot)).sum(), ts)
        return o.detach().numpy(), [x.numpy() for x in g]

    for force in (False, True):
        (_, jo), jg = jax_fn(force)
        o, g = torch_fn(force)
        np.testing.assert_allclose(o, np.asarray(jo), atol=1e-5, rtol=1e-5)
        for got, want in zip(g, jg):
            want = np.asarray(want)
            assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max()
    dense, blockwise = torch_fn(False), torch_fn(True)
    np.testing.assert_allclose(blockwise[0], dense[0], atol=1e-5, rtol=1e-5)


def test_blockwise_sweeps_are_rematerialized(monkeypatch):
    """While autograd records, each q block's sweep runs under
    ``torch.utils.checkpoint``: the graph keeps none of the per-(q
    block, k block) scores and accumulators, (1, Hkv, G, bq, bk) here;
    without the checkpoint it would keep them."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 64, 2, 8)).astype(
        np.float32)).requires_grad_(True) for _ in range(3))

    def kept_shapes():
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = layers.attn_causal_plain(q, k, v, block_q=8, block_k=8,
                                           force_blockwise=True)
        assert out.requires_grad
        return shapes

    assert (1, 2, 1, 8, 8) not in kept_shapes()
    monkeypatch.setattr(layers, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    assert kept_shapes().count((1, 2, 1, 8, 8)) >= 8 * 8


# ------------------------------------------------------------ MoE grads
@pytest.mark.parametrize("capacity_factor,shared", [(4.0, 0), (1.25, 1)],
                         ids=["dropless", "capacity_shared"])
def test_moe_grads_match_jax(capacity_factor, shared):
    """Gradients through the gate values of the stable sort, the gather
    dispatch and combine, and both aux losses, with tokens dropped at
    capacity 1.25 (expert 0's router column raised)."""
    d, e, k, f = 32, 8, 2, 16
    kw = dict(num_experts=e, top_k=k, d_expert=f, num_shared_experts=shared,
              d_shared_expert=f if shared else 0,
              capacity_factor=capacity_factor)
    jm, m = JMoEConfig(**kw), MoEConfig(**kw)
    p = jax.tree.map(np.asarray, jax_init(JMOE.moe_specs(d, jm),
                                          jax.random.PRNGKey(5)))
    p["router"] = p["router"].copy()
    p["router"][:, 0] += 0.15
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def jf(p, x):
        out, aux = JMOE.moe_ffn(p, jm, x)
        return jnp.sum(out * cot) + sum(aux.values())
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    tp = tree_map(lambda a: torch.tensor(a, requires_grad=True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, routing, plan = moe.moe_ffn(tp, m, tx)
    loss = (out * torch.from_numpy(cot)).sum() + sum(
        moe.aux_losses(routing, m).values())
    leaves = [t for _, t in tree_flatten(tp)] + [tx]
    g = torch.autograd.grad(loss, leaves)
    assert _rel(loss.detach(), jl) <= LOSS_RTOL
    if capacity_factor < 2:
        assert not bool(plan.keep.all())        # tokens were dropped
    _assert_grads_close(tree_unflatten(tp, dict(zip(
        [pth for pth, _ in tree_flatten(tp)], g[:-1]))), jgp)
    _assert_grads_close({"x": g[-1]}, {"x": jgx})


# ------------------------------------------------------------ optimizer
LR_CFG = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)


@pytest.mark.parametrize("step", [0, 4, 9, 10, 11, 55, 100, 140])
def test_lr_at_matches_jax(step):
    want = JO.lr_at(JO.AdamWConfig(**LR_CFG), jnp.int32(step))
    got = O.lr_at(O.AdamWConfig(**LR_CFG), torch.tensor(step,
                                                        dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * max(float(want), 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """One update on the JAX gradients of reduced qwen3-0.6b from a state
    at step 3 with nonzero moments, clipping active (norm > 0.5): params
    and moments within 1e-6 (bf16 params within one bf16 step of
    rounding, as a float32 difference in the last bit can round
    across)."""
    jcfg, cfg = _configs("qwen3-0.6b")
    jp = _jax_params(jcfg)
    batch = _jax_batch(_batch(cfg, 4, s=32))
    (_, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, batch, remat=False),
        has_aux=True))(jax.tree.map(jnp.asarray, jp))
    rng = np.random.default_rng(3)
    mu = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(
        np.float32), jp)
    nu = jax.tree.map(lambda a: (rng.random(a.shape) * 1e-5).astype(
        np.float32), jp)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), jp)
    jgrads = jax.tree.map(lambda a: a.astype(jdt), jgrads)
    cfg_opt = dict(OPT, warmup_steps=10)
    jstate = JO.AdamWState(jnp.int32(3), jax.tree.map(jnp.asarray, mu),
                           jax.tree.map(jnp.asarray, nu))
    jnew, jst, jmet = jax.jit(JO.adamw_update, static_argnums=0)(
        JO.AdamWConfig(**cfg_opt), jgrads, jstate, jparams)
    assert float(jmet["grad_norm"]) > 0.5           # clipping is active

    tdt = getattr(torch, dtype)
    state = bridge.train_state_from_numpy(
        JT.TrainState(jp, JO.AdamWState(np.int32(3), mu, nu)), cfg,
        dtype=tdt, device="cpu")
    grads = bridge.params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg,
                                     dtype=tdt, device="cpu")
    new, st, met = O.adamw_update(O.AdamWConfig(**cfg_opt), grads,
                                  state.opt, state.params)
    assert int(st.step) == 4 and st.step.dtype == torch.int32
    assert _rel(met["grad_norm"], jmet["grad_norm"]) <= 1e-6
    assert _rel(met["lr"], jmet["lr"]) <= 1e-6
    for got, want in ((st.mu, jst.mu), (st.nu, jst.nu)):
        for path, w in _flat(want).items():
            np.testing.assert_allclose(_flat(got)[path], w, rtol=1e-6,
                                       atol=1e-9, err_msg=path)
    got_p, want_p = _flat(new), _flat(jnew)
    for path, w in want_p.items():
        assert new_dtype(new, path) == tdt
        if dtype == "float32":
            np.testing.assert_allclose(got_p[path], w, rtol=1e-6, atol=1e-7,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(got_p[path], w, rtol=2 ** -7,
                                       atol=1e-7, err_msg=path)


def new_dtype(tree, path):
    for key in path.strip("/").split("/"):
        tree = tree[key]
    return tree.dtype


def test_adamw_init_and_global_norm():
    params = {"a": torch.ones(2, 3, dtype=torch.bfloat16),
              "b": {"c": torch.full((4,), 2.0)}}
    st = O.adamw_init(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert st.mu["a"].dtype == torch.float32 and st.nu["b"]["c"].shape == (4,)
    assert float(O.global_norm(params)) == pytest.approx(math.sqrt(6 + 16))


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_train_step_trajectory_matches_jax(arch, grad_accum):
    """Three steps from the same state on the same batches: loss and
    grad-norm trajectories within 1e-4 relative (parameters are not
    compared element by element: Adam amplifies last-bit noise where a
    gradient is near zero)."""
    jcfg, cfg = _configs(arch)
    jp = _jax_params(jcfg)
    jstate = JT.TrainState(jax.tree.map(jnp.asarray, jp),
                           JO.adamw_init(jax.tree.map(jnp.asarray, jp)))
    state = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          cfg, device="cpu")
    jstep = jax.jit(JT.make_train_step(jcfg, JO.AdamWConfig(**OPT),
                                       remat=True, grad_accum=grad_accum))
    step = T.make_train_step(cfg, O.AdamWConfig(**OPT), remat=True,
                             grad_accum=grad_accum)
    for i in range(3):
        batch = _batch(cfg, 10 + i, b=4, s=32)
        jstate, jm = jstep(jstate, _jax_batch(batch))
        state, m = step(state, _torch_batch(batch))
        assert set(m) == set(jm)
        for k in ("loss", "grad_norm", "lr"):
            assert _rel(m[k], jm[k]) <= 1e-4, (i, k)
    assert int(state.opt.step) == 3


def test_grad_accum_two_equals_one():
    """On one batch of a dense model, two micro-batches give the step's
    loss and gradient norm of one batch."""
    _, cfg = _configs("qwen3-0.6b")
    state = T.init_state(cfg, 0, device="cpu")
    batch = _batch(cfg, 5, b=4, s=32)
    batch["weights"][:] = 1.0           # equal micro-batch weights
    opt = O.AdamWConfig(**OPT)
    _, m1 = T.make_train_step(cfg, opt, grad_accum=1)(
        state, _torch_batch(batch))
    _, m2 = T.make_train_step(cfg, opt, grad_accum=2)(
        state, _torch_batch(batch))
    for k in ("loss", "grad_norm"):
        assert _rel(m2[k], m1[k]) <= 1e-5, k


def test_train_step_leaves_state_untouched():
    """A step returns new trees; the old state's tensors and their
    requires_grad stay as they were."""
    _, cfg = _configs("qwen3-0.6b")
    state = T.init_state(cfg, 0, device="cpu")
    before = {k: v.clone() for k, v in tree_flatten(state.params)}
    new, m = T.make_train_step(cfg, O.AdamWConfig(**OPT))(
        state, _torch_batch(_batch(cfg, 6, s=32)))
    for k, v in tree_flatten(state.params):
        assert torch.equal(v, before[k]) and not v.requires_grad
    assert not all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_flatten(new.params), tree_flatten(state.params)))
    assert all(not v.requires_grad for _, v in tree_flatten(new.params))
    assert math.isfinite(float(m["loss"]))


def test_train_loop_history_and_checkpoints(tmp_path):
    _, cfg = _configs("qwen3-0.6b")
    data = P.synthetic_lm_batches(cfg.vocab_size, 2, 16, device="cpu",
                                  corpus_tokens=5000)
    state, hist = T.train_loop(cfg, O.AdamWConfig(**OPT), data, 5,
                               log_every=2, checkpoint_dir=str(tmp_path),
                               checkpoint_every=2, device="cpu")
    assert [h["step"] for h in hist] == [0, 2, 4]
    assert set(hist[0]) == {"loss", "nll", "grad_norm", "lr", "step",
                            "elapsed_s"}
    assert CK.latest_step(str(tmp_path)) == 4
    assert int(CK.restore(str(tmp_path), state).opt.step) == 4


# ------------------------------------------------------------ trees
@pytest.mark.parametrize("case", ["nested_dicts", "sequences", "train_state"])
def test_tree_walker_matches_jax(case):
    """``repro_torch.tree`` walks leaves in jax's order (dict keys
    sorted, sequences and NamedTuple fields in order), maps over them
    keeping the structure, and ``tree_unflatten`` inverts
    ``tree_flatten``."""
    a = lambda i: np.full((2,), i, np.float32)  # noqa: E731
    tree = {
        "nested_dicts": {"b": {"y": a(1), "x": a(2)}, "a": a(3)},
        "sequences": {"z": (a(1), [a(2), a(3)]), "c": [a(4)]},
        "train_state": T.TrainState(
            {"run_1": {"w": a(1)}, "run_0": {"w": a(2)}, "emb": a(3)},
            O.AdamWState(np.int32(4), {"k": a(5), "j": a(6)},
                         {"k": a(7), "j": a(8)})),
    }[case]
    got, want = tree_leaves(tree), jax.tree.leaves(tree)
    assert len(got) == len(want)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    doubled = tree_map(lambda x, y: x + y, tree, tree)
    assert jax.tree.structure(doubled) == jax.tree.structure(tree)
    assert all(np.array_equal(x, 2 * y) for x, y in zip(
        tree_leaves(doubled), want))
    back = tree_unflatten(tree, dict(tree_flatten(tree)))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(x is y for x, y in zip(tree_leaves(back), got))


# ------------------------------------------------------------ checkpoints
def _states(arch="qwen3-0.6b"):
    """A JAX TrainState after one step and the port's copy of it."""
    jcfg, cfg = _configs(arch)
    jp = jax.tree.map(jnp.asarray, _jax_params(jcfg))
    jstate = JT.TrainState(jp, JO.adamw_init(jp))
    jstate, _ = jax.jit(JT.make_train_step(jcfg, JO.AdamWConfig(**OPT),
                                           remat=False))(
        jstate, _jax_batch(_batch(cfg, 8, s=16)))
    return jcfg, cfg, jstate, bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_crosses_the_bridge(dtype):
    """A JAX TrainState -> the port's -> numpy again is the same state
    bit for bit (bf16 params as ml_dtypes arrays, float32 moments, the
    int32 step), and the JAX trainer steps from it."""
    jcfg, cfg, jstate, _ = _states()
    jdt = getattr(jnp, dtype)
    jstate = jstate._replace(params=jax.tree.map(lambda a: a.astype(jdt),
                                                 jstate.params))
    state = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          cfg, device="cpu")
    assert state.params["embedding"].dtype == getattr(torch, dtype)
    back = bridge.tree_to_numpy(state)
    assert type(back) is T.TrainState
    jleaves = jax.tree.leaves(jstate)
    leaves = tree_leaves(back)
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    restarted = JT.TrainState(
        jax.tree.map(jnp.asarray, back.params),
        JO.AdamWState(*(jax.tree.map(jnp.asarray, x) for x in back.opt)))
    _, m = jax.jit(JT.make_train_step(jcfg, JO.AdamWConfig(**OPT),
                                      remat=False))(
        restarted, _jax_batch(_batch(cfg, 8, s=16)))
    assert math.isfinite(float(m["loss"]))


def test_checkpoint_jax_to_port(tmp_path):
    _, cfg, jstate, _ = _states()
    JCK.save(str(tmp_path), 7, jstate)
    like = T.init_state(cfg, 1, device="cpu")
    got = CK.restore(str(tmp_path), like)
    assert CK.latest_step(str(tmp_path)) == 7
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == 1
    want = _flat(jstate)
    for path, v in _flat(got).items():
        np.testing.assert_array_equal(v, want[path], err_msg=path)


def test_checkpoint_port_to_jax(tmp_path):
    jcfg, _, jstate, state = _states()
    CK.save(str(tmp_path), 3, state)
    like = JT.init_state(jcfg, jax.random.PRNGKey(9))
    got = JCK.restore(str(tmp_path), like)
    want = _flat(jstate)
    assert int(got.opt.step) == 1
    for path, v in _flat(got).items():
        np.testing.assert_array_equal(v, want[path], err_msg=path)
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f)["latest_step"] == 3


def test_checkpoint_bfloat16_fault_matches_reference(tmp_path):
    """Both packages store a bf16 leaf as the same raw 2-byte voids, key
    for key, and neither can restore it (ROADMAP F3)."""
    jcfg, cfg, jstate, _ = _states()
    jbf = jstate._replace(params=jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), jstate.params))
    state = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jbf), cfg,
                                          dtype=torch.bfloat16, device="cpu")
    jpath = JCK.save(str(tmp_path / "jax"), 1, jbf)
    path = CK.save(str(tmp_path / "port"), 1, state)
    with np.load(jpath) as a, np.load(path) as b:
        assert set(a.files) == set(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
    with pytest.raises(ValueError, match="F3"):
        CK.restore(str(tmp_path / "jax"), state)
    with pytest.raises(ValueError):
        JCK.restore(str(tmp_path / "port"), jbf)


# ------------------------------------------------------------ data
@pytest.mark.parametrize("num_codebooks", [0, 4])
def test_synthetic_batches_match_jax(num_codebooks):
    want = JP.synthetic_lm_batches(300, 3, 24, num_codebooks=num_codebooks,
                                   seed=5, corpus_tokens=4000)
    got = P.synthetic_lm_batches(300, 3, 24, num_codebooks=num_codebooks,
                                 seed=5, corpus_tokens=4000, device="cpu")
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == {"weights": torch.float32}.get(
                k, torch.int32)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_byte_tokenizer_and_corpus_match_jax():
    text = "héllo, wörld"
    assert np.array_equal(P.ByteTokenizer().encode(text),
                          JP.ByteTokenizer().encode(text))
    assert P.ByteTokenizer().decode(P.ByteTokenizer().encode(text)) == text
    np.testing.assert_array_equal(P.markov_corpus(2000, 97, seed=3),
                                  JP.markov_corpus(2000, 97, seed=3))


# ------------------------------------------------------------ launcher
def test_launch_train_debug_on_cpu(tmp_path, capsys):
    log = tmp_path / "hist.json"
    hist = launch_train.main(["--arch", "qwen3-0.6b", "--debug",
                              "--torch-device", "cpu", "--steps", "21",
                              "--batch", "4", "--seq", "32", "--lr", "3e-3",
                              "--log-json", str(log)])
    assert [h["step"] for h in hist] == [0, 10, 20]
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5
    with open(log) as f:
        assert json.load(f) == hist
    assert capsys.readouterr().out.count("{'step':") == 3


def test_launch_train_refuses_multi_pod(capsys):
    """The 2x16x16 mesh needs 512 ranks: on one, the launcher refuses and
    names the world size (as it does for 16x16 without --multi-pod)."""
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen3-0.6b", "--torch-device", "cpu",
                           "--multi-pod"])
    assert "world size 512" in capsys.readouterr().err


# ------------------------------------------------------------ kernels
def _wrapper_case(name):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    if name == "flash_prefill":
        return FP.flash_prefill, (t(1, 8, 2, 16), t(1, 8, 1, 16),
                                  t(1, 8, 1, 16), i32(8))
    bt = torch.arange(4, dtype=torch.int32)[None]
    if name == "paged_prefill":
        return PP.paged_prefill, (t(1, 8, 2, 16), t(4, 4, 1, 16),
                                  t(4, 4, 1, 16), bt, i32(0), i32(8))
    return PA.paged_attention, (t(1, 2, 16), t(4, 4, 1, 16),
                                t(4, 4, 1, 16), bt, i32(9))


@pytest.mark.parametrize("name", ["flash_prefill", "paged_prefill",
                                  "paged_attention"])
def test_kernel_wrappers_refuse_autograd(name):
    """A wrapper whose input requires grad raises while autograd records,
    on the CPU as on the card; under no_grad, or with no input requiring
    grad, it runs."""
    fn, args = _wrapper_case(name)
    for i in range(3):
        grad_args = list(args)
        grad_args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*grad_args)
        with torch.no_grad():
            fn(*grad_args)
    assert not fn(*args).requires_grad


def test_train_routing_gives_qkv_grads():
    """``loss_fn`` routes attention to the trainer's plain path: it does
    not raise and every Q/K/V projection gets a nonzero gradient, while
    ``forward(impl="kernel")`` with grad-requiring weights refuses."""
    _, cfg = _configs("qwen3-0.6b")
    params = M.init(cfg, 0, device="cpu")
    tb = _torch_batch(_batch(cfg, 9, s=16))
    _, _, grads = T.value_and_grad(params, cfg, tb)
    for w in ("wq", "wk", "wv"):
        assert grads["run_0"]["attn"][w].abs().amax(dim=(1, 2, 3)).min() > 0
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in tree_flatten(params)}
    with pytest.raises(RuntimeError, match="no backward"):
        M.forward(tree_unflatten(params, leaves), cfg, tb["tokens"],
                  impl="kernel")
