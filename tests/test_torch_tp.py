"""Tensor, sequence and expert parallelism over ``model`` in the port's
sharded train step, held to the JAX reference's GSPMD step: reduced
qwen3-0.6b at (data, model) = (1, 2) and (2, 2), reduced gemma3-4b
(SWA and dense layers) at (1, 2) and reduced granite-moe-3b-a800m at
(1, 2) with a capacity that drops tokens, three steps each, over 2 or 4
gloo processes against the reference's jitted step on as many host
devices (``AxisType.Auto``); query heads split with KV heads replicated
(``n_kv_heads=2`` at (1, 4)) against the one-process step; the
dry-run's prefill and decode steps on a mesh against one process's
logits; and, on a
fake 4-rank group through the dry-run's own functions, that no weight
split over ``model`` is all-gathered whole and that the step's
collective bytes stay within 2x of the reference's compiled HLO."""
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402
from torch.testing._internal.distributed.fake_pg import (  # noqa: E402
    FakeStore)

from repro_torch.configs import InputShape, get_reduced_config  # noqa
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.comm_analysis import StepRecorder  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, adamw_init  # noqa
from repro_torch.training.train_loop import (TrainState,  # noqa: E402
                                             make_train_step)

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-4                 # the trainer's bar (tests/test_torch_training)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
BATCH, SEQ, STEPS = 4, 32, 3
torch.set_num_threads(1)

# name -> the reduced config's changes and the (data, model) mesh
CASES = {
    "qwen3-1x2": dict(arch="qwen3-0.6b", mesh=[1, 2]),
    "qwen3-2x2": dict(arch="qwen3-0.6b", mesh=[2, 2]),
    "gemma3-1x2": dict(arch="gemma3-4b", mesh=[1, 2]),
    "granite-1x2": dict(arch="granite-moe-3b-a800m", mesh=[1, 2],
                        capacity_factor=0.5),
    "qwen3-kv2-1x4": dict(arch="qwen3-0.6b", mesh=[1, 4], n_kv_heads=2),
}
REFERENCE = ("qwen3-1x2", "qwen3-2x2", "gemma3-1x2", "granite-1x2")
# the dry-run's prefill and decode steps on a mesh: a (1, 2) mesh with
# KV heads split, (1, 4) with KV heads replicated (the cache split over
# its sequence instead), gemma3's ring buffer at (2, 2), granite's
# experts at (1, 4)
SERVE_CASES = {
    "qwen3-1x2": CASES["qwen3-1x2"],
    "qwen3-kv2-1x4": CASES["qwen3-kv2-1x4"],
    "gemma3-2x2": dict(arch="gemma3-4b", mesh=[2, 2]),
    "granite-1x4": dict(arch="granite-moe-3b-a800m", mesh=[1, 4]),
}
SERVE_LEN, SERVE_TOL = 40, 1e-5
# the reference's HLO at these meshes, for the collective bytes
BYTES_MESHES = {"qwen3-1x4": dict(arch="qwen3-0.6b", mesh=[1, 4]),
                "qwen3-2x2": CASES["qwen3-2x2"]}
# the gather-everything step's per-device bytes by the same method (the
# dry-run's input_specs and step_fn on a fake 4-rank group), before the
# model axis ran tensor-parallel
GATHERED_BYTES = {"qwen3-1x4": 5_506_568, "qwen3-2x2": 8_392_468}

_CFG = r"""
def reduced(get, case):
    import dataclasses
    cfg = get(case["arch"])
    if "n_kv_heads" in case:
        cfg = cfg.replace(n_kv_heads=case["n_kv_heads"])
    if "capacity_factor" in case:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity_factor"]))
    return cfg
"""
exec(_CFG)

JAX_REF = _CFG + r"""
import json, sys, jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_reduced_config
from repro.data.pipeline import synthetic_lm_batches
from repro.launch import hlo_analysis
from repro.models import model as JM, sharding as JS
from repro.training import optimizer as JO, train_loop as JT
cases, out = json.loads(sys.argv[1]), {}
for name, c in cases.items():
    cfg = reduced(get_reduced_config, c)
    d, m = c["mesh"]
    # Auto axes: jax 0.9's make_mesh makes Explicit ones by default,
    # which with_sharding_constraint refuses
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         devices=jax.devices()[:d * m],
                         axis_types=(AxisType.Auto, AxisType.Auto))
    ctx, zero1 = JS.ShardingCtx(mesh), JS.ShardingCtx(mesh, fsdp=False)
    axes = JM.param_axes(cfg)
    params = JM.init(cfg, jax.random.PRNGKey(0))
    # the dry-run's regime below 8B: weights ZeRO-1, moments 2D
    state = jax.device_put(
        JT.TrainState(params, JO.adamw_init(params)),
        JT.TrainState(JS.tree_shardings(zero1, params, axes),
                      JO.AdamWState(NamedSharding(mesh, P()),
                                    JS.tree_shardings(ctx, params, axes),
                                    JS.tree_shardings(ctx, params, axes))))
    step = JT.make_train_step(cfg, JO.AdamWConfig(**json.loads(
        sys.argv[3])), remat=True)
    it = synthetic_lm_batches(cfg.vocab_size, *c["batch"])
    bsh = ctx.sharding_for(tuple(c["batch"]), ("batch", "seq"))
    rows = []
    with mesh, JS.use_sharding(ctx):
        fn = jax.jit(step)
        for i in range(c["steps"]):
            b = jax.device_put(next(it), bsh)
            if i == 0:
                coll = hlo_analysis.collective_report(
                    fn.lower(state, b).compile().as_text())
            state, met = fn(state, b)
            rows.append({k: float(v) for k, v in met.items()})
    out[name] = {"rows": rows, "coll": coll}
json.dump(out, open(sys.argv[2], "w"))
"""

WORKER = _CFG + r"""
import json, sys, torch, torch.distributed as dist
rank, world, port, cases, serve, out, opt = sys.argv[1:8]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=int(rank), world_size=int(world))
from repro_torch.configs import get_reduced_config
from repro_torch.data import synthetic_lm_batches
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M, sharding
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import TrainState, make_train_step
from repro_torch.tree import tree_flatten, tree_unflatten


# the step's gradients with the backward (and so the remat recompute)
# inside the step's context, against the same with the backward run on
# another thread, where the context is unset (CUDA runs a backward on
# autograd's device thread): the largest difference over the largest
# gradient
def thread_grads(cfg, ctx, state, b):
    import threading
    flat = tree_flatten(state.params)
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    tree = tree_unflatten(state.params, {p: t for (p, _), t in
                                         zip(flat, leaves)})
    grads = []
    for other_thread in (False, True):
        with sharding.use_sharding(ctx.local(b["tokens"].placements)):
            loss, _ = M.loss_fn(tree, cfg, {
                k: sharding.batch_shard(v) for k, v in b.items()})
            if not other_thread:
                grads.append(torch.autograd.grad(loss, leaves))
        if other_thread:
            out = []
            t = threading.Thread(target=lambda: out.append(
                torch.autograd.grad(loss, leaves)))
            t.start()
            t.join()
            grads.append(out[0])
    full = [[g.full_tensor() for g in gs] for gs in grads]
    top = max(float(g.abs().max()) for g in full[0])
    return max(float((a - c).abs().max()) for a, c in zip(*full)) / top


res = {}
for name, c in json.loads(cases).items():
    cfg = reduced(get_reduced_config, c)
    ctx = sharding.ShardingCtx(make_debug_mesh(*c["mesh"]))
    params = sharding.distribute(ctx, M.init(cfg, 0, device="cpu"),
                                 M.param_axes(cfg))
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, AdamWConfig(**json.loads(opt)),
                           remat=True, ctx=ctx)
    it = synthetic_lm_batches(cfg.vocab_size, *c["batch"], device="cpu")
    rows = []
    for i in range(c["steps"]):
        b = sharding.distribute(ctx, next(it), {
            k: ("batch", "seq") for k in ("tokens", "labels", "weights")})
        state, m = step(state, b)
        rows.append({k: float(v) for k, v in m.items()})
    res[name] = rows
    res[name + "/thread"] = thread_grads(cfg, ctx, state, b)
# prefill and one decode step (the dry-run's steps) against one
# process's logits: each rank's rows and vocab slice, the error relative
# to the logits' scale, the worst over the ranks
from repro_torch.configs import InputShape
from repro_torch.launch import dryrun
for name, c in json.loads(serve).items():
    cfg = reduced(get_reduced_config, c)
    (b, s), n = c["batch"], c["cache_len"]
    ctx = sharding.ShardingCtx(make_debug_mesh(*c["mesh"]))
    full = M.init(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                        dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab_size, (b,), generator=g,
                        dtype=torch.int32)
    pos = torch.full((b,), s, dtype=torch.int32)
    c1 = M.init_cache(cfg, b, n, device="cpu")
    want = [M.prefill(full, cfg, tok.long(), c1, impl="train")[0],
            M.decode_step(full, cfg, c1, nxt.long(), pos.long())[0]]
    caches = sharding.distribute(ctx, M.init_cache(cfg, b, n, device="cpu"),
                                 M.cache_axes(cfg, b, n))
    params = sharding.distribute(ctx, full, M.param_axes(cfg))
    got = [dryrun.step_fn(cfg, InputShape("p", s, b, "prefill"), ctx)(
        params, caches, sharding.distribute(ctx, tok, ("batch", "seq")))[0]]
    got.append(dryrun.step_fn(cfg, InputShape("d", n, b, "decode"), ctx)(
        params, caches, *(sharding.distribute(ctx, t, ("batch",))
                          for t in (nxt, pos)))[0])
    di, mi = ctx.mesh.get_coordinate()
    d, m = c["mesh"]
    errs = []
    for gl, w in zip(got, want):
        v = gl.shape[-1]
        w = w[di * b // d:(di + 1) * b // d, mi * v:(mi + 1) * v]
        errs.append(float((gl - w).abs().max() / w.abs().max()))
    every = [None] * int(world)
    dist.all_gather_object(every, errs)
    res[name + "/serve"] = [max(e[i] for e in every) for i in range(2)]
if rank == "0":
    json.dump(res, open(out, "w"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spec(case):
    return dict(case, batch=[BATCH, SEQ], steps=STEPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests compare, started at once: the reference's
    steps and HLO in one JAX process with 4 host devices, and the port's
    steps in a world of 2 gloo processes ((1, 2) meshes) and one of 4
    ((2, 2) and (1, 4))."""
    tmp = tmp_path_factory.mktemp("tp")
    opt = json.dumps(OPT)
    jax_cases = {n: _spec(CASES[n]) for n in REFERENCE}
    jax_cases.update({n: dict(_spec(c), steps=1)
                      for n, c in BYTES_MESHES.items() if n not in CASES})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_REF, json.dumps(jax_cases),
         str(tmp / "jax.json"), opt],
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for world in (2, 4):
        cases = {n: _spec(c) for n, c in CASES.items()
                 if c["mesh"][0] * c["mesh"][1] == world}
        serve = {n: dict(_spec(c), cache_len=SERVE_LEN)
                 for n, c in SERVE_CASES.items()
                 if c["mesh"][0] * c["mesh"][1] == world}
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world), str(port),
             json.dumps(cases), json.dumps(serve),
             str(tmp / f"port{world}.json"), opt],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), \
        "\n".join(log[-3000:] for log in logs)
    port = {**json.loads((tmp / "port2.json").read_text()),
            **json.loads((tmp / "port4.json").read_text())}
    return json.loads((tmp / "jax.json").read_text()), port


def _close(got, want, where):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "nll", "grad_norm"):
            assert abs(g[k] - w[k]) <= RTOL * abs(w[k]), (where, i, k, g[k],
                                                          w[k])
    assert len(got) == len(want) == STEPS


@pytest.mark.parametrize("name", REFERENCE)
def test_tp_step_matches_the_reference(runs, name):
    """(a) The port's tensor-parallel step against the reference's GSPMD
    step on the same mesh shape: loss, nll and grad norm of 3 steps
    from the same weights and batches within 1e-4 relative."""
    ref, port = runs
    _close(port[name], ref[name]["rows"], name)


def test_heads_split_kv_replicated_matches_one_process(runs):
    """(b) Reduced qwen3-0.6b with 2 KV heads at model 4: each rank's one
    query head reads one of the replicated KV heads; the trajectory
    equals the one-process step's."""
    case = CASES["qwen3-kv2-1x4"]
    cfg = reduced(get_reduced_config, case)
    params = M.init(cfg, 0, device="cpu")
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, AdamWConfig(**OPT), remat=True)
    it = synthetic_lm_batches(cfg.vocab_size, BATCH, SEQ, device="cpu")
    want = []
    for _ in range(STEPS):
        state, m = step(state, next(it))
        want.append({k: float(v) for k, v in m.items()})
    _close(runs[1]["qwen3-kv2-1x4"], want, "qwen3-kv2-1x4")


@pytest.mark.parametrize("name", CASES)
def test_remat_recompute_keeps_the_step_context(runs, name):
    """The remat recompute of the sharded step, run by a backward on
    another thread (as CUDA runs every backward, on autograd's device
    thread, where the sharding context variable is unset), gives the
    gradients of a backward inside the step's context."""
    assert runs[1][name + "/thread"] <= 1e-6


@pytest.mark.parametrize("name", SERVE_CASES)
def test_tp_prefill_and_decode_match_one_process(runs, name):
    """The dry-run's prefill and decode steps run tensor-parallel on a
    mesh: each rank's logits (its rows, its vocab slice) equal one
    process's ``prefill`` and next ``decode_step`` from the same weights
    and tokens, within 1e-5 of the logits' scale; the cache written by
    the sharded prefill is the one the sharded decode reads."""
    errs = runs[1][name + "/serve"]
    assert max(errs) <= SERVE_TOL, errs


@pytest.fixture(scope="module")
def fake_steps():
    """The dry-run's train step (its input_specs and step_fn) of reduced
    qwen3-0.6b at batch 4 x 32 on a fake 4-rank group, one per mesh of
    ``BYTES_MESHES``, under ``FakeTensorMode`` and a ``StepRecorder``;
    with each mesh's context."""
    cfg = get_reduced_config("qwen3-0.6b")
    shape = InputShape("tp", SEQ, BATCH, "train")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        out = {}
        for name, case in BYTES_MESHES.items():
            ctx = sharding.ShardingCtx(make_debug_mesh(*case["mesh"]))
            rec = StepRecorder()
            with FakeTensorMode(allow_non_fake_inputs=True):
                kwargs = dryrun.input_specs(cfg, shape, ctx)
                fn = dryrun.step_fn(cfg, shape, ctx)
                rec.own(kwargs)
                with rec:
                    fn(**kwargs)
            out[name] = (ctx, rec)
    finally:
        dist.destroy_process_group()
    return cfg, out


def test_no_model_split_weight_is_gathered_whole(fake_steps):
    """(c) At (1, 4) no all-gather returns as many elements as a weight
    that ``placements_for`` splits over ``model`` (a layer's view of a
    stacked leaf, or the embedding: the collective's raw result stacks
    the ranks' shards along dim 0, so its shape is not the weight's),
    and the model-axis collectives do run: the batch shard's rows
    gathered before the column-parallel products and reduce-scattered
    into each rank's rows after the row-parallel ones."""
    cfg, out = fake_steps
    ctx, rec = out["qwen3-1x4"]
    whole = set()
    m = ctx.model_dim

    def visit(axes, t, stacked):
        if isinstance(axes, dict):
            for k in axes:
                visit(axes[k], t[k], stacked or k.startswith("run_"))
            return
        if isinstance(ctx.placements_for(t.shape, axes)[m], Shard):
            whole.add(tuple(t.shape[1:] if stacked else t.shape))
    visit(M.param_axes(cfg), M.abstract(cfg), False)
    # wq/wk/wv, wo, w_gate/w_in, w_out and the embedding (both 512 x 256)
    assert {(cfg.d_model, cfg.n_heads, cfg.head_dim),
            (cfg.vocab_size, cfg.d_model)} <= whole and len(whole) == 4
    sizes = {int(np.prod(s)) for s in rec.shapes["all-gather"]}
    assert not sizes & {int(np.prod(s)) for s in whole}, sizes
    rows = BATCH * SEQ * cfg.d_model
    assert rows in sizes
    assert rows // 4 in {int(np.prod(s))
                         for s in rec.shapes["reduce-scatter"]}


def test_collective_bytes_within_twice_the_reference(runs, fake_steps):
    """(d) Per-device collective bytes of one step of reduced qwen3-0.6b
    at (1, 4) and (2, 2): at most twice the reference's compiled HLO
    (``hlo_analysis.collective_report``, the same weights' ZeRO-1
    placements), and below the gather-everything step's; the total is
    the sum of the kinds."""
    ref = runs[0]
    _cfg, out = fake_steps
    for name, (_ctx, rec) in out.items():
        rep = rec.collective_report()
        assert rep["total"] == sum(v for k, v in rep.items()
                                   if k != "total")
        want = ref[name]["coll"]["total"]
        assert 0 < rep["total"] <= 2 * want, (name, rep, ref[name]["coll"])
        assert rep["total"] < GATHERED_BYTES[name], (name, rep)


def test_reference_trajectories_agree_across_meshes(runs):
    """The reference's own step is the same math on every mesh shape:
    its (1, 2) and (2, 2) qwen3-0.6b trajectories agree within the bar
    (the check that the comparisons above compare like with like)."""
    ref = runs[0]
    _close(ref["qwen3-2x2"]["rows"], ref["qwen3-1x2"]["rows"], "reference")
    assert np.isfinite([r["loss"] for r in ref["granite-1x2"]["rows"]]).all()
