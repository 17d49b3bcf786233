"""MLA, Hymba and xLSTM layers on their model shards, and decode over a
sequence-split cache without gathering it, in the port's sharded steps:
reduced deepseek-v2-236b, hymba-1.5b and xlstm-1.3b train steps at
(data, model) = (1, 2) and (2, 2) against the reference's jitted GSPMD
step on as many host devices (``AxisType.Auto``), three steps each;
xLSTM with its heads whole and its matrix memory split by value dim
(``num_heads=2`` at (1, 4)) against the one-process step; prefill and
decode through the dry-run's steps on meshes whose caches split their
sequence (hymba with one KV head and deepseek-v2's latents at (1, 4),
gemma3-4b's ring buffer decoding past its window at (1, 2), hymba
under ``LONG_CONTEXT_RULES`` with the cache over ``data`` at (2, 2)),
with rows that see no key on some ranks, against one process's logits;
the split softmax on rows no key is visible to; the fused projections'
channels (``sharding.split_halves``); and, on a fake 4-rank group
through the dry-run's own functions, that no weight split over
``model`` is all-gathered whole, that no decode all-gathers a tensor the
size of a layer's cache, and that reduced deepseek-v2's collective
bytes stay within 2x of the reference's compiled HLO."""
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
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.comm_analysis import StepRecorder  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from test_torch_tp import JAX_REF, _CFG  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-4                 # the trainer's bar (tests/test_torch_training)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
BATCH, SEQ, STEPS = 4, 32, 3
torch.set_num_threads(1)

ARCHS = {"deepseek": "deepseek-v2-236b", "hymba": "hymba-1.5b",
         "xlstm": "xlstm-1.3b"}
# name -> the reduced config's changes and the (data, model) mesh
CASES = {f"{short}-{d}x{m}": dict(arch=arch, mesh=[d, m])
         for short, arch in ARCHS.items() for d, m in ((1, 2), (2, 2))}
# heads whole (2 at model 4), C split over its value dim
CASES["xlstm-h2-1x4"] = dict(arch="xlstm-1.3b", mesh=[1, 4], xlstm_heads=2)
REFERENCE = tuple(n for n in CASES if n != "xlstm-h2-1x4")
# prefill + decode on meshes with a sequence-split cache: the prompt
# length, the cache length, the decode steps and the rules
SERVE_CASES = {
    # KV 1 at model 4: both attention caches split over model, the query
    # heads gathered; 12 of 40 positions: ranks 2 and 3 see no key
    "hymba-kv1-1x4": dict(arch="hymba-1.5b", mesh=[1, 4], n_kv_heads=1,
                          prompt=12, cache_len=40, steps=3),
    # query heads whole too (2 at model 4): full-width hymba's layout
    "hymba-h2kv1-1x4": dict(arch="hymba-1.5b", mesh=[1, 4], n_heads=2,
                            n_kv_heads=1, prompt=12, cache_len=40, steps=3),
    # the latents over model: the expanded and the absorbed decode
    "deepseek-1x4": dict(arch="deepseek-v2-236b", mesh=[1, 4], prompt=12,
                         cache_len=40, steps=3),
    "deepseek-absorb-1x4": dict(arch="deepseek-v2-236b", mesh=[1, 4],
                                mla_absorb=True, prompt=12, cache_len=40,
                                steps=3),
    # the ring buffer split over model, decoding past the 64-token window
    "gemma3-kv1-1x2": dict(arch="gemma3-4b", mesh=[1, 2], n_kv_heads=1,
                           prompt=60, cache_len=72, steps=8),
    # LONG_CONTEXT_RULES: batch whole, the cache over data, heads and KV
    # heads over model, the prefill's rows whole on every model rank
    "hymba-long-2x2": dict(arch="hymba-1.5b", mesh=[2, 2], long=True,
                           prompt=12, cache_len=40, steps=3),
    "xlstm-h2-1x4": dict(arch="xlstm-1.3b", mesh=[1, 4], xlstm_heads=2,
                         prompt=12, cache_len=40, steps=3),
}
SERVE_BATCH, SERVE_TOL = 2, 1e-5
# reduced deepseek-v2's train step bytes against the reference's HLO
BYTES_MESH = [1, 4]

_MORE = r"""
def more(cfg, case):
    import dataclasses
    if "xlstm_heads" in case:
        cfg = cfg.replace(xlstm=dataclasses.replace(
            cfg.xlstm, num_heads=case["xlstm_heads"]))
    if "n_heads" in case:
        cfg = cfg.replace(n_heads=case["n_heads"])
    if "mla_absorb" in case:
        cfg = cfg.replace(mla_absorb=case["mla_absorb"])
    return cfg
"""

WORKER = _CFG + _MORE + r"""
import json, sys, torch, torch.distributed as dist
rank, world, port, spec, out, opt = sys.argv[1:7]
spec = json.loads(spec)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=int(rank), world_size=int(world))
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs import InputShape, get_reduced_config
from repro_torch.data import synthetic_lm_batches
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import layers, model as M, sharding
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import TrainState, make_train_step


def config(c):
    return more(reduced(get_reduced_config, c), c)


def trajectory(cfg, ctx, batch):
    params = M.init(cfg, 0, device="cpu")
    if ctx is not None:
        params = sharding.distribute(ctx, params, M.param_axes(cfg))
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, AdamWConfig(**json.loads(opt)),
                           remat=True, ctx=ctx)
    it = synthetic_lm_batches(cfg.vocab_size, *batch, device="cpu")
    rows = []
    for _ in range(3):
        b = next(it)
        if ctx is not None:
            b = sharding.distribute(ctx, b, {k: ("batch", "seq") for k in b})
        state, m = step(state, b)
        rows.append({k: float(v) for k, v in m.items()})
    return rows


res = {}
for name, c in spec["train"].items():
    cfg = config(c)
    res[name] = trajectory(cfg, sharding.ShardingCtx(
        make_debug_mesh(*c["mesh"])), c["batch"])
    if c.get("one") and rank == "0":
        res[name + "/one"] = trajectory(cfg, None, c["batch"])


def whole(t, ctx, rows):
    # a rank's logits (its batch rows, its vocab slice) as the whole
    pl = [Replicate()] * ctx.mesh.ndim
    for i, p in enumerate(rows):
        if isinstance(p, Shard):
            pl[i] = Shard(0)
    if t.shape[-1] != cfg.vocab_size:
        pl[ctx.model_dim] = Shard(t.dim() - 1)
    return DTensor.from_local(t, ctx.mesh, pl, run_check=False).full_tensor()


for name, c in spec["serve"].items():
    cfg = config(c)
    b, s, n = c["batch"], c["prompt"], c["cache_len"]
    rules = sharding.LONG_CONTEXT_RULES if c.get("long") else \
        sharding.DEFAULT_RULES
    ctx = sharding.ShardingCtx(make_debug_mesh(*c["mesh"]), rules)
    full = M.init(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                        dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab_size, (c["steps"], b), generator=g,
                        dtype=torch.int32)
    c1 = M.init_cache(cfg, b, n, device="cpu")
    want = [M.prefill(full, cfg, tok.long(), c1, impl="train")[0]]
    for t in range(c["steps"]):
        want.append(M.decode_step(full, cfg, c1, nxt[t].long(), torch.full(
            (b,), s + t, dtype=torch.long))[0])
    caches = sharding.distribute(ctx, M.init_cache(cfg, b, n, device="cpu"),
                                 M.cache_axes(cfg, b, n))
    params = sharding.distribute(ctx, full, M.param_axes(cfg))
    tokens = sharding.distribute(ctx, tok, ("batch", "seq"))
    got = [dryrun.step_fn(cfg, InputShape("p", s, b, "prefill"), ctx)(
        params, caches, tokens)[0]]
    decode = dryrun.step_fn(cfg, InputShape("d", n, b, "decode"), ctx)
    for t in range(c["steps"]):
        tk, ps = (sharding.distribute(ctx, x, ("batch",)) for x in (
            nxt[t], torch.full((b,), s + t, dtype=torch.int32)))
        got.append(decode(params, caches, tk, ps)[0])
    rows = ctx.placements_for((b,), ("batch",))
    res[name + "/serve"] = [float((whole(gl, ctx, rows) - w).abs().max()
                                  / w.abs().max())
                            for gl, w in zip(got, want)]

if spec.get("checks"):
    ctx = sharding.ShardingCtx(make_debug_mesh(1, int(world)))
    r = ctx.mesh.get_local_rank("model")
    g = torch.Generator().manual_seed(2)
    # split_halves: a rank's column shard of [x_in | z] -> its channels
    for width in (64, 48):
        x = torch.randn(2, 5, 16, generator=g)
        w = torch.randn(16, 2 * width, generator=g)
        x_in, z = (x @ w).chunk(2, -1)
        cw = width // int(world)
        with sharding.use_sharding(ctx.local((Replicate(), Replicate()),
                                             serve=True)):
            shard = w.chunk(int(world), -1)[r]
            mine = sharding.split_halves(x @ shard, cw, width)
            both = sharding.split_halves(x @ shard, width, width)
        lo = r * cw
        want = torch.cat([x_in[..., lo:lo + cw], z[..., lo:lo + cw]], -1)
        res.setdefault("halves", []).append(max(
            float((mine - want).abs().max()),
            float((both - torch.cat([x_in, z], -1)).abs().max())))
    # the split softmax: rows with keys on one rank only, and rows that
    # see no key at all (the reference's finite fill: V averaged)
    q = torch.randn(3, 4, 2, 8, generator=g)
    k = torch.randn(3, 8, 1, 8, generator=g)
    v = torch.randn(3, 8, 1, 8, generator=g)
    mask = torch.rand(3, 4, 8, generator=g) < 0.5
    mask[0] = False
    mask[1, :, 2:] = False
    want = layers.attention(q, k, v, mask)
    n = 8 // int(world)
    split = sharding.SeqSplit((1,), r, True)
    with sharding.use_sharding(ctx.local((Replicate(), Replicate()),
                                         serve=True)):
        got = layers.attention(q, k[:, r * n:(r + 1) * n],
                               v[:, r * n:(r + 1) * n],
                               mask[..., r * n:(r + 1) * n], split=split)
    res["softmax"] = float((got - want).abs().max())
    res["uniform"] = float((got[0] - v[0].mean(0)).abs().max())

if rank == "0":
    json.dump(res, open(out, "w"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world(case) -> int:
    return case["mesh"][0] * case["mesh"][1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests compare, started at once: the reference's
    steps (and the HLO at ``BYTES_MESH``) in one JAX process with 4 host
    devices, and the port's in a world of 2 gloo processes and one of
    4."""
    tmp = tmp_path_factory.mktemp("tpl")
    opt = json.dumps(OPT)
    spec = lambda c: dict(c, batch=[BATCH, SEQ], steps=STEPS)  # noqa
    jax_cases = {n: spec(CASES[n]) for n in REFERENCE}
    jax_cases["deepseek-bytes"] = dict(spec(CASES["deepseek-1x2"]),
                                       mesh=BYTES_MESH, steps=1)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_REF, json.dumps(jax_cases),
         str(tmp / "jax.json"), opt],
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for world in (2, 4):
        work = {
            "train": {n: dict(spec(c), one=n not in REFERENCE)
                      for n, c in CASES.items() if _world(c) == world},
            "serve": {n: dict(c, batch=SERVE_BATCH)
                      for n, c in SERVE_CASES.items() if _world(c) == world},
            "checks": True}
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world), str(port),
             json.dumps(work), str(tmp / f"port{world}.json"), opt],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), \
        "\n".join(log[-3000:] for log in logs)
    port = {w: json.loads((tmp / f"port{w}.json").read_text())
            for w in (2, 4)}
    return json.loads((tmp / "jax.json").read_text()), port


def _close(got, want, where):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "nll", "grad_norm"):
            assert abs(g[k] - w[k]) <= RTOL * abs(w[k]), (where, i, k, g[k],
                                                          w[k])
    assert len(got) == len(want) == STEPS


@pytest.mark.parametrize("name", REFERENCE)
def test_layer_tp_step_matches_the_reference(runs, name):
    """(a) MLA (dense and MoE), Hymba and xLSTM layers on their model
    shards in the port's step against the reference's GSPMD step on the
    same mesh: loss, nll and grad norm of 3 steps from the same weights
    and batches within 1e-4 relative."""
    ref, port = runs
    _close(port[_world(CASES[name])][name], ref[name]["rows"], name)


def test_mlstm_value_split_matches_one_process(runs):
    """(a) xLSTM with 2 heads at model 4: the heads stay whole, the
    mLSTM's channels and its matrix memory's value dim split, the sLSTM
    runs whole on gathered rows; the trajectory equals one process's."""
    port = runs[1][4]
    _close(port["xlstm-h2-1x4"], port["xlstm-h2-1x4/one"], "xlstm-h2-1x4")


@pytest.mark.parametrize("name", SERVE_CASES)
def test_split_cache_prefill_and_decode_match_one_process(runs, name):
    """(b) The dry-run's prefill and decode steps on a mesh whose cache
    splits its sequence (or ring slots): each rank's logits, made whole,
    equal one process's ``prefill`` and ``decode_step``s from the same
    weights and tokens within 1e-5 of the logits' scale."""
    errs = runs[1][_world(SERVE_CASES[name])][name + "/serve"]
    assert len(errs) == SERVE_CASES[name]["steps"] + 1
    assert max(errs) <= SERVE_TOL, errs


@pytest.mark.parametrize("world", (2, 4))
def test_split_softmax_and_fused_channels(runs, world):
    """(b) The split softmax equals the whole one, on rows whose keys all
    lie on one rank and on rows that see no key (V averaged uniformly
    over every rank's keys, as the reference's finite fill gives); (e) a
    rank's ``[x_in | z]`` channels from its column shard of the fused
    projection equal one process's slices (and the halves gathered
    whole where the channels do not split)."""
    res = runs[1][world]
    assert res["softmax"] <= 1e-6 and res["uniform"] <= 1e-6, res
    assert max(res["halves"]) <= 1e-5, res["halves"]


def _whole_gathers(cfg, ctx):
    """For every weight ``placements_for`` splits over ``model`` (a
    layer's view of a stacked leaf), the raw result shape an all-gather
    of its model shards would record: the shards stacked on dim 0."""
    out = set()
    m = ctx.model_dim
    size = ctx.mesh.shape[m]

    def visit(axes, t, stacked):
        if isinstance(axes, dict):
            for k in axes:
                visit(axes[k], t[k], stacked or k.startswith("run_"))
            return
        p = ctx.placements_for(t.shape, axes)[m]
        if isinstance(p, Shard):
            shape = list(t.shape)
            shape[p.dim] //= size
            if stacked:
                shape = shape[1:]
            out.add((shape[0] * size,) + tuple(shape[1:]))
    visit(M.param_axes(cfg), M.abstract(cfg), False)
    return out


# the fake decode's cache length and batch (not 4: a (4, 1, 64) shard of
# sLSTM's output would stack like its (4, 4, 64) gate biases' shards)
FAKE_CACHE, FAKE_BATCH = 64, 8


@pytest.fixture(scope="module")
def fake_steps():
    """The dry-run's train and decode steps (its input_specs and step_fn)
    of the three reduced configs at (1, 4) on a fake 4-rank group, under
    ``FakeTensorMode`` and a ``StepRecorder``; each with its context."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        out = {}
        for short, arch in ARCHS.items():
            cfg = get_reduced_config(arch)
            if short == "hymba":    # 2 KV heads at 4: the cache over model
                cfg = cfg.replace(n_kv_heads=2)
            for kind, s, b in (("train", SEQ, BATCH),
                               ("decode", FAKE_CACHE, FAKE_BATCH)):
                c = cfg.replace(inference_weight_layout=kind == "decode")
                shape = InputShape(kind, s, b, kind)
                ctx = sharding.ShardingCtx(make_debug_mesh(1, 4))
                rec = StepRecorder()
                with FakeTensorMode(allow_non_fake_inputs=True):
                    kwargs = dryrun.input_specs(c, shape, ctx)
                    fn = dryrun.step_fn(c, shape, ctx)
                    rec.own(kwargs)
                    with rec:
                        fn(**kwargs)
                out[short, kind] = (c, ctx, rec)
    finally:
        dist.destroy_process_group()
    return out


@pytest.mark.parametrize("short", ARCHS)
@pytest.mark.parametrize("kind", ("train", "decode"))
def test_no_model_split_weight_is_gathered_whole(fake_steps, short, kind):
    """(c) At (1, 4) no all-gather of the train or decode step gathers a
    weight that ``placements_for`` splits over ``model`` whole (no raw
    result has the shape its model shards stacked on dim 0 would have);
    the model-axis collectives of the layer type run."""
    cfg, ctx, rec = fake_steps[short, kind]
    whole = _whole_gathers(cfg, ctx)
    assert whole
    shapes = {tuple(s) for s in rec.shapes["all-gather"]}
    assert not shapes & whole, (shapes & whole)
    sizes = {int(np.prod(s)) for s in shapes}
    if kind == "train":
        # rows gathered before the column-parallel products and summed
        # into each rank's rows after the row-parallel ones
        rows = BATCH * SEQ * cfg.d_model
        assert rows in sizes
        assert rows // 4 in {int(np.prod(s))
                             for s in rec.shapes["reduce-scatter"]}
    if short != "deepseek":
        assert rec.coll["all-to-all"] > 0   # [x_in | z] to channels


@pytest.mark.parametrize("short", ARCHS)
def test_no_decode_gathers_a_layer_cache(fake_steps, short):
    """(c) No decode all-gathers a tensor the size of a layer's cache:
    every all-gather of a decode step at (1, 4) is smaller than the
    smallest cache field of one layer (the batch shard's whole K, latent
    or matrix memory), and where the cache splits its sequence over
    ``model`` the softmax's all-reduces run instead."""
    cfg, ctx, rec = fake_steps[short, "decode"]
    fields = [int(np.prod(shape[1:])) for run in M.cache_struct(
        cfg, FAKE_BATCH, FAKE_CACHE) for name, (shape, _ax) in run.items()
        if name in blocks.SEQ_FIELDS + ("C",)]
    smallest = min(fields)
    sizes = [int(np.prod(s)) for s in rec.shapes["all-gather"]]
    assert max(sizes, default=0) < smallest, (sorted(sizes)[-3:], smallest)
    if short != "xlstm":
        assert rec.coll["all-reduce"] > 0


def test_mla_collective_bytes_within_twice_the_reference(runs, fake_steps):
    """(d) Per-device collective bytes of one train step of reduced
    deepseek-v2 at (1, 4): at most twice the reference's compiled HLO
    (``hlo_analysis.collective_report``, the same weights' ZeRO-1
    placements); the total is the sum of the kinds."""
    ref = runs[0]["deepseek-bytes"]["coll"]
    _cfg, _ctx, rec = fake_steps["deepseek", "train"]
    rep = rec.collective_report()
    assert rep["total"] == sum(v for k, v in rep.items() if k != "total")
    assert 0 < rep["total"] <= 2 * ref["total"], (rep, ref)
