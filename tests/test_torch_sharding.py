"""Sharding on ``torch.distributed``: ``models.sharding``'s rules against
``repro.models.sharding`` (the reference's rule cases on meshes of a fake
process group, and ``spec_for`` on every leaf of every config), the
dry-run's per-device input shards against the reference's, a 2-process
gloo train step against the 1-process step, the MoE's shard-local
dispatch against the JAX reference on 2 devices, and
``comm_analysis.collective_report`` on hand-counted collectives."""
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial,  # noqa: E402
                                      Replicate, Shard)
from torch.testing._internal.distributed.fake_pg import (  # noqa: E402
    FakeStore)

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import sharding as JS  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, _MODULES,  # noqa: E402
                                 get_config, get_reduced_config)
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.launch import comm_analysis, dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe, sharding  # noqa: E402
from repro_torch.models.sharding import (DEFAULT_RULES,  # noqa: E402
                                         LONG_CONTEXT_RULES, ShardingCtx)
from repro_torch.training.optimizer import AdamWConfig, adamw_init  # noqa
from repro_torch.training.train_loop import (TrainState,  # noqa: E402
                                             make_train_step)

jax.devices()           # jax's backend is up before the dry-run's import
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jax_dryrun  # noqa: E402
if _flags is None:      # it sets XLA_FLAGS for a fresh process: undo
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

REPO = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def fake_world():
    """A fake process group of 512 ranks (this one rank 0): meshes of up
    to 512 devices in one process, collectives that move nothing."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


def _mesh(shape=None):
    shape = shape or {"data": 16, "model": 16}
    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def _ctx(shape=None, rules=DEFAULT_RULES, **kw):
    return ShardingCtx(_mesh(shape), rules, **kw)


# ------------------------------------ tests/test_sharding.py's 8 cases
def test_batch_shards_over_data():
    ctx = _ctx()
    assert ctx.spec_for((256, 4096), ("batch", "seq")) == ("data", "model")
    assert ctx.placements_for((256, 4096), ("batch", "seq")) == (
        Shard(0), Shard(1))


def test_multipod_batch_uses_pod_and_data():
    ctx = _ctx({"pod": 2, "data": 16, "model": 16})
    assert ctx.spec_for((256, 4096), ("batch", None)) == (("pod", "data"),)
    assert ctx.placements_for((256, 4096), ("batch", None)) == (
        Shard(0), Shard(0), Replicate())


def test_divisibility_fallback_replicates():
    ctx = _ctx()
    spec = ctx.spec_for((8, 1024, 2, 64),
                        ("batch", "cache_seq", "kv_heads", None))
    assert spec == (None, "model")
    spec2 = ctx.spec_for((32, 1024, 32, 64),
                         ("batch", "cache_seq", "kv_heads", None))
    assert spec2[0] == "data" and spec2[2] == "model"
    assert spec2[1] is None


def test_no_mesh_axis_used_twice():
    spec = _ctx().spec_for((64, 4096), ("heads", "mlp"))
    assert [s for s in spec if s is not None].count("model") <= 1


def test_fsdp_toggle():
    axes = ("embed", "mlp")
    assert _ctx().spec_for((4096, 11008), axes) == ("data", "model")
    assert _ctx(fsdp=False).spec_for((4096, 11008), axes) == (None, "model")


def test_long_context_rules_shard_cache_seq_wide():
    ctx = _ctx({"pod": 2, "data": 16, "model": 16}, LONG_CONTEXT_RULES)
    spec = ctx.spec_for((1, 524288, 8, 64),
                        ("batch", "cache_seq", "kv_heads", None))
    assert spec[1] == ("pod", "data")


def test_constrain_noop_without_context_or_on_plain_tensor():
    x = torch.ones(4, 4)
    assert sharding.constrain(x, ("batch", None)) is x
    with sharding.use_sharding(_ctx()):
        assert sharding.constrain(x, ("batch", None)) is x


def test_data_shards_property():
    assert _ctx().data_shards == 16
    assert _ctx({"pod": 2, "data": 16, "model": 16}).data_shards == 32
    assert _ctx({"data": 1, "model": 1}).data_shards == 1
    # a sharded step's view: groups per batch shard
    local = _ctx().local((Shard(0), Replicate()))
    assert (local.batch_shards, local.data_shards) == (16, 1)


def test_constrain_redistributes_a_dtensor():
    ctx = _ctx({"data": 2, "model": 1})
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 4), ctx.mesh,
                               (Replicate(), Replicate()), run_check=False)
        with sharding.use_sharding(ctx):
            y = sharding.constrain(x, ("batch", None))
    assert y.placements == (Shard(0), Replicate())
    assert y.to_local().shape == (4, 4)


# ------------------------------------------------------------ meshes
def test_production_meshes_need_their_world_size():
    m = mesh_mod.make_production_mesh(multi_pod=True)    # 512 ranks here
    assert (m.mesh_dim_names, tuple(m.shape)) == (
        ("pod", "data", "model"), (2, 16, 16))
    with pytest.raises(RuntimeError, match="world size 256"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="world size 1"):
        mesh_mod.make_debug_mesh()


# ---------------------------------------- spec_for on every config leaf
def _leaves(axes_tree, shapes_tree):
    if isinstance(axes_tree, dict):
        for k in axes_tree:
            yield from _leaves(axes_tree[k], shapes_tree[k])
    elif isinstance(axes_tree, list):
        for a, s in zip(axes_tree, shapes_tree):
            yield from _leaves(a, s)
    else:
        yield tuple(shapes_tree.shape), axes_tree


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(_MODULES))
def test_spec_for_matches_reference_on_every_leaf(arch, mesh):
    """Every leaf of ``param_axes`` (training and inference layouts) and
    ``cache_axes`` (decode, long-context and reduced sizes) of the full
    and the reduced config, under both rule sets: the port's entries
    equal the reference's ``PartitionSpec`` (the reference reads only
    ``mesh.shape``: an ``AbstractMesh`` stands in for its devices)."""
    shape = MESHES[mesh]
    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    n = 0
    for rules in (DEFAULT_RULES, LONG_CONTEXT_RULES):
        for fsdp in (True, False):
            ctx, jctx = _ctx(shape, rules, fsdp=fsdp), JS.ShardingCtx(
                jmesh, rules, fsdp=fsdp)
            for full in (True, False):
                cfg = get_config(arch) if full else get_reduced_config(arch)
                jcfg = jax_config(arch) if full else jax_reduced(arch)
                cases = []
                for inf in (False, True):
                    c = cfg.replace(inference_weight_layout=inf)
                    jc = jcfg.replace(inference_weight_layout=inf)
                    assert M.param_axes(c) == JM.param_axes(jc)
                    cases += list(_leaves(M.param_axes(c),
                                          M.abstract(c)))
                for b, s in ((128, 32768), (1, 524288), (4, 64)):
                    assert M.cache_axes(cfg, b, s) == JM.cache_axes(jcfg,
                                                                    b, s)
                    cases += list(_leaves(M.cache_axes(cfg, b, s),
                                          M.abstract_cache(cfg, b, s)))
                for shp, axes in cases:
                    assert ctx.spec_for(shp, axes) == tuple(
                        jctx.spec_for(shp, axes)), (shp, axes)
                    n += 1
    assert n > 100


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-0.6b", "train_4k"), ("granite-moe-3b-a800m", "train_4k"),
    ("gemma3-4b", "decode_32k")])
def test_dryrun_input_shards_match_reference(arch, shape):
    """The dry-run's DTensor inputs on 16x16: each rank's shard has the
    shape of the reference's per-device shard (``NamedSharding.
    shard_shape``) and its dtype, leaf for leaf."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    if INPUT_SHAPES[shape].kind != "train":
        cfg = cfg.replace(inference_weight_layout=True)
        jcfg = jcfg.replace(inference_weight_layout=True)
    ctx = _ctx()
    with FakeTensorMode():
        got = dryrun.input_specs(cfg, INPUT_SHAPES[shape], ctx)
    jctx = JS.ShardingCtx(AbstractMesh((16, 16), ("data", "model")),
                          DEFAULT_RULES)
    want, _ = jax_dryrun.input_specs(jcfg, jax_dryrun.INPUT_SHAPES[shape],
                                     jctx)
    g = jax.tree.leaves(jax.tree.map(
        lambda t: (tuple(t.to_local().shape) if isinstance(t, DTensor)
                   else tuple(t.shape), str(t.dtype).split(".")[-1]),
        got, is_leaf=lambda t: isinstance(t, torch.Tensor)),
        is_leaf=lambda t: isinstance(t, tuple) and isinstance(t[1], str))
    w = jax.tree.leaves(jax.tree.map(
        lambda a: (tuple(a.sharding.shard_shape(a.shape)), str(a.dtype)),
        want), is_leaf=lambda t: isinstance(t, tuple) and isinstance(
            t[1], str))
    assert len(g) == len(w) > 10
    assert g == w


# --------------------------------------------------- collective report
def test_collective_report_counts_by_hand():
    """A (4, 3) float32 shard per rank, Shard(0) over data=16 of a 16x16
    mesh: its gather is one all-gather of 16*4*3*4 = 768 bytes a device;
    a Partial (2,) float32 over model reduced is one 8-byte all-reduce."""
    mesh = _mesh()
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 3), mesh,
                               (Shard(0), Replicate()), run_check=False)
        p = DTensor.from_local(torch.empty(2), mesh,
                               (Replicate(), Partial()), run_check=False)

        def fn():
            assert x.full_tensor().shape == (64, 3)
            p.full_tensor()
        rep = comm_analysis.collective_report(fn)
        hist = comm_analysis.op_histogram(fn)
    assert rep == {"all-gather": 768, "all-reduce": 8, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 0, "total": 776}
    assert hist["_c10d_functional.all_gather_into_tensor"] == 1
    assert hist["_c10d_functional.all_reduce"] == 1


def test_collective_report_counts_only_collectives():
    """On a 4-rank mesh of the fake group and real CPU tensors, a
    differentiable ``full_tensor`` and its backward: the op that wraps
    the differentiable gather's result runs but moves nothing, so the
    report has only the five kinds, and ``total`` is their sum (the
    gather forward, its reduce-scatter backward)."""
    mesh = _mesh({"data": 2, "model": 2})
    x = DTensor.from_local(torch.ones(4, 3, requires_grad=True), mesh,
                           (Shard(0), Replicate()), run_check=False)

    def fn():
        y = x.full_tensor(grad_placements=(Partial(), Replicate()))
        assert y.shape == (8, 3)
        y.sum().backward()
    with comm_analysis.StepRecorder() as rec:
        fn()
    rep = rec.collective_report()
    assert set(rep) == set(comm_analysis.COLLECTIVES) | {"total"}
    assert rep["total"] == sum(rep[k] for k in comm_analysis.COLLECTIVES)
    assert rep["all-gather"] == 8 * 3 * 4
    assert rep["reduce-scatter"] == 4 * 3 * 4
    assert rec.ops["_c10d_functional._wrap_tensor_autograd"] >= 1


def test_step_recorder_peak_counts_live_storages():
    with FakeTensorMode():
        with comm_analysis.StepRecorder() as rec:
            a = torch.empty(1000, dtype=torch.float32)      # 4000 B
            b = a.view(10, 100)                             # a view
            c = torch.empty(500, dtype=torch.float32)       # 2000 B
            del a, b, c
            torch.empty(250, dtype=torch.float32)           # 1000 B
    assert rec.peak_bytes == 6000 and rec.live_bytes == 0


# ------------------------------------------------------ sharded steps
WORKER = r"""
import json, sys, torch, torch.distributed as dist
rank, world, port, data, model, accum, out = sys.argv[1:8]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=int(rank), world_size=int(world))
from repro_torch.configs import get_reduced_config
from repro_torch.data import synthetic_lm_batches
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M, sharding
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import TrainState, make_train_step
cfg = get_reduced_config("qwen3-0.6b")
ctx = sharding.ShardingCtx(make_debug_mesh(int(data), int(model)))
params = sharding.distribute(ctx, M.init(cfg, 0, device="cpu"),
                             M.param_axes(cfg))
state = TrainState(params, adamw_init(params))
step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=10),
                       remat=True, grad_accum=int(accum), ctx=ctx)
it = synthetic_lm_batches(cfg.vocab_size, 4, 32, device="cpu")
rows = []
for i in range(3):
    b = sharding.distribute(ctx, next(it), {k: ("batch", "seq") for k in
                                            ("tokens", "labels",
                                             "weights")})
    state, m = step(state, b)
    rows.append({k: float(v) for k, v in m.items()})
if rank == "0":
    json.dump(rows, open(out, "w"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("data,model,accum", [(2, 1, 1), (1, 2, 1),
                                              (2, 1, 2)],
                         ids=["data2", "model2", "data2-accum2"])
def test_two_process_gloo_step_matches_one_process(tmp_path, data, model,
                                                   accum):
    """Reduced qwen3-0.6b, three steps on ``make_debug_mesh(data, model)``
    over two gloo processes: the loss, nll and grad-norm trajectories
    equal the 1-process step's within the trainer's 1e-4 relative."""
    out = tmp_path / "rows.json"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(port), str(data),
         str(model), str(accum), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    rows = json.loads(out.read_text())

    cfg = get_reduced_config("qwen3-0.6b")
    params = M.init(cfg, 0, device="cpu")
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10),
                           remat=True, grad_accum=accum)
    it = synthetic_lm_batches(cfg.vocab_size, 4, 32, device="cpu")
    for i, row in enumerate(rows):
        state, m = step(state, next(it))
        assert set(row) == set(m)
        for k in ("loss", "nll", "grad_norm", "lr"):
            assert abs(row[k] - float(m[k])) <= 1e-4 * abs(float(m[k])), \
                (i, k, row[k], float(m[k]))


JAX_MOE = r"""
import json, sys, dataclasses, numpy as np, jax
from repro.configs import get_reduced_config
from jax.sharding import AxisType
from repro.models import model as JM, moe as JMOE, sharding as JS
assert len(jax.devices()) == 2
cfg = get_reduced_config("granite-moe-3b-a800m")
mcfg = dataclasses.replace(cfg.moe, capacity_factor=0.5)
p = jax.tree.map(lambda a: a[0],
                 JM.init(cfg, jax.random.PRNGKey(0))["run_0"]["moe"])
x = np.load(sys.argv[1])
# Auto axes: jax 0.9's make_mesh (the reference's make_debug_mesh) makes
# Explicit ones, which with_sharding_constraint refuses
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
with mesh, JS.use_sharding(JS.ShardingCtx(mesh)):
    out, aux = jax.jit(lambda p, x: JMOE.moe_ffn(p, mcfg, x, cfg.act))(p, x)
np.save(sys.argv[2], np.asarray(out))
json.dump({k: float(v) for k, v in aux.items()}, open(sys.argv[3], "w"))
"""


def test_moe_dispatch_per_data_shard_matches_jax(tmp_path):
    """Reduced granite's ``moe_ffn`` under a context of 2 data shards,
    at a capacity that drops tokens: output and aux losses equal the
    JAX reference's on a 2-device mesh (run in a subprocess with 2 host
    devices), and differ from one shard's dispatch."""
    cfg = get_reduced_config("granite-moe-3b-a800m")
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    x = np.random.default_rng(3).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    subprocess.run([sys.executable, "-c", JAX_MOE, str(tmp_path / "x.npy"),
                    str(tmp_path / "out.npy"), str(tmp_path / "aux.json")],
                   env=env, check=True, timeout=300)
    want = np.load(tmp_path / "out.npy")
    want_aux = json.loads((tmp_path / "aux.json").read_text())

    p = M.layer_view(M.init(cfg, 0, device="cpu")["run_0"]["moe"], 0)
    xt = torch.from_numpy(x)
    with sharding.use_sharding(_ctx({"data": 2, "model": 1})):
        assert moe.shards(64) == 2
        out, r, pl = moe.moe_ffn(p, mcfg, xt, cfg.act)
        aux = moe.aux_losses(r, mcfg)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
    for k, v in want_aux.items():
        assert float(aux[k]) == pytest.approx(v, rel=1e-5)
    one, _, pl1 = moe.moe_ffn(p, mcfg, xt, cfg.act)
    assert not bool(pl1.keep.all()) and not torch.equal(pl.keep, pl1.keep)
    assert not np.allclose(one.numpy(), want, atol=1e-5)
