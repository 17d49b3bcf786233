"""Logical-axis -> mesh-axis sharding rules, the PyTorch counterpart of
``repro/models/sharding.py``, over a ``torch.distributed`` ``DeviceMesh``.

Every parameter / cache / activation tensor carries a tuple of logical
axis names (see ``params.Spec``).  ``ShardingCtx.spec_for`` maps those
names onto mesh axes by the reference's priority-ordered rules, with its
two safety properties:

  * a rule only fires if the dim size is divisible by the mesh-axes
    product (e.g. kv_heads=2 on model=16 falls back to replicated);
  * no mesh axis is used twice within one tensor.

``spec_for`` returns the reference's per-dim entries (a mesh-axis name,
a tuple of names, or None; trailing Nones dropped), and
``placements_for`` turns them into one DTensor placement per mesh dim:
``Shard(d)`` where a mesh dim splits tensor dim d, else ``Replicate()``.
A dim split over ("pod", "data") is ``Shard(d)`` on both, in mesh order,
which splits it pod-major as JAX's ``PartitionSpec`` does.

The active context is a context variable, as in the reference:
``constrain`` redistributes a DTensor activation to its placements and
leaves a plain tensor (and everything without a context) as it is.

The sharded train step (``training.train_loop.make_sharded_train_step``)
runs the model on each rank's shard of the batch: its context is the
mesh context's ``local`` view, in which ``gather_params`` all-gathers a
layer's DTensor weights (their gradients come back summed over the
batch shards and re-sharded, FSDP-style), ``batch_sum`` all-reduces the
few statistics a loss needs over the batch, and ``data_shards`` counts
the MoE dispatch groups on one shard.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

# Priority-ordered candidate mesh axes per logical axis.  Each candidate
# is a tuple of mesh axis names used jointly for that dim.
DEFAULT_RULES: Tuple[Tuple[str, Tuple[Tuple[str, ...], ...]], ...] = (
    ("batch", (("pod", "data"), ("data",))),
    ("vocab", (("model",),)),
    ("expert", (("model",),)),
    ("heads", (("model",),)),
    ("kv_heads", (("model",),)),
    ("mlp", (("model",),)),
    ("cache_seq", (("model",),)),          # decode: pooled-HBM KV sharding
    ("seq", (("model",),)),                # sequence parallelism (activations)
    ("embed", (("pod", "data"), ("data",))),  # FSDP weight sharding
    ("layers", ()),
)

# Variant used for long_500k: batch=1 so the data axis is free; the KV
# cache sequence dim spreads across BOTH axes = the whole pod's memory.
LONG_CONTEXT_RULES = (
    ("batch", ()),
    ("vocab", (("model",),)),
    ("expert", (("model",),)),
    ("heads", (("model",),)),
    ("kv_heads", (("model",),)),
    ("mlp", (("model",),)),
    ("cache_seq", (("pod", "data"), ("data",))),
    ("seq", (("data",),)),
    ("embed", (("pod", "data"), ("data",))),
    ("layers", ()),
)


class ShardingCtx:
    """Rules over a ``DeviceMesh`` (only its dim names and sizes are read
    by ``spec_for``).  ``batch_dims`` is empty for a mesh context; the
    ``local`` view of a sharded step names the mesh dims its batch is
    split over."""

    def __init__(self, mesh, rules=DEFAULT_RULES, fsdp: bool = True,
                 batch_dims: Tuple[int, ...] = ()):
        self.mesh = mesh
        self.rules = dict(rules)
        self.fsdp = fsdp
        self.batch_dims = tuple(batch_dims)
        self.shape: Dict[str, int] = dict(zip(mesh.mesh_dim_names,
                                              mesh.shape))

    @property
    def batch_shards(self) -> int:
        """How many shards the step's batch is split into (1 outside a
        sharded step)."""
        return math.prod(self.mesh.shape[i] for i in self.batch_dims)

    @property
    def data_shards(self) -> int:
        """Number of shards along the 'batch' logical axis (for
        shard-local MoE dispatch), per batch shard of a sharded step."""
        for cand in self.rules.get("batch", ()):
            size = self.axis_size(cand)
            if size:
                return max(size // self.batch_shards, 1)
        return 1

    def axis_size(self, names: Tuple[str, ...]) -> Optional[int]:
        size = 1
        for n in names:
            if n not in self.shape:
                return None
            size *= self.shape[n]
        return size

    def spec_for(self, shape: Sequence[int],
                 axes: Sequence[Optional[str]]) -> tuple:
        """Per-dim mesh axes; priority order = the rules' order."""
        assign: dict = {}
        used: set = set()
        # evaluate logical axes in rule-priority order, not dim order
        for rule_name, candidates in self.rules.items():
            if rule_name == "embed" and not self.fsdp:
                continue
            for dim, ax in enumerate(axes):
                if ax != rule_name or dim in assign:
                    continue
                for cand in candidates:
                    if any(c in used for c in cand):
                        continue
                    size = self.axis_size(cand)
                    if size is None or size <= 1:
                        continue
                    if shape[dim] % size == 0:
                        assign[dim] = cand if len(cand) > 1 else cand[0]
                        used.update(cand)
                        break
        entries = [assign.get(d) for d in range(len(shape))]
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def placements_for(self, shape: Sequence[int],
                       axes: Sequence[Optional[str]]) -> tuple:
        """One DTensor placement per mesh dim for ``spec_for``'s entries."""
        names = list(self.shape)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec_for(shape, axes)):
            for n in ((entry,) if isinstance(entry, str) else entry or ()):
                out[names.index(n)] = Shard(dim)
        return tuple(out)

    def local(self, batch_placements: Sequence) -> "ShardingCtx":
        """The view a sharded step runs its batch shard under: the mesh
        dims on which ``batch_placements`` (the batch's) shard dim 0."""
        dims = tuple(i for i, p in enumerate(batch_placements)
                     if isinstance(p, Shard) and p.dim == 0)
        return ShardingCtx(self.mesh, tuple(self.rules.items()), self.fsdp,
                           dims)

    @property
    def grad_placements(self) -> tuple:
        """How a gathered weight's gradient lies on the mesh inside a
        step: a partial sum over the batch shards, the same on the other
        dims (their ranks compute the same thing)."""
        return tuple(Partial() if i in self.batch_dims else Replicate()
                     for i in range(self.mesh.ndim))


_CTX: contextvars.ContextVar[Optional[ShardingCtx]] = \
    contextvars.ContextVar("sharding_ctx", default=None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingCtx]):
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def current() -> Optional[ShardingCtx]:
    return _CTX.get()


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Activation sharding constraint: a DTensor is redistributed to
    ``placements_for`` its axes; a no-op without an active context or on
    a plain tensor."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, ctx.placements_for(x.shape, axes))


# ------------------------------------------------------ inside a step
def gather_params(tree):
    """Every DTensor leaf all-gathered to a plain tensor (differentiable:
    the gradient is summed over the batch shards and re-sharded to the
    leaf's placements); plain leaves as they are."""
    ctx = _CTX.get()
    if ctx is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_params(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.full_tensor(grad_placements=ctx.grad_placements)
    return tree


def batch_shard(x: DTensor) -> torch.Tensor:
    """A rank's rows of a batch DTensor: the shard of its dim-0 split,
    every other split (the sequence's over model) gathered."""
    keep = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)
    return x.redistribute(x.device_mesh, keep).to_local()


def gather_cache(tree: Optional[dict]) -> Optional[dict]:
    """A layer's cache dict with its DTensor fields gathered over every
    mesh dim but the batch's: the batch shard's whole cache, as plain
    tensors.  The dict itself where nothing is a DTensor."""
    ctx = _CTX.get()
    if ctx is None or tree is None or not any(
            isinstance(v, DTensor) for v in tree.values()):
        return tree
    return {k: v.redistribute(ctx.mesh, tuple(
        p if i in ctx.batch_dims else Replicate()
        for i, p in enumerate(v.placements))).to_local()
        if isinstance(v, DTensor) else v for k, v in tree.items()}


def scatter_cache(tree: dict, gathered: dict) -> None:
    """Write this rank's shard of each ``gather_cache`` field (updated in
    place by the layer) back into the DTensor field it came from."""
    ctx = _CTX.get()
    coord = ctx.mesh.get_coordinate()
    for k, v in tree.items():
        if not isinstance(v, DTensor):
            continue
        loc = gathered[k]
        for i, p in enumerate(v.placements):
            if i not in ctx.batch_dims and isinstance(p, Shard):
                loc = loc.chunk(ctx.mesh.shape[i], p.dim)[coord[i]]
        v.to_local().copy_(loc)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the batch shards of a sharded step (an all-reduce);
    x itself outside one."""
    ctx = _CTX.get()
    if ctx is None or not ctx.batch_dims:
        return x
    return DTensor.from_local(
        x, ctx.mesh, ctx.grad_placements, run_check=False).full_tensor()


def batch_shards() -> int:
    ctx = _CTX.get()
    return ctx.batch_shards if ctx is not None else 1


# -------------------------------------------------------------- trees
def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(
        isinstance(e, (str, type(None))) for e in t)


def _tree_map_axes(fn, tree, axes_tree):
    if hasattr(axes_tree, "_fields"):          # NamedTuple containers
        return type(axes_tree)(*(
            _tree_map_axes(fn, getattr(tree, f), getattr(axes_tree, f))
            for f in axes_tree._fields))
    if _is_axes(axes_tree):
        return fn(tree, axes_tree)             # axes leaf (possibly empty)
    if isinstance(axes_tree, dict):
        return {k: _tree_map_axes(fn, tree[k], axes_tree[k])
                for k in axes_tree}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(
            _tree_map_axes(fn, t, a) for t, a in zip(tree, axes_tree))
    raise TypeError(type(axes_tree))


def _local_shape(ctx: ShardingCtx, shape: Sequence[int],
                placements: Sequence) -> Tuple[int, ...]:
    """The shard one rank holds (every split divides: ``spec_for`` only
    splits divisible dims)."""
    out = list(shape)
    for size, p in zip(ctx.mesh.shape, placements):
        if isinstance(p, Shard):
            out[p.dim] //= size
    return tuple(out)


def with_shardings(ctx: ShardingCtx, abstract_tree, axes_tree):
    """DTensors of the abstract tree's shapes and dtypes, each rank's
    shard made with ``torch.empty`` on the mesh's device: under a
    ``FakeTensorMode`` (as the dry-run calls it) nothing is allocated."""
    def attach(a, ax):
        pl = ctx.placements_for(a.shape, ax)
        loc = torch.empty(_local_shape(ctx, a.shape, pl), dtype=a.dtype,
                          device=ctx.mesh.device_type)
        return DTensor.from_local(loc, ctx.mesh, pl, run_check=False,
                                  shape=tuple(a.shape),
                                  stride=torch.empty(a.shape,
                                                     device="meta").stride())
    return _tree_map_axes(attach, abstract_tree, axes_tree)


def distribute(ctx: ShardingCtx, tree, axes_tree):
    """A tree of full tensors, the same on every rank (drawn from one
    seed), as DTensors with ``placements_for`` their axes: each rank
    keeps its own shard, with no communication."""
    return _tree_map_axes(
        lambda t, ax: distribute_tensor(
            t, ctx.mesh, ctx.placements_for(t.shape, ax),
            src_data_rank=None),
        tree, axes_tree)
