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

The sharded train step (``training.train_loop.make_train_step(...,
ctx=)``) runs the model on each rank's shard of the batch: its context
is the mesh context's ``local`` view.  Over the batch dims the weights
are gathered as a layer runs (FSDP or ZeRO-1, by the weights'
placements) and their gradients come back summed over the batch shards;
``batch_sum`` all-reduces the few statistics a loss needs over the
batch, and ``data_shards`` counts the MoE dispatch groups on one shard.

Over ``model`` every layer type is tensor-, sequence- and
expert-parallel, as the reference's rules place it (Megatron's pairs of
collectives); no weight the rules split over ``model`` is gathered
whole over it:

  * the rows of a batch shard stay split over ``model`` between layers
    wherever the sequence divides (``batch_shard`` keeps that split);
    norms and token-wise work run on a rank's own rows;
  * ``local_params`` hands a layer each weight's ``model`` shard (its
    heads, MLP or SSM channels, vocab slice or experts), gathered over
    the other mesh dims only; a weight replicated over ``model`` comes
    whole, and its gradient is a partial sum over ``model`` too, since
    each rank works on its own rows, heads or experts;
  * ``model_rows`` gathers the rows before a column-parallel product
    (its backward reduce-scatters) and ``sum_model_rows`` sums the
    ranks' partial outputs of a row-parallel one into each rank's own
    rows (a reduce-scatter; its backward all-gathers).  In a serving
    step whose rows are whole on every model rank (a decode's one row)
    they are the identity and an all-reduce (Megatron's copy and
    reduce);
  * ``reduce_model`` sums a statistic over ``model`` whose every rank
    then holds the same value (forward all-reduce, identity backward):
    the vocab-parallel cross-entropy's sums and the MoE aux losses;
    ``sum_model`` sums partial products each rank then uses for its own
    channels (all-reduce forward and backward: Mamba's ``x_proj``,
    mLSTM's gates, a norm's sum of squares over split channels);
  * activations are gathered over ``model`` only where a split does not
    line up with the computation: the queries of a decode whose cache
    splits its sequence over ``model`` (every head then attends to this
    rank's keys); mLSTM's inputs and outputs where its heads stay whole
    (``ssm``); ``split_halves`` moves the column blocks of a fused
    ``[x_in | z]`` product to their channels' ranks (an all-to-all) and
    ``channels_to_rows`` sLSTM's head outputs to their rows' ranks;
    the small recurrent states a cache holds whole are gathered when
    stored (``blocks._store``).

A cache is read and written as each rank's shards (``local_cache``):
where its sequence splits over mesh dims (``SeqSplit``) the owner of a
new token's slot writes it and the decode's softmax reduces its max and
sums over those dims (``reduce_over``, ``layers.softmax_split``); no
cache is gathered.

The collectives go through ``torch.distributed._functional_collectives``
inside ``torch.autograd.Function``s, so ``comm_analysis`` sees them
forward and backward, and a fake process group runs them under a
``FakeTensorMode`` (the serving steps' reductions over a cache's split
take no gradient and call them directly).  ``tensor_parallel()`` says
whether they are active: only inside a step's ``local`` view over a
``model`` axis of more than one rank, in a training step only where the
sequence splits over it (else the step gathers every weight), in a
serving step (``local(..., serve=True)``) always.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.utils.checkpoint import checkpoint as torch_checkpoint
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
    split over, ``tp`` the ranks it runs tensor-parallel over (1: none)
    and ``sp`` whether its rows are split over them."""

    def __init__(self, mesh, rules=DEFAULT_RULES, fsdp: bool = True,
                 batch_dims: Tuple[int, ...] = (), tp: int = 1,
                 sp: bool = False):
        self.mesh = mesh
        self.rules = dict(rules)
        self.fsdp = fsdp
        self.batch_dims = tuple(batch_dims)
        self.tp = tp
        self.sp = sp
        self.shape: Dict[str, int] = dict(zip(mesh.mesh_dim_names,
                                              mesh.shape))

    @property
    def model_dim(self) -> Optional[int]:
        """The mesh dim named "model", None without one."""
        names = list(self.shape)
        return names.index("model") if "model" in names else None

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

    def local(self, batch_placements: Sequence,
              serve: bool = False) -> "ShardingCtx":
        """The view a sharded step runs its batch shard under: the mesh
        dims on which ``batch_placements`` (the batch's) shard dim 0;
        tensor-parallel over ``model`` where the batch's rows (dim 1)
        split over it, or for a ``serve`` step (prefill or decode: no
        gradient), whose rows may stay whole on every model rank."""
        dims = tuple(i for i, p in enumerate(batch_placements)
                     if isinstance(p, Shard) and p.dim == 0)
        m = self.model_dim
        sp = m is not None and batch_placements[m] == Shard(1)
        tp = self.mesh.shape[m] if m is not None and (sp or serve) else 1
        return ShardingCtx(self.mesh, tuple(self.rules.items()), self.fsdp,
                           dims, tp, sp and tp > 1)

    @property
    def grad_placements(self) -> tuple:
        """How a gathered weight's gradient lies on the mesh inside a
        step: a partial sum over the batch shards, and over ``model``
        where its ranks work on their own rows (``sp``); the same on the
        other dims (their ranks compute the same thing)."""
        return tuple(Partial() if i in self.batch_dims
                     or (self.sp and i == self.model_dim) else Replicate()
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


def checkpoint(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn`` under the
    context active now.  The backward recomputes ``fn`` where autograd
    runs it: on a CUDA device that is the engine's own thread, where
    this module's context variable is unset."""
    ctx = _CTX.get()

    def run(*a):
        with use_sharding(ctx):
            return fn(*a)
    return torch_checkpoint(run, *args, use_reentrant=False)


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
    the gradient is summed over the batch shards, and over ``model``
    under sequence parallelism, and re-sharded to the leaf's
    placements); plain leaves as they are."""
    ctx = _CTX.get()
    if ctx is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_params(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.full_tensor(grad_placements=ctx.grad_placements)
    return tree


def local_params(tree):
    """Every DTensor leaf as this rank's ``model`` shard, a plain tensor:
    gathered over every other mesh dim, split as ``placements_for``
    splits it over ``model`` (whole where it is replicated there).  The
    gradient comes back summed over the batch shards, as this rank's
    shard on ``model`` (a partial sum there for a replicated leaf, as
    ``grad_placements`` says), and re-sharded to the leaf's
    placements."""
    ctx = _CTX.get()
    if ctx is None:
        return tree
    if isinstance(tree, dict):
        return {k: local_params(v) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    m = ctx.model_dim
    keep = tuple(p if i == m and isinstance(p, Shard) else Replicate()
                 for i, p in enumerate(tree.placements))
    grads = tuple(keep[i] if isinstance(keep[i], Shard) else g
                  for i, g in enumerate(ctx.grad_placements))
    return tree.redistribute(ctx.mesh, keep).to_local(grad_placements=grads)


def batch_shard(x: DTensor) -> torch.Tensor:
    """A rank's rows of a batch DTensor: the shard of its dim-0 split and
    of its sequence's (dim 1) split over ``model``, every other split
    gathered."""
    names = list(x.device_mesh.mesh_dim_names or ())
    m = names.index("model") if "model" in names else None
    keep = tuple(p if isinstance(p, Shard) and (
        p.dim == 0 or (p.dim == 1 and i == m)) else Replicate()
        for i, p in enumerate(x.placements))
    return x.redistribute(x.device_mesh, keep).to_local()


class SeqSplit(NamedTuple):
    """How a cache's sequence dim is split: over mesh ``dims`` (in mesh
    order, so pod-major) into equal chunks, of which this rank holds
    chunk ``index``."""
    dims: Tuple[int, ...]
    index: int
    model: bool             # whether ``model`` is among the dims

    def bounds(self, length: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's chunk, ``length`` entries long, of the
        whole dim."""
        return self.index * length, (self.index + 1) * length


def local_cache(tree: Optional[dict], seq_fields: Sequence[str],
                dim: int) -> Tuple[Optional[dict], Optional[SeqSplit]]:
    """A run's cache as this rank's shards, plain tensors that share the
    DTensors' storage (written in place, nothing moves), and the split
    of dim ``dim`` of its ``seq_fields`` (None where it is whole).  Every
    split the rules give a cache is one the layers compute on: the
    batch's, the KV heads', mLSTM's heads or value dim over ``model``,
    and the sequence's, which the attention reduces over."""
    ctx = _CTX.get()
    if ctx is None or tree is None:
        return tree, None
    split = None
    for name in seq_fields:
        t = tree.get(name)
        if isinstance(t, DTensor):
            dims = tuple(i for i, p in enumerate(t.placements)
                         if p == Shard(dim))
            if dims:
                coord = ctx.mesh.get_coordinate()
                index = 0
                for i in dims:
                    index = index * ctx.mesh.shape[i] + coord[i]
                split = SeqSplit(dims, index, ctx.model_dim in dims)
            break
    return {k: v.to_local() if isinstance(v, DTensor) else v
            for k, v in tree.items()}, split


def reduce_over(x: torch.Tensor, split: SeqSplit, op: str) -> torch.Tensor:
    """x reduced (``op`` "max" or "sum") over the mesh dims of a cache's
    sequence split, one all-reduce a dim (no gradient: serving steps)."""
    ctx = _CTX.get()
    for i in split.dims:
        x = _all_reduce(x, (ctx.mesh, i), op)
    return x


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the batch shards of a sharded step (an all-reduce);
    x itself outside one."""
    ctx = _CTX.get()
    if ctx is None or not ctx.batch_dims:
        return x
    return DTensor.from_local(x, ctx.mesh, tuple(
        Partial() if i in ctx.batch_dims else Replicate()
        for i in range(ctx.mesh.ndim)), run_check=False).full_tensor()


def batch_shards() -> int:
    ctx = _CTX.get()
    return ctx.batch_shards if ctx is not None else 1


# ------------------------------------------------- over the model axis
def tensor_parallel() -> bool:
    """Whether the active step runs tensor-parallel over ``model``."""
    ctx = _CTX.get()
    return ctx is not None and ctx.tp > 1


def seq_parallel() -> bool:
    """Whether the active step's rows are split over ``model``."""
    ctx = _CTX.get()
    return ctx is not None and ctx.sp


def tp_size() -> int:
    ctx = _CTX.get()
    return ctx.tp if ctx is not None else 1


def tp_rank() -> int:
    ctx = _CTX.get()
    return ctx.mesh.get_local_rank("model") if tensor_parallel() else 0


def _group():
    ctx = _CTX.get()
    return (ctx.mesh, ctx.model_dim)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_reduce(x, group, op: str = "sum"):
    return _wait(funcol.all_reduce(x.contiguous(), op, group))


# the *_single names replace the *_tensor ones in newer torch
_gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
_scatter = getattr(funcol, "reduce_scatter_single",
                   funcol.reduce_scatter_tensor)


def _all_gather(x, group, dim: int):
    return _wait(_gather(x.contiguous(), dim % x.dim(), group))


def _reduce_scatter(x, group, dim: int):
    return _wait(_scatter(x.contiguous(), "sum", dim % x.dim(), group))


# Megatron's pairs over the model axis; each keeps the group it ran on
# for its backward
class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    """Chunk j of x (along ``split_dim``) to rank j, the chunks received
    concatenated along ``cat_dim`` in rank order; the backward is the
    same exchange the other way.  ``sizes`` (None: equal chunks) gives
    the (sent, received) element counts along those dims per rank."""

    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim, sizes):
        ctx.args = (group, cat_dim, split_dim,
                    None if sizes is None else sizes[::-1])
        return _all_to_all(x, group, split_dim, cat_dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def _all_to_all(x, group, split_dim, cat_dim, sizes):
    n = group[0].shape[group[1]]
    sent, got = sizes if sizes is not None else (
        [x.shape[split_dim] // n] * n, None)
    parts = x.split(sent, split_dim)
    flat = torch.cat([t.movedim(split_dim, 0).reshape(-1) for t in parts])
    per = [t.numel() for t in parts]
    rest = list(parts[0].movedim(split_dim, 0).shape[1:])
    width = math.prod(rest)
    recv = [per[0]] * n if got is None else [c * width for c in got]
    out = _wait(funcol.all_to_all_single(flat, recv, per, group))
    chunks = [c.reshape([-1] + rest).movedim(0, split_dim)
              for c in out.split(recv)]
    return torch.cat(chunks, cat_dim)


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' partial sums x added up on every rank, where each
    rank then uses the sum differently (its own channels or heads): an
    all-reduce forward and backward."""
    if not tensor_parallel():
        return x
    return _Copy.apply(_Reduce.apply(x, _group()), _group())


def model_slice(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """This rank's ``n`` entries of dim ``dim`` of a tensor every model
    rank holds whole (a view, no communication); t where it has n."""
    if t.shape[dim] == n:
        return t
    return t.narrow(dim, tp_rank() * n, n)


def channels_to_rows(y: torch.Tensor) -> torch.Tensor:
    """(B, S, C/model) this rank's channels of every row of the batch
    shard -> (B, S', C) every channel of this rank's rows: an all-to-all
    under sequence parallelism, else an all-gather of the channels."""
    if not tensor_parallel():
        return y
    if seq_parallel():
        return _AllToAll.apply(y, _group(), 1, y.dim() - 1, None)
    return gather_model(y, y.dim() - 1)


def split_halves(y: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """This rank's column shard ``y`` of a fused product ``[a | b]``
    (each half ``width`` channels, split over ``model`` as one weight)
    -> ``[a_c | b_c]`` for this rank's ``n`` channels c.  The stored
    split is not a channel split: at model 4 ranks 0-1 hold ``a``, ranks
    2-3 ``b``.  With n = width / model the column blocks move between
    the ranks (an all-to-all of the activation, the weight stays where
    it is); with n = width (channels not split) the halves are gathered
    whole.  y itself where it is whole."""
    if not tensor_parallel() or y.shape[-1] == 2 * width:
        return y
    m, c = tp_size(), y.shape[-1] // 2          # c = width / model
    if n == width:
        return gather_model(y, y.dim() - 1)
    if n != c:
        raise ValueError(f"{n} channels a rank from a {2 * c}-column shard")
    # global block j (c columns) goes to rank j % m; rank r holds blocks
    # 2r and 2r + 1 and receives blocks r and m + r
    r = tp_rank()
    sent = [0] * m
    for j in (2 * r, 2 * r + 1):
        sent[j % m] += c
    got = [0] * m
    for j in (r, m + r):
        got[j // 2] += c
    return _AllToAll.apply(y, _group(), y.dim() - 1, y.dim() - 1,
                           (sent, got))


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over ``model`` (every rank's result the same; each rank's
    gradient flows to its own part)."""
    return _Reduce.apply(x, _group()) if tensor_parallel() else x


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' slices of x concatenated along ``dim`` (backward: each
    rank's slice of the summed gradient)."""
    return _GatherSeq.apply(x, _group(), dim) if tensor_parallel() else x


def model_rows(x: torch.Tensor) -> torch.Tensor:
    """The batch shard's rows (dim 1) of x on every model rank before a
    column-parallel product: gathered under sequence parallelism, else
    x (its gradient all-reduced)."""
    if not tensor_parallel():
        return x
    if seq_parallel():
        return _GatherSeq.apply(x, _group(), 1)
    return _Copy.apply(x, _group())


def sum_model_rows(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' partial sums x of a row-parallel product, summed
    into this rank's own rows (a reduce-scatter under sequence
    parallelism, else an all-reduce)."""
    if not tensor_parallel():
        return x
    if seq_parallel():
        return _ScatterSeq.apply(x, _group(), 1)
    return _Reduce.apply(x, _group())


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows (dim 1) of a tensor every model rank holds whole
    (no communication); x itself without sequence parallelism."""
    if not seq_parallel():
        return x
    n = x.shape[1] // tp_size()
    return x[:, tp_rank() * n:(tp_rank() + 1) * n]


def gather_model_values(x: torch.Tensor, dim: int) -> torch.Tensor:
    """An all-gather over ``model`` of values that take no gradient
    (token ids, label weights)."""
    return _all_gather(x, _group(), dim) if tensor_parallel() else x


def max_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model`` (no gradient)."""
    x = x.detach()
    return _all_reduce(x, _group(), "max") if tensor_parallel() else x


def row_offset(n: int) -> int:
    """The global index of this rank's first row, ``n`` rows a rank under
    sequence parallelism (0 without it)."""
    return tp_rank() * n if seq_parallel() else 0


def own_rows_mask(b: int, s: int, device) -> Optional[torch.Tensor]:
    """(b*s,) bool: which of a batch shard's flattened (b, s) rows are
    this rank's under sequence parallelism; None without it."""
    if not seq_parallel():
        return None
    n = s // tp_size()
    pos = torch.arange(s, device=device) // n == tp_rank()
    return pos.expand(b, s).reshape(-1)


def model_offset(full: int, local: int) -> int:
    """Where this rank's slice of a dim of ``full`` entries, ``local`` a
    rank, starts (0 where the dim is not split)."""
    return 0 if local == full else tp_rank() * local


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
