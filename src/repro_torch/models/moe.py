"""Mixture-of-experts FFN with sort-based capacity dispatch, the PyTorch
counterpart of ``repro/models/moe.py``.

Tokens are routed top-k, sorted by expert id, packed into an (E, C, d)
buffer (capacity overflow dropped: Switch/GShard semantics), run through
the experts as batched products (``torch.bmm``), and combined with the
router weights.  DeepSeek-style shared experts run densely on every
token.

The dispatch is shard-local, as the reference's: the flattened batch
splits into ``n_sh`` contiguous groups, the sharding context's
``data_shards`` (one without a context, as in the JAX package's CPU
runs), each with its own capacity.  A group's experts are packed as
experts of their own (id ``g * E + e``), so one sort dispatches every
group.  The reference's gather-only dispatch is kept, and so are the
details its results depend on:

* top-k breaks ties towards the lower expert id, as ``jax.lax.top_k``
  does (a stable descending sort; ``torch.topk`` orders ties otherwise);
* the sorts are stable (``jnp.argsort``) and ``searchsorted`` finds the
  left edge;
* the capacity is computed from a group's tokens, padding rows
  included, so co-batched rows take capacity slots from each other;
* the combine gathers and sums over k; no atomic adds, so a token's
  output does not change from run to run.

Every shape follows from (T, E, k, capacity), which the host knows:
nothing here waits for the device (no ``.item()``, ``nonzero`` or
boolean-mask indexing).

Inside a tensor-parallel step (see ``models.sharding``) every model rank
gathers the batch shard's rows, gathers the router's logits (its expert
columns are split) and routes, plans and drops exactly as one device
would; it then runs only its ``E / model`` experts' slots of the
buffer (or, where the expert count does not divide, every expert's
slice of the hidden width), and the ranks' partial combines are summed
into each rank's own rows.  With neither split the FFN runs whole on
every rank and each keeps its rows.  The aux losses are taken over each
rank's own rows (``Routing.rows``) and summed over ``model``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import layers, sharding
from repro_torch.models.config import MoEConfig
from repro_torch.models.params import Spec


def moe_specs(d_model: int, mcfg: MoEConfig, inference: bool = False
              ) -> dict:
    e, f = mcfg.num_experts, mcfg.d_expert
    if inference:
        # shard expert->model, f->data: contraction dim d stays
        # unsharded (the reference's inference weight layout)
        gate_axes = ("expert", None, "embed")
        out_axes = ("expert", "embed", None)
    else:
        gate_axes = ("expert", "embed", "mlp")
        out_axes = ("expert", "mlp", "embed")
    specs = {
        "router": Spec((d_model, e), (None, "expert"), "scaled", 0),
        "experts": {
            "w_gate": Spec((e, d_model, f), gate_axes, "scaled", 1),
            "w_in": Spec((e, d_model, f), gate_axes, "scaled", 1),
            "w_out": Spec((e, f, d_model), out_axes, "scaled", 1),
        },
    }
    if mcfg.num_shared_experts:
        fs = mcfg.d_shared_expert * mcfg.num_shared_experts
        specs["shared"] = layers.mlp_specs(d_model, fs)
    return specs


def _capacity(tokens_per_shard: int, mcfg: MoEConfig) -> int:
    c = int(tokens_per_shard * mcfg.top_k / mcfg.num_experts
            * mcfg.capacity_factor)
    return max(c, mcfg.top_k)


def shards(t: int) -> int:
    """The dispatch groups of t tokens: the context's ``data_shards``,
    halved until it divides t (the reference's guard for odd shapes)."""
    ctx = sharding.current()
    n_sh = ctx.data_shards if ctx is not None else 1
    while t % n_sh:
        n_sh //= 2
    return n_sh


class Routing(NamedTuple):
    logits: torch.Tensor       # (T, E) float32
    probs: torch.Tensor        # (T, E) float32
    gate: torch.Tensor         # (T, k) float32, renormalized
    expert_ids: torch.Tensor   # (T, k) int64, ties to the lower id
    # (T,) bool under sequence parallelism: this rank's own rows
    rows: Optional[torch.Tensor] = None


class Plan(NamedTuple):
    slot_tok: torch.Tensor     # (E*cap,) token read by each buffer slot
    slot_valid: torch.Tensor   # (E*cap,) bool
    flat_slot: torch.Tensor    # (T*k,) buffer slot of each (token, choice)
    keep: torch.Tensor         # (T*k,) bool: False where capacity dropped it


def route(router: torch.Tensor, mcfg: MoEConfig,
          xf: torch.Tensor) -> Routing:
    """Top-k routing of the tokens ``xf`` (T, d), in float32.  A router
    that holds some of the experts' columns (a model shard) has its
    logits gathered over ``model`` first."""
    logits = xf.float() @ router.float()
    if router.shape[1] != mcfg.num_experts:
        logits = sharding.gather_model(logits, -1)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts equal probabilities in id order, as
    # jax.lax.top_k does
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :mcfg.top_k], ids[:, :mcfg.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return Routing(logits, probs, gate, ids)


def plan(expert_ids: torch.Tensor, num_experts: int, cap: int) -> Plan:
    """The sort-based dispatch of ``expert_ids`` (T, k): which token each
    of the E*cap buffer slots reads, and where each (token, choice) finds
    its expert's output.  Slot (e, c) reads sorted position
    starts[e] + c, a gather and not a scatter."""
    t, k = expert_ids.shape
    dev = expert_ids.device
    tk = t * k
    flat_expert = expert_ids.reshape(tk)
    sort_idx = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[sort_idx]
    starts = torch.searchsorted(
        sorted_expert, torch.arange(num_experts, device=dev))
    ends = torch.cat([starts[1:], torch.full((1,), tk, dtype=starts.dtype,
                                             device=dev)])
    rank = torch.arange(tk, device=dev) - starts[sorted_expert]
    token_idx = sort_idx // k
    slot_pos = starts[:, None] + torch.arange(cap, device=dev)[None]
    slot_valid = (slot_pos < ends[:, None]).reshape(-1)
    slot_tok = token_idx[torch.clamp(slot_pos, max=tk - 1).reshape(-1)]
    inv = torch.argsort(sort_idx, stable=True)
    rank_orig = rank[inv]
    keep = rank_orig < cap
    flat_slot = flat_expert * cap + torch.clamp(rank_orig, max=cap - 1)
    return Plan(slot_tok, slot_valid, flat_slot, keep)


def aux_losses(r: Routing, mcfg: MoEConfig) -> dict:
    """The reference's load-balance and z auxiliary losses (Switch-style)
    of one ``moe_ffn`` call's routing, as 0-d float32 tensors.  Only the
    full forward reads them; the serving steps drop them, as XLA drops
    the reference's under jit, so ``moe_ffn`` does not compute them.

    Inside a sharded step the routing is one batch shard's: the token
    counts are summed over the shards and the means taken over the whole
    batch, so the shards' losses sum to the whole batch's."""
    t, e = r.probs.shape
    k = r.expert_ids.shape[1]
    n = sharding.batch_shards()
    one_hot = (r.expert_ids[..., None]
               == torch.arange(e, device=r.probs.device)).float()
    frac_tokens = sharding.batch_sum(one_hot.sum((0, 1))) / (t * n * k)
    z = torch.logsumexp(r.logits, -1) ** 2
    if r.rows is not None:      # every model rank routed all t rows
        w = r.rows.float()
        frac_probs = sharding.reduce_model(
            (r.probs * w[:, None]).sum(0)) / (t * n)
        z = sharding.reduce_model((z * w).sum()) / (t * n)
    elif n == 1:
        frac_probs, z = r.probs.mean(0), torch.mean(z)
    else:
        frac_probs, z = r.probs.sum(0) / (t * n), z.sum() / (t * n)
    return {
        "moe_load_balance": e * torch.sum(frac_tokens * frac_probs)
        * mcfg.router_aux_coef,
        "moe_router_z": z * mcfg.router_z_coef,
    }


def moe_ffn(p: dict, mcfg: MoEConfig, x: torch.Tensor, act: str = "silu"):
    """x: (B, S, d) -> (out (B, S, d), routing, plan).  The capacity is
    taken over each of ``shards(B*S)`` groups of rows; ``aux_losses(
    routing, mcfg)`` gives the reference's auxiliary losses, and
    ``plan.keep`` the (token, choice) pairs that capacity kept."""
    ep = p["experts"]
    e, k = mcfg.num_experts, mcfg.top_k
    el = ep["w_gate"].shape[0]            # the experts this rank runs
    # a model shard of the experts, or of every expert's hidden width:
    # this rank's output is a partial sum over model
    partial = el != e or ep["w_gate"].shape[-1] != mcfg.d_expert
    x_own = x
    if sharding.tensor_parallel():
        x = sharding.model_rows(x)
    b, s, d = x.shape
    t = b * s
    n_sh = shards(t)
    tl = t // n_sh                        # tokens per data shard
    cap = _capacity(tl, mcfg)
    xf = x.reshape(t, d)
    xf = sharding.constrain(xf, ("batch", None))
    r = route(p["router"], mcfg, xf)
    r = r._replace(rows=sharding.own_rows_mask(b, s, x.device))
    # group g's experts are experts g*E .. g*E + E-1 of one dispatch
    group = torch.arange(t, device=x.device)[:, None] // tl
    pl = plan(r.expert_ids + group * e, n_sh * e, cap)
    slot_tok, slot_valid, flat_slot, keep = (pl.slot_tok, pl.slot_valid,
                                             pl.flat_slot, pl.keep)
    if el != e:                           # this rank's experts' slots
        lo = sharding.tp_rank() * el
        slot_tok, slot_valid = (
            a.reshape(n_sh, e, cap)[:, lo:lo + el].reshape(-1)
            for a in (slot_tok, slot_valid))
        g, ex, c = flat_slot // (e * cap), flat_slot // cap % e, \
            flat_slot % cap
        keep = keep & (ex >= lo) & (ex < lo + el)
        flat_slot = ((g * el + (ex - lo).clamp(0, el - 1)) * cap + c)
    buf = (xf[slot_tok] * slot_valid[:, None].to(x.dtype)).reshape(
        n_sh, el, cap, d).transpose(0, 1).reshape(el, n_sh * cap, d)
    buf = sharding.constrain(buf, ("expert", "batch", None))
    h = (layers.activation(act, torch.bmm(buf, ep["w_gate"]))
         * torch.bmm(buf, ep["w_in"]))
    out_buf = torch.bmm(h, ep["w_out"])
    out_buf = sharding.constrain(out_buf, ("expert", "batch", None))
    out_buf = out_buf.reshape(el, n_sh, cap, d).transpose(0, 1).reshape(
        n_sh * el * cap, d)

    # combine: gather each (token, choice)'s slot, weight, sum over k
    vals = out_buf[flat_slot].masked_fill(~keep[:, None], 0.0)
    vals = sharding.constrain(vals, ("batch", None))
    combined = (vals.reshape(t, k, d)
                * r.gate.to(x.dtype)[..., None]).sum(1)
    combined = sharding.constrain(combined, ("batch", None))
    out = combined.reshape(b, s, d)
    if sharding.tensor_parallel():
        out = (sharding.sum_model_rows(out) if partial
               else sharding.own_rows(out))
    if mcfg.num_shared_experts:
        out = out + layers.mlp(p["shared"], x_own, act,
                               mcfg.d_shared_expert * mcfg.num_shared_experts)
    return out, r, pl
