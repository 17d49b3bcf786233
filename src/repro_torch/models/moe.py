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
"""
from __future__ import annotations

from typing import NamedTuple

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


class Plan(NamedTuple):
    slot_tok: torch.Tensor     # (E*cap,) token read by each buffer slot
    slot_valid: torch.Tensor   # (E*cap,) bool
    flat_slot: torch.Tensor    # (T*k,) buffer slot of each (token, choice)
    keep: torch.Tensor         # (T*k,) bool: False where capacity dropped it


def route(router: torch.Tensor, mcfg: MoEConfig,
          xf: torch.Tensor) -> Routing:
    """Top-k routing of the tokens ``xf`` (T, d), in float32."""
    logits = xf.float() @ router.float()
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
    if n == 1:
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
    b, s, d = x.shape
    t = b * s
    e, k = mcfg.num_experts, mcfg.top_k
    n_sh = shards(t)
    tl = t // n_sh                        # tokens per data shard
    cap = _capacity(tl, mcfg)
    xf = x.reshape(t, d)
    xf = sharding.constrain(xf, ("batch", None))
    r = route(p["router"], mcfg, xf)
    # group g's experts are experts g*E .. g*E + E-1 of one dispatch
    group = torch.arange(t, device=x.device)[:, None] // tl
    pl = plan(r.expert_ids + group * e, n_sh * e, cap)
    buf = (xf[pl.slot_tok] * pl.slot_valid[:, None].to(x.dtype)).reshape(
        n_sh, e, cap, d).transpose(0, 1).reshape(e, n_sh * cap, d)
    buf = sharding.constrain(buf, ("expert", "batch", None))
    ep = p["experts"]
    h = (layers.activation(act, torch.bmm(buf, ep["w_gate"]))
         * torch.bmm(buf, ep["w_in"]))
    out_buf = torch.bmm(h, ep["w_out"])
    out_buf = sharding.constrain(out_buf, ("expert", "batch", None))
    out_buf = out_buf.reshape(e, n_sh, cap, d).transpose(0, 1).reshape(
        n_sh * e * cap, d)

    # combine: gather each (token, choice)'s slot, weight, sum over k
    vals = out_buf[pl.flat_slot].masked_fill(~pl.keep[:, None], 0.0)
    vals = sharding.constrain(vals, ("batch", None))
    combined = (vals.reshape(t, k, d)
                * r.gate.to(x.dtype)[..., None]).sum(1)
    combined = sharding.constrain(combined, ("batch", None))
    out = combined.reshape(b, s, d)
    if mcfg.num_shared_experts:
        out = out + layers.mlp(p["shared"], x, act)
    return out, r, pl
