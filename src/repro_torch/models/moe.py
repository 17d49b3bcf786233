"""Mixture-of-experts FFN with sort-based capacity dispatch, the PyTorch
counterpart of ``repro/models/moe.py``.

Tokens are routed top-k, sorted by expert id, packed into an (E, C, d)
buffer (capacity overflow dropped: Switch/GShard semantics), run through
the experts as batched products (``torch.bmm``), and combined with the
router weights.  DeepSeek-style shared experts run densely on every
token.

The port has no sharding context, so the whole flattened batch is one
shard, as in the JAX package's CPU runs.  The reference's gather-only
dispatch is kept, and so are the details its results depend on:

* top-k breaks ties towards the lower expert id, as ``jax.lax.top_k``
  does (a stable descending sort; ``torch.topk`` orders ties otherwise);
* the sorts are stable (``jnp.argsort``) and ``searchsorted`` finds the
  left edge;
* the capacity is computed from the whole flattened batch, padding rows
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

from repro_torch.models import layers
from repro_torch.models.config import MoEConfig
from repro_torch.models.params import Spec


def moe_specs(d_model: int, mcfg: MoEConfig) -> dict:
    e, f = mcfg.num_experts, mcfg.d_expert
    specs = {
        "router": Spec((d_model, e), (None, "expert"), "scaled", 0),
        "experts": {
            "w_gate": Spec((e, d_model, f), ("expert", "embed", "mlp"),
                           "scaled", 1),
            "w_in": Spec((e, d_model, f), ("expert", "embed", "mlp"),
                         "scaled", 1),
            "w_out": Spec((e, f, d_model), ("expert", "mlp", "embed"),
                          "scaled", 1),
        },
    }
    if mcfg.num_shared_experts:
        fs = mcfg.d_shared_expert * mcfg.num_shared_experts
        specs["shared"] = layers.mlp_specs(d_model, fs)
    return specs


def _capacity(tokens: int, mcfg: MoEConfig) -> int:
    c = int(tokens * mcfg.top_k / mcfg.num_experts * mcfg.capacity_factor)
    return max(c, mcfg.top_k)


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
    the reference's under jit, so ``moe_ffn`` does not compute them."""
    t, e = r.probs.shape
    k = r.expert_ids.shape[1]
    one_hot = (r.expert_ids[..., None]
               == torch.arange(e, device=r.probs.device)).float()
    frac_tokens = one_hot.sum((0, 1)) / (t * k)
    frac_probs = r.probs.mean(0)
    return {
        "moe_load_balance": e * torch.sum(frac_tokens * frac_probs)
        * mcfg.router_aux_coef,
        "moe_router_z": torch.mean(torch.logsumexp(r.logits, -1) ** 2)
        * mcfg.router_z_coef,
    }


def moe_ffn(p: dict, mcfg: MoEConfig, x: torch.Tensor, act: str = "silu"):
    """x: (B, S, d) -> (out (B, S, d), routing, plan).  The capacity is
    taken over all B*S rows; ``aux_losses(routing, mcfg)`` gives the
    reference's auxiliary losses, and ``plan.keep`` the (token, choice)
    pairs that capacity kept."""
    b, s, d = x.shape
    t = b * s
    e, k = mcfg.num_experts, mcfg.top_k
    cap = _capacity(t, mcfg)
    xf = x.reshape(t, d)
    r = route(p["router"], mcfg, xf)
    pl = plan(r.expert_ids, e, cap)
    buf = (xf[pl.slot_tok] * pl.slot_valid[:, None].to(x.dtype)).reshape(
        e, cap, d)
    ep = p["experts"]
    h = (layers.activation(act, torch.bmm(buf, ep["w_gate"]))
         * torch.bmm(buf, ep["w_in"]))
    out_buf = torch.bmm(h, ep["w_out"]).reshape(e * cap, d)

    # combine: gather each (token, choice)'s slot, weight, sum over k
    vals = out_buf[pl.flat_slot].masked_fill(~pl.keep[:, None], 0.0)
    combined = (vals.reshape(t, k, d)
                * r.gate.to(x.dtype)[..., None]).sum(1)
    out = combined.reshape(b, s, d)
    if mcfg.num_shared_experts:
        out = out + layers.mlp(p["shared"], x, act)
    return out, r, pl
