"""Decoder-only model over run-grouped layers, the PyTorch counterpart of
``repro/models/model.py`` for every layer type (see ``blocks``), codebook
streams included.

The parameter tree keeps ``repro``'s layout — ``embedding`` ((V, d), or
(K, V, d) for K codebooks), one stacked ``run_<i>`` per run of identical
layers in ``cfg.layer_runs`` whose leaves carry a leading layer dim,
``final_norm`` and, for untied heads, ``lm_head`` ((d, V) or (d, K, V))
— so the bridge maps it leaf for leaf.  Where the JAX package runs a
``lax.scan`` over each run, ``forward`` loops over the layers in Python.
Caches are a list with one dict per run, each leaf stacked over the
run's layers; ``forward`` writes them in place and returns the same
list.

Entry points:
  * ``loss_fn``      training: full causal pass, chunked cross-entropy
                     and the MoE aux losses, differentiable
  * ``prefill``      full causal pass over a prompt, fills the caches
  * ``decode_step``  one token per row against the caches

Inside a tensor-parallel step (``models.sharding``) the embedding is
looked up vocab-parallel (each rank its vocab slice, zeros elsewhere,
summed into each rank's own rows), the logits are this rank's vocab
slice and the cross-entropy is vocab-parallel (the max, the sum of
exponentials and the target logit reduced over ``model``; the whole
vocab's logits are never built).  Where the vocab does not divide the
model axis, the embedding comes whole and each rank takes the loss of
its own rows.  Every layer type runs on its rank's model shards
(``blocks``), and a cache is read and written as this rank's shards
(a sequence split over the mesh included: the decode's softmax is then
reduced over the ranks, ``layers.softmax_split``).  ``prefill`` and
``decode_step`` then return this rank's vocab slice of the logits.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers, moe, sharding
from repro_torch.models import config as C
from repro_torch.models.params import (Spec, abstract_params, axes_tree,
                                       init_params, map_specs_with_path,
                                       stack_specs)


# ===================================================================== specs
def model_specs(cfg: C.ModelConfig) -> dict:
    d, v, nc = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    specs: Dict[str, Any] = {}
    if nc:
        specs["embedding"] = Spec((nc, v, d), (None, "vocab", None), "embed")
    else:
        specs["embedding"] = Spec((v, d), ("vocab", "embed"), "embed")
    for i, (ltype, n) in enumerate(cfg.layer_runs):
        specs[f"run_{i}"] = stack_specs(blocks.layer_specs(cfg, ltype), n,
                                        "layers")
    specs["final_norm"] = layers.norm_spec(d)
    if not cfg.tie_embeddings:
        if nc:
            specs["lm_head"] = Spec((d, nc, v), ("embed", None, "vocab"),
                                    "scaled", 0)
        else:
            specs["lm_head"] = Spec((d, v), ("embed", "vocab"), "scaled", 0)
    return specs


def init(cfg: C.ModelConfig, seed: int = 0, dtype=torch.float32,
         device=None):
    """Random weights from ``seed`` on ``device`` (the card unless one is
    named): ``repro``'s ``init(cfg, jax.random.PRNGKey(seed))``, bit for
    bit."""
    return init_params(model_specs(cfg), seed, dtype, device)


def abstract(cfg: C.ModelConfig, dtype=torch.float32):
    return abstract_params(model_specs(cfg), dtype)


def param_axes(cfg: C.ModelConfig):
    return axes_tree(model_specs(cfg))


def count_params(cfg: C.ModelConfig, active_only: bool = False) -> int:
    """Total (or MoE-active: expert banks scaled by top_k / num_experts)
    parameter count, from the spec tree."""
    total = 0

    def visit(path: str, s: Spec):
        nonlocal total
        n = math.prod(s.shape)
        if active_only and cfg.moe is not None and "/experts/" in path:
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n

    map_specs_with_path(visit, model_specs(cfg))
    return total


# ===================================================================== cache
def cache_struct(cfg: C.ModelConfig, batch: int, cache_len: int):
    """[(run cache shapes dict) ...] — name -> ((n, *shape), (axes))."""
    out = []
    for ltype, n in cfg.layer_runs:
        shapes = blocks.cache_shape(cfg, ltype, batch, cache_len)
        out.append({name: ((n,) + shape, ("layers",) + axes)
                    for name, (shape, axes) in shapes.items()})
    return out


def init_cache(cfg: C.ModelConfig, batch: int, cache_len: int,
               dtype=torch.float32, device=None) -> List[dict]:
    """Stacked caches for every run on ``device`` (the card unless one is
    named): K/V, latents and conv buffers in ``dtype``, the recurrent
    states (``blocks.STATE_FIELDS``) in float32, as in the JAX package."""
    device = resolve_device(device)
    return [blocks.alloc_cache(run, dtype, device)
            for run in cache_struct(cfg, batch, cache_len)]


def abstract_cache(cfg: C.ModelConfig, batch: int, cache_len: int,
                   dtype=torch.float32) -> List[dict]:
    """``init_cache``'s tensors as meta tensors: no allocation."""
    return init_cache(cfg, batch, cache_len, dtype, "meta")


def cache_axes(cfg: C.ModelConfig, batch: int, cache_len: int) -> List[dict]:
    return [{name: axes for name, (_s, axes) in run.items()}
            for run in cache_struct(cfg, batch, cache_len)]


# ===================================================================== embed
def embed(params, cfg: C.ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S), or (B, S, K) for codebooks, whose K embeddings are
    summed (MusicGen)."""
    emb = params["embedding"]
    tokens = tokens.long()
    if emb.shape[-2] != cfg.vocab_size:
        return _embed_vocab_parallel(emb, cfg, tokens)
    if cfg.num_codebooks:
        x = emb[0][tokens[..., 0]]
        for k in range(1, cfg.num_codebooks):
            x = x + emb[k][tokens[..., k]]
        return x
    return emb[tokens]


def _embed_vocab_parallel(emb, cfg: C.ModelConfig, tokens: torch.Tensor):
    """The lookup of an embedding split over ``model`` by vocab: each
    rank looks up the tokens of its slice (zeros for the others) over
    every row of the batch shard, and the ranks' sums land in each
    rank's own rows."""
    v = emb.shape[-2]
    if sharding.seq_parallel():
        tokens = sharding.gather_model_values(tokens, 1)
    lo = sharding.model_offset(cfg.vocab_size, v)
    ids = tokens - lo
    hit = ((ids >= 0) & (ids < v)).to(emb.dtype)[..., None]
    ids = ids.clamp(0, v - 1)
    if cfg.num_codebooks:
        x = emb[0][ids[..., 0]] * hit[..., 0, :]
        for k in range(1, cfg.num_codebooks):
            x = x + emb[k][ids[..., k]] * hit[..., k, :]
    else:
        x = emb[ids] * hit
    return sharding.sum_model_rows(x)


def unembed(params, cfg: C.ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> logits (B, S, V), or (B, S, K, V) for codebooks:
    this rank's vocab slice of them inside a tensor-parallel step."""
    nc = cfg.num_codebooks
    if cfg.tie_embeddings:
        emb = params["embedding"]
        if nc:
            return (x @ emb.reshape(-1, emb.shape[-1]).T).unflatten(
                -1, (nc, -1))
        return x @ emb.T
    head = params["lm_head"]
    if nc:
        return (x @ head.reshape(head.shape[0], -1)).unflatten(-1, (nc, -1))
    return x @ head


# ===================================================================== forward
def layer_view(tree, i: int):
    """Layer ``i``'s view of a stacked run tree."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def _gathered(params):
    """The embedding, final norm and head as plain tensors where they
    are DTensors (inside a sharded step): all-gathered, or this rank's
    model shards of them in a tensor-parallel step; else as they are."""
    if sharding.current() is None:
        return params
    fetch = (sharding.local_params if sharding.tensor_parallel()
             else sharding.gather_params)
    return {k: v if k.startswith("run_") else fetch(v)
            for k, v in params.items()}


def _layer(p_l, cfg: C.ModelConfig, ltype: str, x: torch.Tensor, **kw):
    """One layer, its DTensor weights fetched first: inside the remat
    region, so the backward fetches them again (FSDP's reshard after
    forward).  A tensor-parallel step runs every layer type on its
    rank's model shards."""
    fetch = (sharding.local_params if sharding.tensor_parallel()
             else sharding.gather_params)
    return blocks.apply_layer(fetch(p_l), cfg, ltype, x, **kw)


def _trunk(params, cfg: C.ModelConfig, tokens: torch.Tensor,
           positions: Optional[torch.Tensor], caches: Optional[List[dict]],
           mode: str, impl: str, remat: bool = False):
    """The embedding, every layer and the final norm.  Returns (hidden,
    the MoE layers' routings).  ``remat`` runs each layer under
    ``torch.utils.checkpoint`` (recomputed in the backward), as the
    reference wraps its scan body in ``jax.checkpoint``.  Inside a
    sharded step each layer's DTensor weights are fetched as it runs,
    and a DTensor cache is read and written as this rank's shards of it
    (``sharding.local_cache``): nothing of a cache moves."""
    params = _gathered(params)
    if mode == "full":
        b, s = tokens.shape[:2]
        if positions is None:   # every row's (the sequence may be split)
            s *= sharding.tp_size() if sharding.seq_parallel() else 1
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = embed(params, cfg, tokens)
        x = sharding.constrain(x, ("batch", "seq", None))
    else:
        x = embed(params, cfg, tokens[:, None] if tokens.dim() == 1
                  else tokens[:, None, :])
        x = sharding.constrain(x, ("batch", None, None))
    routings = []
    for i, (ltype, n) in enumerate(cfg.layer_runs):
        run_p = params[f"run_{i}"]
        # stacked fields: (layers, batch, sequence, ...)
        run_c, split = sharding.local_cache(
            caches[i] if caches is not None else None, blocks.SEQ_FIELDS, 2)
        for j in range(n):
            c_l = layer_view(run_c, j) if run_c is not None else None
            layer = functools.partial(
                _layer, layer_view(run_p, j), cfg, ltype,
                positions=positions, cache=c_l, mode=mode, impl=impl,
                split=split)
            x, _, r = (sharding.checkpoint(layer, x) if remat
                       else layer(x))
            if r is not None:
                routings.append(r)
        if mode == "full":
            x = sharding.constrain(x, ("batch", "seq", None))
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), routings


def forward(params, cfg: C.ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[List[dict]] = None, mode: str = "full",
            impl: str = "kernel", remat: bool = False):
    """Returns (hidden (B, S, d), caches, aux): aux sums each MoE
    auxiliary loss over the layers, one 0-d tensor a key (empty without
    MoE layers).  ``prefill`` and ``decode_step`` skip the aux.

    mode="full": tokens (B, S) (or (B, S, K)), positions default to
    0..S-1.  mode="decode": tokens (B,) (or (B, K)), positions (B,).
    ``impl`` routes the full-mode attention (``blocks.apply_layer``):
    "kernel" or "ref" for serving, "train" for a differentiable pass.
    ``remat`` recomputes each layer in the backward instead of keeping
    its activations."""
    x, routings = _trunk(params, cfg, tokens, positions, caches, mode, impl,
                         remat)
    aux_total: Dict[str, torch.Tensor] = {}
    for r in routings:
        for k, v in moe.aux_losses(r, cfg.moe).items():
            aux_total[k] = aux_total[k] + v if k in aux_total else v
    return x, caches, aux_total


# ===================================================================== steps
def _nll_chunk(params, cfg: C.ModelConfig, x_chunk: torch.Tensor,
               labels_chunk: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over one sequence chunk, from float32 logits (B,
    chunk, V), averaged over the codebooks where there are several."""
    logits = unembed(params, cfg, x_chunk).float()
    logits = sharding.constrain(
        logits, ("batch", "seq", None, "vocab") if logits.dim() == 4
        else ("batch", "seq", "vocab"))
    labels = labels_chunk.long()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1), reduction="none")
    nll = nll.reshape(labels.shape)
    if cfg.num_codebooks:
        nll = nll.mean(-1)
    return nll


def _nll_vocab_parallel(params, cfg: C.ModelConfig, x_chunk: torch.Tensor,
                        labels_chunk: torch.Tensor) -> torch.Tensor:
    """``_nll_chunk`` from this rank's vocab slice of the logits of every
    row of the chunk (gathered over ``model``): the max, the sum of
    exponentials and the target logit reduced over ``model``.  Returns
    the nll of the gathered rows, the same on every model rank."""
    logits = unembed(params, cfg, sharding.model_rows(x_chunk)).float()
    labels = sharding.gather_model_values(labels_chunk.long(), 1)
    v = logits.shape[-1]
    lo = sharding.model_offset(cfg.vocab_size, v)
    m = sharding.max_model(logits.amax(-1))
    se = sharding.reduce_model(torch.exp(logits - m[..., None]).sum(-1))
    ids = labels - lo
    hit = (ids >= 0) & (ids < v)
    tgt = logits.gather(-1, ids.clamp(0, v - 1)[..., None])[..., 0]
    tgt = sharding.reduce_model(torch.where(hit, tgt, 0.0))
    nll = torch.log(se) + m - tgt
    if cfg.num_codebooks:
        nll = nll.mean(-1)
    return nll


def _weighted_nll_tp(params, cfg: C.ModelConfig, x: torch.Tensor,
                     labels: torch.Tensor, w: torch.Tensor,
                     ce_chunk: int) -> torch.Tensor:
    """Under sequence parallelism: the weighted nll summed over the
    batch shard's rows, the same on every model rank, chunk by
    checkpointed chunk of this rank's rows.  Vocab-parallel where the
    vocab splits; else each rank's own rows' sum, reduced."""
    emb = params["embedding" if cfg.tie_embeddings else "lm_head"]
    vocab_split = (emb.shape[-2] if cfg.tie_embeddings
                   else emb.shape[-1]) != cfg.vocab_size
    s = x.shape[1]
    ck = min(ce_chunk, s)
    if not (s % ck == 0 and s > ck):
        ck = s
    fn = functools.partial(
        _nll_vocab_parallel if vocab_split else _nll_chunk, params, cfg)
    total = torch.zeros((), device=x.device)
    for i in range(0, s, ck):
        xs, ls, ws = x[:, i:i + ck], labels[:, i:i + ck], w[:, i:i + ck]
        nll = sharding.checkpoint(fn, xs, ls) if ck < s else fn(xs, ls)
        if vocab_split:
            ws = sharding.gather_model_values(ws, 1)
        total = total + (nll * ws).sum()
    return total if vocab_split else sharding.reduce_model(total)


def loss_fn(params, cfg: C.ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True, ce_chunk: int = 512):
    """batch: tokens, labels, weights.  Returns (loss + the MoE aux
    losses, metrics {"nll": loss, **aux}), differentiable in ``params``.

    The attention is the trainer's plain one (``impl="train"``).  Where
    the sequence splits into more than one whole ``ce_chunk``, the
    cross-entropy runs chunk by chunk, each under
    ``torch.utils.checkpoint``, so the float32 logits of only one
    (B, chunk, V) block live at a time, forward and backward."""
    params = _gathered(params)
    x, _, aux = forward(params, cfg, batch["tokens"], mode="full",
                        impl="train", remat=remat)
    labels = batch["labels"]
    w = batch["weights"].float()
    # inside a sharded step: this batch shard's share of the loss (the
    # step sums the shares; the weights' total is the whole batch's)
    if sharding.seq_parallel():
        wsum = sharding.batch_sum(sharding.reduce_model(w.sum()))
        loss = _weighted_nll_tp(params, cfg, x, labels, w, ce_chunk) \
            / torch.clamp(wsum, min=1.0)
    else:
        s = x.shape[1]
        ck = min(ce_chunk, s)
        if s % ck == 0 and s > ck:
            chunk = functools.partial(_nll_chunk, params, cfg)
            nll = torch.cat([sharding.checkpoint(chunk, x[:, i:i + ck],
                                                 labels[:, i:i + ck])
                             for i in range(0, s, ck)], dim=1)
        else:
            nll = _nll_chunk(params, cfg, x, labels)
        loss = (nll * w).sum() / torch.clamp(sharding.batch_sum(w.sum()),
                                             min=1.0)
    metrics = {"nll": loss, **aux}
    total = loss + sum(aux.values(), torch.zeros((), device=loss.device))
    return total, metrics


def prefill(params, cfg: C.ModelConfig, tokens: torch.Tensor,
            caches: List[dict], impl: str = "kernel"):
    """Full prefill; returns (last-token logits (B, ...), caches)."""
    params = _gathered(params)
    x, _ = _trunk(params, cfg, tokens, None, caches, "full", impl)
    last = x[:, -1:]
    if sharding.seq_parallel():      # the last row is the last rank's
        last = sharding.gather_model(last, 1)[:, -1:]
    return unembed(params, cfg, last)[:, 0], caches


def decode_step(params, cfg: C.ModelConfig, caches: List[dict],
                tokens: torch.Tensor, positions: torch.Tensor):
    """One decode step.  tokens: (B,) or (B, K); positions: (B,)."""
    params = _gathered(params)
    x, _ = _trunk(params, cfg, tokens, positions, caches, "decode",
                  "kernel")
    return unembed(params, cfg, x)[:, 0], caches
