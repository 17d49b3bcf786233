"""Per-layer-type blocks, the PyTorch counterpart of
``repro/models/blocks.py``: parameter specs, cache shapes and the residual
block forward.

Every layer type of the JAX package: DENSE and SWA (sliding-window)
layers, MOE (GQA attention and the mixture-of-experts FFN), MLA_DENSE
and MLA_MOE (multi-head latent attention, whose caches hold the latents
``c_kv`` and ``k_rope``), HYMBA and HYMBA_GLOBAL (windowed or full
attention in parallel with a Mamba head, whose states ``conv`` and ``h``
sit beside the K/V), and xLSTM's MLSTM and SLSTM (recurrent states
only: ``conv``, ``C``, ``n``, ``m``; ``c``, ``n``, ``m``, ``h``).

``apply_layer`` runs in two modes:
  * mode="full":   x (B, S, d), positions (B, S) — prefill; fills
                   ``cache`` (if given) for the decode steps after it.
  * mode="decode": x (B, 1, d), positions (B,) — one token against the
                   cache.

Sliding-window layers keep a ring-buffer cache of ``window`` slots with
an explicit per-slot absolute-position array (keys are roped when they
are written, so RoPE stays consistent across the ring's wraparound).

Where the JAX package returns a new cache, these functions write the new
K/V, ring positions and recurrent states **in place** into the tensors
of the cache dict they are given, cast to the cache's dtype, and return
that dict.  JAX drops the ring writes of all
but the last ``window`` prompt tokens with ``mode="drop"``; here only
those last ``window`` rows are selected and written.

Inside a tensor-parallel step (``sharding.tensor_parallel()``; see
``models.sharding``) every layer type runs on its rank's ``model``
shards, between layers on the rank's own rows of the sequence:

  * the norms run on those rows;
  * GQA attention gathers the rows, projects this rank's query heads
    (``layers.kv_heads_for`` picks their KV heads), attends over the
    whole sequence and sums the ranks' row-parallel outputs back into
    each rank's rows.  Where the query heads do not divide the model
    axis (gemma3-4b: H 8 at 16; hymba-1.5b: 25) the attention's weights
    come whole and each rank attends for its own query rows against the
    gathered keys (the reference's fallback: query blocks over ``seq``);
  * MLA (``models.mla``) likewise over its heads, the latents computed
    from the gathered rows with the whole ``w_dkv``/``w_krope``;
  * Mamba, mLSTM and sLSTM (``models.ssm``) scan every row of the batch
    shard on this rank's channels or heads;
  * the MLP is column- then row-parallel where its hidden width divides
    (``ffn_width``), the MoE FFN expert-parallel (``models.moe``).

A decode step has one row: it runs the same shards on replicated rows
and sums the partial outputs with an all-reduce.  The cache is this
rank's shards of it (``sharding.local_cache``): its KV heads where they
split, and, where the sequence splits over mesh dims (KV heads that do
not divide ``model``, or ``LONG_CONTEXT_RULES``' ``data``), its chunk
of the sequence or of the ring's slots (``split``), which the owner of
a new token's slot writes and the softmax reduces over.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import config as C
from repro_torch.models import layers, mla, moe, sharding, ssm

LAYER_TYPES = (C.DENSE, C.SWA, C.MOE, C.MLA_DENSE, C.MLA_MOE, C.HYMBA,
               C.HYMBA_GLOBAL, C.MLSTM, C.SLSTM)
# the recurrent states, which ``alloc_cache`` keeps in float32
STATE_FIELDS = ("C", "n", "m", "h", "c")
# the cache fields whose dim 1 is the sequence ("cache_seq")
SEQ_FIELDS = ("k", "v", "c_kv", "k_rope")


def _check_type(ltype: str) -> None:
    if ltype not in LAYER_TYPES:
        raise ValueError(f"unknown layer type {ltype}")


# ------------------------------------------------------------------ specs
def layer_specs(cfg: C.ModelConfig, ltype: str) -> dict:
    _check_type(ltype)
    d = cfg.d_model
    ln = layers.norm_spec(d)
    if ltype in (C.HYMBA, C.HYMBA_GLOBAL):
        return {"ln1": ln, "attn": layers.attn_specs(cfg),
                "mamba": ssm.mamba_specs(cfg),
                "ln2": ln, "mlp": layers.mlp_specs(d, cfg.d_ff)}
    if ltype == C.MLSTM:
        return {"ln1": ln, "mlstm": ssm.mlstm_specs(cfg)}
    if ltype == C.SLSTM:
        return {"ln1": ln, "slstm": ssm.slstm_specs(cfg),
                "ln2": ln, "mlp": layers.mlp_specs(d, ffn_width(cfg, ltype))}
    mixer = ({"mla": mla.mla_specs(cfg)} if ltype in C.MLA_LAYER_TYPES
             else {"attn": layers.attn_specs(cfg)})
    if ltype in (C.MOE, C.MLA_MOE):
        ffn = {"moe": moe.moe_specs(d, cfg.moe,
                                    cfg.inference_weight_layout)}
    else:
        ffn = {"mlp": layers.mlp_specs(d, ffn_width(cfg, ltype))}
    return {"ln1": ln, **mixer, "ln2": ln, **ffn}


def ffn_width(cfg: C.ModelConfig, ltype: str) -> int:
    """The hidden width of a layer's gated MLP."""
    if ltype == C.SLSTM:
        return int(cfg.xlstm.slstm_proj_factor * cfg.d_model)
    if ltype == C.MLA_DENSE and not cfg.d_ff:
        # deepseek-v2 layer 0: dense FFN sized like shared+routed width
        return cfg.moe.d_expert * 4
    return cfg.d_ff


# ------------------------------------------------------------------ caches
def _kv_cache(cfg, batch, length) -> Dict[str, Tuple[tuple, tuple]]:
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    axes = ("batch", "cache_seq", "kv_heads", None)
    return {"k": ((batch, length, hkv, hd), axes),
            "v": ((batch, length, hkv, hd), axes)}


def _window_cache(cfg, batch) -> Dict[str, Tuple[tuple, tuple]]:
    w = cfg.sliding_window
    c = _kv_cache(cfg, batch, w)
    c["pos"] = ((batch, w), ("batch", None))
    return c


def cache_shape(cfg: C.ModelConfig, ltype: str, batch: int,
                cache_len: int) -> Dict[str, Tuple[tuple, tuple]]:
    """dict of cache field -> ((shape), (logical axes))."""
    _check_type(ltype)
    if ltype in (C.DENSE, C.MOE):
        return _kv_cache(cfg, batch, cache_len)
    if ltype == C.SWA:
        return _window_cache(cfg, batch)
    if ltype in C.MLA_LAYER_TYPES:
        m = cfg.mla
        return {"c_kv": ((batch, cache_len, m.kv_lora_rank),
                         ("batch", "cache_seq", None)),
                "k_rope": ((batch, cache_len, m.qk_rope_head_dim),
                           ("batch", "cache_seq", None))}
    if ltype == C.HYMBA:
        return {**_window_cache(cfg, batch),
                **ssm.mamba_state_shape(cfg, batch)}
    if ltype == C.HYMBA_GLOBAL:
        return {**_kv_cache(cfg, batch, cache_len),
                **ssm.mamba_state_shape(cfg, batch)}
    if ltype == C.MLSTM:
        return ssm.mlstm_state_shape(cfg, batch)
    return ssm.slstm_state_shape(cfg, batch)


def alloc_cache(shapes: Dict[str, Tuple[tuple, tuple]], dtype,
                device) -> dict:
    """Zeroed fields: ring positions of -1 (int32), the recurrent states
    (``STATE_FIELDS``) in float32, as the JAX package's
    ``models.model.init_cache`` keeps them, the rest (K/V, latents, conv
    buffers) in ``dtype``."""
    def zeros(name, shape):
        dt = torch.float32 if name in STATE_FIELDS else dtype
        return torch.zeros(shape, dtype=dt, device=device)
    return {name: (torch.full(shape, -1, dtype=torch.int32, device=device)
                   if name == "pos" else zeros(name, shape))
            for name, (shape, _axes) in shapes.items()}


# ------------------------------------------------------------------ attention paths
def _attn_full(p, cfg, x, positions, cache, window: int, impl: str,
               split=None):
    """Full-sequence attention (prefill or training); optionally fills
    the cache (this rank's chunk of it under a ``split``).  positions:
    (B, S), every row's, though x may hold only this rank's rows
    (sequence parallelism)."""
    qsplit = p["wq"].shape[1] != cfg.n_heads      # query heads over model
    xg = sharding.model_rows(x)
    q_offset = 0
    if qsplit or not sharding.tensor_parallel():
        q = layers.attn_q(p, cfg, xg, positions)
    else:                 # whole weights: this rank's query rows only
        q = layers.attn_q(p, cfg, x, sharding.own_rows(positions))
        q_offset = sharding.row_offset(x.shape[1])
    heads = layers.kv_heads_for(p, cfg, q.shape[2])
    # a cache takes every KV head the weights hold; the attention only
    # the ones these query heads read
    k, v = layers.attn_kv(p, cfg, xg, positions,
                          heads if cache is None else None)
    ka, va = ((k, v) if cache is None or heads is None
              else (k[:, :, heads], v[:, :, heads]))
    if impl == "train":
        o = layers.attn_causal_plain(q, ka, va, window=window,
                                     softcap=cfg.attn_logit_softcap,
                                     q_offset=q_offset)
    else:
        o = layers.attn_causal(q, ka, va, window=window,
                               softcap=cfg.attn_logit_softcap,
                               q_offset=q_offset, impl=impl)
    if cache is not None:
        if "pos" in cache:  # ring buffer: only the last `window` tokens
            _write_ring(cache, cfg, k, v, positions, split)
        else:
            layers.write_rows(cache["k"], k, split)
            layers.write_rows(cache["v"], v, split)
    out = layers.attn_out(p, o)
    return (sharding.sum_model_rows(out) if qsplit else out), cache


def _write_ring(cache, cfg, k, v, positions, split) -> None:
    """The last ``window`` prompt tokens' K/V into the ring buffer's slots
    ``pos % window`` and their positions into ``pos`` (whole on every
    rank).  Under a ``split`` of the slots the tokens are placed in a
    whole ring of this rank's own and its chunk of it is kept."""
    w = cfg.sliding_window
    keep_from = max(k.shape[1] - w, 0)
    pos = positions[:, keep_from:]
    slots = pos.long() % w                                   # (B, w)
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["pos"][bidx, slots] = pos.to(torch.int32)
    for name, new in (("k", k), ("v", v)):
        dst = cache[name]
        if split is None:
            dst[bidx, slots] = new[:, keep_from:].to(dst.dtype)
            continue
        ring = dst.new_zeros((dst.shape[0], w) + dst.shape[2:])
        hit = torch.zeros(dst.shape[:1] + (w,), dtype=torch.bool,
                          device=dst.device)
        ring[bidx, slots] = new[:, keep_from:].to(dst.dtype)
        hit[bidx, slots] = True
        lo, hi = split.bounds(dst.shape[1])
        dst.copy_(torch.where(hit[:, lo:hi, None, None], ring[:, lo:hi],
                              dst))


def _attn_decode(p, cfg, x, positions, cache, window: int, split=None):
    """One-token decode against a (possibly ring-buffer) cache, in plain
    torch, as the JAX package computes it.  The cache holds the KV heads
    the weights hold.  Under a ``split`` of its sequence (or ring slots)
    the cache is this rank's chunk: the rank that holds the new token's
    slot writes it, and the softmax is taken over every rank's keys
    (``layers.softmax_split``); where the split is over ``model`` and the
    query heads are too, every query head attends to this rank's keys
    (the queries gathered over ``model``) and each rank keeps its own
    heads' outputs."""
    qsplit = p["wq"].shape[1] != cfg.n_heads
    q = layers.attn_q(p, cfg, x, positions[:, None])
    k, v = layers.attn_kv(p, cfg, x, positions[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    ck, cv = cache["k"], cache["v"]
    lo = split.bounds(ck.shape[1])[0] if split is not None else 0
    if "pos" in cache:
        w = cfg.sliding_window
        slot = positions.long() % w
        layers.put_token(ck, bidx, slot, k[:, 0], split)
        layers.put_token(cv, bidx, slot, v[:, 0], split)
        cache["pos"][bidx, slot] = positions.to(torch.int32)
        kpos = cache["pos"][:, lo:lo + ck.shape[1]]            # (B, w)
        cur = positions[:, None]
        mask = ((kpos >= 0) & (kpos <= cur) & (kpos > cur - w))[:, None, :]
    else:
        layers.put_token(ck, bidx, positions.long(), k[:, 0], split)
        layers.put_token(cv, bidx, positions.long(), v[:, 0], split)
        mask = layers.decode_mask(positions, ck.shape[1], window=window,
                                  offset=lo)
    every_head = qsplit and split is not None and split.model
    if every_head:
        q = sharding.gather_model(q, 2)
    else:
        heads = layers.kv_heads_for(p, cfg, q.shape[2])
        if heads is not None:
            ck, cv = ck[:, :, heads], cv[:, :, heads]
    o = layers.attention(q, ck, cv, mask, softcap=cfg.attn_logit_softcap,
                         split=split)
    if every_head:
        o = sharding.model_slice(o, 2, p["wq"].shape[1])
    out = layers.attn_out(p, o)
    return (sharding.sum_model_rows(out) if qsplit else out), cache


# ------------------------------------------------------------------ apply
def _store(cache: Optional[dict], new: dict) -> None:
    """Write new recurrent states into the cache's tensors, in place,
    cast to the cache's dtype (the reference's scan writes them back as
    ``new.astype(cache.dtype)``).  A state the cache holds whole that a
    rank computed a model shard of (Mamba's ``h`` and the conv buffers,
    ``("batch", None, None)``) is gathered over ``model`` first."""
    if cache is not None:
        for name, t in new.items():
            for d in range(t.dim()):
                if t.shape[d] != cache[name].shape[d]:
                    t = sharding.gather_model_values(t, d)
            cache[name].copy_(t)


def apply_layer(p: dict, cfg: C.ModelConfig, ltype: str, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict], mode: str,
                impl: str = "kernel",
                split: Optional[sharding.SeqSplit] = None
                ) -> Tuple[torch.Tensor, Optional[dict],
                           Optional[moe.Routing]]:
    """Residual block.  Returns (x, cache, routing): the MoE FFN's
    routing, from which ``moe.aux_losses`` computes the reference's
    auxiliary losses, None for the other layers.  ``impl`` routes the
    full-mode GQA attention (Hymba's included): "kernel" to the
    ``flash_prefill`` kernel, "ref" to its plain version (both for
    serving), "train" to the trainer's differentiable
    ``layers.attn_causal_plain``, the JAX package's ``attn_causal``
    (MLA has no kernel and always takes it).  ``split`` says how the
    cache's sequence is split over the mesh (None: whole)."""
    _check_type(ltype)
    if mode not in ("full", "decode"):
        raise ValueError(f"mode must be 'full' or 'decode', got {mode!r}")
    full = mode == "full"
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if ltype in C.MLA_LAYER_TYPES:
        mix = mla.mla_full if full else mla.mla_decode
        a, cache = mix(p["mla"], cfg, h, positions, cache,
                       absorb=cfg.mla_absorb, split=split)
    elif ltype in (C.HYMBA, C.HYMBA_GLOBAL):
        window = cfg.sliding_window if ltype == C.HYMBA else 0
        attn_cache = state = None
        if cache is not None:
            attn_cache = {k: cache[k] for k in ("k", "v", "pos")
                          if k in cache}
            state = {k: cache[k] for k in ("conv", "h")}
        if full:
            a, _ = _attn_full(p["attn"], cfg, h, positions, attn_cache,
                              window, impl, split)
            m_out, new = ssm.mamba_seq(p["mamba"], cfg, h,
                                       state or _fresh_mamba(cfg, h))
        else:
            a, _ = _attn_decode(p["attn"], cfg, h, positions, attn_cache,
                                window, split)
            m_out, new = ssm.mamba_step(p["mamba"], cfg, h[:, 0], state)
            m_out = m_out[:, None, :]
        _store(cache, new)
        a = 0.5 * (a + m_out)
    elif ltype in (C.MLSTM, C.SLSTM):
        name, fresh = (("mlstm", _fresh_mlstm) if ltype == C.MLSTM
                       else ("slstm", _fresh_slstm))
        seq, step = ((ssm.mlstm_seq, ssm.mlstm_step) if ltype == C.MLSTM
                     else (ssm.slstm_seq, ssm.slstm_step))
        st = cache if cache else fresh(cfg, h)
        if full:
            a, new = seq(p[name], cfg, h, st)
        else:
            a, new = step(p[name], cfg, h[:, 0], st)
            a = a[:, None, :]
        _store(cache, new)
        if ltype == C.MLSTM:
            return x + a, cache, None             # no FFN sublayer
    else:
        window = cfg.sliding_window if ltype == C.SWA else 0
        if full:
            a, cache = _attn_full(p["attn"], cfg, h, positions, cache,
                                  window, impl, split)
        else:
            a, cache = _attn_decode(p["attn"], cfg, h, positions, cache,
                                    window, split)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, routing, _ = moe.moe_ffn(p["moe"], cfg.moe, h, cfg.act)
        return x + f, cache, routing
    return (x + layers.mlp(p["mlp"], h, cfg.act, ffn_width(cfg, ltype)),
            cache, None)


def _fresh_mamba(cfg, x):
    return alloc_cache(ssm.mamba_state_shape(cfg, x.shape[0]), x.dtype,
                       x.device)


def _fresh_mlstm(cfg, x):
    return alloc_cache(ssm.mlstm_state_shape(cfg, x.shape[0]),
                       torch.float32, x.device)


def _fresh_slstm(cfg, x):
    return alloc_cache(ssm.slstm_state_shape(cfg, x.shape[0]),
                       torch.float32, x.device)
