"""Paged-KV forward passes for serving, the PyTorch counterpart of
``repro/engine/paged_model.py`` (DENSE and MOE configs).

Five entry points over the stacked layer parameters of a single-run
config:

- ``prefill_step``: one (possibly chunked) prefill for one request; the
  chunk attends directly over the pages through ``paged_prefill``.
- ``decode_batch``: one token per sequence through ``paged_attention``.
- ``mixed_step``: the fused continuous-batching step: B decode tokens
  and K prefill chunks flattened into one token batch; only attention
  forks (decode rows to ``paged_attention``, chunk rows to
  ``paged_prefill``).
- ``spec_decode_step``: speculative verification: every decode row is a
  short chunk (its last token and its drafts) through ``paged_verify``,
  the ``paged_prefill`` kernel at a lane width padded to 8, with logits
  for every row.
- ``spec_mixed_step``: the same lanes fused with K prefill chunks.

Where the JAX package runs a ``lax.scan`` over the stacked layers and
returns a new pool, these functions loop over the layers in Python and
write each layer's new K/V into the pool **in place**; the returned
``PagePool`` is the same object that was passed in.  JAX drops masked
K/V writes (inactive decode rows, chunk padding, idle spec lanes) with
``mode="drop"``; here only the valid rows are written, so no write
reaches any page for them, the scratch page included, and no two writes
of a step land on one slot.

Between the GEMMs each layer runs three fused elementwise kernels
(``kernels/fused_elementwise.py``, dispatched through ``kernels.ops``):
a residual add with the RMSNorm after it (twice), RoPE of q and k with
the K/V page write, and the MLP's gated activation.  The (sin, cos)
table is made once a step.  For CPU tensors (and ``impl="ref"``) each
is the plain composition of ``models.layers`` it replaces.

High-density LoRA is applied in-batch as in the JAX package: every
request carries an adapter id into a gathered (adapter, d, r) x
(adapter, r, out) pair on the q/v projections, two batched products
(``torch.bmm``) outside any kernel, whose deltas join q and v before
RoPE.  Adapter 0 is the zero (base-model) adapter, so base rows and N
adapters share one step.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch import random as R
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers, moe
from repro_torch.models import model as M
from repro_torch.models.config import DENSE, MOE, ModelConfig
from repro_torch.models.params import Spec, init_params


def pageable(cfg: ModelConfig) -> bool:
    """True when the paged path supports this config (uniform attn run)."""
    return (len(cfg.layer_runs) == 1
            and cfg.layer_runs[0][0] in (DENSE, MOE)
            and cfg.num_codebooks == 0)


class PagePool(NamedTuple):
    k: torch.Tensor         # (L, P, page, Hkv, D)
    v: torch.Tensor


def init_pool(cfg: ModelConfig, num_pages: int, page_size: int,
              dtype=torch.float32, device=None) -> PagePool:
    """A zeroed pool on ``device`` (the card unless one is named)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    return PagePool(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------- LoRA
def lora_specs(cfg: ModelConfig, n_adapters: int, rank: int) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "A_q": Spec((n_adapters, d, rank), (None, None, None), "zeros"),
        "B_q": Spec((n_adapters, rank, h * hd), (None, None, None), "zeros"),
        "A_v": Spec((n_adapters, d, rank), (None, None, None), "zeros"),
        "B_v": Spec((n_adapters, rank, hkv * hd), (None, None, None),
                    "zeros"),
    }


def init_lora(cfg: ModelConfig, n_adapters: int, rank: int,
              dtype=torch.float32, device=None) -> dict:
    """A zeroed adapter bank on ``device`` (the card unless one is
    named); slot 0 stays zero, the base model."""
    return init_params(lora_specs(cfg, n_adapters, rank), 7, dtype, device)


def make_adapter(cfg: ModelConfig, rank: int, key: torch.Tensor,
                 dtype=torch.float32) -> dict:
    """A single random (non-zero) adapter's weights, on the key's device:
    ``repro.engine.paged_model.make_adapter``'s draws from the same key
    (a 4-way ``split``, one ``normal`` each), bit for bit."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k1, k2, k3, k4 = R.split(key, 4)
    # the scales round to ``dtype`` first, as jax's weak-typed scalars do
    a_scale, b_scale = torch.tensor(
        [1.0 / (d ** 0.5), 0.5 / (rank ** 0.5)], dtype=dtype).tolist()
    return {
        "A_q": R.normal(k1, (d, rank), dtype) * a_scale,
        "B_q": R.normal(k2, (rank, h * hd), dtype) * b_scale,
        "A_v": R.normal(k3, (d, rank), dtype) * a_scale,
        "B_v": R.normal(k4, (rank, hkv * hd), dtype) * b_scale,
    }


def _lora_delta(lora: dict, which: str, x: torch.Tensor,
                adapter_ids: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); adapter_ids: (B,) -> (B, S, out)."""
    ids = adapter_ids.long()
    a = lora[f"A_{which}"][ids]                 # (B, d, r)
    b_ = lora[f"B_{which}"][ids]                # (B, r, out)
    return torch.bmm(torch.bmm(x, a), b_)


def _lora_deltas(cfg: ModelConfig, lora: Optional[dict], x: torch.Tensor,
                 groups: List[Tuple[torch.Tensor, int, int]]):
    """The q and v deltas of a token batch ``x`` (..., d), shaped as q
    and v (None, None without a bank).  ``x`` is made of chunk-shaped
    *groups*: ``groups`` lists ``(adapter_ids, n_chunks, chunk_width)``
    covering its rows in order (the mixed step's B decode rows are B
    chunks of width 1).  The adapter pair is gathered once per chunk,
    not per token: all rows of a chunk share one request's adapter."""
    if lora is None:
        return None, None
    d_model = x.shape[-1]
    flat = x.reshape(-1, d_model)

    def delta(which: str, heads: int) -> torch.Tensor:
        parts, off = [], 0
        for aids, n, s in groups:
            seg = flat[off:off + n * s].reshape(n, s, d_model)
            parts.append(_lora_delta(lora, which, seg, aids).reshape(
                n * s, heads, cfg.head_dim))
            off += n * s
        return torch.cat(parts).reshape(x.shape[:-1] + (heads, cfg.head_dim))
    return delta("q", cfg.n_heads), delta("v", cfg.n_kv_heads)


def _qkv(p_attn: dict, cfg: ModelConfig, x: torch.Tensor):
    """(q, k, v) of x (..., d) before RoPE: ``layers.attn_q``'s and
    ``attn_kv``'s projections, bias, then ``qk_norm``.  The rope comes
    with the K/V write (``kops.rope_write_kv``)."""
    q, k, v = (layers._proj(x, p_attn[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p_attn["bq"], k + p_attn["bk"], v + p_attn["bv"]
    if cfg.qk_norm:
        q = layers.rms_norm(q, p_attn["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p_attn["k_norm"], cfg.norm_eps)
    return q, k, v


def _layer_params(params, cfg: ModelConfig) -> List[dict]:
    """Per-layer views of the stacked ``run_0`` leaves."""
    if not pageable(cfg):
        raise ValueError(f"{cfg.name}: the paged path takes one run of "
                         "DENSE or MOE layers")
    return [M.layer_view(params["run_0"], i) for i in range(cfg.n_layers)]


def _ffn(p_l: dict, cfg: ModelConfig, h: torch.Tensor,
         impl: str) -> torch.Tensor:
    """The FFN sublayer's output for the normed token batch ``h``,
    padding rows included: the MoE capacity is the reference's for that
    batch.  The MoE auxiliary losses are not computed: the reference's
    steps drop them."""
    if "moe" in p_l:
        return moe.moe_ffn(p_l["moe"], cfg.moe, h, cfg.act)[0]
    p = p_l["mlp"]
    return kops.gated_act(h @ p["w_gate"], h @ p["w_in"], cfg.act,
                          impl=impl) @ p["w_out"]


def _write_kv(pool: PagePool, layer: int, kv: Tuple[torch.Tensor, ...],
              q, k, v, sin, cos, dq, dv, impl: str) -> None:
    """Layer ``layer``'s K/V of the rows ``kv`` = (rows, pages, slots)
    into the pool, k roped, and q roped in place (with the LoRA deltas
    dq, dv where given): one kernel, no write for any other row.  Kept
    as a function of its own: the benchmark's fault test
    (``servebench/test_servebench_faults.py``) replaces it by name."""
    kops.rope_write_kv(q, k, v, sin, cos, pool.k[layer], pool.v[layer], *kv,
                       dq=dq, dv=dv, impl=impl)


def _layers(params, cfg: ModelConfig, pool: PagePool, x: torch.Tensor,
            positions: torch.Tensor, kv: Tuple[torch.Tensor, ...],
            lora: Optional[dict], groups, attend, impl: str
            ) -> torch.Tensor:
    """Every layer over the token batch ``x`` (..., d) at ``positions``
    (its leading dims), writing each layer's K/V of the rows ``kv`` =
    (rows, pages, slots) into the pool in place (``_write_kv``).
    ``attend(i, q)`` is layer i's attention over the pages.  Between the
    GEMMs each gap is one kernel: a residual add with the norm after it,
    RoPE with the K/V write, the gated activation.  Returns the final
    norm of the last layer's output."""
    sin, cos = layers.rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
    p_layers = _layer_params(params, cfg)
    norms = [p_l["ln1"] for p_l in p_layers[1:]] + [params["final_norm"]]
    eps = cfg.norm_eps
    x, h = kops.add_rms_norm(x, None, p_layers[0]["ln1"], eps, impl=impl)
    for i, p_l in enumerate(p_layers):
        q, k, v = _qkv(p_l["attn"], cfg, h)
        dq, dv = _lora_deltas(cfg, lora, h, groups)
        _write_kv(pool, i, kv, q, k, v, sin, cos, dq, dv, impl)
        x, h = kops.add_rms_norm(x, layers.attn_out(p_l["attn"],
                                                    attend(i, q)),
                                 p_l["ln2"], eps, impl=impl)
        x, h = kops.add_rms_norm(x, _ffn(p_l, cfg, h, impl), norms[i], eps,
                                 impl=impl)
    return h


def _chunk_rows(tokens: torch.Tensor, ctx: torch.Tensor, lens: torch.Tensor,
                block_tables: torch.Tensor, page_size: int, offset: int):
    """Positions (N, W) of a batch of chunks (N, W) starting at ``ctx``,
    and the flat rows (shifted by ``offset``), pages and slots of the
    valid ones (row j of chunk i is valid when j < lens[i]).  Block
    tables are read for the valid rows only: a padding row's position
    may lie past the table's width."""
    n, w = tokens.shape
    dev = tokens.device
    positions = ctx.long()[:, None] + torch.arange(w, device=dev)[None]
    valid = torch.arange(w, device=dev)[None] < lens[:, None]
    rows = torch.nonzero(valid.reshape(-1)).squeeze(1)
    pos = positions.reshape(-1)[rows]
    pidx = block_tables[rows // w, pos // page_size].long()
    return positions, offset + rows, pidx, pos % page_size


# ---------------------------------------------------------------- prefill
def prefill_step(params, pool: PagePool, tokens: torch.Tensor,
                 block_table: torch.Tensor, ctx_len: int, chunk_len: int,
                 lora: Optional[dict] = None,
                 adapter_ids: Optional[torch.Tensor] = None, *,
                 cfg: ModelConfig, page_size: int, impl: str = "kernel"
                 ) -> Tuple[torch.Tensor, PagePool]:
    """One (possibly chunked) prefill for ONE request.

    tokens:      (1, s) current chunk (padded; ``chunk_len`` valid)
    block_table: (1, NB) int32 pages covering [0, ctx+s)
    ctx_len:     tokens already in the pages (prefix cache + earlier
                 chunks)
    lora, adapter_ids: the adapter bank and (1,) slot (None: no LoRA)
    Returns (last-token logits (1, V), pool updated in place).
    """
    dev = tokens.device
    ctx_len, chunk_len = int(ctx_len), int(chunk_len)
    s = tokens.shape[1]
    tok_pos = ctx_len + torch.arange(s, device=dev)             # (s,)
    positions = tok_pos[None]
    x = M.embed(params, cfg, tokens)
    ctx1 = torch.tensor([ctx_len], dtype=torch.int32, device=dev)
    chunk1 = torch.tensor([chunk_len], dtype=torch.int32, device=dev)
    rows = torch.arange(chunk_len, device=dev)
    pidx = block_table[0, tok_pos[:chunk_len] // page_size].long()
    slot = tok_pos[:chunk_len] % page_size

    def attend(i, q):
        return kops.paged_prefill(q, pool.k[i], pool.v[i], block_table, ctx1,
                                  chunk1, impl=impl)
    x = _layers(params, cfg, pool, x, positions, (rows, pidx, slot), lora,
                [(adapter_ids, 1, s)], attend, impl)
    last = x[:, max(chunk_len - 1, 0)][:, None]
    return M.unembed(params, cfg, last)[:, 0], pool


# ---------------------------------------------------------------- decode
def decode_batch(params, pool: PagePool, tokens: torch.Tensor,
                 positions: torch.Tensor, block_tables: torch.Tensor,
                 active: torch.Tensor, lora: Optional[dict] = None,
                 adapter_ids: Optional[torch.Tensor] = None, *,
                 cfg: ModelConfig, page_size: int, impl: str = "kernel",
                 rows: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, PagePool]:
    """One decode step for a batch.

    tokens: (B,) int32; positions: (B,) int32 next position (== current
    length); block_tables: (B, NB) int32; active: (B,) bool (padding
    slots excluded; they get length 0); lora, adapter_ids: the adapter
    bank and (B,) slots (None: no LoRA); rows: the indices of the active
    rows, where the caller knows them (found from ``active`` otherwise,
    which waits for the device).  Returns (logits (B, V), pool updated
    in place).
    """
    x = M.embed(params, cfg, tokens[:, None])
    lengths = torch.where(active, positions + 1, 0).to(torch.int32)
    if rows is None:
        rows = torch.nonzero(active).squeeze(1)
    pos_a = positions[rows].long()
    pidx = block_tables[rows, pos_a // page_size].long()
    slot = pos_a % page_size

    def attend(i, q):
        return kops.paged_attention(q[:, 0], pool.k[i], pool.v[i],
                                    block_tables, lengths, impl=impl)[:, None]
    x = _layers(params, cfg, pool, x, positions[:, None], (rows, pidx, slot),
                lora, [(adapter_ids, tokens.shape[0], 1)], attend, impl)
    return M.unembed(params, cfg, x)[:, 0], pool


# ---------------------------------------------------------------- mixed step
def mixed_step(params, pool: PagePool,
               dec_tokens: torch.Tensor, dec_positions: torch.Tensor,
               dec_block_tables: torch.Tensor, dec_active: torch.Tensor,
               pre_tokens: torch.Tensor, pre_block_tables: torch.Tensor,
               pre_ctx: torch.Tensor, pre_chunk: torch.Tensor,
               lora: Optional[dict] = None,
               dec_adapter_ids: Optional[torch.Tensor] = None,
               pre_adapter_ids: Optional[torch.Tensor] = None, *,
               cfg: ModelConfig, page_size: int, impl: str = "kernel"
               ) -> Tuple[torch.Tensor, torch.Tensor, PagePool]:
    """One fused continuous-batching step: B decode tokens + K prefill
    chunks in a single forward pass over one flattened token batch.

    dec_tokens:       (B,) int32; dec_positions: (B,) int32 next position
    dec_block_tables: (B, NBd) int32; dec_active: (B,) bool
    pre_tokens:       (K, S) chunk tokens (padded; ``pre_chunk`` valid)
    pre_block_tables: (K, NBp) int32; pre_ctx/pre_chunk: (K,) int32
                      (pre_chunk == 0 marks an idle prefill slot)
    lora:             the adapter bank (None: no LoRA), with the slots
                      dec_adapter_ids (B,) and pre_adapter_ids (K,)
    Returns (decode logits (B, V), prefill last-token logits (K, V),
    pool updated in place).  The token budget of the pass is B + K*S.
    """
    dev = dec_tokens.device
    b = dec_tokens.shape[0]
    kk, s = pre_tokens.shape
    h_, hd = cfg.n_heads, cfg.head_dim
    # the rows whose K/V are written: active decode rows (chunks of one),
    # then the valid rows of each chunk
    dec_pos, dec_rows, dec_pidx, dec_slot = _chunk_rows(
        dec_tokens[:, None], dec_positions, dec_active.int(),
        dec_block_tables, page_size, 0)
    pre_pos, pre_rows, pre_pidx, pre_slot = _chunk_rows(
        pre_tokens, pre_ctx, pre_chunk, pre_block_tables, page_size, b)
    rows = torch.cat([dec_rows, pre_rows])
    pidx = torch.cat([dec_pidx, pre_pidx])
    slot = torch.cat([dec_slot, pre_slot])
    tokens_flat = torch.cat([dec_tokens, pre_tokens.reshape(-1)])
    positions_flat = torch.cat([dec_pos.reshape(-1),
                                pre_pos.reshape(-1)])           # (T,)
    x = M.embed(params, cfg, tokens_flat[None])                 # (1, T, d)
    dec_lengths = torch.where(dec_active, dec_positions + 1, 0).to(
        torch.int32)

    def attend(i, q):
        # both kernels write into views of one (T, H, D) output
        o = torch.empty_like(q[0])
        kops.paged_attention(q[0, :b], pool.k[i], pool.v[i],
                             dec_block_tables, dec_lengths, out=o[:b],
                             impl=impl)
        kops.paged_prefill(q[0, b:].reshape(kk, s, h_, hd), pool.k[i],
                           pool.v[i], pre_block_tables, pre_ctx, pre_chunk,
                           out=o[b:].view(kk, s, h_, hd), impl=impl)
        return o[None]
    x = _layers(params, cfg, pool, x, positions_flat[None],
                (rows, pidx, slot), lora,
                [(dec_adapter_ids, b, 1), (pre_adapter_ids, kk, s)], attend,
                impl)
    # only unembed the rows that produce tokens: every decode row plus
    # each chunk's last valid row
    sel = torch.cat([torch.arange(b, device=dev),
                     b + torch.arange(kk, device=dev) * s
                     + torch.clamp(pre_chunk.long() - 1, min=0)])
    logits = M.unembed(params, cfg, x[0, sel][None])[0]         # (B+K, V)
    return logits[:b], logits[b:], pool


# ------------------------------------------------- speculative verification
def spec_decode_step(params, pool: PagePool, spec_tokens: torch.Tensor,
                     spec_ctx: torch.Tensor, spec_len: torch.Tensor,
                     spec_block_tables: torch.Tensor,
                     lora: Optional[dict] = None,
                     adapter_ids: Optional[torch.Tensor] = None, *,
                     cfg: ModelConfig, page_size: int, impl: str = "kernel"
                     ) -> Tuple[torch.Tensor, PagePool]:
    """One speculative decode step: every decode row is a short
    multi-query chunk ``[last_token, draft_1..draft_d]`` verified in a
    single pass.

    spec_tokens:       (B, SD) int32: row i feeds its last sampled token
                       at position ``spec_ctx[i]``, then the drafts
                       (padded; ``spec_len`` valid, 0 = idle lane)
    spec_ctx:          (B,) tokens already in the pages
    spec_block_tables: (B, NB) int32
    lora, adapter_ids: the adapter bank and (B,) slots (None: no LoRA)
    Returns (logits for EVERY chunk row (B, SD, V), pool updated in
    place).  Row j's logits are the model's distribution after
    drafts[:j], what acceptance needs.  The K/V of every fed token
    (drafts included) is written into the pages; a rejected draft
    leaves a stale slot past the accepted length that attention never
    reads and the next step's real token overwrites.
    """
    b, sd = spec_tokens.shape
    positions, rows, pidx, slot = _chunk_rows(
        spec_tokens, spec_ctx, spec_len, spec_block_tables, page_size, 0)
    positions_flat = positions.reshape(-1)[None]
    x = M.embed(params, cfg, spec_tokens.reshape(1, -1))   # (1, B*SD, d)
    h_, hd = cfg.n_heads, cfg.head_dim

    def attend(i, q):
        return kops.paged_verify(q[0].reshape(b, sd, h_, hd), pool.k[i],
                                 pool.v[i], spec_block_tables, spec_ctx,
                                 spec_len, impl=impl).reshape(q.shape)
    x = _layers(params, cfg, pool, x, positions_flat, (rows, pidx, slot),
                lora, [(adapter_ids, b, sd)], attend, impl)
    logits = M.unembed(params, cfg, x)[0]                   # (B*SD, V)
    return logits.reshape(b, sd, -1), pool


def spec_mixed_step(params, pool: PagePool, spec_tokens: torch.Tensor,
                    spec_ctx: torch.Tensor, spec_len: torch.Tensor,
                    spec_block_tables: torch.Tensor,
                    pre_tokens: torch.Tensor, pre_block_tables: torch.Tensor,
                    pre_ctx: torch.Tensor, pre_chunk: torch.Tensor,
                    lora: Optional[dict] = None,
                    spec_adapter_ids: Optional[torch.Tensor] = None,
                    pre_adapter_ids: Optional[torch.Tensor] = None, *,
                    cfg: ModelConfig, page_size: int, impl: str = "kernel"
                    ) -> Tuple[torch.Tensor, torch.Tensor, PagePool]:
    """``spec_decode_step`` fused with prefill chunks: B speculative
    lanes and K prefill chunks flattened into ONE pass (the spec-enabled
    sibling of ``mixed_step``).  The lanes go through ``paged_verify``,
    the chunks through ``paged_prefill``; logits come out for every spec
    row and for the last valid row of each chunk.  Returns (spec logits
    (B, SD, V), prefill last-token logits (K, V), pool updated in
    place)."""
    dev = spec_tokens.device
    b, sd = spec_tokens.shape
    kk, s = pre_tokens.shape
    h_, hd = cfg.n_heads, cfg.head_dim
    spec_pos, spec_rows, spec_pidx, spec_slot = _chunk_rows(
        spec_tokens, spec_ctx, spec_len, spec_block_tables, page_size, 0)
    pre_pos, pre_rows, pre_pidx, pre_slot = _chunk_rows(
        pre_tokens, pre_ctx, pre_chunk, pre_block_tables, page_size, b * sd)
    rows = torch.cat([spec_rows, pre_rows])
    pidx = torch.cat([spec_pidx, pre_pidx])
    slot = torch.cat([spec_slot, pre_slot])
    tokens_flat = torch.cat([spec_tokens.reshape(-1), pre_tokens.reshape(-1)])
    positions_flat = torch.cat([spec_pos.reshape(-1),
                                pre_pos.reshape(-1)])[None]
    x = M.embed(params, cfg, tokens_flat[None])             # (1, T, d)

    n = b * sd

    def attend(i, q):
        # both kernels write into views of one (T, H, D) output
        o = torch.empty_like(q[0])
        kops.paged_verify(q[0, :n].reshape(b, sd, h_, hd), pool.k[i],
                          pool.v[i], spec_block_tables, spec_ctx, spec_len,
                          out=o[:n].view(b, sd, h_, hd), impl=impl)
        kops.paged_prefill(q[0, n:].reshape(kk, s, h_, hd), pool.k[i],
                           pool.v[i], pre_block_tables, pre_ctx, pre_chunk,
                           out=o[n:].view(kk, s, h_, hd), impl=impl)
        return o[None]
    x = _layers(params, cfg, pool, x, positions_flat, (rows, pidx, slot),
                lora, [(spec_adapter_ids, b, sd), (pre_adapter_ids, kk, s)],
                attend, impl)
    # every spec row + each prefill chunk's last valid row
    sel = torch.cat([torch.arange(b * sd, device=dev),
                     b * sd + torch.arange(kk, device=dev) * s
                     + torch.clamp(pre_chunk.long() - 1, min=0)])
    logits = M.unembed(params, cfg, x[0, sel][None])[0]     # (B*SD+K, V)
    return logits[:b * sd].reshape(b, sd, -1), logits[b * sd:], pool
