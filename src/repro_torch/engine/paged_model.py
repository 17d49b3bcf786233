"""Paged-KV forward passes for serving, the PyTorch counterpart of
``repro/engine/paged_model.py`` (DENSE configs, no LoRA yet).

Three entry points over the stacked layer parameters of a single-run
config:

- ``prefill_step``: one (possibly chunked) prefill for one request; the
  chunk attends directly over the pages through ``paged_prefill``.
- ``decode_batch``: one token per sequence through ``paged_attention``.
- ``mixed_step``: the fused continuous-batching step: B decode tokens
  and K prefill chunks flattened into one token batch; only attention
  forks (decode rows to ``paged_attention``, chunk rows to
  ``paged_prefill``).

Where the JAX package runs a ``lax.scan`` over the stacked layers and
returns a new pool, these functions loop over the layers in Python and
write each layer's new K/V into the pool **in place**; the returned
``PagePool`` is the same object that was passed in.  JAX drops masked
K/V writes (inactive decode rows, chunk padding) with ``mode="drop"``;
here only the valid rows are selected and written, so no write reaches
any page for them, the scratch page included.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.config import DENSE, MOE, ModelConfig


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


def _layer_params(params, cfg: ModelConfig) -> List[dict]:
    """Per-layer views of the stacked ``run_0`` leaves."""
    if cfg.layer_runs[0][0] != DENSE:
        raise NotImplementedError(
            f"{cfg.name}: only DENSE layers are ported to the paged path")
    return [M.layer_view(params["run_0"], i) for i in range(cfg.n_layers)]


def _ffn(p_l: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h2 = layers.rms_norm(x, p_l["ln2"], cfg.norm_eps)
    return x + layers.mlp(p_l["mlp"], h2, cfg.act)


def _write_kv(pool: PagePool, layer: int, pidx: torch.Tensor,
              slot: torch.Tensor, rows: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """pool[layer, pidx[i], slot[i]] = k/v[rows[i]] for the valid rows."""
    pool.k[layer][pidx, slot] = k[rows].to(pool.k.dtype)
    pool.v[layer][pidx, slot] = v[rows].to(pool.v.dtype)


# ---------------------------------------------------------------- prefill
def prefill_step(params, pool: PagePool, tokens: torch.Tensor,
                 block_table: torch.Tensor, ctx_len: int, chunk_len: int,
                 *, cfg: ModelConfig, page_size: int, impl: str = "kernel"
                 ) -> Tuple[torch.Tensor, PagePool]:
    """One (possibly chunked) prefill for ONE request.

    tokens:      (1, s) current chunk (padded; ``chunk_len`` valid)
    block_table: (1, NB) int32 pages covering [0, ctx+s)
    ctx_len:     tokens already in the pages (prefix cache + earlier
                 chunks)
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

    for i, p_l in enumerate(_layer_params(params, cfg)):
        h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        q, k, v = layers.attn_qkv(p_l["attn"], cfg, h, positions)
        _write_kv(pool, i, pidx, slot, rows, k[0], v[0])
        o = kops.paged_prefill(q, pool.k[i], pool.v[i], block_table, ctx1,
                               chunk1, impl=impl)
        x = _ffn(p_l, cfg, x + layers.attn_out(p_l["attn"], o))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[:, max(chunk_len - 1, 0)][:, None]
    return M.unembed(params, cfg, last)[:, 0], pool


# ---------------------------------------------------------------- decode
def decode_batch(params, pool: PagePool, tokens: torch.Tensor,
                 positions: torch.Tensor, block_tables: torch.Tensor,
                 active: torch.Tensor, *, cfg: ModelConfig, page_size: int,
                 impl: str = "kernel") -> Tuple[torch.Tensor, PagePool]:
    """One decode step for a batch.

    tokens: (B,) int32; positions: (B,) int32 next position (== current
    length); block_tables: (B, NB) int32; active: (B,) bool (padding
    slots excluded; they get length 0).  Returns (logits (B, V), pool
    updated in place).
    """
    x = M.embed(params, cfg, tokens[:, None])
    lengths = torch.where(active, positions + 1, 0).to(torch.int32)
    rows = torch.nonzero(active).squeeze(1)
    pos_a = positions[rows].long()
    pidx = block_tables[rows, pos_a // page_size].long()
    slot = pos_a % page_size

    for i, p_l in enumerate(_layer_params(params, cfg)):
        h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        q, k, v = layers.attn_qkv(p_l["attn"], cfg, h, positions[:, None])
        _write_kv(pool, i, pidx, slot, rows, k[:, 0], v[:, 0])
        o = kops.paged_attention(q[:, 0], pool.k[i], pool.v[i],
                                 block_tables, lengths, impl=impl)
        x = _ffn(p_l, cfg, x + layers.attn_out(p_l["attn"], o[:, None]))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return M.unembed(params, cfg, x)[:, 0], pool


# ---------------------------------------------------------------- mixed step
def mixed_step(params, pool: PagePool,
               dec_tokens: torch.Tensor, dec_positions: torch.Tensor,
               dec_block_tables: torch.Tensor, dec_active: torch.Tensor,
               pre_tokens: torch.Tensor, pre_block_tables: torch.Tensor,
               pre_ctx: torch.Tensor, pre_chunk: torch.Tensor, *,
               cfg: ModelConfig, page_size: int, impl: str = "kernel"
               ) -> Tuple[torch.Tensor, torch.Tensor, PagePool]:
    """One fused continuous-batching step: B decode tokens + K prefill
    chunks in a single forward pass over one flattened token batch.

    dec_tokens:       (B,) int32; dec_positions: (B,) int32 next position
    dec_block_tables: (B, NBd) int32; dec_active: (B,) bool
    pre_tokens:       (K, S) chunk tokens (padded; ``pre_chunk`` valid)
    pre_block_tables: (K, NBp) int32; pre_ctx/pre_chunk: (K,) int32
                      (pre_chunk == 0 marks an idle prefill slot)
    Returns (decode logits (B, V), prefill last-token logits (K, V),
    pool updated in place).  The token budget of the pass is B + K*S.
    """
    dev = dec_tokens.device
    b = dec_tokens.shape[0]
    kk, s = pre_tokens.shape
    h_, hd = cfg.n_heads, cfg.head_dim

    pre_positions = (pre_ctx.long()[:, None]
                     + torch.arange(s, device=dev)[None])       # (K, S)
    tokens_flat = torch.cat([dec_tokens, pre_tokens.reshape(-1)])
    positions_flat = torch.cat([dec_positions.long(),
                                pre_positions.reshape(-1)])     # (T,)
    x = M.embed(params, cfg, tokens_flat[None])                 # (1, T, d)
    dec_lengths = torch.where(dec_active, dec_positions + 1, 0).to(
        torch.int32)
    # the rows whose K/V are written: active decode rows, then the valid
    # rows of each chunk.  Block tables are read for those rows only:
    # a padding row's position may lie past the table's width.
    in_range = torch.arange(s, device=dev)[None] < pre_chunk[:, None]
    dec_rows = torch.nonzero(dec_active).squeeze(1)
    pre_rows = torch.nonzero(in_range.reshape(-1)).squeeze(1)
    dec_pos = positions_flat[dec_rows]
    pre_pos = pre_positions.reshape(-1)[pre_rows]
    rows = torch.cat([dec_rows, b + pre_rows])
    pidx = torch.cat([dec_block_tables[dec_rows, dec_pos // page_size],
                      pre_block_tables[pre_rows // s, pre_pos // page_size]
                      ]).long()
    slot = torch.cat([dec_pos, pre_pos]) % page_size

    for i, p_l in enumerate(_layer_params(params, cfg)):
        h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        q, k, v = layers.attn_qkv(p_l["attn"], cfg, h, positions_flat[None])
        _write_kv(pool, i, pidx, slot, rows, k[0], v[0])
        o_dec = kops.paged_attention(q[0, :b], pool.k[i], pool.v[i],
                                     dec_block_tables, dec_lengths,
                                     impl=impl)                 # (B, H, D)
        o_pre = kops.paged_prefill(q[0, b:].reshape(kk, s, h_, hd),
                                   pool.k[i], pool.v[i], pre_block_tables,
                                   pre_ctx, pre_chunk, impl=impl)
        o = torch.cat([o_dec, o_pre.reshape(kk * s, h_, hd)])[None]
        x = _ffn(p_l, cfg, x + layers.attn_out(p_l["attn"], o))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    # only unembed the rows that produce tokens: every decode row plus
    # each chunk's last valid row
    sel = torch.cat([torch.arange(b, device=dev),
                     b + torch.arange(kk, device=dev) * s
                     + torch.clamp(pre_chunk.long() - 1, min=0)])
    logits = M.unembed(params, cfg, x[0, sel][None])[0]         # (B+K, V)
    return logits[:b], logits[b:], pool
