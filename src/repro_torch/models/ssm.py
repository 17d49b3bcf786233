"""Recurrent token mixers, the PyTorch counterpart of
``repro/models/ssm.py``: Mamba's selective SSM (Hymba's parallel head),
and xLSTM's mLSTM (matrix memory) and sLSTM (scalar memory) blocks.

All three expose a *sequence* form (a scan over time, for training and
prefill) and a *single-step* form (an O(1) state update, for decode).
The states double as these layers' "KV cache": they are constant-size.

The scans are plain torch: the reference's are ``lax.scan``s, not
Pallas kernels.  Each keeps the reference's arithmetic step for step:
the same float32 recurrent state, the same casts, ``softplus`` and
``log_sigmoid`` as ``jnp.logaddexp`` computes them.  Two rewrites keep
the values and save host launches:

* what a step computes elementwise from its own inputs alone (Mamba's
  decay ``exp(dt * A)`` and input ``(dt * x) B``, its readout's
  ``+ D * x``) is computed for a whole chunk at once, and each step
  keeps the work that needs the carried state: the update of ``h`` and
  the readout ``h . C``, one step's reduction at a time as in the
  reference;
* the reference pads a scan to a whole number of 128-step chunks and
  makes the padded steps exact no-ops (Mamba's carry dt = 0, sLSTM's
  are masked with ``valid``); here the last chunk is simply shorter.

Each 128-step chunk runs under ``torch.utils.checkpoint`` while autograd
records, the counterpart of ``jax.checkpoint(chunk_body)``: the backward
keeps only the states between chunks.

Inside a tensor-parallel step (``models.sharding``) x holds this rank's
rows; each layer gathers the batch shard's rows (a recurrence needs
them all) and runs on the reference's placements:

* Mamba: ``in_proj`` column-parallel over ``mlp``.  Its stored split is
  not a channel split (at model 4 ranks 0-1 hold ``x_in``, ranks 2-3
  ``z``), so ``sharding.split_halves`` moves the product's column
  blocks to their channels' ranks (an all-to-all of the activation; the
  weight stays).  The conv, ``dt_w``, ``dt_b``, ``A_log`` and ``D`` are
  the rank's channels'; ``x_proj`` gives partial sums of (B, S, r + 2N),
  all-reduced; ``out_proj`` is row-parallel.  The states ``h`` and
  ``conv`` have the axes ("batch", None, None), so a cache holds them
  whole on every model rank: each rank scans from its channels' slice
  and the new state is gathered over ``model`` when stored (B x di x N
  and B x 3 x di values a layer, against the cache's K/V or the
  weights), rather than split the state's layout from the reference's.
* mLSTM: ``up_proj`` the same way, ``down_proj`` row-parallel; where the
  heads divide the model axis each rank runs its heads (``wq/wk/wv``
  and the state over "heads"), the dense ``igate_w``/``fgate_w``
  contraction over the split channels is all-reduced, and ``out_norm``'s
  sum of squares too.  Where they do not (xlstm-1.3b's 4 heads at 16),
  the conv's outputs are gathered over ``model`` (activations) and every
  rank runs every head on its share of the matrix memory's value dim,
  as the rules split C ("mlp" on its last dim); the normed outputs are
  gathered back to the rank's channels for ``down_proj``.
* sLSTM: ``w_gates``, ``r_gates`` and ``b_gates`` over "heads": the
  recurrence is per head, so the scan needs no collective a step;
  ``out_norm``'s sum of squares is all-reduced and the heads' outputs
  go to their rows' ranks (``sharding.channels_to_rows``).

A layer whose weights the rules leave whole runs whole on the gathered
rows and keeps its own.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, sharding
from repro_torch.models.config import ModelConfig, SSMConfig, XLSTMConfig
from repro_torch.models.params import Spec

CHUNK = 128


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, without torch's linear
    cut above 20."""
    return torch.logaddexp(x, x.new_zeros(()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def _chunked(body, carry, seq_len: int, chunk: int, *inputs):
    """Run ``body(carry, start, stop, *inputs) -> (carry, ys)`` over
    ``[0, seq_len)`` in chunks of ``chunk`` steps, each under
    ``torch.utils.checkpoint`` while autograd records; returns the final
    carry and the chunks' ys concatenated along dim 1."""
    remat = layers.recording(carry, *inputs)
    ys = []
    for start in range(0, seq_len, chunk):
        stop = min(start + chunk, seq_len)
        if remat:
            out = checkpoint(body, carry, start, stop, *inputs,
                             use_reentrant=False)
        else:
            out = body(carry, start, stop, *inputs)
        carry, y = out
        ys.append(y)
    return carry, torch.cat(ys, dim=1)


def _causal_conv_seq(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, D); w: (CW, D) -> (B, S, D)."""
    cw = w.shape[0]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = b
    s = x.shape[1]
    for i in range(cw):
        out = out + pad[:, i:i + s] * w[i]
    return out


def _causal_conv_step(x: torch.Tensor, buf: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token conv.  x: (B, D); buf: (B, CW-1, D) previous inputs."""
    window = torch.cat([buf, x[:, None, :]], dim=1)            # (B, CW, D)
    out = torch.einsum("bcd,cd->bd", window, w) + b
    return out, window[:, 1:]


# ===================================================================== Mamba
def mamba_specs(cfg: ModelConfig) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    n = s.state_size
    r = s.dt_rank or max(1, math.ceil(d / 16))
    return {
        "in_proj": Spec((d, 2 * di), ("embed", "mlp"), "scaled", 0),
        "conv_w": Spec((s.conv_width, di), (None, "mlp"), "normal"),
        "conv_b": Spec((di,), ("mlp",), "zeros"),
        "x_proj": Spec((di, r + 2 * n), ("mlp", None), "scaled", 0),
        "dt_w": Spec((r, di), (None, "mlp"), "scaled", 0),
        "dt_b": Spec((di,), ("mlp",), "ones"),
        "A_log": Spec((di, n), ("mlp", None), "ones"),
        "D": Spec((di,), ("mlp",), "ones"),
        "out_proj": Spec((di, d), ("mlp", "embed"), "scaled", 0),
    }


def mamba_state_shape(cfg: ModelConfig, batch: int) -> dict:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {"conv": ((batch, s.conv_width - 1, di), ("batch", None, None)),
            "h": ((batch, di, s.state_size), ("batch", None, None))}


def _mamba_chunk(h, start, stop, x_c, dt, bmat, cmat, a, d_skip):
    """Steps [start, stop) of the selective scan from state ``h``
    (B, di, N) float32.  Per step: h = exp(dt A) h + (dt x) B and
    y = h . C + D x, y cast to x's dtype; the terms that need no state
    are computed for the whole chunk, the readout ``h . C`` one step at a
    time (one ``bmm``), as the reference reduces it."""
    sl = slice(start, stop)
    xt, dtt, bt = x_c[:, sl], dt[:, sl], bmat[:, sl]
    da = torch.exp(dtt.float()[..., None] * a)                # (B,T,di,N)
    dbx = (dtt * xt)[..., None] * bt[:, :, None, :]
    ct = cmat[:, sl, :, None].float().contiguous()            # (B,T,N,1)
    hc = []
    for t in range(stop - start):
        h = da[:, t] * h + dbx[:, t]
        hc.append(torch.bmm(h, ct[:, t]))                      # (B,di,1)
    y = torch.cat(hc, dim=-1).transpose(1, 2) + d_skip * xt
    return h, y.to(xt.dtype)


def _mamba_core(p, scfg, x_c, x_in, h0, chunk: int = CHUNK,
                partial: bool = False):
    """Selective-scan recurrence over x_c (B, S, di), chunked for
    sqrt-memory training.  Returns (y (B, S, di) in x_c's dtype, final
    state (B, di, N) float32).  ``partial``: x_c holds this rank's
    channels, so its ``x_proj`` product is a partial sum over ``model``,
    all-reduced."""
    n = scfg.state_size
    r = p["dt_w"].shape[0]
    s = x_c.shape[1]
    dbc = x_c @ p["x_proj"]
    if partial:
        dbc = sharding.sum_model(dbc)
    dt_r, bmat, cmat = dbc.split([r, n, n], dim=-1)
    dt = softplus(dt_r @ p["dt_w"] + p["dt_b"])
    a = -torch.exp(p["A_log"].float())                         # (di, N)
    h, ys = _chunked(_mamba_chunk, h0.float(), s, min(chunk, s), x_c, dt,
                     bmat, cmat, a, p["D"])
    return ys, h


def _mamba_in(p, x, di: int):
    """x @ in_proj split into (x_in, z), each this rank's channels (the
    conv's: all of them outside a tensor-parallel step)."""
    n = p["conv_w"].shape[-1]
    return sharding.split_halves(x @ p["in_proj"], n, di).chunk(2, dim=-1)


def _mamba_out(y, z, p, di: int):
    """The gated output through ``out_proj``: row-parallel where y holds
    this rank's channels (summed into its rows), else this rank's
    rows."""
    out = (y * F.silu(z)) @ p["out_proj"]
    if y.shape[-1] != di:
        return sharding.sum_model_rows(out)
    return sharding.own_rows(out)


def mamba_seq(p, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x: (B, S, d) -> (out, new_state).  The conv is seeded with the
    carried buffer (chunked prefill).  Inside a tensor-parallel step x
    holds this rank's rows and the scan runs over every row, on this
    rank's channels."""
    scfg = cfg.ssm
    di = scfg.expand * cfg.d_model
    x_in, z = _mamba_in(p, sharding.model_rows(x), di)
    n = x_in.shape[-1]
    cw = scfg.conv_width
    padded = torch.cat([sharding.model_slice(state["conv"], -1, n)
                        .to(x_in.dtype), x_in], dim=1)
    x_c = F.silu(_causal_conv_seq(padded, p["conv_w"], p["conv_b"])
                 [:, cw - 1:])
    y, h = _mamba_core(p, scfg, x_c, x_in,
                       sharding.model_slice(state["h"], 1, n),
                       partial=n != di)
    return _mamba_out(y, z, p, di), {"conv": padded[:, -(cw - 1):], "h": h}


def mamba_step(p, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x: (B, d) one token -> (out (B, d), new_state)."""
    scfg = cfg.ssm
    di = scfg.expand * cfg.d_model
    x_in, z = _mamba_in(p, x, di)
    n = x_in.shape[-1]
    xc, conv_buf = _causal_conv_step(
        x_in, sharding.model_slice(state["conv"], -1, n).to(x_in.dtype),
        p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    y, h = _mamba_core(p, scfg, xc[:, None], x_in[:, None],
                       sharding.model_slice(state["h"], 1, n),
                       partial=n != di)
    return _mamba_out(y[:, 0], z, p, di), {"conv": conv_buf, "h": h}


# ===================================================================== mLSTM
def mlstm_specs(cfg: ModelConfig) -> dict:
    xc: XLSTMConfig = cfg.xlstm
    d = cfg.d_model
    di = int(xc.mlstm_proj_factor * d)
    h = xc.num_heads
    return {
        "up_proj": Spec((d, 2 * di), ("embed", "mlp"), "scaled", 0),
        "conv_w": Spec((xc.conv_width, di), (None, "mlp"), "normal"),
        "conv_b": Spec((di,), ("mlp",), "zeros"),
        # block-diagonal per head: (H, dh, dh) instead of dense (di, di)
        "wq": Spec((h, di // h, di // h), ("heads", None, None),
                   "scaled", 1),
        "wk": Spec((h, di // h, di // h), ("heads", None, None),
                   "scaled", 1),
        "wv": Spec((h, di // h, di // h), ("heads", None, None),
                   "scaled", 1),
        "igate_w": Spec((di, h), (None, None), "scaled", 0),
        "igate_b": Spec((h,), (None,), "zeros"),
        "fgate_w": Spec((di, h), (None, None), "scaled", 0),
        "fgate_b": Spec((h,), (None,), "zeros"),
        "out_norm": layers.norm_spec(di),
        "down_proj": Spec((di, d), ("mlp", "embed"), "scaled", 0),
    }


def mlstm_state_shape(cfg: ModelConfig, batch: int) -> dict:
    xc = cfg.xlstm
    di = int(xc.mlstm_proj_factor * cfg.d_model)
    h = xc.num_heads
    dh = di // h
    return {
        "conv": ((batch, xc.conv_width - 1, di), ("batch", None, None)),
        # the matrix memory (B, H, dh, dh) is the big decode state
        "C": ((batch, h, dh, dh), ("batch", "heads", None, "mlp")),
        "n": ((batch, h, dh), ("batch", "heads", None)),
        "m": ((batch, h), ("batch", "heads")),
    }


def _mlstm_core(p, nheads, q, k, v, i_raw, f_raw, state):
    """q, k, v: (B, S, H, dh) float32; gates (B, S, H).  The recurrent
    form, one step at a time from ``state``'s C, n, m."""
    c_mat, n_vec, m = (state[k_].float() for k_ in ("C", "n", "m"))
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, it, ft = (x[:, t] for x in (q, k, v, i_raw, f_raw))
        f_log = log_sigmoid(ft)
        m_new = torch.maximum(f_log + m, it)
        i_sc = torch.exp(it - m_new)
        f_sc = torch.exp(f_log + m - m_new)
        c_mat = (f_sc[..., None, None] * c_mat
                 + i_sc[..., None, None] * kt[..., :, None] * vt[..., None, :])
        n_vec = f_sc[..., None] * n_vec + i_sc[..., None] * kt
        denom = torch.clamp(torch.einsum("bhd,bhd->bh", n_vec, qt).abs(),
                            min=1.0)
        hs.append(torch.einsum("bhd,bhdv->bhv", qt, c_mat)
                  / denom[..., None])
        m = m_new
    return torch.stack(hs, dim=1), {"C": c_mat, "n": n_vec, "m": m}


def mlstm_seq(p, cfg: ModelConfig, x: torch.Tensor, state: dict,
              parallel: bool = None):
    """Sequence mLSTM.  parallel=True (the default for S > 1) takes the
    quadratic gate-biased attention form (``layers.mlstm_parallel``):
    no per-step (dh x dh) matrix state kept for the backward.  The final
    recurrent state is then built in closed form so that decode can
    continue from a parallel prefill; the parallel form assumes a fresh
    (zero) initial C, n, m.  A single token takes the recurrent step.

    Inside a tensor-parallel step (see the module's docstring) x holds
    this rank's rows and the layer runs over every row: on this rank's
    heads where they split, else on every head with this rank's share of
    the matrix memory's value dim."""
    xc = cfg.xlstm
    b = x.shape[0]
    hn = xc.num_heads
    di = int(xc.mlstm_proj_factor * cfg.d_model)
    dh = di // hn
    if parallel is None:
        parallel = x.shape[1] > 1
    xg = sharding.model_rows(x)
    s = xg.shape[1]
    n = p["conv_w"].shape[-1]                  # this rank's channels
    x_in, z = sharding.split_halves(xg @ p["up_proj"], n, di).chunk(2, -1)
    cw = xc.conv_width
    padded = torch.cat([sharding.model_slice(state["conv"], -1, n)
                        .to(x_in.dtype), x_in], dim=1)
    x_c = F.silu(_causal_conv_seq(padded, p["conv_w"], p["conv_b"])
                 [:, cw - 1:])
    hl = p["wq"].shape[0]                      # this rank's heads
    x_inh = x_in
    if hl == hn and n != di:       # heads whole, channels split: gather
        x_c = sharding.gather_model(x_c, -1)
        x_inh = sharding.gather_model(x_in, -1)
    # the value dim of C this rank keeps: all of it, or (heads whole) its
    # share where it divides, as the rules split C's "mlp" dim
    vl, tp = dh, sharding.tp_size()
    if hl == hn and tp > 1 and dh % tp == 0:
        vl = dh // tp
    x_ch = x_c.reshape(b, s, hl, dh)
    q = torch.einsum("bshd,hde->bshe", x_ch, p["wq"])
    k = torch.einsum("bshd,hde->bshe", x_ch, p["wk"]) / math.sqrt(dh)
    v = torch.einsum("bshd,hde->bshe", x_inh.reshape(b, s, hl, dh),
                     sharding.model_slice(p["wv"], 2, vl))
    i_raw, f_raw = (x_inh @ sharding.model_slice(p[w], 0, x_inh.shape[-1])
                    for w in ("igate_w", "fgate_w"))
    if x_inh.shape[-1] != di:      # this rank's channels: partial sums
        i_raw, f_raw = sharding.sum_model(i_raw), sharding.sum_model(f_raw)
    i_raw = sharding.model_slice(i_raw + p["igate_b"], -1, hl).float()
    f_raw = sharding.model_slice(f_raw + p["fgate_b"] + 3.0, -1, hl).float()
    if parallel:
        f_log = log_sigmoid(f_raw)                             # (B,S,H)
        f_cum = torch.cumsum(f_log, dim=1)                     # F_t
        bias_q = f_cum
        bias_k = i_raw - f_cum                                 # i_s - F_s
        k32, v32 = k.float(), v.float()
        hs = layers.mlstm_parallel(q.float(), k32, v32, bias_q, bias_k)
        # closed-form final state for decode continuation
        f_total = f_cum[:, -1]                                 # F_S (B,H)
        log_w = f_total[:, None] - f_cum + i_raw               # F_S-F_s+i_s
        m_new = log_w.amax(dim=1)                              # (B,H)
        w = torch.exp(log_w - m_new[:, None])                  # (B,S,H)
        c_mat = torch.einsum("bsh,bshd,bshe->bhde", w, k32, v32)
        n_vec = torch.einsum("bsh,bshd->bhd", w, k32)
        new_core = {"C": c_mat, "n": n_vec, "m": m_new}
    else:
        st = {"C": sharding.model_slice(sharding.model_slice(
                  state["C"], 1, hl), 3, vl),
              "n": sharding.model_slice(state["n"], 1, hl),
              "m": sharding.model_slice(state["m"], 1, hl)}
        hs, new_core = _mlstm_core(p, hl, q.float(), k.float(), v.float(),
                                   i_raw, f_raw, st)
    y = hs.reshape(b, s, hl * vl).to(x.dtype)
    scale = p["out_norm"]
    if vl != dh:        # every head's share of the value dim
        lo = sharding.tp_rank() * vl
        y = layers.rms_norm(y, scale.reshape(hn, dh)[:, lo:lo + vl]
                            .reshape(-1), cfg.norm_eps, width=di)
        y = sharding.gather_model(y.reshape(b, s, hn, vl), -1)
        y = sharding.model_slice(y.reshape(b, s, di), -1, n)
    elif hl != hn:      # this rank's heads: its channels
        y = layers.rms_norm(y, sharding.model_slice(scale, 0, n),
                            cfg.norm_eps, width=di)
    else:
        y = sharding.model_slice(layers.rms_norm(y, scale, cfg.norm_eps),
                                 -1, n)
    out = (y * F.silu(z)) @ p["down_proj"]
    out = (sharding.sum_model_rows(out) if n != di
           else sharding.own_rows(out))
    new_core["conv"] = padded[:, -(cw - 1):]
    return out, new_core


def mlstm_step(p, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x: (B, d) one token -> (out (B, d), new_state), the recurrent
    form."""
    out, new_state = mlstm_seq(p, cfg, x[:, None, :], state, parallel=False)
    return out[:, 0], new_state


# ===================================================================== sLSTM
def slstm_specs(cfg: ModelConfig) -> dict:
    xc: XLSTMConfig = cfg.xlstm
    d = cfg.d_model
    h = xc.num_heads
    dh = d // h
    return {
        "w_gates": Spec((d, 4, h, dh), ("embed", None, "heads", None),
                        "scaled", 0),
        "r_gates": Spec((h, dh, 4, dh), ("heads", None, None, None),
                        "scaled", 1),
        "b_gates": Spec((4, h, dh), (None, "heads", None), "zeros"),
        "out_norm": layers.norm_spec(d),
    }


def slstm_state_shape(cfg: ModelConfig, batch: int) -> dict:
    h = cfg.xlstm.num_heads
    dh = cfg.d_model // h
    shp = ((batch, h, dh), ("batch", "heads", None))
    return {"c": shp, "n": shp, "m": shp, "h": shp}


def _slstm_chunk(carry, start, stop, wx, r_gates, b_gates):
    """Steps [start, stop) of the sLSTM recurrence.  carry: (c, n, m, h)
    float32 (B, H, dh); wx: (B, S, 4, H, dh) input contributions;
    r_gates: (H, dh, 4*dh) float32."""
    c, n, m, h_prev = carry
    nh, dh = h_prev.shape[1], h_prev.shape[2]
    hs = []
    for t in range(start, stop):
        # einsum("bhd,hdgk->bghk", h_prev, r_gates), one product per head
        rec = torch.bmm(h_prev.transpose(0, 1), r_gates)       # (H,B,4dh)
        rec = rec.reshape(nh, -1, 4, dh).permute(1, 2, 0, 3)   # (B,4,H,dh)
        pre = wx[:, t] + rec + b_gates                         # (B,4,H,dh)
        z_t = torch.tanh(pre[:, 0])
        i_t = pre[:, 1]
        f_t = log_sigmoid(pre[:, 2])
        o_t = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(f_t + m, i_t)
        i_sc = torch.exp(i_t - m_new)
        f_sc = torch.exp(f_t + m - m_new)
        c = f_sc * c + i_sc * z_t
        n = f_sc * n + i_sc
        h_prev = o_t * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h_prev)
    return (c, n, m, h_prev), torch.stack(hs, dim=1)


def _slstm_scan(p, cfg, wx, state, chunk: int = CHUNK):
    """wx: (B, S, 4, H, dh) input contributions; recurrent h feedback.
    Chunked with remat like the Mamba core.  Returns (hs (B, S, H, dh),
    final state)."""
    s = wx.shape[1]
    nh, dh = p["r_gates"].shape[0], p["r_gates"].shape[1]
    r_gates = p["r_gates"].float().reshape(nh, dh, 4 * dh)
    carry = tuple(state[k].float() for k in ("c", "n", "m", "h"))
    (c, n, m, h), hs = _chunked(_slstm_chunk, carry, s, min(chunk, s), wx,
                                r_gates, p["b_gates"])
    return hs, {"c": c, "n": n, "m": m, "h": h}


def slstm_seq(p, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x: (B, S, d) -> (out, new_state).  Inside a tensor-parallel step x
    holds this rank's rows and the scan runs over every row, on this
    rank's heads where they split (their normed channels then sent to
    the rows' ranks)."""
    xg = sharding.model_rows(x)
    b, s, d = xg.shape
    w = p["w_gates"].float()
    wx = (xg.float() @ w.reshape(d, -1)).reshape((b, s) + w.shape[1:])
    hl = w.shape[2]
    hs, new_state = _slstm_scan(p, cfg, wx, {
        k: sharding.model_slice(state[k], 1, hl) for k in ("c", "n", "m",
                                                            "h")})
    y = hs.reshape(b, s, -1).to(x.dtype)
    if hl != cfg.xlstm.num_heads:
        y = layers.rms_norm(y, sharding.model_slice(
            p["out_norm"], 0, y.shape[-1]), cfg.norm_eps, width=d)
        return sharding.channels_to_rows(y), new_state
    return (sharding.own_rows(layers.rms_norm(y, p["out_norm"],
                                              cfg.norm_eps)), new_state)


def slstm_step(p, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x: (B, d) one token -> (out (B, d), new_state)."""
    out, new_state = slstm_seq(p, cfg, x[:, None, :], state)
    return out[:, 0], new_state
