"""The dense decoder: RMSNorm, grouped-query attention with RoPE on split
halves over the whole head (optional QKV bias), a SwiGLU MLP and an
untied head; Llama's layout, and deepseek-coder's.

The port's layout (what ``InferenceEngine(params=)`` takes):
``embedding`` (V, d); ``run_0`` with every leaf stacked over the layers
(``ln1``, ``attn`` {``wq`` (L, d, H, D), ``wk``/``wv`` (L, d, Hkv, D),
``wo`` (L, H, D, d) and, with ``attention_bias``, ``bq``/``bk``/``bv``},
``ln2``, ``mlp`` {``w_gate``/``w_in`` (L, d, f), ``w_out`` (L, f, d)});
``final_norm`` (d); ``lm_head`` (d, V).  An RMSNorm weight is stored as
the port stores it: the norm multiplies by ``1 + scale``.

Scales of the random weights: projections 1/sqrt(fan-in), so activations
keep unit size through the depth; the embedding unit normal; norm
scales 0.1 and biases 0.2 of a unit normal, so that both matter.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from servebench import reference
from servebench.roofline import StepRecord, chunk_pairs


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every weight, in the order they are drawn."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    n, v = cfg["num_hidden_layers"], cfg["vocab_size"]
    out = [("embedding", (v, d), 1.0),
           ("run_0/ln1", (n, d), 0.1),
           ("run_0/attn/wq", (n, d, h, hd), d ** -0.5),
           ("run_0/attn/wk", (n, d, hkv, hd), d ** -0.5),
           ("run_0/attn/wv", (n, d, hkv, hd), d ** -0.5),
           ("run_0/attn/wo", (n, h, hd, d), (h * hd) ** -0.5)]
    if cfg["attention_bias"]:
        out += [("run_0/attn/bq", (n, h, hd), 0.2),
                ("run_0/attn/bk", (n, hkv, hd), 0.2),
                ("run_0/attn/bv", (n, hkv, hd), 0.2)]
    out += [("run_0/ln2", (n, d), 0.1),
            ("run_0/mlp/w_gate", (n, d, f), d ** -0.5),
            ("run_0/mlp/w_in", (n, d, f), d ** -0.5),
            ("run_0/mlp/w_out", (n, f, d), f ** -0.5),
            ("final_norm", (d,), 0.1),
            ("lm_head", (d, v), d ** -0.5)]
    return out


def port_config(cfg: dict) -> dict:
    """The port's ``ModelConfig`` of a configuration file's model."""
    if cfg.get("rope_scaling") or cfg.get("partial_rotary_factor", 1) != 1:
        raise ValueError(f"{cfg['name']}: the port rotates the whole head "
                         "without scaling")
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{cfg['name']}: the port's MLP here is SwiGLU")
    return dict(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"], qkv_bias=bool(cfg["attention_bias"]),
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        norm_eps=float(cfg["rms_norm_eps"]), act="silu",
        max_seq_len=cfg["max_position_embeddings"], source=cfg["source"])


def token_flops(cfg: dict) -> int:
    """Operations of one token through every layer's projections and
    MLP (2 per multiply-add)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    per_layer = d * h * hd * 2 + 2 * d * hkv * hd + 3 * d * f
    return 2 * per_layer * cfg["num_hidden_layers"]


def attention_flops(cfg: dict, step: StepRecord) -> int:
    """Operations of a step's query rows over their live (query, key)
    pairs in every layer (scores and the weighted sum of values): a
    decode row over its whole context, a chunk causally over its cached
    tokens and itself."""
    keys = sum(step.dec_lens) + sum(chunk_pairs(s, c)
                                    for s, c, _ in step.chunks)
    return (4 * keys * cfg["num_attention_heads"] * cfg["head_dim"]
            * cfg["num_hidden_layers"])


class Reference(reference.Reference):
    """The dense decoder's layer in plain PyTorch."""

    def _mlp(self, x: torch.Tensor, l: int) -> torch.Tensor:
        p = self.w["run_0"]["mlp"]
        out = torch.empty_like(x)
        for a in range(0, x.shape[0], self.row_block):
            xb = x[a:a + self.row_block]
            gate = F.silu(self._linear(xb, p["w_gate"][l]))
            out[a:a + self.row_block] = self._linear(
                gate * self._linear(xb, p["w_in"][l]), p["w_out"][l])
        return out

    def layer(self, x: torch.Tensor, l: int, sin, cos) -> torch.Tensor:
        cfg, run = self.cfg, self.w["run_0"]
        a = run["attn"]
        n, d = x.shape
        h, hkv, hd = (cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
        y = self._rms(x, run["ln1"][l])
        q = self._linear(y, a["wq"][l].reshape(d, h * hd)).view(n, h, hd)
        k = self._linear(y, a["wk"][l].reshape(d, hkv * hd)).view(n, hkv, hd)
        v = self._linear(y, a["wv"][l].reshape(d, hkv * hd)).view(n, hkv, hd)
        if cfg["attention_bias"]:
            q = q + a["bq"][l].float()
            k = k + a["bk"][l].float()
            v = v + a["bv"][l].float()
        q, k = self._rope(q, sin, cos), self._rope(k, sin, cos)
        if self.precision == "fp8":
            k, v = reference.fp8_round(k, -1), reference.fp8_round(v, -1)
        o = self._attend(q, k, v).reshape(n, h * hd)
        x = x + self._linear(o, a["wo"][l].reshape(h * hd, d))
        return x + self._mlp(self._rms(x, run["ln2"][l]), l)
