"""A family beyond the dense one enters through its own module alone.

The families here are made up for the tests and live in ``sys.modules``
under ``servebench.families.<name>``, not in ``families/``:

- ``tiny_moe`` states ``moe`` as plain data; ``program.model_config``
  builds the port's ``MoEConfig``, its weights are the port's layout,
  its plain reference agrees with the port's plain forward pass, and a
  tiny MoE engine on the CPU serves greedy requests on them to the end;
- ``tiny_window`` declares a kernel that launches on 3 of its 4 layers,
  replaces the default ``paged_attention`` entry's cost, and counts its
  attention row by row with a window on some layers.
"""
import copy
import sys
import types

import pytest
import torch

from servebench import harness, kernel_share, roofline, weights
from servebench.families import dense
from servebench.roofline import StepRecord, chunk_pairs
from servebench.test_servebench_roofline import CFG, made_up_run

pytest.importorskip("repro_torch")

from servebench import program, reference  # noqa: E402


# ------------------------------------------------------- tiny_moe family
def moe_leaves(cfg):
    d, h, hkv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                     cfg["num_key_value_heads"], cfg["head_dim"])
    n, v = cfg["num_hidden_layers"], cfg["vocab_size"]
    e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    fs = f * cfg["n_shared_experts"]
    return [("embedding", (v, d), 1.0),
            ("run_0/ln1", (n, d), 0.1),
            ("run_0/attn/wq", (n, d, h, hd), d ** -0.5),
            ("run_0/attn/wk", (n, d, hkv, hd), d ** -0.5),
            ("run_0/attn/wv", (n, d, hkv, hd), d ** -0.5),
            ("run_0/attn/wo", (n, h, hd, d), (h * hd) ** -0.5),
            ("run_0/ln2", (n, d), 0.1),
            ("run_0/moe/router", (n, d, e), 4 * d ** -0.5),
            ("run_0/moe/experts/w_gate", (n, e, d, f), d ** -0.5),
            ("run_0/moe/experts/w_in", (n, e, d, f), d ** -0.5),
            ("run_0/moe/experts/w_out", (n, e, f, d), f ** -0.5),
            ("run_0/moe/shared/w_gate", (n, d, fs), d ** -0.5),
            ("run_0/moe/shared/w_in", (n, d, fs), d ** -0.5),
            ("run_0/moe/shared/w_out", (n, fs, d), fs ** -0.5),
            ("final_norm", (d,), 0.1),
            ("lm_head", (d, v), d ** -0.5)]


def moe_port_config(cfg):
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    return dict(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"], rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=False, norm_eps=float(cfg["rms_norm_eps"]),
        layer_pattern=["moe"] * cfg["num_hidden_layers"],
        moe={"num_experts": e, "top_k": k,
             "d_expert": cfg["moe_intermediate_size"],
             "num_shared_experts": cfg["n_shared_experts"],
             "d_shared_expert": cfg["moe_intermediate_size"],
             "capacity_factor": e / k},          # dropless
        max_seq_len=cfg["max_position_embeddings"], source=cfg["source"])


class MoEReference(reference.Reference):
    """Attention as the dense family's; the FFN routed top-k over the
    softmax of the router's logits, the gates renormalized, plus the
    shared expert."""

    def _mlp(self, x, p):
        gate = torch.nn.functional.silu(self._linear(x, p["w_gate"]))
        return self._linear(gate * self._linear(x, p["w_in"]), p["w_out"])

    def layer(self, x, l, sin, cos):
        run, k = self.w["run_0"], self.cfg["num_experts_per_tok"]
        h = self._rms(x, run["ln1"][l])
        x = x + _dense_attention(self, h, l, sin, cos)
        h = self._rms(x, run["ln2"][l])
        m = run["moe"]
        probs = torch.softmax(self._linear(h, m["router"][l]), dim=-1)
        gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, ids = gate[:, :k], ids[:, :k]
        gate = gate / gate.sum(-1, keepdim=True)
        out = self._mlp(h, {w: m["shared"][w][l] for w in m["shared"]})
        for e in range(self.cfg["num_experts"]):
            rows, slot = (ids == e).nonzero(as_tuple=True)
            if len(rows):
                ex = {w: m["experts"][w][l][e] for w in m["experts"]}
                out[rows] += gate[rows, slot, None] * self._mlp(h[rows], ex)
        return x + out


def _dense_attention(self, y, l, sin, cos):
    """The dense family's attention sublayer over normed rows ``y``."""
    cfg, a = self.cfg, self.w["run_0"]["attn"]
    n, d = y.shape
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    q = self._linear(y, a["wq"][l].reshape(d, h * hd)).view(n, h, hd)
    k = self._linear(y, a["wk"][l].reshape(d, hkv * hd)).view(n, hkv, hd)
    v = self._linear(y, a["wv"][l].reshape(d, hkv * hd)).view(n, hkv, hd)
    q, k = self._rope(q, sin, cos), self._rope(k, sin, cos)
    o = self._attend(q, k, v).reshape(n, h * hd)
    return self._linear(o, a["wo"][l].reshape(h * hd, d))


def moe_token_flops(cfg):
    d, h, hkv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                     cfg["num_key_value_heads"], cfg["head_dim"])
    f, k = cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    per_layer = (2 * d * h * hd + 2 * d * hkv * hd + d * cfg["num_experts"]
                 + 3 * d * f * (k + cfg["n_shared_experts"]))
    return 2 * per_layer * cfg["num_hidden_layers"]


def tiny_moe_module():
    mod = types.ModuleType("servebench.families.tiny_moe")
    mod.leaves, mod.port_config = moe_leaves, moe_port_config
    mod.token_flops, mod.attention_flops = moe_token_flops, \
        dense.attention_flops
    mod.Reference = MoEReference
    return mod


def tiny_moe_cfg():
    cfg = copy.deepcopy(harness.load_json(
        harness.ROOT / "configs" / "deepseek-coder-6.7b.json"))
    cfg.update(name="tiny-moe", family="tiny_moe", hidden_size=64,
               intermediate_size=96, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               vocab_size=300, max_position_embeddings=512,
               num_experts=4, num_experts_per_tok=2,
               moe_intermediate_size=32, n_shared_experts=1)
    cfg["engine"].update(chunk_size=32, max_prefills=2, max_batch=4,
                         max_pages_per_seq=32, num_pages=128)
    return cfg


@pytest.fixture
def tiny_moe(monkeypatch):
    monkeypatch.setitem(sys.modules, "servebench.families.tiny_moe",
                        tiny_moe_module())
    return tiny_moe_cfg()


def test_a_family_states_moe_as_plain_data(tiny_moe):
    from repro_torch.models.config import MOE, ModelConfig, MoEConfig
    mcfg = program.model_config(tiny_moe)
    assert isinstance(mcfg, ModelConfig) and isinstance(mcfg.moe, MoEConfig)
    assert (mcfg.moe.num_experts, mcfg.moe.top_k, mcfg.moe.d_expert) == (
        4, 2, 32)
    assert mcfg.layer_pattern == (MOE, MOE)


def test_the_families_weights_are_the_ports_moe_layout(tiny_moe):
    from repro_torch.models import model as M
    w = weights.make(tiny_moe, 2 ** 31 + 9, "cpu")
    specs = M.model_specs(program.model_config(tiny_moe))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)
    assert shapes(w) == shapes(specs)


def test_the_families_reference_matches_the_ports_plain_forward(tiny_moe):
    from repro_torch.models import model as M
    w = weights.make(tiny_moe, 2 ** 31 + 5, "cpu", torch.float32)
    tokens = torch.randint(0, tiny_moe["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(3))
    mcfg = program.model_config(tiny_moe)
    hidden, _, _ = M.forward(w, mcfg, tokens[None], impl="ref")
    want = M.unembed(w, mcfg, hidden)[0]
    got = reference.build(tiny_moe, w, q_block=16).logits(tokens.tolist(), 0)
    assert torch.allclose(got, want, atol=2e-5 * want.abs().max().item())


def test_a_tiny_moe_engine_serves_the_families_weights(tiny_moe):
    torch.set_num_threads(1)
    params = weights.make(tiny_moe, 2 ** 31 + 13, "cpu")
    engine = program.build(tiny_moe, params, "cpu")
    assert engine.params is params
    program.warm_up(engine, tiny_moe)
    reqs = [program.request([(5 * i + j) % 300 for j in range(n)], k)
            for i, (n, k) in enumerate([(9, 4), (45, 6), (70, 3)])]
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    assert all(program.is_finished(r) for r in reqs)
    assert [len(r.output_tokens) for r in reqs] == [4, 6, 3]


def test_the_harness_runs_a_cell_of_the_family(tiny_moe):
    from servebench import run as bench_run
    from servebench import test_servebench_faults as faults
    torch.set_num_threads(1)
    _, mix = faults.tiny()
    entries = [{"name": "ttft_p95_s", "unit": "s"},
               {"name": "mfu_pct", "unit": "%"}]
    out = bench_run.run(tiny_moe, mix, faults.CHECK, entries, 2 ** 31 + 21,
                        2.0, True, program, "cpu")
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ttft_p95_s", "mfu_pct"}
    assert 0 <= out["checks"]["logit_gap_max"]["value"] < float("inf")


@pytest.mark.parametrize("bad, named", [
    ({"moe": {"num_expert": 4}}, "num_expert"),       # a key MoEConfig lacks
    ({"rope": {"type": "linear"}}, "rope"),           # no such sub-config
    ({"moe": {"num_experts": 4, "extra": {}}}, "extra"),  # nested deeper
    ({"window": 128}, "window"),                      # ModelConfig lacks it
])
def test_an_unknown_key_raises_and_names_it(tiny_moe, bad, named):
    mod = sys.modules["servebench.families.tiny_moe"]
    mod.port_config = lambda c: {**moe_port_config(c), **bad}
    with pytest.raises(ValueError, match=named):
        program.model_config(tiny_moe)


def test_the_dense_family_maps_as_before():
    from repro_torch.models.config import ModelConfig
    cfg = harness.configuration(harness.benchmark(), "deepseek-coder-6.7b")
    assert program.model_config(cfg) == ModelConfig(**dense.port_config(cfg))


# ---------------------------------------------------- tiny_window family
WINDOW = 4
WINDOW_LAYERS = 3                  # of 4: the last layer attends fully


def window_attention_flops(cfg, step):
    """Keys counted row by row: a window layer sees at most ``WINDOW``."""
    full = sum(step.dec_lens) + sum(chunk_pairs(s, c)
                                    for s, c, _ in step.chunks)
    near = sum(min(n, WINDOW) for n in step.dec_lens) + sum(
        min(i + 1, WINDOW) for s, c, _ in step.chunks
        for i in range(s, s + c))
    per_key = 4 * cfg["num_attention_heads"] * cfg["head_dim"]
    return per_key * (WINDOW_LAYERS * near
                      + (cfg["num_hidden_layers"] - WINDOW_LAYERS) * full)


def expert_least_s(cfg, step, page, esize):
    """Three launches a step, each reading 1000 bytes a real token."""
    return WINDOW_LAYERS * roofline.bound_s(0, 1000 * step.real_tokens)


def attention_least_s(cfg, step, page, esize):
    return 4 * roofline.bound_s(0, 7 * sum(step.dec_lens))


def tiny_window_module():
    mod = types.ModuleType("servebench.families.tiny_window")
    mod.token_flops = dense.token_flops
    mod.attention_flops = window_attention_flops
    mod.KERNELS = {
        "window_expert": kernel_share.Kernel(
            "window_expert_kernel", ("mixed", "decode"),
            lambda cfg: WINDOW_LAYERS, expert_least_s),
        "paged_attention": kernel_share.Kernel(
            "paged_attention_kernel", ("mixed", "decode"),
            lambda cfg: cfg["num_hidden_layers"], attention_least_s),
    }
    return mod


@pytest.fixture
def window_run(monkeypatch):
    """``made_up_run`` on four layers of the ``tiny_window`` family, with
    ``window_expert`` launched 3 times in its first step and 4 times in
    its second (1 us each) and 4 ``paged_attention`` launches a step."""
    monkeypatch.setitem(sys.modules, "servebench.families.tiny_window",
                        tiny_window_module())
    run = made_up_run()
    run.cfg = dict(CFG, family="tiny_window", num_hidden_layers=4)
    base = [int(100.0e9) + 1000, int(100.1e9) + 1000]
    pa = "void paged_attention_kernel<bf16, 2>(x)"
    ex = "void window_expert_kernel<64>(z)"
    run.trace.events = (
        [(pa, b + 10 * i, b + 10 * i + 1000) for b in base for i in range(4)]
        + [(ex, base[0] + 10 * i, base[0] + 10 * i + 1000)
           for i in range(3)]
        + [(ex, base[1] + 10 * i, base[1] + 10 * i + 1000)
           for i in range(4)])
    return run


def test_a_kernel_on_3_of_4_layers_reads_the_steps_with_3(window_run):
    assert kernel_share.kernels(window_run.cfg)["window_expert"].launches(
        window_run.cfg) == 3
    assert [len(x) for _, x in kernel_share.step_launches(
        window_run, "window_expert")] == [3, 4]
    first = window_run.trace_steps[0]         # the second is left out
    assert kernel_share.roofline_pct(window_run, "window_expert") == \
        pytest.approx(100 * expert_least_s(window_run.cfg, first, 4, 2)
                      / 3e-6)


def test_a_family_entry_replaces_the_default_cost(window_run):
    want = sum(attention_least_s(window_run.cfg, s, 4, 2)
               for s in window_run.trace_steps)
    assert harness.reader("paged_attention_roofline_pct")(window_run) == \
        pytest.approx(100 * want / 8e-6)
    assert "paged_prefill" in kernel_share.kernels(window_run.cfg)


def test_a_family_counts_its_attention_row_by_row(window_run):
    step = StepRecord("mixed", dec_lens=[5, 3], chunks=[(4, 3, 7)])
    cfg = window_run.cfg
    near = (4 + 3) + (4 + 4 + 4)               # min(n, 4); rows 5, 6, 7
    full = 8 + chunk_pairs(4, 3)
    want = 4 * 4 * 2 * (3 * near + 1 * full)
    assert window_attention_flops(cfg, step) == want
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    assert roofline.forward_flops(cfg, step) == (
        step.real_tokens * dense.token_flops(cfg) + want
        + step.emitting_rows * head)


def test_dense_attention_flops_from_the_step_count_as_before():
    steps = made_up_run().steps + [StepRecord(
        "mixed", dec_lens=[5, 3], chunks=[(4, 3, 7), (0, 2, 9)])]
    for step in steps:
        keys = sum(step.dec_lens) + sum(chunk_pairs(s, c)
                                        for s, c, _ in step.chunks)
        assert dense.attention_flops(CFG, step) == 4 * keys * 4 * 2 * 2
