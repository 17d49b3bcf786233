"""The plain reference against the port's plain forward pass, on a tiny
configuration on the CPU, in float32; and the comparison's pieces."""
import copy

import pytest
import torch

from servebench import harness, judge, reference, weights
from servebench.reference import fp8_round

pytest.importorskip("repro_torch")


def tiny(bias: bool) -> dict:
    cfg = copy.deepcopy(harness.load_json(
        harness.ROOT / "configs" / "deepseek-coder-6.7b.json"))
    cfg.update(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2 if bias else 4,
               head_dim=16, vocab_size=300, max_position_embeddings=512,
               attention_bias=bias)
    return cfg


@pytest.mark.parametrize("bias", [True, False])
def test_reference_matches_the_ports_plain_forward(bias):
    from repro_torch.models import model as M

    from servebench import program
    cfg = tiny(bias)
    w = weights.make(cfg, 2 ** 31 + 5, "cpu", torch.float32)
    tokens = torch.randint(0, cfg["vocab_size"], (70,),
                           generator=torch.Generator().manual_seed(1))
    mcfg = program.model_config(cfg)
    hidden, _, _ = M.forward(w, mcfg, tokens[None], impl="ref")
    want = M.unembed(w, mcfg, hidden)[0]
    got = reference.build(cfg, w, q_block=16, row_block=32).logits(
        tokens.tolist(), 0)
    assert torch.allclose(got, want, atol=2e-5 * want.abs().max().item())
    tail = reference.build(cfg, w).logits(tokens.tolist(), 60)
    assert torch.allclose(tail, got[60:], atol=1e-5)


def test_fp8_round_keeps_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    y = fp8_round(x, -1)
    assert y[0, 0] == 1.0 and y[0, 2] == 448.0
    assert y[0, 1] == 1.0                   # 1 + 1/16 rounds to 1 (3 bits)
    assert abs(y[0, 3] + 3.25) < 1e-6


def test_gaps_and_the_sample():
    logits = torch.tensor([[0.0, 2.0, 1.0], [5.0, 4.0, 0.5]])
    assert judge.gaps(logits, [1, 2]).tolist() == [0.0, 4.5]
    done = [judge.Finished([1] * n, [2] * k)
            for n, k in [(5, 3), (50, 2), (7, 4), (9, 9), (3, 1)]]
    idx = judge.pick(done, 2 ** 32 + 3, 8)
    assert idx[0] == 1                      # the longest
    assert sum(len(done[i].served) for i in idx) >= 8
    assert idx == judge.pick(done, 2 ** 32 + 3, 8)
    assert judge.pick([], 1, 8) == []


def test_weights_are_the_ports_layout_and_repeat():
    from repro_torch.models import model as M

    from servebench import program
    cfg = tiny(True)
    w = weights.make(cfg, 11, "cpu")
    specs = M.model_specs(program.model_config(cfg))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)
    assert shapes(w) == shapes(specs)
    again = weights.make(cfg, 11, "cpu")
    assert torch.equal(w["run_0"]["mlp"]["w_in"], again["run_0"]["mlp"]["w_in"])


def test_the_family_is_found_by_name():
    from servebench.families import dense, family
    cfg = tiny(False)
    assert family(cfg) is dense
    assert isinstance(reference.build(cfg, {}), dense.Reference)
    assert [p for p, _, _ in weights.family(cfg).leaves(cfg)][:2] == [
        "embedding", "run_0/ln1"]
    with pytest.raises(ModuleNotFoundError):
        family(dict(cfg, family="no_such_family"))
