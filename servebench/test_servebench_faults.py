"""The harness's comparison catches a broken timed path.

Each test drives the rest of a run on the CPU (the harness's look for a
card skipped) on a tiny configuration, with the program's timed path
broken underneath, and sees ``correct`` come out false: a token altered
where it is produced, a step that leaves the KV pages unchanged, half
of the batch left out.  The sound run beside them comes out true.  (A
one-card cell has no exchange between chips to leave out.)
"""
import copy

import pytest
import torch

pytest.importorskip("repro_torch")

from servebench import harness, program  # noqa: E402
from servebench import run as bench_run  # noqa: E402

SEED = 2 ** 31 + 77
CHECK = {"sample_served_tokens": 64, "logit_gap_max": 0.04}


def tiny():
    cfg = copy.deepcopy(harness.load_json(
        harness.ROOT / "configs" / "deepseek-coder-6.7b.json"))
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               vocab_size=512, max_position_embeddings=1024,
               attention_bias=True)
    cfg["engine"].update(chunk_size=32, max_prefills=2, max_batch=4,
                         max_pages_per_seq=32, num_pages=256)
    mix = copy.deepcopy(harness.mix("code"))
    mix.update(arrivals={"rate_per_s": 8.0},
               preroll_s=0.5,
               prompt_tokens={"dist": "lognormal", "median": 40,
                              "sigma": 0.6, "min": 8, "max": 200},
               output_tokens={"dist": "lognormal", "median": 6,
                              "sigma": 0.5, "min": 2, "max": 16})
    return cfg, mix


def run_tiny():
    torch.set_num_threads(1)
    cfg, mix = tiny()
    entries = [{"name": "ttft_p95_s", "unit": "s"},
               {"name": "useful_token_pct", "unit": "%"}]
    out = bench_run.run(cfg, mix, CHECK, entries, SEED, 2.0, True, program,
                        "cpu")
    assert out["attempted"] > 0 and "ttft_p95_s" in out["metrics"]
    return out


def test_a_sound_run_is_correct():
    out = run_tiny()
    assert out["correct"], out["checks"]


def test_an_altered_token_is_caught(monkeypatch):
    from repro_torch.engine.runner import ModelRunner
    orig = ModelRunner.sample

    def altered(self, logits, reqs, positions=None):
        toks = orig(self, logits, reqs, positions)
        toks[0] = (toks[0] + 1) % logits.shape[-1]
        return toks
    monkeypatch.setattr(ModelRunner, "sample", altered)
    assert not run_tiny()["correct"]


def test_a_step_that_leaves_the_pages_unchanged_is_caught(monkeypatch):
    from repro_torch.engine import paged_model
    monkeypatch.setattr(paged_model, "_write_kv", lambda *a, **k: None)
    assert not run_tiny()["correct"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.kernels import ops
    for name in ("paged_attention", "paged_prefill"):
        orig = getattr(ops, name)

        def half(q, *args, _orig=orig, **kw):
            out = _orig(q, *args, **kw).clone()
            out[q.shape[0] // 2:] = 0
            return out
        monkeypatch.setattr(ops, name, half)
    assert not run_tiny()["correct"]
