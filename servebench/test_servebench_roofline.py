"""Operation and byte counts against hand-worked cases, and the readers
of the kernels' shares, the MFU and the padding on made-up runs."""

import pytest

from servebench import harness, roofline
from servebench.families import dense
from servebench.roofline import StepRecord
from servebench.tracing import TraceSummary

CFG = {"family": "dense", "hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2,
       "vocab_size": 10,
       "engine": {"page_size": 4, "dtype": "bfloat16", "max_batch": 4,
                  "max_prefills": 2}}


def test_linear_flops_per_token():
    # q 8x8, k and v 8x4 each, o 8x8, MLP 3 x 8x16: 576 multiply-adds a
    # layer, two layers, two operations each
    assert dense.token_flops(CFG) == 2 * 2 * 576


def test_chunk_pairs():
    assert roofline.chunk_pairs(0, 3) == 6          # 1 + 2 + 3
    assert roofline.chunk_pairs(5, 2) == 13         # 6 + 7


def test_paged_attention_cost():
    ops, nbytes = roofline.paged_attention_cost(CFG, [5, 3], page=4)
    assert ops == 4 * 8 * 4 * 2                     # 8 live keys, H 4, D 2
    # K and V: 8 keys x Hkv 2 x D 2 x 2 bytes x 2; q and out: 2 rows x
    # H 4 x D 2 x 2 bytes x 2; tables: 2 + 1 pages x 4; lengths 2 x 4
    assert nbytes == 128 + 64 + 12 + 8


def test_paged_prefill_cost():
    chunks = [(4, 3, 20), (0, 0, 9)]                # the second is idle
    ops, nbytes = roofline.paged_prefill_cost(CFG, chunks, page=4)
    assert ops == 4 * 4 * 2 * (3 * 4 + 6)
    # K and V: 7 keys x 2 x 2 x 2 bytes x 2; q and out: 3 rows x 4 x 2 x
    # 2 bytes x 2; table: 2 pages x 4; lengths 8
    assert nbytes == 112 + 96 + 8 + 8


def test_forward_flops_counts_real_tokens_only():
    step = StepRecord("mixed", dec_lens=[5, 3],
                      chunks=[(4, 3, 7), (0, 2, 9)], padded_rows=4 + 2 * 4)
    assert step.real_tokens == 7 and step.emitting_rows == 3
    per_token = dense.token_flops(CFG)
    keys = 8 + roofline.chunk_pairs(4, 3) + roofline.chunk_pairs(0, 2)
    assert roofline.forward_flops(CFG, step) == (
        7 * per_token + 4 * keys * 4 * 2 * 2 + 3 * 2 * 8 * 10)


def test_bound_is_the_larger_term():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(1, 3.35e12) == pytest.approx(1.0)


def made_up_run(first_step_launches=2):
    """Three steps; the traced sub-window holds the first two.  Launches
    of each kernel: 1 us each, at the steps' starts."""
    steps = [StepRecord("mixed", [5, 3], [(4, 3, 7)], 12, 1.0, 1.1,
                        100.0, 100.1),
             StepRecord("decode", [6, 4], [], 4, 1.1, 1.2, 100.1, 100.2),
             StepRecord("decode", [7], [], 4, 1.3, 1.4, 100.3, 100.4)]
    pa = "void (anonymous namespace)::paged_attention_kernel<bf16, 2>(x)"
    pp = "void (anonymous namespace)::paged_prefill_kernel_tc<64>(y)"
    at = [int(100.0e9) + 1000 + 10 * i
          for i in range(first_step_launches)] + [
        int(100.1e9) + 1000 + 10 * i for i in range(2)]
    events = ([(pa, a, a + 1000) for a in at]
              + [(pp, int(100.0e9) + 1000 + 10 * i,
                  int(100.0e9) + 3000 + 10 * i) for i in range(2)]
              + [("gemm", int(100.05e9), int(100.15e9))])
    trace = TraceSummary(int(99.9e9), int(100.35e9), 0.2,
                         {pa: 1e-6, pp: 4e-6, "gemm": 0.1}, {}, events)
    return harness.Run(CFG, 0.4, 1.0, 1.4, [], steps, trace=trace)


def test_roofline_share_over_the_traced_steps():
    run = made_up_run()
    assert [s.mode for s in run.trace_steps] == ["mixed", "decode"]
    least = 2 * sum(roofline.bound_s(*roofline.paged_attention_cost(
        CFG, lens, 4)) for lens in ([5, 3], [6, 4]))
    assert harness.reader("paged_attention_roofline_pct")(run) == \
        pytest.approx(100 * least / 4e-6)
    least = 2 * roofline.bound_s(*roofline.paged_prefill_cost(
        CFG, [(4, 3, 7)], 4))
    assert harness.reader("paged_prefill_roofline_pct")(run) == \
        pytest.approx(100 * least / 4e-6)


def test_launches_go_to_steps_in_order_when_none_is_missing():
    run = made_up_run()
    # the host's clock runs ahead of the trace's: every launch of the
    # second step starts inside the first step's span
    run.trace.events = [(n, a - int(0.1e9), b - int(0.1e9))
                        if a > int(100.09e9) else (n, a, b)
                        for n, a, b in run.trace.events]
    assert harness.reader("paged_attention_roofline_pct")(run) == \
        pytest.approx(harness.reader("paged_attention_roofline_pct")(
            made_up_run()))


def test_a_step_with_dropped_launches_is_left_out():
    run = made_up_run(first_step_launches=1)
    least = 2 * roofline.bound_s(*roofline.paged_attention_cost(
        CFG, [6, 4], 4))
    assert harness.reader("paged_attention_roofline_pct")(run) == \
        pytest.approx(100 * least / 2e-6)
    run = made_up_run(first_step_launches=0)
    run.trace.events = [e for e in run.trace.events
                        if "paged_attention" not in e[0]]
    assert harness.reader("paged_attention_roofline_pct")(run) is None


def test_padding_mfu_step_and_idle_readers():
    run = made_up_run()
    assert harness.reader("useful_token_pct")(run) == pytest.approx(
        100 * 8 / 20)
    assert harness.reader("step_ms")(run) == pytest.approx(400 / 3)
    flops = sum(roofline.forward_flops(CFG, s) for s in run.steps)
    assert harness.reader("mfu_pct")(run) == pytest.approx(
        100 * flops / (0.4 * roofline.PEAK_FLOPS))
    assert harness.reader("device_idle_pct")(run) == pytest.approx(
        100 * (1 - 0.2 / 0.45))


def test_breakdown_names_and_idle_labels():
    from servebench import tracing
    ev = [("void k1<int>(float*)", 0, 10), ("k2", 5, 20), ("k1<int>", 40, 50)]
    spans = [("InferenceEngine.step", 0, 60), ("ModelRunner.sample", 22, 38)]
    s = tracing.summarize(ev, spans, 0, 60)
    assert s.busy_s == pytest.approx(30e-9)
    assert s.idle_by_host == pytest.approx(
        {"ModelRunner.sample": 20e-9, "InferenceEngine.step": 10e-9})
    b = s.breakdown()
    assert b["device_ops"] == [["k1", pytest.approx(2e-8)],
                               ["k2", pytest.approx(1.5e-8)]]
    assert s.aligned_share == 1.0


def test_reader_of_every_metric_exists():
    bench = harness.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
