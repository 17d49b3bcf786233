"""The program's step trace as the benchmark reads it: a tiny engine
driven through the harness records every step's spans in order and the
counters the harness's own records imply; the idle readers on a made-up
device trace with known gaps add up to ``device_idle_pct``; and every
reader reads nothing once the ring has dropped part of its window, or
where the program keeps no trace."""
import sys

import pytest

from servebench import harness, program_trace
from servebench.tracing import TraceSummary

torch = pytest.importorskip("torch")
T = pytest.importorskip("repro_torch.engine.trace")

NEW = ("useful_row_pct", "host_syncs_per_step", "idle_in_prep_pct",
       "idle_in_launch_pct", "idle_in_sample_pct")
COPIES = {"mixed": 10, "decode": 5, "prefill": 3}  # the runner's _dev calls


@pytest.fixture(scope="module")
def driven():
    from servebench import program, weights
    from servebench import test_servebench_faults as faults
    torch.set_num_threads(1)
    cfg, mix = faults.tiny()
    engine = program.build(cfg, weights.make(cfg, 11, "cpu"), "cpu")
    program.warm_up(engine, cfg)
    run = harness.offer(engine, cfg, mix, 2 ** 31 + 5, 2.0, program)
    steps = [s for s in engine.trace.spans if s[0] == T.STEP]
    # the harness recorded the last len(run.steps) of the engine's steps
    return engine, run, steps[len(steps) - len(run.steps):]


def test_each_step_records_its_spans_in_order(driven):
    engine, run, steps = driven
    spans = list(engine.trace.spans)
    executed = [(rec, st) for rec, st in zip(run.steps, steps)
                if rec.mode != "idle"]
    assert len(executed) > 20
    for rec, st in executed:
        mine = sorted((s for s in spans if s[1] == st[1]),
                      key=lambda s: (s[3], -s[4]))
        names = [s[0] for s in mine]
        assert names[:4] == [T.STEP, T.SCHEDULE, T.INPUTS, T.FORWARD], names
        forward_end = mine[3][4]
        rest = mine[4:]
        assert all(s[3] >= forward_end for s in rest)
        assert rest[-1][0] == T.UPDATE
        # one sampling call, each with its readback, per emitting row
        # group: the decode rows, and each prefill that completes
        emitting = bool(rec.dec_lens) + sum(
            1 for s, c, p in rec.chunks if c > 0 and s + c == p)
        assert names.count(T.SAMPLE) == names.count(T.READBACK) == emitting
        assert set(names) == ({T.STEP, T.SCHEDULE, T.INPUTS, T.FORWARD,
                               T.UPDATE}
                              | ({T.SAMPLE, T.READBACK} if emitting
                                 else set()))
        for s in mine:
            if s[0] == T.READBACK:
                assert s[2] == T.SAMPLE
            elif s[0] != T.STEP:
                assert s[2] == T.STEP


def test_counters_match_what_the_harness_saw(driven):
    _, run, steps = driven
    modes = set()
    for rec, st in zip(run.steps, steps):
        real, padded, syncs = st[5:8]
        assert (real, padded) == (rec.real_tokens, rec.padded_rows)
        if rec.mode == "idle":
            assert syncs == 0
            continue
        modes.add(rec.mode)
        completing = sum(1 for s, c, p in rec.chunks
                         if c > 0 and s + c == p)
        assert syncs == (COPIES[rec.mode] + bool(rec.dec_lens)
                         + completing), rec
    assert {"mixed", "decode"} <= modes
    read = {n: harness.reader(n)(run) for n in NEW[:2]}
    assert read["useful_row_pct"] == pytest.approx(
        harness.reader("useful_token_pct")(run), abs=1e-9)
    assert 5 <= read["host_syncs_per_step"] <= 12


# ------------------------------------------------- a made-up device trace
OFF = 1000          # the wall clock runs 1000 ns ahead of the trace's


def made_up_trace():
    """Two steps on the trace clock, and counters for each."""
    tr = T.StepTrace()
    tr.wall_offset_ns = OFF
    for step, spans, counts in (
            (1, [(T.SCHEDULE, 5, 15), (T.INPUTS, 15, 30),
                 (T.FORWARD, 30, 60), (T.READBACK, 70, 85),
                 (T.SAMPLE, 60, 90), (T.UPDATE, 90, 98)], (30, 40, 11)),
            (2, [(T.SCHEDULE, 120, 125), (T.INPUTS, 125, 140),
                 (T.FORWARD, 140, 180), (T.READBACK, 182, 190),
                 (T.SAMPLE, 180, 195), (T.UPDATE, 195, 199)], (10, 40, 6))):
        for name, a, b in spans:
            parent = T.SAMPLE if name == T.READBACK else T.STEP
            tr.spans.append((name, step, parent, a, b))
        a, b = (0, 100) if step == 1 else (110, 200)
        tr.spans.append((T.STEP, step, None, a, b) + counts)
    return tr


def made_up_run():
    # busy on the wall clock: [1035, 1080] (two overlapping kernels) and
    # [1120, 1190], in a sub-window [1000, 1200]; idle 85 of 200 ns
    events = [("k", 1035, 1060), ("k2", 1050, 1080), ("k", 1120, 1190)]
    summary = TraceSummary(1000, 1200, 115e-9, events=events)
    return harness.Run({}, 1e-6, 0.0, 1e-6, [], [], trace=summary)


def test_idle_is_charged_to_the_innermost_span_by_overlap():
    tr = made_up_trace()
    run = made_up_run()
    idle = program_trace.idle_under(run)
    # [0, 35]: step 5, schedule 10, inputs 15, forward 5; [80, 120]:
    # readback 5, sample 5, update 8, step 2, none 10, step 10;
    # [190, 200]: sample 5, update 4, step 1
    assert idle == {T.STEP: 18, T.SCHEDULE: 10, T.INPUTS: 15,
                    T.FORWARD: 5, T.READBACK: 5, T.SAMPLE: 10,
                    T.UPDATE: 12, None: 10}
    got = {n: harness.reader(n)(run) for n in NEW}
    assert got["idle_in_prep_pct"] == pytest.approx(12.5)
    assert got["idle_in_launch_pct"] == pytest.approx(2.5)
    assert got["idle_in_sample_pct"] == pytest.approx(13.5)
    total = harness.reader("device_idle_pct")(run)
    assert total == pytest.approx(42.5)
    outside = 100.0 * (idle[T.STEP] + idle[None]) / 200
    assert (got["idle_in_prep_pct"] + got["idle_in_launch_pct"]
            + got["idle_in_sample_pct"] + outside) == pytest.approx(total)
    assert got["useful_row_pct"] == pytest.approx(50.0)
    assert got["host_syncs_per_step"] == pytest.approx(8.5)
    del tr


def test_readers_read_nothing_once_the_ring_dropped_part_of_the_window():
    full = made_up_trace()
    tr = T.StepTrace(capacity=6)        # the newest: the one read
    tr.wall_offset_ns = OFF
    for s in full.spans:
        tr.spans.append(s)      # the first step's oldest spans fall out
    run = made_up_run()
    assert all(harness.reader(n)(run) is None for n in NEW)
    del full


def test_readers_read_nothing_where_the_program_keeps_no_trace(
        monkeypatch):
    tr = made_up_trace()
    run = made_up_run()
    assert harness.reader("idle_in_prep_pct")(run) is not None
    monkeypatch.delitem(sys.modules, program_trace.TRACE_MODULE)
    assert all(harness.reader(n)(run) is None for n in NEW)
    del tr
