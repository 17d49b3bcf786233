"""The engine's step trace: the trace alone (nesting, self time, the ring
wrapping, the clock offset, the registry), and every path of
``InferenceEngine.step`` recording its spans and counters, with the
engine's step wall and the runner's device wait read from them."""
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                Request, SamplingParams)
from repro_torch.engine import trace as T  # noqa: E402

torch.set_num_threads(1)

ECFG = dict(num_pages=128, max_batch=4, max_pages_per_seq=16,
            chunk_size=16)


class Ticks:
    """A clock that advances by ``dt`` ns each read."""

    def __init__(self, start=1000, dt=10):
        self.t, self.dt = start, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def test_spans_nest_under_their_parent_and_step():
    tr = T.StepTrace(clock=Ticks())
    s = tr.begin_step()
    a = tr.begin(T.SAMPLE)
    b = tr.begin(T.READBACK)         # a readback counts as a host sync
    tr.end(b)
    tr.end(a)
    tr.rows_real, tr.rows_padded = 3, 8
    tr.end_step(s)
    got = [x[:3] for x in tr.spans]
    assert got == [(T.READBACK, 1, T.SAMPLE), (T.SAMPLE, 1, T.STEP),
                   (T.STEP, 1, None)]
    assert tr.spans[-1][5:] == (3, 8, 1)
    # bounds nest: each child inside its parent
    rb, sa, st = tr.spans
    assert st[3] < sa[3] < rb[3] < rb[4] < sa[4] < st[4]
    assert tr.wait_ns == rb[4] - rb[3]
    assert tr.step_ns == st[4] - st[3]
    # the next step starts its counters at 0 under a new id
    s = tr.begin_step()
    tr.end_step(s)
    assert tr.spans[-1][1] == 2 and tr.spans[-1][5:] == (0, 0, 0)


def test_self_time_is_duration_less_children():
    spans = [(T.READBACK, 1, T.SAMPLE, 30, 50),
             (T.SAMPLE, 1, T.STEP, 20, 60),
             (T.FORWARD, 1, T.STEP, 5, 15),
             (T.STEP, 1, None, 0, 100, 0, 0, 0),
             (T.STEP, 2, None, 200, 250, 0, 0, 0)]
    assert T.self_ns(spans) == {T.READBACK: 20, T.SAMPLE: 20,
                                T.FORWARD: 10, T.STEP: 100 - 40 - 10 + 50}


def test_an_exception_drops_the_open_spans_not_the_step():
    tr = T.StepTrace(clock=Ticks())
    s = tr.begin_step()
    tr.begin(T.FORWARD)             # never closed: the call raised
    tr.end_step(s)
    s = tr.begin_step()
    a = tr.begin(T.SCHEDULE)
    tr.end(a)
    tr.end_step(s)
    assert [x[:3] for x in tr.spans] == [(T.STEP, 1, None),
                                        (T.SCHEDULE, 2, T.STEP),
                                        (T.STEP, 2, None)]


def test_the_ring_wraps_and_says_what_it_no_longer_holds():
    tr = T.StepTrace(capacity=8, clock=Ticks(dt=10))
    for _ in range(6):
        s = tr.begin_step()
        a = tr.begin(T.FORWARD)
        tr.end(a)
        tr.end_step(s)
    assert len(tr.spans) == 8
    oldest = tr.spans[0]
    assert oldest[:2] == (T.FORWARD, 3)
    # every span that ends at or after the oldest's end may be missing a
    # dropped neighbour only before it: windows from past it are whole
    assert tr.window(oldest[4], 10 ** 9) is None
    assert tr.steps(oldest[4], 10 ** 9) is None
    later = tr.spans[1][4] + 1
    assert [s[1] for s in tr.steps(later, 10 ** 9)] == [4, 5, 6]
    assert all(s[4] >= later for s in tr.window(later, 10 ** 9))
    # totals outlive the ring
    assert tr.step_ns == 6 * 30


def test_the_wall_offset_takes_the_tightest_pair():
    reads = iter([100, 180,        # 80 ns apart
                  300, 310,        # 10 ns apart: this pair
                  500, 540])
    walls = iter([10_000, 10_305, 10_520])
    off = T.wall_offset_ns(clock=lambda: next(reads),
                           wall=lambda: next(walls), reads=3)
    assert off == 10_305 - 305
    real = T.StepTrace()
    import time
    assert abs(time.monotonic_ns() + real.wall_offset_ns
               - time.time_ns()) < 50_000_000


def test_the_registry_holds_traces_weakly_and_returns_the_newest():
    a = T.StepTrace()
    b = T.StepTrace()
    assert T.newest() is b
    del b
    gc.collect()
    assert T.newest() is a


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def cfg():
    return get_reduced_config("qwen3-0.6b")


def serve(cfg, prompts, max_new=5, **kw):
    eng = InferenceEngine(cfg, EngineConfig(**ECFG, **kw), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(request_id=f"r{i}", prompt_tokens=list(p),
                           sampling=SamplingParams(max_new_tokens=max_new,
                                                   seed=i)))
    eng.run_until_idle()
    return eng


PROMPTS = [[5, 6, 7, 8] * 6, list(range(3, 43)), [9, 9, 3, 9, 9, 3, 9, 9]]
PATHS = {"mixed": {}, "two_phase": dict(mixed_batching=False),
         "spec": dict(spec_tokens=3), "async": dict(async_loop=True)}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_path_of_step_records_the_same_spans(cfg, path):
    eng = serve(cfg, PROMPTS, **PATHS[path])
    spans = list(eng.trace.spans)
    steps = [s for s in spans if s[0] == T.STEP]
    assert steps and len(steps) == eng.trace.step
    names = {s[0] for s in spans}
    assert names == {T.STEP, T.SCHEDULE, T.INPUTS, T.FORWARD, T.SAMPLE,
                     T.READBACK, T.UPDATE}
    bounds = {s[1]: (s[3], s[4]) for s in steps}
    for s in spans:
        if s[0] == T.STEP:
            continue
        parent = T.SAMPLE if s[0] == T.READBACK else T.STEP
        a, b = bounds[s[1]]
        if not a <= s[3] <= s[4] <= b:
            # only the async loop's drain runs after its last step
            assert path == "async" and s[3] > b, s
            parent = T.SAMPLE if s[0] == T.READBACK else None
        assert s[2] == parent, s
    executed = [s for s in steps if s[6] > 0]
    assert executed and all(0 < s[5] <= s[6] for s in executed)
    # every sync step waits for the device; an async dispatch need not
    assert all(s[7] >= 1 for s in executed) or path == "async"
    # the engine's accounting is the spans'
    assert eng.runner.device_wait_s == pytest.approx(sum(
        s[4] - s[3] for s in spans if s[0] == T.READBACK) / 1e9)
    assert eng.step_wall_s == pytest.approx(sum(
        s[4] - s[3] for s in steps) / 1e9)
    m = eng.metrics()
    assert m.device_wait_s == eng.runner.device_wait_s
    assert m.host_overhead_frac == pytest.approx(
        1.0 - eng.runner.device_wait_s / eng.step_wall_s)


def test_the_runner_shares_the_engines_trace(cfg):
    eng = InferenceEngine(cfg, EngineConfig(**ECFG), device="cpu")
    assert eng.runner.trace is eng.trace
    assert T.newest() is eng.trace
