"""Traffic: a mix finds its generator by name; the stratified Poisson
generator's determinism per seed, the same work for every seed and the
length clips; the open-loop schedule's hand-out; and a closed loop, a
source that admits a request only once another has finished, driving
the engine through the harness."""
import numpy as np
import pytest

from servebench import harness, traffic

MIX = {"generator": "stratified_poisson",
       "arrivals": {"rate_per_s": 5.0},
       "prompt_tokens": {"dist": "lognormal", "median": 100, "sigma": 1.0,
                         "min": 16, "max": 400},
       "output_tokens": {"dist": "lognormal", "median": 8, "sigma": 0.8,
                         "min": 2, "max": 32},
       "preroll_s": 1.0}


def generate(mix, vocab, seed, seconds, rate_per_s=None):
    return traffic.source(mix, vocab, seed, seconds, rate_per_s).reqs


def shape(reqs):
    return [(r.due_s, len(r.prompt), r.max_new_tokens) for r in reqs]


def test_same_seed_same_requests():
    a = generate(MIX, 1000, 2 ** 31 + 11, 20.0)
    b = generate(MIX, 1000, 2 ** 31 + 11, 20.0)
    assert shape(a) == shape(b)
    assert [r.prompt for r in a] == [r.prompt for r in b]


def test_every_seed_gets_the_same_work_in_another_order():
    a = generate(MIX, 1000, 1, 20.0)
    b = generate(MIX, 1000, 2, 20.0)
    assert len(a) == len(b) == 5 + 100
    # the pre-roll's requests and the window's are each the same set
    for part in (lambda r: r.due_s < 1.0, lambda r: r.due_s >= 1.0):
        pa, pb = [r for r in a if part(r)], [r for r in b if part(r)]
        assert sorted(len(r.prompt) for r in pa) == sorted(
            len(r.prompt) for r in pb)
        assert sorted(r.max_new_tokens for r in pa) == sorted(
            r.max_new_tokens for r in pb)
    assert sum(1 for r in a if r.due_s < 1.0) == 5
    gaps = [np.diff([1.0] + [r.due_s for r in x[5:]]) for x in (a, b)]
    assert np.allclose(np.sort(gaps[0]), np.sort(gaps[1]))
    assert shape(a) != shape(b)
    assert a[-1].due_s == pytest.approx(b[-1].due_s)


def test_blocks_hold_one_of_each_band():
    import itertools
    order = traffic.blocked_order(95, 10, np.random.default_rng(3))
    assert sorted(order) == list(range(95))
    # 10 blocks; block b holds the ranks b, b + 10, ...: one of each band
    blocks = [list(g) for _, g in itertools.groupby(order, lambda r: r % 10)]
    assert len(blocks) == 10
    assert sorted(len(b) for b in blocks) == [9] * 5 + [10] * 5
    assert all(sorted(r // 10 for r in b) == list(range(len(b)))
               for b in blocks)
    reqs = generate(MIX, 1000, 2 ** 33 + 1, 40.0)
    window = [r.due_s for r in reqs if r.due_s >= 1.0]
    first = sum(1 for d in window if d < 21.0)
    assert abs(first - (len(window) - first)) <= 12


def test_lengths_are_clipped_and_follow_the_median():
    reqs = generate(MIX, 1000, 5, 200.0)
    lens = sorted(len(r.prompt) for r in reqs)
    outs = [r.max_new_tokens for r in reqs]
    assert lens[0] == 16 and lens[-1] == 400
    assert min(outs) >= 2 and max(outs) <= 32
    assert abs(lens[len(lens) // 2] - 100) <= 2
    assert all(0 <= t < 1000 for r in reqs for t in r.prompt)


def test_rate_and_span():
    reqs = generate(MIX, 50, 3, 40.0, rate_per_s=2.5)
    assert len(reqs) == 2 + 100             # the 1 s pre-roll, the window
    assert all(a.due_s <= b.due_s for a, b in zip(reqs, reqs[1:]))
    # the stratified exponential gaps sum to about n / rate
    assert reqs[-1].due_s == pytest.approx(41.0, rel=0.05)


def test_the_cells_mixes_generate():
    bench = harness.benchmark()
    for cell in bench["workloads"]:
        mix = harness.mix(cell["traffic"])
        cfg = harness.configuration(bench, cell["config"])
        reqs = generate(mix, cfg["vocab_size"], 7, 5.0)
        assert reqs and all(max(r.prompt) < cfg["vocab_size"] for r in reqs)
        longest = max(len(r.prompt) + r.max_new_tokens for r in reqs)
        cap = (mix["prompt_tokens"]["max"] + mix["output_tokens"]["max"])
        assert longest <= cap <= (cfg["engine"]["max_pages_per_seq"]
                                  * cfg["engine"]["page_size"])


def test_a_mix_finds_its_generator_by_name():
    from servebench.generators import stratified_poisson
    src = traffic.source(MIX, 1000, 3, 4.0)
    assert [r.due_s for r in src.reqs] == [
        r.due_s for r in stratified_poisson.requests(MIX, 1000, 3, 4.0)]
    assert src.preroll_s == 1.0
    with pytest.raises(ModuleNotFoundError):
        traffic.source(dict(MIX, generator="no_such_generator"), 1000, 3,
                       4.0)


def test_the_schedule_hands_out_what_is_due_once():
    reqs = [traffic.TimedRequest(t, [1], 2) for t in (0.5, 0.1, 0.9, 2.0)]
    sched = traffic.Schedule(reqs, 0.0)
    assert sched.next_due(0.0) == 0.1
    assert [r.due_s for r in sched.take(0.6)] == [0.1, 0.5]
    assert sched.take(0.6) == []
    assert sched.next_due(0.6) == 0.9
    assert [r.due_s for r in sched.take(5.0)] == [0.9, 2.0]
    assert sched.next_due(5.0) is None


class ClosedLoop:
    """``clients`` users, each sending its next request as soon as its
    last one has finished: a source that reads completions."""

    preroll_s = 0.3

    def __init__(self, clients, vocab):
        self.clients, self.vocab, self.sent = clients, vocab, 0

    def take(self, t, finished):
        busy = sum(1 for f in finished() if f is None)
        out = []
        for _ in range(self.clients - busy):
            self.sent += 1
            out.append(traffic.TimedRequest(
                t, [(7 * self.sent + j) % self.vocab for j in range(40)], 4))
        return out

    def next_due(self, t):
        return None


def test_a_closed_loop_source_drives_the_engine():
    pytest.importorskip("repro_torch")
    import torch

    from servebench import program, weights
    from servebench import test_servebench_faults as faults
    torch.set_num_threads(1)
    cfg, _ = faults.tiny()
    engine = program.build(cfg, weights.make(cfg, 5, "cpu"), "cpu")
    program.warm_up(engine, cfg)
    src = ClosedLoop(2, cfg["vocab_size"])
    run = harness.drive(engine, cfg, src, 2.0, program.request)
    start = run.ws - src.preroll_s
    # what a client hands out at the close itself falls outside the run
    assert src.sent - 2 <= len(run.served) <= src.sent
    assert len(run.served) > 4, len(run.steps)
    for i, s in enumerate(run.served):
        # when it was handed out, fewer than 2 others were in flight
        flight = [o for o in run.served[:i]
                  if not (0 < o.req.finish_time <= s.due)]
        assert len(flight) < 2, i
        assert s.due >= start
    done = [s for s in run.served if program.is_finished(s.req)]
    assert len(done) >= len(run.served) - 2
    assert all(len(s.req.output_tokens) == 4 for s in done)
