"""The knee of a cell: the highest offered rate at which the waiting
queue does not grow through the window.

    python3 servebench/sweep.py --workload <name> --rates 4,6,8 \
        [--seconds 51] [--seeds 1,2,3]

One process: for each seed the weights once, then for each rate a fresh
engine with the configuration's settings, the cell's mix at that rate
for its pre-roll and ``--seconds``.  One JSON line per seed and rate:
requests due in the window, the backlog (due and not yet admitted) at
each tenth of the window, its least-squares slope in requests a second,
the time to first token at the median and the 95th percentile, the 95th
percentile of the queue wait and of the gaps between tokens, and the
steps run.  The knee is the highest rate whose backlog does not grow
through the window on any seed; the cell's rate is about four fifths of
it and goes into the mix's file as a number.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
for _p in (REPO / "src", REPO):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def backlog(served, t: float) -> int:
    """Requests due by ``t`` and not admitted by then."""
    return sum(1 for s in served if s.due <= t and not (
        s.req is not None and 0.0 < s.req.schedule_time <= t))


def slope(xs, ys) -> float:
    """The least-squares slope of ys over xs."""
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seeds", default="1")
    args = ap.parse_args(argv)
    import torch

    from servebench import harness, program, weights
    from servebench.window import percentile, queue_waits, token_gaps, ttfts
    bench = harness.benchmark()
    w = harness.workload(bench, args.workload)
    cfg = harness.configuration(bench, w["config"])
    mix = harness.mix(w["traffic"])
    for seed in (int(x) for x in args.seeds.split(",")):
        params = weights.make(cfg, seed, "cuda")
        for rate in (float(r) for r in args.rates.split(",")):
            engine = program.build(cfg, params, "cuda")
            program.warm_up(engine, cfg)
            run = harness.offer(engine, cfg, mix, seed, args.seconds,
                                program, rate)
            ws, we = run.ws, run.we
            at = [ws + (we - ws) * k / 10 for k in range(11)]
            queue = [backlog(run.served, x) for x in at]
            t = ttfts(run.served, ws, we)
            print(json.dumps({
                "seed": seed, "rate_per_s": rate,
                "due": sum(1 for s in run.served if ws <= s.due < we),
                "backlog": queue,
                "backlog_slope_per_s": slope([x - ws for x in at], queue),
                "ttft_p50_s": percentile(t, 50),
                "ttft_p95_s": percentile(t, 95),
                "queue_wait_p95_s": percentile(
                    queue_waits(run.served, ws, we), 95),
                "itl_p95_ms": (percentile(token_gaps(run.served, ws, we), 95)
                               or 0.0) * 1e3,
                "steps": len(run.window_steps),
                "preemptions": engine.metrics().preemptions}), flush=True)
            del engine, run
            gc.collect()
            torch.cuda.empty_cache()
        del params
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
