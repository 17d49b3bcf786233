"""Readings that set a cell's comparison limit, many seeds in one process.

    python3 servebench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control 3] [--seconds 15]

For each seed, as a run does it: weights from the seed, the engine with
the configuration's settings, the cell's traffic for its pre-roll and
``--seconds``, then the sample of finished requests judged by the plain
reference: the program's widest gap (``program_gap``).  For the first
``--control`` seeds the control too: the reference computed in fp8
(``reference.build(..., precision="fp8")``), whose first choice at every
position of the same sequences is judged the same way
(``control_gap``).  One JSON line per seed on standard output.  The
lower reading of a limit is the largest program gap over a dozen seeds
or more, the upper the smallest control gap (PERF.md).
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
for _p in (REPO / "src", REPO):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def cell_files(cell: str):
    """(configuration, mix, check) of a cell, by the names
    ``BENCHMARK.json`` gives."""
    from servebench import harness
    bench = harness.benchmark()
    w = harness.workload(bench, cell)
    return (harness.configuration(bench, w["config"]),
            harness.mix(w["traffic"]), harness.check(cell))


def readings(cfg: dict, mix: dict, chk: dict, seeds, control: int,
             seconds: float, device: str = "cuda"):
    """Yield one dict of readings per seed."""
    import torch

    from servebench import harness, judge, program, weights
    from servebench.reference import build as reference
    for k, seed in enumerate(seeds):
        t0 = time.monotonic()
        params = weights.make(cfg, seed, device)
        engine = program.build(cfg, params, device)
        program.warm_up(engine, cfg)
        run = harness.offer(engine, cfg, mix, seed, seconds, program)
        done = harness.finished(run, program.is_finished)
        del engine, run
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        ref = reference(cfg, params)
        ctl = reference(cfg, params, "fp8") if k < control else None
        idx = judge.pick(done, seed, chk["sample_served_tokens"])
        out = {"seed": seed, "requests": len(idx),
               "tokens": sum(len(done[i].served) for i in idx),
               "longest": max((done[i].length for i in idx), default=0),
               "program_gap": 0.0}
        for i in idx:
            out["program_gap"] = max(out["program_gap"], float(
                judge.served_gaps(ref, done[i]).max()))
            if ctl is not None:
                out["control_gap"] = max(out.get("control_gap", 0.0), float(
                    judge.control_gaps(ref, ctl, done[i]).max()))
        out["seconds"] = time.monotonic() - t0
        del params, ref, ctl
        gc.collect()
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=0,
                    help="seeds (the first ones) that also read the control")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for out in readings(*cell_files(args.workload), seeds, args.control,
                        args.seconds):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
