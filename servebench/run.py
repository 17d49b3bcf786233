"""One run of one benchmark cell of the port's paged engine.

    python3 servebench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout: finds the cell in ``BENCHMARK.json``, draws
the weights on the card from the seed, builds the port's
``InferenceEngine`` with the configuration's settings, warms up the
cell's step shapes, offers the cell's traffic open-loop for its
pre-roll and then for ``--seconds`` measured seconds, and compares a
sample of what it served with the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, a device trace of a few seconds of
the window with them), ``device`` and, last, ``checks``: each number
compared beside its limit, which also end standard error.

Exits with a code other than 0 and prints no result when there is no
CUDA card, when the program cannot be imported, or when JAX or the JAX
package was loaded by the time the window closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
for _p in (REPO / "src", REPO):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
# caches stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"servebench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from servebench import harness
    bench = harness.benchmark()
    cell = harness.workload(bench, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        return fail(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"found {torch.cuda.device_count()}", 2)
    try:
        from servebench import program
    except ImportError as e:
        return fail(f"the program cannot be imported: {e}", 3)
    cfg = harness.configuration(bench, cell["config"])
    out = run(cfg, harness.mix(cell["traffic"]), harness.check(cell["name"]),
              harness.metric_entries(bench, cell["name"], bool(args.trace)),
              args.seed, args.seconds, bool(args.trace), program, "cuda")
    found = harness.banned_modules()
    if found:
        return fail(f"loaded by the window's close: {found}", 4)
    print(json.dumps(out), flush=True)
    return 0


def run(cfg: dict, mix: dict, chk: dict, entries: list, seed: int,
        seconds: float, trace: bool, program, device: str,
        t_process: float = T_PROCESS, log=sys.stderr):
    """One run; the result's dict.  ``program`` is the module that drives
    the system (``servebench.program``); tests hand in the same one with
    the timed path broken underneath, on the CPU."""
    import torch

    from servebench import harness, kernel_share, weights
    from servebench.tracing import DeviceTrace, Spans
    on_card = torch.device(device).type == "cuda"
    params = weights.make(cfg, seed, device)
    engine = program.build(cfg, params, device)
    program.warm_up(engine, cfg)
    spans = device_trace = None
    if trace:
        spans = Spans()
        spans.instrument(engine)
        if on_card:
            DeviceTrace.warm()
            device_trace = DeviceTrace()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_drive = time.monotonic()
    w = harness.offer(engine, cfg, mix, seed, seconds, program,
                      device_trace=device_trace, spans=spans)
    w.setup_s = (t_drive - t_process) + mix["preroll_s"]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        free, total = torch.cuda.mem_get_info()
        print(f"memory: peak {peak}, reserved "
              f"{torch.cuda.max_memory_reserved()}, free {free} of {total}",
              file=log)
    metrics = harness.report(w, entries)
    done = harness.finished(w, program.is_finished)
    due = [s for s in w.served if w.ws <= s.due < w.we]
    n_failed = sum(1 for s in due
                   if s.req is not None and program.is_failed(s.req))
    steps = w.window_steps
    print(f"window: {len(due)} requests due, {len(done)} finished in all, "
          f"{len(steps)} steps "
          f"({sum(s.mode == 'mixed' for s in steps)} mixed, "
          f"{sum(s.mode == 'decode' for s in steps)} decode, "
          f"{sum(s.mode == 'prefill' for s in steps)} prefill), "
          f"{engine.metrics().preemptions} preemptions, "
          f"setup {w.setup_s:.2f} s", file=log)
    if w.trace is not None:
        print(f"trace: {len(w.trace.events)} device events over "
              f"{w.trace.window_s:.3f} s, busy {w.trace.busy_s:.3f} s, "
              f"{w.trace.aligned_share} of them inside a step span",
              file=log)
        for name, k in kernel_share.kernels(cfg).items():
            got = [len(x) for _, x in kernel_share.step_launches(w, name)]
            print(f"trace: {name} launches a step {got}, "
                  f"{k.launches(cfg)} declared", file=log)
    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = harness.judge(cfg, params, done, seed,
                            chk["sample_served_tokens"], log)
    print(f"reference: {verdict['reference_s']:.2f} s", file=log)
    checks = {"logit_gap_max": {"value": verdict["logit_gap_max"],
                                "limit": chk["logit_gap_max"]},
              "failed_requests": {"value": n_failed, "limit": 0}}
    correct = (verdict["tokens_compared"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(due), "failed": n_failed,
           "metrics": metrics, "device": dev}
    if w.trace is not None:
        dev["busy_s"] = w.trace.busy_s
        dev["window_s"] = w.trace.window_s
        out["breakdown"] = w.trace.breakdown()
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=log)
    out["checks"] = checks
    return out


if __name__ == "__main__":
    sys.exit(main())
