"""One run of one cell: the steps every caller shares.

``benchmark``/``workload``/``configuration``/``mix``/``check`` find a
cell's files by the names ``BENCHMARK.json`` gives; ``metric_entries``
and ``reader`` find the metrics a run reports and the reader of each
(``servebench/metrics/<name>.py``, a ``read(run)`` that returns a number
or None).  ``drive`` offers a cell's traffic to an engine as the mix's
generator decides (``servebench/traffic.py``) and records the window; ``judge`` compares what the window served with the
plain reference.  ``run.py`` strings them together for one run;
``calibrate.py`` and ``sweep.py`` reuse them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from servebench import traffic
from servebench.judge import Finished, pick, served_gaps
from servebench.reference import build as reference
from servebench.roofline import StepRecord
from servebench.tracing import DeviceTrace, Spans, TraceSummary
from servebench.window import Served

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 3.0     # the traced sub-window: the window's last 3 s


# ------------------------------------------------------------- the files
def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def configuration(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(REPO / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def check(name: str) -> dict:
    return load_json(ROOT / "checks" / f"{name}.json")


def metric_entries(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (those that list it, or, without a
    list, those that move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m["workloads"] or (
                "workloads" not in m and m["moves"] in moved)]


def reader(name: str) -> Callable:
    """The ``read`` function of ``servebench/metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "servebench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED_MODULES))


# ------------------------------------------------------------ the window
@dataclass
class Run:
    """What one run saw; the metric readers read it."""
    cfg: dict
    seconds: float
    ws: float
    we: float
    served: List[Served]
    steps: List[StepRecord]
    setup_s: float = 0.0
    trace: Optional[TraceSummary] = None

    @property
    def window_steps(self) -> List[StepRecord]:
        return [s for s in self.steps if self.ws <= s.t0 < self.we]

    @property
    def trace_steps(self) -> List[StepRecord]:
        if self.trace is None:
            return []
        t0, t1 = self.trace.t0_ns / 1e9, self.trace.t1_ns / 1e9
        return [s for s in self.steps if t0 <= s.wall0 and s.wall1 <= t1]


class StepRecorder:
    """Keeps a ``StepRecord`` of every schedule the engine executes."""

    def __init__(self, engine, cfg: dict):
        e = cfg["engine"]
        self.max_batch, self.max_prefills = e["max_batch"], e["max_prefills"]
        self.steps: List[StepRecord] = []
        self._last: Optional[StepRecord] = None
        orig = engine.sched.schedule

        def schedule(now):
            out = orig(now)
            self._last = self.record(out)
            return out
        engine.sched.schedule = schedule

    def record(self, out) -> StepRecord:
        pad = {"mixed": self.max_batch + self.max_prefills * out.pad_len,
               "decode": self.max_batch, "prefill": out.pad_len}
        return StepRecord(
            out.mode,
            [r.prompt_len + len(r.output_tokens) for r in out.decode],
            [(w.start, w.chunk_len, w.req.prompt_len) for w in out.prefills],
            pad.get(out.mode, 0))

    def close(self, t0: float, t1: float, wall0: float,
              wall1: float) -> None:
        rec, self._last = self._last, None
        if rec is not None:
            rec.t0, rec.t1, rec.wall0, rec.wall1 = t0, t1, wall0, wall1
            self.steps.append(rec)


def drive(engine, cfg: dict, source, seconds: float,
          make_request: Callable,
          device_trace: Optional[DeviceTrace] = None,
          spans: Optional[Spans] = None) -> Run:
    """Offer a traffic ``source``'s requests: between steps submit what
    it hands out, step while there is work, sleep until it next has a
    request due otherwise.  The window opens the source's ``preroll_s``
    after the start and lasts ``seconds``; nothing is submitted or
    stepped after it closes, and requests that fell due before the close
    without being submitted are kept, unsubmitted, for the window's
    arithmetic.
    ``device_trace`` profiles the window's last ``TRACE_SECONDS`` (at
    most 0.3 of it), from the start of a step to the end of the last
    one, and is read after the window has closed, so that nothing of the
    trace's own cost stalls the window."""
    clock = engine.clock
    steps = StepRecorder(engine, cfg)
    start = clock()
    ws = start + source.preroll_s
    we = ws + seconds
    served: List[Served] = []

    def finished() -> List[Optional[float]]:
        return [s.req.finish_time - start if s.req.finish_time else None
                for s in served]
    tr0 = we - min(TRACE_SECONDS, 0.3 * seconds)
    while True:
        now = clock()
        if now >= we:
            break
        for r in source.take(now - start, finished):
            s = Served(start + r.due_s, make_request(r.prompt,
                                                     r.max_new_tokens))
            engine.submit(s.req)
            served.append(s)
        if not engine.has_work:
            nxt = source.next_due(now - start)
            time.sleep(max(0.0, min(we, start + nxt if nxt is not None
                                    else we) - now))
            continue
        if (device_trace is not None and not device_trace.running
                and now >= tr0):
            device_trace.start()
        w0, t0 = time.time(), clock()
        engine.step()
        t1, w1 = clock(), time.time()
        steps.close(t0, t1, w0, w1)
    if device_trace is not None and device_trace.running:
        device_trace.stop(spans.items if spans else [])
    served += [Served(start + r.due_s)
               for r in source.take(we - start, finished)
               if start + r.due_s < we]
    return Run(cfg, seconds, ws, we, served, steps.steps,
               trace=device_trace.summary if device_trace else None)


def offer(engine, cfg: dict, mix: dict, seed: int, seconds: float,
          program, rate_per_s: Optional[float] = None,
          device_trace: Optional[DeviceTrace] = None,
          spans: Optional[Spans] = None) -> Run:
    """The mix's requests from ``seed`` offered to ``engine`` for its
    pre-roll and then ``seconds`` (``drive``)."""
    src = traffic.source(mix, cfg["vocab_size"], seed, seconds, rate_per_s)
    return drive(engine, cfg, src, seconds, program.request, device_trace,
                 spans)


# -------------------------------------------------------------- judging
def finished(run: Run, is_finished: Callable) -> List[Finished]:
    return [Finished(list(s.req.prompt_tokens), list(s.req.output_tokens))
            for s in run.served if s.req is not None and is_finished(s.req)]


def judge(cfg: dict, weights, done: List[Finished], seed: int,
          tokens: int, log=sys.stderr) -> dict:
    """Compare a sample of the finished requests with the reference:
    ``{"logit_gap_max": ..., "tokens_compared": ..., "requests": ...,
    "reference_s": ...}``."""
    t0 = time.monotonic()
    ref = reference(cfg, weights)
    worst, n = 0.0, 0
    idx = pick(done, seed, tokens)
    for i in idx:
        g = served_gaps(ref, done[i])
        worst = max(worst, float(g.max()))
        n += len(g)
    print(f"judged {len(idx)} requests, {n} served tokens, longest "
          f"{max((done[i].length for i in idx), default=0)} tokens",
          file=log)
    return {"logit_gap_max": worst, "tokens_compared": n,
            "requests": len(idx), "reference_s": time.monotonic() - t0}


def report(run: Run, entries: List[dict]) -> Dict[str, dict]:
    """Each metric's reading as ``{name: {"value", "unit"}}``; a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in entries:
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
