"""Workload generators for the cluster benchmarks.

Statistically matched stand-ins for the paper's datasets:

  * ``sharegpt_like``  — chat traffic: lognormal prompt/output lengths,
    Poisson arrivals, light prefix sharing (conversation turns).
  * ``birdsql_like``   — the Table-1 workload: text-to-SQL over a set of
    database schemas.  Prompts are dominated by a large schema prefix
    shared across all questions on the same database; outputs are short
    SQL.  Token ratio tuned to the paper's Table 1 (~1.08M prompt vs
    ~12.7k decode tokens ⇒ ~85:1).
  * ``multiturn_chat`` — growing shared-prefix conversations (the
    KV-reuse-friendly case motivating the distributed pool).
  * ``burst``          — step/burst arrival pattern for autoscaler tests.
  * ``slo_mixed``      — interleaved interactive (short, latency-bound)
    and batch (long, throughput-bound) arrivals with priority classes
    set — the SLO-aware-scheduling testbed (bench_slo).
  * ``phase_shift``    — prefill-heavy half then decode-heavy half: the
    role-pool rebalancing testbed (bench_pd_pools) — any static P:D
    split is mis-sized for one of the two phases.
  * ``lora_zipf``      — high-density multi-LoRA traffic: every request
    tags one of N adapters with zipf-distributed popularity (a few hot
    adapters, a long cold tail) — the adapter-tiering + LoRA-aware
    routing testbed (bench_lora).
  * ``multi_round_qa`` — million-session multi-turn traffic: a LAZY
    generator (the other workloads materialize lists — at 1M sessions
    that alone would dominate memory) of zipf-deep sessions whose turns
    are separated by lognormal think-times.  Every request carries its
    ``session_id`` so the gateway's sticky session policy can pin the
    conversation to the engine holding its KV prefix.

``summarize`` reduces a finished-request list to the benchmark
headline dict; :class:`StreamingSummary` is its streaming twin for
runs too large to hold every Request — ``observe()`` each finish and
drop the object, exact percentiles below a size threshold and
log-histogram approximations (tolerance-pinned) above it.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.engine.request import Request, SamplingParams

VOCAB = 32_000


@dataclass
class TimedRequest:
    arrival: float
    request: Request


def _toks(rng: np.random.Generator, n: int) -> List[int]:
    return rng.integers(0, VOCAB, size=max(n, 1)).tolist()


def _lognormal_len(rng, mean: float, sigma: float, lo: int, hi: int) -> int:
    mu = math.log(mean) - sigma ** 2 / 2
    return int(np.clip(rng.lognormal(mu, sigma), lo, hi))


def sharegpt_like(rate_rps: float, duration_s: float, seed: int = 0,
                  mean_prompt: float = 220.0, mean_output: float = 180.0
                  ) -> List[TimedRequest]:
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while t < duration_s:
        t += rng.exponential(1.0 / rate_rps)
        plen = _lognormal_len(rng, mean_prompt, 0.9, 8, 4096)
        olen = _lognormal_len(rng, mean_output, 0.8, 4, 1024)
        req = Request(prompt_tokens=_toks(rng, plen),
                      sampling=SamplingParams(max_new_tokens=olen),
                      arrival_time=t)
        out.append(TimedRequest(t, req))
    return out


def birdsql_like(n_requests: int, rate_rps: float, seed: int = 0,
                 n_databases: int = 12, schema_tokens: int = 1600,
                 question_tokens: int = 120, output_tokens: int = 20
                 ) -> List[TimedRequest]:
    """Shared-schema-prefix Text2SQL traffic (Table 1 workload)."""
    rng = np.random.default_rng(seed)
    schemas = [_toks(rng, schema_tokens) for _ in range(n_databases)]
    # zipf-ish database popularity (some DBs are hot)
    popularity = 1.0 / (np.arange(n_databases) + 1.0)
    popularity /= popularity.sum()
    out, t = [], 0.0
    for _ in range(n_requests):
        t += rng.exponential(1.0 / rate_rps)
        db = rng.choice(n_databases, p=popularity)
        q = _lognormal_len(rng, question_tokens, 0.6, 16, 512)
        o = _lognormal_len(rng, output_tokens, 0.5, 4, 96)
        prompt = schemas[db] + _toks(rng, q)
        req = Request(prompt_tokens=prompt,
                      sampling=SamplingParams(max_new_tokens=o),
                      arrival_time=t, user=f"db-{db}")
        out.append(TimedRequest(t, req))
    return out


def multiturn_chat(n_conversations: int, turns: int, rate_rps: float,
                   seed: int = 0, sys_prompt: int = 400,
                   turn_tokens: int = 80, output_tokens: int = 120
                   ) -> List[TimedRequest]:
    rng = np.random.default_rng(seed)
    sys_tok = _toks(rng, sys_prompt)
    out, t = [], 0.0
    convs = [list(sys_tok) for _ in range(n_conversations)]
    order = []
    for turn in range(turns):
        for c in range(n_conversations):
            order.append(c)
    for c in order:
        t += rng.exponential(1.0 / rate_rps)
        convs[c] = convs[c] + _toks(rng, turn_tokens)
        o = _lognormal_len(rng, output_tokens, 0.6, 8, 512)
        req = Request(prompt_tokens=list(convs[c]),
                      sampling=SamplingParams(max_new_tokens=o),
                      arrival_time=t, user=f"conv-{c}")
        convs[c] = convs[c] + _toks(rng, o)   # model reply joins context
        out.append(TimedRequest(t, req))
    return out


def burst(base_rps: float, burst_rps: float, duration_s: float,
          burst_at: float, burst_len: float, seed: int = 0,
          mean_prompt: float = 220.0, mean_output: float = 120.0
          ) -> List[TimedRequest]:
    """Step-burst arrivals: autoscaler reaction testbed."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while t < duration_s:
        rate = burst_rps if burst_at <= t < burst_at + burst_len \
            else base_rps
        t += rng.exponential(1.0 / rate)
        plen = _lognormal_len(rng, mean_prompt, 0.8, 8, 2048)
        olen = _lognormal_len(rng, mean_output, 0.7, 4, 512)
        req = Request(prompt_tokens=_toks(rng, plen),
                      sampling=SamplingParams(max_new_tokens=olen),
                      arrival_time=t)
        out.append(TimedRequest(t, req))
    return out


def slo_mixed(rate_rps: float, duration_s: float, seed: int = 0,
              interactive_frac: float = 0.5,
              interactive_prompt: float = 128.0,
              interactive_output: float = 48.0,
              batch_prompt: float = 1800.0,
              batch_output: float = 200.0) -> List[TimedRequest]:
    """Mixed-class arrivals for SLO-aware scheduling benchmarks:
    interactive chat turns (short prompt/output, tight TTFT target)
    Poisson-interleaved with batch jobs (long prompts, long outputs,
    loose TTFT).  Each request carries its ``priority_class`` so the
    scheduler/gateway/autoscaler SLO path sees real class labels."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while t < duration_s:
        t += rng.exponential(1.0 / rate_rps)
        if rng.random() < interactive_frac:
            cls, mp, mo = "interactive", interactive_prompt, \
                interactive_output
        else:
            cls, mp, mo = "batch", batch_prompt, batch_output
        plen = _lognormal_len(rng, mp, 0.5, 8, 4096)
        olen = _lognormal_len(rng, mo, 0.5, 4, 1024)
        req = Request(prompt_tokens=_toks(rng, plen),
                      sampling=SamplingParams(max_new_tokens=olen),
                      arrival_time=t, priority_class=cls)
        out.append(TimedRequest(t, req))
    return out


def phase_shift(duration_s: float, seed: int = 0,
                interactive_frac: float = 1.0,
                prefill_rate_rps: float = 15.0,
                prefill_prompt: float = 512.0,
                prefill_output: float = 16.0,
                decode_rate_rps: float = 2.5,
                decode_prompt: float = 256.0,
                decode_output: float = 400.0) -> List[TimedRequest]:
    """Phase-shifting P/D load: the first half is prefill-heavy (high
    arrival rate of long prompts with short outputs — the TTFT-bound
    phase), the second half decode-heavy (fewer, short prompts with
    long outputs — decode residency and ITL bound).  A static
    prefill:decode split tuned for either phase starves in the other;
    the attainment-driven RolePoolManager rebalance migrates members
    between pools when the phase flips
    (``benchmarks/bench_pd_pools.py``).  Requests default to the
    'interactive' priority class so per-class attainment is the metric
    under test."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while t < duration_s:
        if t < duration_s / 2:
            rate, mp, mo = prefill_rate_rps, prefill_prompt, \
                prefill_output
        else:
            rate, mp, mo = decode_rate_rps, decode_prompt, decode_output
        t += rng.exponential(1.0 / rate)
        cls = ("interactive" if rng.random() < interactive_frac
               else "standard")
        plen = _lognormal_len(rng, mp, 0.35, 8, 4096)
        olen = _lognormal_len(rng, mo, 0.35, 4, 1024)
        req = Request(prompt_tokens=_toks(rng, plen),
                      sampling=SamplingParams(max_new_tokens=olen),
                      arrival_time=t, priority_class=cls)
        out.append(TimedRequest(t, req))
    return out


def lora_zipf(n_adapters: int, rate_rps: float, duration_s: float,
              seed: int = 0, zipf_s: float = 1.1,
              mean_prompt: float = 160.0, mean_output: float = 48.0,
              prefix: str = "lora-") -> List[TimedRequest]:
    """Thousand-adapter zipf trace: Poisson arrivals where each request
    targets adapter ``{prefix}{i}`` drawn from a zipf(s) popularity
    curve — a handful of hot adapters take most traffic while the long
    tail stays cold, so adapter placement/tiering and affinity routing
    (not raw capacity) decide hit rates and cold-load stalls."""
    rng = np.random.default_rng(seed)
    heat = 1.0 / (np.arange(1, n_adapters + 1) ** zipf_s)
    heat /= heat.sum()
    out, t = [], 0.0
    while t < duration_s:
        t += rng.exponential(1.0 / rate_rps)
        a = int(rng.choice(n_adapters, p=heat))
        plen = _lognormal_len(rng, mean_prompt, 0.6, 8, 1024)
        olen = _lognormal_len(rng, mean_output, 0.5, 4, 256)
        req = Request(prompt_tokens=_toks(rng, plen),
                      sampling=SamplingParams(max_new_tokens=olen),
                      arrival_time=t, user=f"u-{a}",
                      lora_adapter=f"{prefix}{a}")
        out.append(TimedRequest(t, req))
    return out


def multi_round_qa(n_sessions: int, session_rate_rps: float,
                   seed: int = 0, rounds_max: int = 8,
                   zipf_s: float = 1.3, think_time_s: float = 20.0,
                   sys_prompt: int = 64, turn_tokens: int = 48,
                   output_tokens: int = 32,
                   shared_sys: bool = False,
                   think_sigma: float = 0.8,
                   stats: Optional[dict] = None
                   ) -> Iterator[TimedRequest]:
    """Million-session multi-round QA: a lazy, time-ordered generator.

    New sessions open as a Poisson stream at ``session_rate_rps``; each
    runs ``1 + min(zipf(zipf_s), rounds_max - 1)`` rounds (a few deep
    power-user conversations, a long tail of one-shots) separated by
    lognormal think-times around ``think_time_s``.  Turn *r*'s prompt
    is the whole conversation so far — system prompt, every earlier
    turn and reply, plus the new turn — so consecutive rounds share a
    growing prefix and routing the session back to the same engine
    converts that prefix into cache hits.

    Memory discipline (this trace runs at ~1M sessions): per-session
    token history is NOT stored.  A session's token stream is
    regenerated deterministically from ``(seed, session index)`` at
    every emission — a counter-mix over the token index, NOT a
    Generator construction per emit, which would dominate the whole
    simulator's per-request cost — so the generator's live state is
    one heap entry per session with a pending round: O(concurrent
    sessions), not O(total tokens).  Every request carries
    ``session_id``/``user``.

    ``shared_sys=True`` makes the first ``sys_prompt`` tokens identical
    across ALL sessions (the common deployment shape: one system prompt,
    many users) while every later token keeps the per-session salt —
    with it, sessions landing on different engines write the SAME
    system-prompt pages, which is what the host-shared SSD pool
    deduplicates and serves as cross-engine hits.

    ``stats`` (optional dict) is updated in place with
    ``open_sessions`` (sessions currently between rounds — the live
    heap size) and ``peak_open_sessions``, so million-session benches
    can report concurrency without a second pass over the trace.
    """
    rng = np.random.default_rng(seed)
    # lognormal mean fix: E[lognormal(mu, s)] = e^(mu + s^2/2), so the
    # observed mean think-time stays ``think_time_s`` for any
    # ``think_sigma`` (0.8 = human chat; ~0.2-0.3 = the regular cadence
    # of agent/tool loops that predictive promotion targets)
    mu = math.log(max(think_time_s, 1e-3)) - think_sigma ** 2 / 2
    per_round = turn_tokens + output_tokens

    def _emit(sid: int, rnd: int, t: float) -> TimedRequest:
        n = sys_prompt + rnd * per_round + turn_tokens
        # deterministic per-(seed, session, index) token stream: the
        # tokens only need to be stable and session-unique (they are
        # cache keys, not text), so a 64-bit mix beats an rng here
        idx = np.arange(n, dtype=np.uint64)
        salt = ((seed * 0x5851F42D + sid) * 0x9E3779B97F4A7C15) \
            & (2**64 - 1)
        x = idx + np.uint64(salt)
        if shared_sys and sys_prompt > 0:
            # session-independent salt for the system-prompt span so
            # its pages content-address identically fleet-wide
            sys_salt = (seed * 0x9E3779B97F4A7C15) & (2**64 - 1)
            x[:sys_prompt] = idx[:sys_prompt] + np.uint64(sys_salt)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        prompt = (x % np.uint64(VOCAB)).astype(np.int64).tolist()
        req = Request(prompt_tokens=prompt,
                      sampling=SamplingParams(
                          max_new_tokens=output_tokens),
                      arrival_time=t, session_id=f"s{sid}",
                      user=f"s{sid}")
        return TimedRequest(t, req)

    heap: list = []         # (next_arrival, sid, round, total_rounds)
    started = 0
    next_start = rng.exponential(1.0 / session_rate_rps)
    while started < n_sessions or heap:
        if started < n_sessions and (not heap
                                     or next_start <= heap[0][0]):
            sid, t, rnd = started, next_start, 0
            nrounds = 1 + min(int(rng.zipf(zipf_s)), rounds_max - 1) \
                if rounds_max > 1 else 1
            started += 1
            next_start += rng.exponential(1.0 / session_rate_rps)
        else:
            t, sid, rnd, nrounds = heapq.heappop(heap)
        yield _emit(sid, rnd, t)
        if rnd + 1 < nrounds:
            heapq.heappush(
                heap, (t + rng.lognormal(mu, think_sigma), sid, rnd + 1,
                       nrounds))
        if stats is not None:
            stats["open_sessions"] = len(heap)
            stats["peak_open_sessions"] = max(
                stats.get("peak_open_sessions", 0), len(heap))


# ------------------------------------------------------------------ summary
def percentile(vals: List[float], p: float) -> float:
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals), p))


def summarize(requests: List[Request], span_s: Optional[float] = None
              ) -> dict:
    done = [r for r in requests if r.finish_time > 0]
    if not done:
        return {"finished": 0}
    t0 = min(r.arrival_time for r in done)
    t1 = max(r.finish_time for r in done)
    span = span_s or max(t1 - t0, 1e-9)
    prompt_toks = sum(r.prompt_len for r in done)
    out_toks = sum(len(r.output_tokens) for r in done)
    ttfts = [r.ttft * 1000 for r in done]
    itls = [x * 1000 for r in done for x in r.itl]
    return {
        "finished": len(done),
        "prompt_tokens": prompt_toks,
        "decode_tokens": out_toks,
        "total_tput_tok_s": (prompt_toks + out_toks) / span,
        "decode_tput_tok_s": out_toks / span,
        "ttft_avg_ms": float(np.mean(ttfts)),
        "ttft_p99_ms": percentile(ttfts, 99),
        "itl_avg_ms": float(np.mean(itls)) if itls else 0.0,
        "itl_p99_ms": percentile(itls, 99),
        "latency_avg_s": float(np.mean([r.total_latency for r in done])),
        "latency_p99_s": percentile([r.total_latency for r in done], 99),
        "completion_time_s": span,
    }


class StreamingDist:
    """Bounded streaming distribution: exact values (np.percentile
    parity) up to ``exact_max`` samples, then a one-time conversion to
    a fixed log-spaced histogram over [lo, hi].  Histogram percentiles
    carry a relative error bounded by one bin's width —
    ``(hi/lo)**(1/bins) - 1`` (~1.3% at the defaults), pinned by
    tests/test_sessions.py — while memory stays O(bins) no matter how
    many samples stream in."""

    def __init__(self, exact_max: int = 100_000, bins: int = 2048,
                 lo: float = 1e-6, hi: float = 1e5):
        self.exact_max = exact_max
        self.bins = bins
        self._log_lo = math.log(lo)
        self._scale = bins / (math.log(hi) - self._log_lo)
        self._lo, self._hi = lo, hi
        self._vals: Optional[List[float]] = []
        self._hist: Optional[np.ndarray] = None
        self.count = 0
        self.total = 0.0

    @property
    def rel_tolerance(self) -> float:
        """Worst-case relative percentile error once histogrammed."""
        return (self._hi / self._lo) ** (1.0 / self.bins) - 1.0

    def _bin(self, v: float) -> int:
        v = min(max(v, self._lo), self._hi)
        return min(int((math.log(v) - self._log_lo) * self._scale),
                   self.bins - 1)

    def _to_hist(self) -> None:
        self._hist = np.zeros(self.bins, dtype=np.int64)
        for v in self._vals:
            self._hist[self._bin(v)] += 1
        self._vals = None

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if self._hist is None:
            self._vals.append(v)
            if len(self._vals) > self.exact_max:
                self._to_hist()
        else:
            self._hist[self._bin(v)] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        if not self.count:
            return 0.0
        if self._hist is None:
            return percentile(self._vals, p)
        target = (p / 100.0) * (self.count - 1)
        cum = np.cumsum(self._hist)
        i = int(np.searchsorted(cum, target + 1))
        i = min(i, self.bins - 1)
        # geometric bin midpoint (log-spaced edges)
        lo_e = math.exp(self._log_lo + i / self._scale)
        hi_e = math.exp(self._log_lo + (i + 1) / self._scale)
        return math.sqrt(lo_e * hi_e)


class StreamingSummary:
    """Streaming twin of :func:`summarize`: ``observe(req)`` extracts
    each finished request's metrics and lets the object go, so a 1M-
    request run keeps O(exact_max + bins) state instead of every
    Request.  Wire it as ``SchedulerCore.finish_sink`` (what
    ``ClusterConfig.retain_requests=False`` does) and read
    ``summary()`` — same keys as ``summarize`` plus attainment rows
    when ``ttft_slo_s`` targets are given."""

    def __init__(self, exact_max: int = 100_000,
                 ttft_slo_s: Optional[Dict[str, float]] = None):
        self.ttft_ms = StreamingDist(exact_max)
        self.itl_ms = StreamingDist(exact_max)
        self.latency_s = StreamingDist(exact_max)
        self.finished = 0
        self.prompt_tokens = 0
        self.decode_tokens = 0
        self.t0 = float("inf")
        self.t1 = 0.0
        self.ttft_slo_s = ttft_slo_s or {}
        self.slo_seen = 0
        self.slo_ok = 0

    def observe(self, req: Request) -> None:
        if req.finish_time <= 0:
            return
        self.finished += 1
        self.prompt_tokens += req.prompt_len
        self.decode_tokens += len(req.output_tokens)
        self.t0 = min(self.t0, req.arrival_time)
        self.t1 = max(self.t1, req.finish_time)
        ttft = req.ttft
        self.ttft_ms.add(ttft * 1000)
        for gap in req.itl:
            self.itl_ms.add(gap * 1000)
        self.latency_s.add(req.total_latency)
        target = self.ttft_slo_s.get(req.priority_class)
        if target is not None:
            self.slo_seen += 1
            self.slo_ok += int(ttft <= target)

    @property
    def ttft_attainment(self) -> float:
        return self.slo_ok / self.slo_seen if self.slo_seen else 1.0

    def summary(self, span_s: Optional[float] = None) -> dict:
        if not self.finished:
            return {"finished": 0}
        span = span_s or max(self.t1 - self.t0, 1e-9)
        out = {
            "finished": self.finished,
            "prompt_tokens": self.prompt_tokens,
            "decode_tokens": self.decode_tokens,
            "total_tput_tok_s": (self.prompt_tokens
                                 + self.decode_tokens) / span,
            "decode_tput_tok_s": self.decode_tokens / span,
            "ttft_avg_ms": self.ttft_ms.mean,
            "ttft_p99_ms": self.ttft_ms.percentile(99),
            "itl_avg_ms": self.itl_ms.mean,
            "itl_p99_ms": self.itl_ms.percentile(99),
            "latency_avg_s": self.latency_s.mean,
            "latency_p99_s": self.latency_s.percentile(99),
            "completion_time_s": span,
        }
        if self.slo_seen:
            out["ttft_attainment"] = self.ttft_attainment
        return out
