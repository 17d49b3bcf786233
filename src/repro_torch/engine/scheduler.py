"""Unified scheduler core shared by every engine in the system.

One scheduling semantics, written once: the real JAX ``InferenceEngine``
(repro.engine.engine), the analytic cluster-simulator ``SimEngine``
(repro.core.sim.sim_engine) and the ``SlotEngine`` all drive the classes
in this module instead of carrying their own drifting copies of
admission / budget / finish logic.

Layers
------
``SchedulerCore``
    The engine-shape-agnostic request bookkeeping: arrival queue,
    admission accounting (queue-time EWMA, admitted counter), the
    finish/stop predicate (max_new_tokens + stop_token), latency EWMA
    and the sliding token-throughput window.  The slot engine builds
    directly on this.

``Scheduler``
    The paged-KV scheduler: cache-aware admission (prefix match, pool
    fetch, deferral of a prompt whose leading block hash matches an
    in-flight prefill), per-step token budget with chunk trimming,
    preemption, decode bookkeeping, and P/D roles.  ``schedule(now)``
    is *declarative*: it returns a :class:`ScheduleOutput` naming the
    decode rows and budget-trimmed prefill chunks for this iteration
    and mutates nothing but admission state — the host's "runner"
    (jitted forward passes for the real engine, the roofline cost model
    for the simulator) executes it and reports back through the
    ``note_* / finish_* / on_decode_batch`` bookkeeping calls.

Roles (paper §3.2.5, DistServe-style P/D disaggregation)
--------------------------------------------------------
``role="mixed"`` is a normal colocated engine.  ``role="prefill"``
prefills, publishes KV through the distributed pool, then hands the
request off (``handoff_prefill`` releases the pages and re-queues the
request for the decode side; the host delivers it via its ``handoff``
callable — synchronously for real engines, after the pool's metadata
lag for the simulator).  ``role="decode"`` engines admit handed-off
requests whose KV they pull from the pool by block hash, so they only
recompute the tail block before decoding.

SLO-aware scheduling (paper §"SLO-driven GPU optimizer")
---------------------------------------------------------
Requests carry a ``priority_class`` (interactive | standard | batch);
:data:`DEFAULT_SLO_CLASSES` maps each class to TTFT/ITL targets and a
preemption rank.  With ``SchedulerConfig.slo_aware=True`` admission is
deadline-aware — strict priority rank across classes, earliest TTFT
slack first within a class — and an interactive prefill about to miss
its TTFT target (slack below ``slo_preempt_headroom`` of the target)
may preempt one strictly-lower-priority decode (rate-limited by
``slo_preempt_cooldown_s``).  Per-class TTFT/ITL attainment is
accounted in :class:`SchedulerCore` regardless of mode, so the gateway
(``slo-aware`` routing policy) and the autoscaler (``slo_attainment``
metric) can consume it even from FIFO engines.  Because all of this
lives in the one shared Scheduler, the same SLO policy drives the real
JAX engine, the simulator and the P/D role split with no duplication.

Tiered KV placement (paper §3.2.5 + "KV cache offloading" line of work)
-----------------------------------------------------------------------
With a :class:`~repro.core.kvcache.tiers.HostPagePool` attached, KV
pages have three homes checked in order by the admission page walk:
device HBM (``PageAllocator`` prefix cache), host DRAM (the bounded
tier this scheduler feeds via the allocator's eviction cascade and via
swap-based preemption), and the cluster ``DistributedKVPool``.
``preempt`` then *swaps* instead of discarding: the victim's pages —
prompt and generated — are offloaded under per-request swap keys, the
request parks in ``waiting`` as ``SWAPPED``, and ``_try_resume`` swaps
the pages back in to continue decoding from ``prefill_done_tokens``
(byte-identical to the never-preempted run) rather than re-prefilling
from token 0.  Pool handoff transfers are chunked into page groups
(``handoff_chunk_pages``): only the head group must land before the
tail recompute starts; later groups are marked ``stream=True`` for the
host to overlap (the simulator prices them against the step's compute,
the real engine installs them synchronously).

All bookkeeping methods take an explicit ``now`` so the same code runs
under wall clock (real engines) and forward-dated discrete-event time
(the simulator).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.kvcache.pool import KVPoolError
from repro_torch.core.kvcache.tiers import payload_nbytes
from repro_torch.engine.page_table import PageAllocator, chunk_hashes
from repro_torch.engine.request import Request, RequestState
from repro_torch.engine.speculative import DraftController

# sentinel: continuation admission found the checkpoint unrecoverable
# (distinct from None = out of memory, retry later)
_RECOMPUTE = object()

# async overlapped loop: placeholder appended for a dispatched-but-not-
# yet-read-back decode token (never a real token id; patched at readback)
PENDING_TOKEN = -1


def window_throughput(events, now: float, horizon: float = 10.0) -> float:
    """tokens/sec over the span actually observed within ``horizon``.

    ``events`` is a list of (timestamp, token_count).  A fixed-horizon
    divisor deflated early/low-traffic readings (skewing gateway routing
    and autoscaler signals); the 1 s floor keeps a single post-idle
    burst from reading as a huge rate spike when polled within the same
    instant.  Shared by InferenceEngine, SlotEngine and SimEngine so
    their tokens_per_sec semantics cannot drift apart.
    """
    window = [(t, c) for t, c in events if t >= now - horizon]
    if not window:
        return 0.0
    span = max(now - window[0][0], 1.0)
    return sum(c for _, c in window) / span


@dataclass(frozen=True)
class ClassSLO:
    """Per-priority-class service-level objective.

    ``ttft_s``/``itl_s`` are the attainment targets (a request attains
    its TTFT SLO when ``req.ttft <= ttft_s``; each inter-token gap is
    checked against ``itl_s``).  ``rank`` orders preemption: lower rank
    preempts strictly higher rank, never the reverse.
    """
    ttft_s: float
    itl_s: float
    rank: int


DEFAULT_SLO_CLASSES: Dict[str, ClassSLO] = {
    "interactive": ClassSLO(ttft_s=0.5, itl_s=0.05, rank=0),
    "standard": ClassSLO(ttft_s=2.0, itl_s=0.2, rank=1),
    "batch": ClassSLO(ttft_s=30.0, itl_s=1.0, rank=2),
}

# role taxonomy shared by the scheduler, the gateway's pool routing and
# the RolePoolManager: frontend roles admit NEW requests, decoder roles
# accept prefill handoffs ('mixed' does both)
FRONTEND_ROLES = ("prefill", "mixed")
DECODER_ROLES = ("decode", "mixed")


def default_slo_classes() -> Dict[str, ClassSLO]:
    return dict(DEFAULT_SLO_CLASSES)


@dataclass
class EngineMetrics:
    """Snapshot consumed by gateway routing + autoscaler."""
    num_running: int = 0
    num_waiting: int = 0
    kv_utilization: float = 0.0
    tokens_per_sec: float = 0.0
    avg_latency: float = 0.0        # EWMA of per-request total latency
    avg_queue_time: float = 0.0
    admitted_requests: int = 0
    finished_requests: int = 0
    preemptions: int = 0
    prefix_hit_tokens: int = 0
    remote_hit_tokens: int = 0
    loaded_adapters: tuple = ()
    # multi-LoRA serving: requests that hit the admission gate with a
    # non-resident adapter (lora_miss), requests shed after waiting out
    # ``lora_queue_timeout_s`` (lora_shed), and the adapter-tier churn
    # the engine paid — non-resident loads, seconds stalled on them,
    # HBM-bank evictions and host-tier hits (filled by the engine, like
    # device_wait_s below)
    lora_miss: int = 0
    lora_shed: int = 0
    lora_cold_loads: int = 0
    lora_cold_load_s: float = 0.0
    lora_evictions: int = 0
    lora_host_hits: int = 0
    # SLO attainment: recent-window TTFT attainment fraction (1.0 when
    # nothing finished yet) + cumulative per-class rows of
    # (class, ttft_attainment, itl_attainment, finished)
    slo_attainment: float = 1.0
    slo_by_class: tuple = ()
    # recent-window ITL attainment (mean per-request fraction of
    # inter-token gaps within the class target) — the decode-pool
    # sizing signal for the role-pool rebalancer
    slo_itl_attainment: float = 1.0
    # tiered-KV transfer accounting (host tier + pool wire): tier
    # pressure signals for the rebalancer and dashboards
    host_hit_tokens: int = 0        # admission tokens served from host tier
    ssd_hit_tokens: int = 0         # tokens served from the SSD tier
    # host-shared SSD pool: tokens served from SSD pages some OTHER
    # engine on the host wrote (the cross-engine dedupe payoff), and
    # write-behind puts dropped on a full dirty buffer (satellite:
    # silent drops must be first-class)
    ssd_cross_hit_tokens: int = 0
    ssd_dropped_puts: int = 0
    # predictive promotion: host hits on pages the promoter prefetched
    # from SSD ahead of the predicted turn, vs promoted pages evicted
    # unused (wasted prefetch bandwidth)
    promote_hits: int = 0
    promote_wasted: int = 0
    kv_bytes_offloaded: int = 0     # device -> host (cascade + swap-out)
    kv_bytes_fetched: int = 0       # host/pool -> device (walk + swap-in)
    swap_out: int = 0               # preemptions that swapped (not dropped)
    swap_in: int = 0                # swapped requests resumed in place
    # failure handling: pool fetch/publish attempts lost to a partition
    # (after retries), generated tokens discarded by drop-and-recompute
    # resets, and recovery-log pages published by the checkpoint policy
    kv_fetch_failures: int = 0
    wasted_tokens: int = 0
    ckpt_pages: int = 0
    # speculative decoding: drafted vs model-confirmed verify tokens,
    # steps that carried drafts, and the acceptance fraction — what the
    # sim's expected-speedup pricing and the adaptive backoff key on
    spec_drafted_tokens: int = 0
    spec_accepted_tokens: int = 0
    spec_steps: int = 0
    spec_acceptance: float = 0.0
    # host/device overlap observability (filled by the real engine):
    # seconds blocked on device readback, and the fraction of step wall
    # time spent on host-side work — the gap the async loop hides
    device_wait_s: float = 0.0
    host_overhead_frac: float = 0.0


@dataclass
class SchedulerConfig:
    page_size: int = 16
    max_batch: int = 8              # decode slots / admission capacity
    max_pages_per_seq: int = 0      # 0 => unlimited (the simulator)
    chunk_size: int = 64            # chunked-prefill chunk
    chunked_prefill: bool = True
    prefix_caching: bool = True
    # -- fused mixed-batch scheduler --
    mixed_batching: bool = True     # False => legacy two-phase scheduler
    max_prefills: int = 2           # concurrent PREFILLING requests
    token_budget: int = 0           # 0 => max_batch + max_prefills*chunk
    # False => finish on max_new_tokens only (the simulator's decode
    # tokens are synthetic zeros, which a real EOS id could match)
    honor_stop_token: bool = True
    # -- P/D disaggregation --
    role: str = "mixed"             # mixed | prefill | decode
    # -- multi-LoRA serving --
    # a request whose adapter is not resident (``adapter_ready`` hook)
    # queues until the control plane loads it; after this many seconds
    # in the queue it is shed (FAILED) instead of silently serving
    # base-model outputs.  0 => queue forever.
    lora_queue_timeout_s: float = 30.0
    # -- tiered KV cache / streaming handoff --
    # pool-handoff transfers are split into groups of this many pages;
    # only the head group blocks the tail recompute, later groups are
    # marked streamable for the host to overlap.  0 => eager whole-
    # payload transfer (the pre-tier behavior).
    handoff_chunk_pages: int = 4
    # preemption offloads the victim's pages to the host tier (when one
    # is attached) and resumes from where it stopped; False restores
    # drop-and-recompute preemption even with a host tier present
    swap_preemption: bool = True
    # -- crash-recovery checkpoint policy (the recovery log) --
    # every ``ckpt_interval_tokens`` new sequence tokens, a running
    # decode's full KV blocks are published to the distributed pool
    # under their content hashes, so ``crash_takeover`` can resume the
    # request on another engine from the last checkpointed page.
    # 0 disables checkpointing (crash recovery degrades to
    # drop-and-recompute).  ``ckpt_budget_bytes`` bounds the publish
    # bytes per scheduler pass (0 => unbounded).
    ckpt_interval_tokens: int = 0
    ckpt_budget_bytes: int = 0
    # -- SLO-aware scheduling --
    # False => FIFO admission (legacy).  True => deadline-aware
    # admission: strict priority rank across classes, earliest TTFT
    # slack first within a class, priority preemption of lower-rank
    # decodes when a higher-rank prefill is about to miss TTFT.
    slo_aware: bool = False
    slo_classes: Dict[str, ClassSLO] = field(
        default_factory=default_slo_classes)
    # preempt when remaining slack < headroom * ttft target (0 still
    # preempts once the deadline has actually passed)
    slo_preempt_headroom: float = 0.25
    # minimum spacing between preemptions: bounds the decode work a
    # burst of urgent prefills can throw away
    slo_preempt_cooldown_s: float = 1.0
    # -- speculative n-gram decoding (mixed_batching only) --
    # max draft tokens proposed per decode row (0 disables).  Drafts
    # spend step budget LAST — after decode tokens and prefill chunks —
    # so prefill pressure naturally shrinks/starves them, and the
    # per-request acceptance EWMA (DraftController) backs draft length
    # off to 1 then 0 on low-acceptance outputs, re-probing every
    # ``spec_probe_interval`` passes.
    spec_tokens: int = 0
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    spec_probe_interval: int = 50

    @property
    def step_token_budget(self) -> int:
        """Per-step budget charged decode-first; it trims prefill chunks
        only — the decode batch itself is bounded by ``max_batch``, not
        the budget (a budget below ``max_batch`` + 1 cannot throttle
        decode, it just starves prefill down to its 1-token floor)."""
        return self.token_budget or (
            self.max_batch + self.max_prefills * self.chunk_size)


@dataclass
class PrefillWork:
    """One in-flight prefill's chunk for this step."""
    req: Request
    start: int          # prefill_done_tokens at schedule time
    chunk_len: int      # budget-trimmed valid tokens (0 = starved)
    pad_len: int        # padded chunk width the runner should build


@dataclass
class ScheduleOutput:
    """Declarative description of one scheduler iteration."""
    mode: str                                   # mixed|prefill|decode|idle
    decode: List[Request] = field(default_factory=list)
    prefills: List[PrefillWork] = field(default_factory=list)
    pad_len: int = 0                            # chunk width (mixed)
    # speculative drafts, parallel to ``decode`` (row i verifies
    # ``spec[i]`` draft tokens; [] = plain decode row).  Empty overall
    # when no row drafted — the runner then takes the non-spec path.
    spec: List[List[int]] = field(default_factory=list)


class SchedulerCore:
    """Request bookkeeping shared by every engine shape (paged or slot):
    arrival queue, admission/finish accounting, stop predicate, EWMAs
    and the token-throughput window."""

    SLO_WINDOW_S = 60.0      # recent-window for the scalar attainment

    def __init__(self, honor_stop_token: bool = True,
                 slo_classes: Optional[Dict[str, ClassSLO]] = None):
        self.honor_stop_token = honor_stop_token
        self.slo_classes = slo_classes or default_slo_classes()
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        # million-request runs: when set, finished requests stream into
        # this callable (e.g. a StreamingSummary observer) instead of
        # accumulating in ``finished`` — stats without holding every
        # Request object for the whole run
        self.finish_sink: Optional[Callable[[Request], None]] = None
        self._m = dict(admitted=0, finished=0, preemptions=0,
                       prefix_hit_tokens=0, remote_hit_tokens=0)
        self._lat_ewma = 0.0
        self._q_ewma = 0.0
        self._tok_events: List[tuple] = []
        # per-class cumulative SLO accounting + recent TTFT-attainment
        # events (for the autoscaler's windowed slo_attainment signal)
        self._slo_stats: Dict[str, dict] = {}
        self._slo_events: List[tuple] = []
        # recent per-request ITL-attainment fractions — TTFT misses
        # point at prefill capacity, ITL misses at decode capacity, so
        # the role-pool rebalancer needs both windowed separately
        self._itl_events: List[tuple] = []

    # ---------------------------------------------------------- queue
    def enqueue(self, req: Request, now: float) -> None:
        if req.arrival_time == 0.0:
            req.arrival_time = now
        self.waiting.append(req)

    def note_admitted(self, req: Request, now: float) -> None:
        req.schedule_time = now
        self._m["admitted"] += 1
        self._q_ewma = 0.9 * self._q_ewma + 0.1 * req.queue_time

    # ---------------------------------------------------------- finish
    def request_done(self, req: Request) -> bool:
        sp = req.sampling
        if len(req.output_tokens) >= sp.max_new_tokens:
            return True
        return (self.honor_stop_token and sp.stop_token is not None
                and bool(req.output_tokens)
                and req.output_tokens[-1] == sp.stop_token)

    def note_finished(self, req: Request, now: float) -> None:
        req.finish_time = now
        req.state = RequestState.FINISHED
        if self.finish_sink is not None:
            self.finish_sink(req)
        else:
            self.finished.append(req)
        self._m["finished"] += 1
        self._lat_ewma = (0.9 * self._lat_ewma + 0.1 * req.total_latency
                          if self._lat_ewma else req.total_latency)
        self._note_slo(req, now)

    # ---------------------------------------------------------- SLO
    def slo_class(self, req: Request) -> ClassSLO:
        """The request's SLO targets; unknown classes fall back to
        'standard' so a typo'd class cannot crash the scheduler."""
        cls = self.slo_classes.get(req.priority_class)
        if cls is None:
            cls = self.slo_classes.get("standard",
                                       DEFAULT_SLO_CLASSES["standard"])
        return cls

    def _note_slo(self, req: Request, now: float) -> None:
        cls = self.slo_class(req)
        rec = self._slo_stats.setdefault(
            req.priority_class,
            dict(finished=0, ttft_ok=0, itl_total=0, itl_ok=0))
        ttft_ok = req.ttft <= cls.ttft_s
        rec["finished"] += 1
        rec["ttft_ok"] += int(ttft_ok)
        gaps = req.itl
        rec["itl_total"] += len(gaps)
        itl_ok = sum(1 for g in gaps if g <= cls.itl_s)
        rec["itl_ok"] += itl_ok
        self._slo_events.append((now, req.priority_class,
                                 1.0 if ttft_ok else 0.0))
        if gaps:
            self._itl_events.append((now, req.priority_class,
                                     itl_ok / len(gaps)))
        cutoff = now - self.SLO_WINDOW_S
        while self._slo_events and self._slo_events[0][0] < cutoff:
            self._slo_events.pop(0)
        while self._itl_events and self._itl_events[0][0] < cutoff:
            self._itl_events.pop(0)

    def slo_attainment(self, now: float) -> float:
        """TTFT attainment over the recent window; falls back to the
        cumulative fraction after a drain, 1.0 before any finish."""
        window = [ok for t, _c, ok in self._slo_events
                  if t >= now - self.SLO_WINDOW_S]
        if window:
            return sum(window) / len(window)
        fin = sum(r["finished"] for r in self._slo_stats.values())
        if fin:
            return (sum(r["ttft_ok"] for r in self._slo_stats.values())
                    / fin)
        return 1.0

    def slo_itl_attainment(self, now: float) -> float:
        """ITL attainment over the recent window (mean per-request
        fraction of inter-token gaps within target); falls back to the
        cumulative fraction after a drain, 1.0 before any finish."""
        window = [ok for t, _c, ok in self._itl_events
                  if t >= now - self.SLO_WINDOW_S]
        if window:
            return sum(window) / len(window)
        tot = sum(r["itl_total"] for r in self._slo_stats.values())
        if tot:
            return (sum(r["itl_ok"] for r in self._slo_stats.values())
                    / tot)
        return 1.0

    def slo_class_stats(self, now: Optional[float] = None) -> tuple:
        """(class, ttft_attainment, itl_attainment, finished) rows.
        With ``now``, TTFT attainment is computed over the recent
        window (what the slo-aware router should react to — an engine
        must not be penalized forever for a warm-up burst of misses),
        falling back to cumulative once the window is empty; without
        ``now`` (and for ITL/finished) the figures are cumulative."""
        rows = []
        for name in sorted(self._slo_stats):
            r = self._slo_stats[name]
            ttft_att = r["ttft_ok"] / max(r["finished"], 1)
            if now is not None:
                window = [ok for t, c, ok in self._slo_events
                          if c == name and t >= now - self.SLO_WINDOW_S]
                if window:
                    ttft_att = sum(window) / len(window)
            rows.append((name, ttft_att,
                         (r["itl_ok"] / r["itl_total"]
                          if r["itl_total"] else 1.0),
                         r["finished"]))
        return tuple(rows)

    # ---------------------------------------------------------- accessors
    @property
    def avg_latency(self) -> float:
        return self._lat_ewma

    @property
    def avg_queue_time(self) -> float:
        return self._q_ewma

    @property
    def admitted_count(self) -> int:
        return self._m["admitted"]

    @property
    def finished_count(self) -> int:
        return self._m["finished"]

    # ---------------------------------------------------------- tokens
    def note_tokens(self, now: float, n: int) -> None:
        self._tok_events.append((now, n))
        cutoff = now - 10.0
        while self._tok_events and self._tok_events[0][0] < cutoff:
            self._tok_events.pop(0)

    def throughput(self, now: float) -> float:
        return window_throughput(self._tok_events, now)


class Scheduler(SchedulerCore):
    """The paged-KV scheduler: one admission/budget/role implementation
    for the real JAX engine AND the cluster simulator.

    The KV tiers are consulted by the scheduler itself
    (``host_pool``/``kv_pool``/``engine_id``): the page walk — which
    blocks to ask for, in which tier, where to stop, allocation and
    hash registration — lives here, once.  Only the payload handling
    differs per host, via ``install_page(page_id, payload, req, now, *,
    source="host"|"pool", stream=bool, nbytes=int)``: the real engine
    writes the fetched arrays into a device page (ignoring the cost
    hints), the simulator attributes a transfer-time cost from them.
    ``page_payload(page_id)`` is the reverse hook (offload/publish
    materialization).
    """

    ROLES = ("mixed", "prefill", "decode")
    # process-wide LoRA-miss counter across every Scheduler instance —
    # benchmarks/run.py prints the per-suite delta so a suite whose
    # requests queued (or shed) behind non-resident adapters says so
    # next to its results
    total_lora_miss: int = 0

    def __init__(self, scfg: SchedulerConfig, alloc: PageAllocator,
                 kv_pool=None, engine_id: str = "engine-0",
                 install_page: Optional[Callable] = None,
                 publish_page: Optional[Callable] = None,
                 host_pool=None, page_payload: Optional[Callable] = None,
                 page_bytes: int = 0,
                 adapter_ready: Optional[Callable[[str], bool]] = None,
                 ssd_pool=None):
        super().__init__(honor_stop_token=scfg.honor_stop_token,
                         slo_classes=scfg.slo_classes)
        if scfg.role not in self.ROLES:
            raise ValueError(f"unknown scheduler role {scfg.role!r}; "
                             f"expected one of {self.ROLES}")
        self.scfg = scfg
        self.alloc = alloc
        self.kv_pool = kv_pool
        self.engine_id = engine_id
        self.install_page = install_page
        self.publish_page = publish_page
        # tiered KV: optional host-DRAM page tier between the device
        # allocator and the distributed pool.  ``page_payload(pid)``
        # materializes a device page for offload (real engines copy
        # the arrays off-device, the simulator returns an opaque
        # record); ``page_bytes`` is the raw per-page payload size the
        # transfer counters and capacity checks use.
        self.host_pool = host_pool
        # SSD third tier below host DRAM: host-tier capacity evictions
        # cascade into it (write-behind), and the admission walk/swap
        # resume consult it after host, before the distributed pool
        self.ssd_pool = ssd_pool
        self.page_payload = page_payload
        self.page_bytes = int(page_bytes)
        self._m.update(host_hit_tokens=0, ssd_hit_tokens=0,
                       ssd_cross_hit_tokens=0,
                       promote_hits=0, promote_wasted=0,
                       kv_bytes_offloaded=0,
                       kv_bytes_fetched=0, swap_out=0, swap_in=0,
                       kv_fetch_failures=0, wasted_tokens=0, ckpt_pages=0,
                       crash_resumes=0, spec_drafted_tokens=0,
                       spec_accepted_tokens=0, spec_steps=0,
                       lora_miss=0, lora_shed=0)
        # predictive promotion state: the block hashes of each finished
        # session's full-page prefix (what the next turn's walk will
        # ask for), and the host-tier keys the promoter parked there
        # but no request has touched yet (key -> session_id)
        self._session_pages: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()
        self._promoted: Dict[str, str] = {}
        # multi-LoRA admission gate: ``adapter_ready(name) -> bool``
        # reports adapter residency on this engine's data plane.  When
        # set, a request naming a non-resident adapter queues (counted
        # as a lora_miss, once) until the control plane loads it —
        # never silently serving base-model outputs — and is shed after
        # ``scfg.lora_queue_timeout_s`` in the queue.
        self.adapter_ready = adapter_ready
        # speculative n-gram drafting: the controller owns the adaptive
        # per-request draft-length policy (acceptance EWMA + probe)
        self.drafter = DraftController(
            max_draft=scfg.spec_tokens,
            ngram_max=scfg.spec_ngram_max,
            ngram_min=scfg.spec_ngram_min,
            probe_interval=scfg.spec_probe_interval) \
            if scfg.spec_tokens > 0 else None
        # pool-failure circuit breaker: after a failed fetch/publish
        # burst the scheduler stops talking to the pool until the
        # backoff deadline (exponential, reset on the next success)
        self._pool_backoff_until = float("-inf")
        self._pool_backoff_s = 0.0
        if host_pool is not None and page_payload is not None:
            # eviction cascade: device-cache victims fall into the host
            # tier (same block hashes) instead of being dropped
            alloc.on_evict = self._cascade_evict
            if ssd_pool is not None:
                # ...and host-tier victims fall one more level, into
                # the SSD write-behind tier, instead of being dropped
                host_pool.on_evict = self._host_evict
        self.prefills: List[Request] = []      # concurrent PREFILLING
        self.running: List[Request] = []
        # P/D handoff: host-provided delivery callable (a decode engine's
        # submit, or a load-balancing shim over several)
        self.handoff: Optional[Callable[[Request], None]] = None
        self._pending_handoff = 0
        self._last_preempt = -1e18      # SLO preemption cooldown clock
        # live role migration: a draining engine admits nothing new and
        # finishes in-flight work so the control plane can flip its role
        self.draining = False

    # ---------------------------------------------------------- views
    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.prefills
                    or self._pending_handoff)

    @property
    def wants_handoff(self) -> bool:
        return self.scfg.role == "prefill" and self.handoff is not None

    @property
    def drained(self) -> bool:
        """True when nothing admitted remains: safe to flip roles."""
        return not (self.waiting or self.prefills or self.running
                    or self._pending_handoff)

    # ------------------------------------------------------- role migration
    def set_role(self, role: str) -> None:
        """Flip this engine's serving role (live P/D migration).  Only
        legal on a drained engine — admitted work holds pages and
        handoff obligations that belong to the old role, so the control
        plane drains first (``draining`` + ``takeover_waiting``)."""
        if role not in self.ROLES:
            raise ValueError(f"unknown scheduler role {role!r}; "
                             f"expected one of {self.ROLES}")
        if not self.drained:
            raise RuntimeError(
                f"set_role({role!r}): engine has queued or admitted "
                "work; drain first (takeover_waiting + finish in-"
                "flight)")
        self.scfg.role = role

    def takeover_waiting(self) -> List[Request]:
        """Drain support: hand the not-yet-admitted queue back to the
        control plane so it can re-route the requests to another pool
        member (in-flight prefills are NOT touched — they finish here
        and leave through the normal pool-handoff path).  SWAPPED
        requests are re-routable too, but their parked KV lives in
        THIS engine's host tier — drop it and reset them to recompute
        on whichever member picks them up."""
        reqs, self.waiting = list(self.waiting), []
        for r in reqs:
            if r.state is RequestState.SWAPPED:
                self._drop_swap(r)
                self._reset_recompute(r)
        return reqs

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.scfg.page_size)

    def _first_hash(self, req: Request) -> Optional[str]:
        hs = chunk_hashes(req.prompt_tokens[:self.scfg.page_size],
                          self.scfg.page_size,
                          req.lora_adapter or "")
        return hs[0] if hs else None

    # ------------------------------------------------------- SLO ordering
    def slack(self, req: Request, now: float) -> float:
        """Seconds of TTFT headroom left (negative = deadline missed)."""
        return self.slo_class(req).ttft_s - (now - req.arrival_time)

    def _admission_key(self, now: float):
        """Deadline-aware admission order: strict priority rank across
        classes (livelock-free — a preempted batch request can never
        leapfrog a waiting interactive one), earliest TTFT slack first
        within a class, then arrival order."""
        return lambda r: (self.slo_class(r).rank, self.slack(r, now),
                          r.arrival_time, r.request_id)

    # ------------------------------------------------------- admission
    def try_admit(self, now: float) -> Optional[Request]:
        scfg = self.scfg
        if self.draining:
            return None     # migrating out: nothing new is admitted
        if not self.waiting or (len(self.running) + len(self.prefills)
                                >= scfg.max_batch):
            return None
        inflight_hashes = set()
        if scfg.prefix_caching and self.prefills:
            inflight_hashes = {self._first_hash(p) for p in self.prefills}
            inflight_hashes.discard(None)
        candidates = list(self.waiting)
        if scfg.slo_aware:
            candidates.sort(key=self._admission_key(now))
        req = None
        for cand in candidates:
            if cand.state is RequestState.SWAPPED:
                continue    # resumes through _try_resume, not admission
            if (self.adapter_ready is not None and cand.lora_adapter
                    and not self.adapter_ready(cand.lora_adapter)):
                # loud LoRA miss: the adapter is not resident, so this
                # request must wait for the control plane to load it
                # (only this request — later waiters still get the
                # slot), or be shed once it has waited out the timeout
                if not getattr(cand, "_lora_missed", False):
                    cand._lora_missed = True
                    self._m["lora_miss"] += 1
                    Scheduler.total_lora_miss += 1
                if (scfg.lora_queue_timeout_s > 0
                        and now - cand.arrival_time
                        > scfg.lora_queue_timeout_s):
                    cand.state = RequestState.FAILED
                    self.waiting.remove(cand)
                    self._m["lora_shed"] += 1
                continue
            total = cand.prompt_len + cand.sampling.max_new_tokens
            if (scfg.max_pages_per_seq
                    and self.pages_for(total) > scfg.max_pages_per_seq):
                cand.state = RequestState.FAILED
                self.waiting.remove(cand)
                continue
            if (inflight_hashes
                    and cand.prompt_len > scfg.page_size
                    and self._first_hash(cand) in inflight_hashes
                    and self.alloc.match_len(
                        cand.prompt_tokens,
                        cand.lora_adapter or "") == 0):
                # cache-aware admission: a prompt sharing its leading
                # block with an in-flight prefill waits for those pages
                # to register so it can reuse them instead of
                # recomputing the prefix — but only THAT request waits
                # (later waiters with distinct prefixes still get the
                # slot), and only when the wait can pay off: not when a
                # registered prefix already matches, nor when the prompt
                # is too short for match_prefix to ever reuse the block.
                continue
            req = cand
            break
        if req is None:
            return None
        if getattr(req, "_resume_decode", False):
            # crash-rewound decode victim: resume from the recovery log
            if self.wants_handoff:
                # a prefill-role engine can't host the decode; degrade
                # to a plain prefill+handoff of the original prompt
                req._resume_decode = False
                self._reset_recompute(req)
            else:
                got = self._admit_continuation(req, now)
                if got is not _RECOMPUTE:
                    return got      # admitted, or out of memory (None)
                # the pool no longer covers the checkpoint (partition
                # or eviction): degrade to full recompute below
                req._resume_decode = False
                self._reset_recompute(req)
        # a handoff-bound prefill engine never decodes: reserving pages
        # for the decode tokens would only shrink its prefill capacity
        # (the decode side allocates them at re-admission)
        total = req.prompt_len + (
            0 if self.wants_handoff else req.sampling.max_new_tokens)
        matched_pages: List[int] = []
        matched_tokens = 0
        if scfg.prefix_caching:
            matched_pages, matched_tokens = self.alloc.match_prefix(
                req.prompt_tokens, now, req.lora_adapter or "")
        local_tokens = matched_tokens
        # the lower tiers work even when engine-local prefix caching is
        # off (the paper's "KV cache + Default" rows): cross-engine
        # reuse is the pool's, not the engine's, feature
        fetched: List[tuple] = []
        if self.kv_pool is not None or self.host_pool is not None:
            rp, rt, fetched = self._pool_walk(req, matched_tokens, now)
            matched_pages += rp
            matched_tokens += rt
        need = self.pages_for(total) - len(matched_pages)
        fresh = self.alloc.allocate(need, now)
        if fresh is None:
            if scfg.prefix_caching and fetched:
                # keep the paid-for transfers: install + register the
                # fetched pages, then release them into the evictable
                # cache so the retry hits them locally via match_prefix
                # instead of re-fetching from the pool every step
                self._apply_fetched(fetched, req, now)
            self.alloc.release(matched_pages, now)
            return None     # no memory — stay queued
        # admission succeeded: only now install the fetched payloads
        # and count the remote hits (a retry after memory pressure must
        # not double-count them)
        self._apply_fetched(fetched, req, now)
        self.waiting.remove(req)
        req.page_ids = matched_pages + fresh
        req.cached_prefix_tokens = matched_tokens
        req.prefill_done_tokens = matched_tokens
        req.state = RequestState.PREFILLING
        self.note_admitted(req, now)
        self._m["prefix_hit_tokens"] += local_tokens
        return req

    def _pool_walk(self, req: Request, have_tokens: int, now: float
                   ) -> Tuple[List[int], int, List[tuple]]:
        """Extend a local prefix hit with pages from the lower tiers:
        walk the prompt's block hashes past the locally covered prefix,
        checking host DRAM, then the SSD tier, then the distributed
        pool (device -> host -> SSD -> distributed is the admission
        order) and allocating a local page per hit.  The tail block is
        never fetched (prefill must produce at least one new token),
        and the walk stops at the first miss in EVERY tier.

        Payload installation and hash registration are DEFERRED — the
        (page, hash, payload, source) tuples are returned for the
        caller to apply only once admission succeeds.  (Hash
        registration with local prefix caching off would also let a
        re-fetch of the same hash clobber hash_index while the stale
        page's eviction later deletes the live entry, so it is
        additionally gated on ``prefix_caching``.)"""
        ps = self.scfg.page_size
        hashes = chunk_hashes(req.prompt_tokens, ps,
                              req.lora_adapter or "")
        pages, tokens, fetched = [], 0, []
        for i in range(have_tokens // ps, len(hashes)):
            if (i + 1) * ps >= req.prompt_len:
                break
            payload, source, nbytes = self._tier_fetch(hashes[i], now)
            if payload is None:
                break
            pids = self.alloc.allocate(1, now)
            if not pids:
                break
            nbytes = payload_nbytes(payload, nbytes)
            fetched.append((pids[0], hashes[i], payload, source, nbytes))
            pages.append(pids[0])
            tokens += ps
        return pages, tokens, fetched

    def _tier_fetch(self, block_hash: str, now: float) -> Tuple:
        """One block's tier walk below the device: host DRAM, then the
        SSD write-behind tier, then the distributed pool.  Returns
        ``(payload, source, nbytes)`` with ``payload=None`` on a miss
        in every tier."""
        payload, source, nbytes = None, "host", self.page_bytes
        if self.host_pool is not None:
            payload = self.host_pool.get(block_hash, now)
        if payload is None and self.ssd_pool is not None:
            payload = self.ssd_pool.get(block_hash, now)
            if payload is not None:
                # a SharedSSDView flags hits on pages another engine on
                # this host wrote; "ssd-cross" is normalized back to
                # "ssd" before it reaches install_page
                source = "ssd-cross" if getattr(
                    self.ssd_pool, "last_get_cross", False) else "ssd"
        if payload is None and self.kv_pool is not None:
            payload = self._pool_fetch(block_hash, now)
            # stored wire size, NOT the raw page: int8-compressed
            # payloads move (and are charged as) fewer bytes
            nbytes = (self.kv_pool.size_of(block_hash)
                      or self.page_bytes)
            source = "pool"
        return payload, source, nbytes

    def _admit_continuation(self, req: Request, now: float):
        """Admit a crash-rewound decode victim by restoring its
        checkpointed KV and rejoining the decode batch directly,
        swap-in style.  EVERY covered page is fetched — including the
        final one, whose KV was decode-computed on the dead engine:
        re-prefilling it would subtly change the numerics and break
        byte-identical greedy resume.  Returns the request on success,
        ``None`` when out of memory (stay queued and retry), or the
        ``_RECOMPUTE`` sentinel when the pool no longer covers the
        checkpoint (caller degrades to full recompute)."""
        ps = self.scfg.page_size
        seq = list(req.prompt_tokens) + [int(t) for t in
                                         req.output_tokens]
        npages = len(seq) // ps
        if npages == 0 or npages * ps != len(seq):
            return _RECOMPUTE       # rewind always leaves page-aligned
        hashes = chunk_hashes(seq, ps, req.lora_adapter or "")
        fetched: List[tuple] = []
        pages: List[int] = []
        missing = False
        for i in range(npages):
            payload, source, nbytes = self._tier_fetch(hashes[i], now)
            if payload is None:
                missing = True
                break
            pids = self.alloc.allocate(1, now)
            if not pids:
                break               # no memory — stay queued
            fetched.append((pids[0], hashes[i], payload, source,
                            payload_nbytes(payload, nbytes)))
            pages.append(pids[0])
        if len(pages) < npages:
            self.alloc.release(pages, now)
            return _RECOMPUTE if missing else None
        total = req.prompt_len + req.sampling.max_new_tokens
        fresh = self.alloc.allocate(
            max(self.pages_for(total) - npages, 0), now)
        if fresh is None:
            self.alloc.release(pages, now)
            return None             # no memory — stay queued
        self._apply_fetched(fetched, req, now)
        self.waiting.remove(req)
        req.page_ids = pages + fresh
        req.cached_prefix_tokens = len(seq)
        req.prefill_done_tokens = req.prompt_len
        req._resume_decode = False  # type: ignore[attr-defined]
        req.state = RequestState.RUNNING
        self.running.append(req)
        self.note_admitted(req, now)
        self._m["crash_resumes"] += 1
        # a victim rewound onto its very last token is already done
        self.maybe_finish(req, now)
        return req

    # ------------------------------------------------ pool fault isolation
    POOL_RETRIES = 2            # in-line attempts before giving up
    POOL_BACKOFF_S = 0.5        # first backoff window after a failure
    POOL_BACKOFF_MAX_S = 8.0

    def _pool_fetch(self, block_hash: str, now: float):
        """``kv_pool.fetch`` behind a bounded retry + circuit breaker.
        A partitioned pool raises :class:`KVPoolError`; the walk must
        degrade to recompute, never crash the scheduler.  Failures
        open an exponential backoff window during which the pool is
        not consulted at all (every admission would otherwise pay the
        retry cost while the partition lasts)."""
        if now < self._pool_backoff_until:
            return None
        for _ in range(self.POOL_RETRIES):
            try:
                payload = self.kv_pool.fetch(block_hash, self.engine_id,
                                             now)
                self._pool_backoff_s = 0.0
                return payload
            except KVPoolError:
                continue
        self._note_pool_failure(now)
        return None

    def _pool_publish(self, pid: int, block_hash: str, req: Request,
                      now: float) -> bool:
        """``publish_page`` behind the same circuit breaker (a publish
        into a partitioned pool raises too).  Returns False when the
        publish did not happen."""
        if now < self._pool_backoff_until:
            return False
        try:
            self.publish_page(pid, block_hash, req, now)
            self._pool_backoff_s = 0.0
            return True
        except KVPoolError:
            self._note_pool_failure(now)
            return False

    def _note_pool_failure(self, now: float) -> None:
        self._m["kv_fetch_failures"] += 1
        self._pool_backoff_s = min(
            max(self._pool_backoff_s * 2, self.POOL_BACKOFF_S),
            self.POOL_BACKOFF_MAX_S)
        self._pool_backoff_until = now + self._pool_backoff_s

    def _apply_fetched(self, fetched: List[tuple], req: Request,
                       now: float) -> None:
        """Install the walk's deferred payloads, register their hashes
        (when locally cacheable) and count the per-tier hits.  The
        transfer is chunked into ``handoff_chunk_pages`` page groups:
        pages past the head group are handed to ``install_page`` with
        ``stream=True`` — the host may overlap them with the tail
        recompute (the simulator prices exactly that overlap)."""
        cp = self.scfg.handoff_chunk_pages
        ps = self.scfg.page_size
        for n, (pid, h, payload, source, nbytes) in enumerate(fetched):
            cross = source == "ssd-cross"
            src = "ssd" if cross else source
            if self.install_page is not None:
                self.install_page(pid, payload, req, now, source=src,
                                  stream=bool(cp) and n >= cp,
                                  nbytes=nbytes)
            if self.scfg.prefix_caching:
                self.alloc.register_hash(pid, h)
            if src == "pool":
                self._m["remote_hit_tokens"] += ps
            elif src == "ssd":
                self._m["ssd_hit_tokens"] += ps
                if cross:
                    self._m["ssd_cross_hit_tokens"] += ps
            else:
                self._m["host_hit_tokens"] += ps
                if self._promoted.pop(h, None) is not None:
                    # the promoter's prefetch paid off: this page was
                    # already in host DRAM when the turn landed
                    self._m["promote_hits"] += 1
            self._m["kv_bytes_fetched"] += nbytes

    def _cascade_evict(self, pid: int, block_hash: str,
                       now: float) -> None:
        """PageAllocator eviction hook: offload the victim page into
        the host tier (content-addressed by the same block hash)
        instead of dropping it."""
        if self.host_pool.contains(block_hash):
            return
        if self.host_pool.put(block_hash, self.page_payload(pid),
                              self.page_bytes, now):
            self._m["kv_bytes_offloaded"] += self.page_bytes

    def _host_evict(self, key: str, payload, nbytes: int,
                    now: float) -> None:
        """HostPagePool eviction hook: a host-tier victim (cache page
        OR parked swap entry) falls into the SSD write-behind tier
        instead of dropping — idle-session prefixes survive host
        pressure and resume from SSD."""
        if self._promoted.pop(key, None) is not None:
            # a promoted page evicted before any request touched it:
            # the prefetch spent SSD+DRAM bandwidth for nothing
            self._m["promote_wasted"] += 1
        # put unconditionally: a resident key is a cheap dup (refreshes
        # LRU, no rewrite) and on a host-shared pool it is exactly the
        # write another engine's copy absorbed — the dedupe metric
        self.ssd_pool.put(key, payload, nbytes, now)

    # ------------------------------------------------------- schedule
    def schedule(self, now: float) -> ScheduleOutput:
        """One scheduler iteration, declaratively.

        Mixed batching (default): admit up to ``max_prefills`` requests
        into PREFILLING, then emit ONE fused pass carrying every decode
        token plus a budget-trimmed chunk per in-flight prefill.
        Legacy (``mixed_batching=False``): one prefill at a time, decode
        only when no prefill is in flight.
        """
        scfg = self.scfg
        self._try_resume(now)   # swapped victims outrank new admissions
        self._maybe_checkpoint(now)
        if not scfg.mixed_batching:
            return self._schedule_two_phase(now)
        self._admit_prefills(now)
        if scfg.slo_aware and self.waiting and self._slo_preempt(now):
            self._admit_prefills(now)   # the freed slot admits the
            # urgent request in the same iteration, not the next one
        if not self.prefills:
            if not self.running:
                return ScheduleOutput(mode="idle")
            dec = self.running[:scfg.max_batch]
            spec = self._assign_drafts(
                dec, scfg.step_token_budget - len(dec))
            return ScheduleOutput(mode="decode", decode=dec, spec=spec)
        dec = self.running[:scfg.max_batch]
        # decode tokens spend the budget first; floor of 1 guarantees an
        # in-flight prefill always progresses (liveness under a budget
        # tighter than the decode batch).
        budget = max(scfg.step_token_budget - len(dec), 1)
        if scfg.chunked_prefill:
            s = scfg.chunk_size
        else:
            s = max(max(p.prompt_len - p.prefill_done_tokens
                        for p in self.prefills), 1)
        # trim each in-flight prefill's chunk to the remaining budget
        # (whole-prompt prefill is budget-exempt by definition)
        works = []
        for p in self.prefills:
            c = min(s, p.prompt_len - p.prefill_done_tokens)
            if scfg.chunked_prefill:
                c = min(c, budget)
            budget -= c
            works.append(PrefillWork(p, p.prefill_done_tokens, c, s))
        if not dec and len(works) == 1:
            # a lone prefill with nothing decoding (a prefill-role pod,
            # or an engine's first step) skips the fused pass — it
            # would carry max_batch dummy decode lanes of compute
            return ScheduleOutput(mode="prefill", prefills=works,
                                  pad_len=s)
        # drafts spend whatever budget the prefill chunks left over —
        # prefill admission can never be starved by drafting
        spec = self._assign_drafts(dec, max(budget, 0))
        return ScheduleOutput(mode="mixed", decode=dec, prefills=works,
                              pad_len=s, spec=spec)

    def _assign_drafts(self, dec: List[Request],
                       budget: int) -> List[List[int]]:
        """Prompt-lookup drafts for the decode rows, spending at most
        the leftover ``budget`` (one token of budget per draft token).
        Returns [] — the non-spec fast path — when no row drafted."""
        if (self.drafter is None or not self.scfg.mixed_batching
                or not dec or budget <= 0):
            return []
        spec, any_draft = [], False
        for r in dec:
            if getattr(r, "_pending_toks", 0):
                # async loop: unresolved placeholder in the history —
                # this schedule pass is a provisional plan, don't draft
                spec.append([])
                continue
            d = self.drafter.propose(r, budget)
            budget -= len(d)
            any_draft = any_draft or bool(d)
            spec.append(d)
        return spec if any_draft else []

    def _admit_prefills(self, now: float) -> None:
        scfg = self.scfg
        while (len(self.prefills) < scfg.max_prefills
               and len(self.prefills) * scfg.chunk_size
               + min(len(self.running), scfg.max_batch)
               < scfg.step_token_budget):
            req = self.try_admit(now)
            if req is None:
                break
            if req.state is RequestState.RUNNING:
                continue    # crash-rewound continuation: already decoding
            self.prefills.append(req)

    def _slo_preempt(self, now: float) -> bool:
        """Priority-aware preemption: when the most urgent waiting
        request could not be admitted and its TTFT slack has shrunk
        below ``slo_preempt_headroom`` of its target, evict ONE
        strictly-lower-priority decode (highest rank first, then the
        one with the least generated work to throw away).  Rate-limited
        by ``slo_preempt_cooldown_s``; preemption only ever crosses
        class ranks downward, so it cannot livelock with the strict-
        priority admission order."""
        scfg = self.scfg
        if (not self.waiting or not self.running
                or now - self._last_preempt < scfg.slo_preempt_cooldown_s):
            return False
        if scfg.mixed_batching and len(self.prefills) >= scfg.max_prefills:
            return False    # a freed decode slot cannot admit anyway
        # SWAPPED waiters re-enter through _try_resume, never through
        # try_admit — preempting on their behalf would just swap one
        # victim out to resume another at the front of the queue (churn)
        admissible = [r for r in self.waiting
                      if r.state is not RequestState.SWAPPED]
        if not admissible:
            return False
        cand = min(admissible, key=self._admission_key(now))
        need = self.pages_for(cand.prompt_len + (
            0 if self.wants_handoff else cand.sampling.max_new_tokens))
        if (len(self.running) + len(self.prefills) < scfg.max_batch
                and self.alloc.num_free >= need):
            return False    # not capacity-blocked (a slot is open and
            # pages suffice even ignoring prefix hits, so the stall is
            # e.g. cache-aware deferral) — evicting a decode won't help
        ccls = self.slo_class(cand)
        if self.slack(cand, now) > scfg.slo_preempt_headroom * ccls.ttft_s:
            return False
        victims = [r for r in self.running
                   if self.slo_class(r).rank > ccls.rank]
        if not victims:
            return False
        victim = max(victims, key=lambda r: (self.slo_class(r).rank,
                                             -len(r.output_tokens),
                                             r.arrival_time))
        self.preempt(victim, now)
        self._last_preempt = now
        return True

    def _schedule_two_phase(self, now: float) -> ScheduleOutput:
        scfg = self.scfg
        if not self.prefills:
            req = self.try_admit(now)
            if (req is None and scfg.slo_aware and self.waiting
                    and self._slo_preempt(now)):
                req = self.try_admit(now)
            if req is not None and req.state is not RequestState.RUNNING:
                self.prefills.append(req)
        if self.prefills:
            req = self.prefills[0]
            s = scfg.chunk_size if scfg.chunked_prefill else \
                max(req.prompt_len, 1)
            start = req.prefill_done_tokens
            c = min(s, req.prompt_len - start)
            return ScheduleOutput(mode="prefill",
                                  prefills=[PrefillWork(req, start, c, s)],
                                  pad_len=s)
        if self.running:
            return ScheduleOutput(mode="decode",
                                  decode=self.running[:scfg.max_batch])
        return ScheduleOutput(mode="idle")

    # --------------------------------------------------- prefill bookkeeping
    def register_prompt_pages(self, req: Request, now: float) -> None:
        """Hash-register the finished prompt's pages for local reuse
        and publish them to the distributed pool.  One walk for every
        engine; only the payload differs, via the host's
        ``publish_page(page_id, block_hash, req, now)`` hook.
        Publishing happens even when engine-local prefix caching is off
        — cross-engine reuse is the pool's feature, not the engine's —
        and is skipped when the pool already knows the hash (a
        duplicate would be dropped at the metadata layer anyway, after
        the payload was materialized for nothing)."""
        if not self.scfg.prefix_caching and self.kv_pool is None:
            return
        hashes = chunk_hashes(req.prompt_tokens, self.scfg.page_size,
                              req.lora_adapter or "")
        for i, h in enumerate(hashes):
            pid = req.page_ids[i]
            if (self.scfg.prefix_caching
                    and self.alloc.pages[pid].block_hash is None):
                self.alloc.register_hash(pid, h)
            # the pool check runs even for blocks already registered
            # locally: the pool may have evicted them since their last
            # publish, and a handoff needs them present again
            if (self.kv_pool is not None and self.publish_page is not None
                    and not self.kv_pool.contains(h)):
                self._pool_publish(pid, h, req, now)

    def note_prefill_progress(self, req: Request, chunk_len: int) -> bool:
        """Advance a prefill by ``chunk_len`` tokens; True when the whole
        prompt is in the KV pages (the request leaves PREFILLING)."""
        req.prefill_done_tokens += chunk_len
        if req.prefill_done_tokens >= req.prompt_len:
            if req in self.prefills:
                self.prefills.remove(req)
            return True
        return False

    def finish_prefill(self, req: Request, tok: int, now: float) -> None:
        """Prefill complete on a mixed/decode engine: record the first
        sampled token and move the request to the decode batch."""
        req.output_tokens.append(int(tok))
        if req.first_token_time:
            req.token_times.append(now)      # migrated-in continuation
        else:
            req.first_token_time = now
        req.state = RequestState.RUNNING
        self.running.append(req)
        self.maybe_finish(req, now)

    def handoff_prefill(self, req: Request, now: float) -> None:
        """Disaggregated prefill complete: KV lives in the pool, so free
        this engine's pages and reset the request for re-admission on a
        decode engine.  The host delivers it (``deliver_handoff``) —
        synchronously for real engines, after the pool's metadata lag
        for the simulator, tracked so drain predicates don't observe a
        momentarily idle pair."""
        self.alloc.release(req.page_ids, now)
        req.page_ids = []
        req.state = RequestState.QUEUED
        req.prefill_done_tokens = 0
        self._pending_handoff += 1
        # a prefill pod's throughput IS prefilled prompt tokens — the
        # same accounting on the real engine and the simulator
        self.note_tokens(now, req.prompt_len)

    def deliver_handoff(self, req: Request) -> None:
        self._pending_handoff -= 1
        self.handoff(req)

    # ---------------------------------------------------- decode bookkeeping
    def on_decode_batch(self, reqs: List[Request], toks, now: float) -> None:
        """Record one decode token per request: grow pages across the
        page boundary (preempting on allocation failure), finish/stop."""
        for i, r in enumerate(reqs):
            r.output_tokens.append(int(toks[i]))
            r.token_times.append(now)
            nxt = r.prompt_len + len(r.output_tokens)
            if self.pages_for(nxt + 1) > len(r.page_ids):
                pid = self.alloc.allocate(1, now)
                if pid is None:
                    self.preempt(r, now)
                    continue
                r.page_ids += pid
            self.maybe_finish(r, now)
        self.note_tokens(now, len(reqs))

    def on_spec_batch(self, reqs: List[Request], spec: List[List[int]],
                      emitted: List[List[int]], now: float) -> int:
        """Record a speculative step's verified tokens.  Row ``i``
        drafted ``spec[i]`` and the runner's verification emitted
        ``emitted[i]`` model-sampled tokens (accepted prefix + the
        bonus/correction sample).  Tokens append one at a time through
        the same page-growth / finish checks as :meth:`on_decode_batch`
        — a stop token mid-emission finishes the request and drops the
        rest (byte-identity with step-by-step decoding); the rejected
        drafts' stale KV slots are never attended (lengths-bounded
        attention) and are overwritten when real tokens land there."""
        total = 0
        for r, drafts, toks in zip(reqs, spec, emitted):
            accepted = max(min(len(toks) - 1, len(drafts)), 0)
            if self.drafter is not None:
                self.drafter.observe(r, len(drafts), accepted)
            self._m["spec_drafted_tokens"] += len(drafts)
            if drafts:
                self._m["spec_steps"] += 1
            appended = 0
            for t in toks:
                r.output_tokens.append(int(t))
                r.token_times.append(now)
                appended += 1
                if self.maybe_finish(r, now):
                    break
                nxt = r.prompt_len + len(r.output_tokens)
                if self.pages_for(nxt + 1) > len(r.page_ids):
                    pid = self.alloc.allocate(1, now)
                    if pid is None:
                        self.preempt(r, now)
                        break
                    r.page_ids += pid
            # only tokens that actually landed count as accepted work
            self._m["spec_accepted_tokens"] += max(
                min(appended - 1, accepted), 0)
            total += appended
        self.note_tokens(now, total)
        return total

    # ------------------------------------------- async overlapped loop
    def on_decode_provisional(self, reqs: List[Request],
                              now: float) -> List[int]:
        """Bookkeeping for a decode step dispatched but not yet read
        back (the async loop schedules step N+1 while N runs on
        device).  Appends a :data:`PENDING_TOKEN` placeholder per row —
        patched with the real token at readback — so page growth,
        max_new_tokens finishes and the next schedule() pass all see
        the correct sequence LENGTH immediately.  Stop-token finishes
        cannot be predicted from a placeholder; the engine resolves
        them retroactively at readback.  Returns each request's
        placeholder index into ``output_tokens``."""
        idxs = []
        for r in reqs:
            r.output_tokens.append(PENDING_TOKEN)
            r.token_times.append(now)
            r._pending_toks = getattr(r, "_pending_toks", 0) + 1  # type: ignore
            idxs.append(len(r.output_tokens) - 1)
            nxt = r.prompt_len + len(r.output_tokens)
            if self.pages_for(nxt + 1) > len(r.page_ids):
                pid = self.alloc.allocate(1, now)
                if pid is None:
                    self.preempt(r, now)
                    continue
                r.page_ids += pid
            # max_new_tokens is count-predictable even on placeholders;
            # stop tokens are handled at readback by the engine
            self.maybe_finish(r, now)
        self.note_tokens(now, len(reqs))
        return idxs

    def maybe_finish(self, req: Request, now: float) -> bool:
        if not self.request_done(req):
            return False
        if req in self.running:
            self.running.remove(req)
        self._record_session_pages(req)
        self.alloc.release(req.page_ids, now)
        req.page_ids = []
        self.note_finished(req, now)
        return True

    # ------------------------------------------------ predictive promotion
    MAX_SESSION_PAGES = 4096    # sessions remembered for the promoter
    PROMOTE_MAX_PAGES = 64      # per-promotion page budget

    def _record_session_pages(self, req: Request) -> None:
        """Remember a finishing session turn's full-page block hashes —
        exactly what the NEXT turn's admission walk will ask for (the
        next prompt extends this turn's prompt + output), so the
        promoter knows which SSD pages to pull back ahead of it.  Only
        tracked when both lower tiers exist (no tiers => nothing to
        promote), LRU-bounded so a million-session trace cannot grow
        it without limit."""
        sid = getattr(req, "session_id", None)
        if sid is None or self.host_pool is None \
                or self.ssd_pool is None:
            return
        ps = self.scfg.page_size
        seq = list(req.prompt_tokens) + [int(t) for t in
                                         req.output_tokens]
        if len(seq) < ps:
            return
        self._session_pages[sid] = chunk_hashes(
            seq, ps, req.lora_adapter or "")
        self._session_pages.move_to_end(sid)
        while len(self._session_pages) > self.MAX_SESSION_PAGES:
            self._session_pages.popitem(last=False)

    def session_promotable(self, session_id: str) -> List[str]:
        """The session's recorded pages currently SSD-resident but NOT
        host-resident — the promoter's shopping list, bounded by
        ``PROMOTE_MAX_PAGES``."""
        if self.host_pool is None or self.ssd_pool is None:
            return []
        out = []
        for h in self._session_pages.get(session_id, ()):
            if not self.host_pool.contains(h) \
                    and self.ssd_pool.contains(h):
                out.append(h)
                if len(out) >= self.PROMOTE_MAX_PAGES:
                    break
        return out

    def complete_promotion(self, key: str, payload, nbytes: int,
                           now: float, session_id: str = "") -> bool:
        """Land one prefetched page in host DRAM (called by the host's
        promotion machinery once the SSD read has been paid for — at
        modelled cost by the simulator, on a background thread by the
        real engine).  The key is marked so a later host hit counts as
        ``promote_hits`` and an untouched eviction as
        ``promote_wasted``."""
        if self.host_pool is None or self.host_pool.contains(key):
            return False
        if self.host_pool.put(key, payload,
                              int(nbytes) or self.page_bytes, now):
            self._promoted[key] = session_id
            return True
        return False

    def promote_session(self, session_id: str, now: float) -> int:
        """Synchronous promotion: read each promotable page from SSD
        and park it in host DRAM.  Hosts with their own latency story
        (sim cost events, the real engine's promoter thread) drive
        ``session_promotable`` + ``complete_promotion`` directly."""
        n = 0
        for key in self.session_promotable(session_id):
            payload = self.ssd_pool.get(key, now)
            if payload is None:
                continue
            if self.complete_promotion(
                    key, payload,
                    payload_nbytes(payload, self.page_bytes), now,
                    session_id):
                n += 1
        return n

    def preempt(self, req: Request, now: float) -> None:
        """Evict a RUNNING request.  With a host tier attached the
        victim's pages are *swapped out* (offloaded under per-request
        keys; resume continues decoding from where it stopped —
        byte-identical to the never-preempted run); without one — or
        when the tier cannot hold the pages — the legacy path drops
        everything and re-prefills from token 0."""
        if req in self.running:
            self.running.remove(req)
        req.preempt_count += 1
        self._m["preemptions"] += 1
        if self._swap_out(req, now):
            return
        self.alloc.release(req.page_ids, now)
        req.page_ids = []
        self._reset_recompute(req)
        self.waiting.insert(0, req)

    def _reset_recompute(self, req: Request) -> None:
        # every discarded generated token is paid-for decode compute
        # the fleet re-runs — the figure bench_chaos compares across
        # recovery modes
        self._m["wasted_tokens"] += len(req.output_tokens)
        req.output_tokens = []
        # the discarded tokens' timestamps go with them — ITL is then
        # measured over the re-run (plus the one real requeue stall
        # from first_token_time, which stays: TTFT already happened)
        req.token_times = []
        req.prefill_done_tokens = 0
        # any in-flight async placeholder died with the tokens; the
        # engine's readback patch guard skips the vanished index
        req._pending_toks = 0               # type: ignore[attr-defined]
        req.state = RequestState.QUEUED

    # ----------------------------------------------------- swap preemption
    @staticmethod
    def _swap_key(req: Request, i: int) -> str:
        return f"swap/{req.request_id}/{i}"

    def _swap_out(self, req: Request, now: float) -> bool:
        """Offload a decode-phase victim's pages (prompt AND generated
        KV) into the host tier.  Returns False — caller falls back to
        drop-and-recompute — when no tier/payload hook is attached, the
        request is still prefilling, or the pages can't ever fit."""
        scfg = self.scfg
        if (not scfg.swap_preemption or self.host_pool is None
                or self.page_payload is None or not req.page_ids
                or req.prefill_done_tokens < req.prompt_len
                or getattr(req, "_pending_toks", 0)):
            # a victim with unresolved async placeholders can't swap —
            # the parked tokens would contain PENDING_TOKEN sentinels a
            # resume could feed back to the model; drop-and-recompute
            return False
        n = len(req.page_ids)
        if not self.host_pool.can_hold(n * self.page_bytes):
            return False
        for i, pid in enumerate(req.page_ids):
            self.host_pool.put(self._swap_key(req, i),
                               self.page_payload(pid), self.page_bytes,
                               now)
        self.alloc.release(req.page_ids, now)
        req.page_ids = []
        req._swap_pages = n                 # type: ignore[attr-defined]
        req.state = RequestState.SWAPPED
        self.waiting.insert(0, req)
        self._m["swap_out"] += 1
        self._m["kv_bytes_offloaded"] += n * self.page_bytes
        return True

    def _drop_swap(self, req: Request) -> None:
        for i in range(getattr(req, "_swap_pages", 0)):
            key = self._swap_key(req, i)
            self.host_pool.discard(key)
            if self.ssd_pool is not None:
                self.ssd_pool.discard(key)
        req._swap_pages = 0                 # type: ignore[attr-defined]

    def _try_resume(self, now: float) -> None:
        """Swap SWAPPED requests back in (preemption order — they sit
        at the front of ``waiting``): re-allocate their pages, install
        the parked payloads and rejoin the decode batch mid-sequence.
        Swap entries the host tier evicted under pressure are looked up
        in the SSD tier below it (host evictions cascade there), so an
        idle session's resume stays a transfer, not a recompute.  Only
        when an entry is gone from BOTH tiers does the request fall
        back to recompute admission (still byte-identical under greedy
        decoding — just slower)."""
        if self.host_pool is None:
            return
        for req in [r for r in self.waiting
                    if r.state is RequestState.SWAPPED]:
            if (len(self.running) + len(self.prefills)
                    >= self.scfg.max_batch):
                break
            need = getattr(req, "_swap_pages", 0)
            entries, sources = [], []
            for i in range(need):
                key = self._swap_key(req, i)
                payload = self.host_pool.get(key, now)
                source = "host"
                if payload is None and self.ssd_pool is not None:
                    payload = self.ssd_pool.get(key, now)
                    source = "ssd"
                entries.append(payload)
                sources.append(source)
            if not need or any(e is None for e in entries):
                self._drop_swap(req)
                self._reset_recompute(req)   # stays queued; try_admit
                continue                     # re-prefills it later
            fresh = self.alloc.allocate(need, now)
            if fresh is None:
                continue        # no memory yet — stay swapped
            for i, (pid, payload, source) in enumerate(
                    zip(fresh, entries, sources)):
                if self.install_page is not None:
                    self.install_page(
                        pid, payload, req, now, source=source,
                        stream=False,
                        nbytes=payload_nbytes(payload, self.page_bytes))
                if source == "ssd":
                    self._m["ssd_hit_tokens"] += self.scfg.page_size
                key = self._swap_key(req, i)
                self.host_pool.discard(key)
                if self.ssd_pool is not None:
                    self.ssd_pool.discard(key)
            req._swap_pages = 0             # type: ignore[attr-defined]
            req.page_ids = fresh
            req.state = RequestState.RUNNING
            self.waiting.remove(req)
            self.running.append(req)
            self._m["swap_in"] += 1
            self._m["kv_bytes_fetched"] += need * self.page_bytes
            # a victim preempted on its very last token is already done
            self.maybe_finish(req, now)

    def drop_running(self, req: Request, now: float) -> None:
        """Remove a RUNNING request without finishing it (migration)."""
        if req in self.running:
            self.running.remove(req)
        self.alloc.release(req.page_ids, now)
        req.page_ids = []

    # --------------------------------------------- crash recovery log
    def _maybe_checkpoint(self, now: float) -> None:
        """The recovery log: periodically publish a running decode's
        full KV blocks — prompt AND generated — to the distributed
        pool under their content hashes.  ``req.ckpt_tokens`` records
        how many sequence tokens the log covers; after a crash,
        :meth:`crash_takeover` rewinds the request to that point and
        the replacement engine's admission walk fetches the
        checkpointed blocks back instead of re-prefilling from token
        0.  Publish volume is bounded per pass by
        ``ckpt_budget_bytes`` and skips blocks the pool already holds
        (prompt blocks usually entered at prefill time)."""
        iv = self.scfg.ckpt_interval_tokens
        if (not iv or self.kv_pool is None
                or self.publish_page is None):
            return
        ps = self.scfg.page_size
        budget = self.scfg.ckpt_budget_bytes or float("inf")
        for req in self.running:
            if getattr(req, "_pending_toks", 0):
                # async loop: unresolved PENDING_TOKEN placeholders —
                # hashing them would poison the recovery log; the next
                # resolved pass checkpoints the real tokens
                continue
            total = req.prompt_len + len(req.output_tokens)
            full = (total // ps) * ps
            if full - req.ckpt_tokens < iv:
                continue
            hashes = chunk_hashes(
                req.prompt_tokens + req.output_tokens, ps,
                req.lora_adapter or "")
            for i in range(req.ckpt_tokens // ps, full // ps):
                if budget <= 0:
                    return
                if not self.kv_pool.contains(hashes[i]):
                    if not self._pool_publish(req.page_ids[i], hashes[i],
                                              req, now):
                        return      # partitioned: retry next pass
                    self._m["ckpt_pages"] += 1
                    budget -= max(self.page_bytes, 1)
                req.ckpt_tokens = (i + 1) * ps

    def crash_takeover(self, now: float) -> List[Request]:
        """Harvest EVERY request a dead engine owns so the control
        plane can re-deliver them to surviving pool members.  Queued
        requests come back untouched (``takeover_waiting`` semantics);
        in-flight prefills reset to recompute; running decodes rewind
        to their last recovery-log checkpoint when one exists — the
        surviving engine's continuation admission pulls every
        checkpointed block (prompt AND generated) back from the pool
        and resumes decoding mid-sequence — and reset to full
        recompute otherwise.  The local pages are released either way:
        this engine is gone."""
        out = self.takeover_waiting()
        for req in list(self.prefills):
            self.prefills.remove(req)
            self.alloc.release(req.page_ids, now)
            req.page_ids = []
            self._reset_recompute(req)
            out.append(req)
        for req in list(self.running):
            self.running.remove(req)
            self.alloc.release(req.page_ids, now)
            req.page_ids = []
            if not self._rewind_to_checkpoint(req):
                self._reset_recompute(req)
            out.append(req)
        return out

    def _rewind_to_checkpoint(self, req: Request) -> bool:
        """Rewind a decode-phase victim onto its recovery log: keep the
        generated tokens the log covers, drop the uncovered tail and
        re-queue flagged for continuation admission
        (:meth:`_admit_continuation` pulls the checkpointed blocks and
        rejoins decode directly — the prompt is NOT folded, because the
        covered tokens' KV must come back verbatim, never be
        re-prefilled).  False (caller falls back to full recompute)
        when the log never got past the prompt."""
        gen_covered = min(req.ckpt_tokens - req.prompt_len,
                          len(req.output_tokens))
        if gen_covered <= 0:
            return False
        self._m["wasted_tokens"] += len(req.output_tokens) - gen_covered
        req.output_tokens = list(req.output_tokens[:gen_covered])
        # inter-token gaps for the kept tokens stay; the gap spanning
        # the crash shows up against the first resumed token
        req.token_times = list(req.token_times[:max(gen_covered - 1, 0)])
        req.prefill_done_tokens = 0
        req.cached_prefix_tokens = 0
        req._resume_decode = True           # type: ignore[attr-defined]
        req.state = RequestState.QUEUED
        return True

    # ---------------------------------------------------------- metrics
    def match_prefix_len(self, tokens) -> int:
        """Prefix-cache coverage for router scoring (non-mutating)."""
        return self.alloc.match_len(tokens)

    @property
    def queue_depth(self) -> int:
        """Admitted-but-unfinished load, equal to the metrics()
        num_running + num_waiting sum — a cheap accessor so routing
        policies scoring load per request don't pay for a full
        EngineMetrics build (windowed throughput, SLO stats) per
        engine per route."""
        return (len(self.running) + len(self.prefills)
                + len(self.waiting))

    def metrics(self, now: float,
                loaded_adapters: tuple = ()) -> EngineMetrics:
        return EngineMetrics(
            num_running=len(self.running) + len(self.prefills),
            num_waiting=len(self.waiting),
            kv_utilization=self.alloc.utilization,
            tokens_per_sec=self.throughput(now),
            avg_latency=self.avg_latency,
            avg_queue_time=self.avg_queue_time,
            admitted_requests=self.admitted_count,
            finished_requests=self.finished_count,
            preemptions=self._m["preemptions"],
            prefix_hit_tokens=self._m["prefix_hit_tokens"],
            remote_hit_tokens=self._m["remote_hit_tokens"],
            loaded_adapters=loaded_adapters,
            lora_miss=self._m["lora_miss"],
            lora_shed=self._m["lora_shed"],
            slo_attainment=self.slo_attainment(now),
            slo_by_class=self.slo_class_stats(now),
            slo_itl_attainment=self.slo_itl_attainment(now),
            host_hit_tokens=self._m["host_hit_tokens"],
            ssd_hit_tokens=self._m["ssd_hit_tokens"],
            ssd_cross_hit_tokens=self._m["ssd_cross_hit_tokens"],
            ssd_dropped_puts=(self.ssd_pool.stats.dropped_puts
                              if self.ssd_pool is not None else 0),
            promote_hits=self._m["promote_hits"],
            promote_wasted=self._m["promote_wasted"],
            kv_bytes_offloaded=self._m["kv_bytes_offloaded"],
            kv_bytes_fetched=self._m["kv_bytes_fetched"],
            swap_out=self._m["swap_out"],
            swap_in=self._m["swap_in"],
            kv_fetch_failures=self._m["kv_fetch_failures"],
            wasted_tokens=self._m["wasted_tokens"],
            ckpt_pages=self._m["ckpt_pages"],
            spec_drafted_tokens=self._m["spec_drafted_tokens"],
            spec_accepted_tokens=self._m["spec_accepted_tokens"],
            spec_steps=self._m["spec_steps"],
            spec_acceptance=(self._m["spec_accepted_tokens"]
                             / max(self._m["spec_drafted_tokens"], 1)))
