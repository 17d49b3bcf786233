"""Analytic engine backend for cluster-scale simulation.

``SimEngine`` implements the same handle contract as the real JAX
``InferenceEngine`` (submit / step-driven progress / metrics /
match_prefix_len / adapter hooks) but advances on the discrete-event
loop with a roofline cost model (repro_torch.core.optimizer.profiles) instead
of executing matmuls.  Crucially it reuses the *real* page allocator,
content-hash prefix cache AND the *real* unified Scheduler
(repro_torch.engine.scheduler) — the exact admission / budget / role /
finish code the JAX engine runs — and speaks to the *real* distributed
KV pool.  Cache hit/miss/eviction behaviour and scheduling decisions
in benchmarks are produced by the production code; only the FLOPs are
analytic (the roofline cost model plays the ModelRunner's part).

Iteration model (vLLM-style continuous batching):
  * ``mixed_batching=False`` (legacy two-phase, the default): each
    engine iteration is either a prefill chunk (compute-bound) or one
    decode step for the running batch (bandwidth-bound)
  * ``mixed_batching=True``: the shared Scheduler emits the SAME fused
    ``B + K*chunk`` step the real engine runs (budget-trimmed chunks
    from up to ``max_prefills`` concurrent prefills riding one pass
    with the decode batch), priced by ``PerfModel.mixed_step_time`` —
    one roofline over the flattened token batch
  * prefix-cache hits (local or distributed-pool) skip prefill compute
    for the covered tokens; pool fetches pay a transfer-time cost
  * faults (repro_torch.core.diagnostics) scale iteration time via
    ``slowdown`` — a dead device stops making progress.

P/D disaggregation (paper §3.2.5): ``role="prefill"`` engines publish
KV to the pool and hand requests off after the pool's metadata lag;
``role="decode"`` engines pull prefilled KV from the pool — the role
semantics themselves live in the shared Scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from repro_torch.core.kvcache.pool import DistributedKVPool, KVPoolError
from repro_torch.core.kvcache.tiers import (HostPagePool, SSDPagePool,
                                      validate_wire_dtype)
from repro_torch.core.optimizer.profiles import DEVICES, PerfModel
from repro_torch.core.runtime.sidecar import H2D_BW, TIER_BW
from repro_torch.core.sim.events import EventLoop
from repro_torch.engine.page_table import PageAllocator, chunk_hashes
from repro_torch.engine.request import Request, RequestState
from repro_torch.engine.speculative import FixedLengthDrafter
from repro_torch.engine.scheduler import (EngineMetrics, Scheduler,
                                    SchedulerConfig)
from repro_torch.models.config import ModelConfig


@dataclass
class SimEngineConfig:
    device_type: str = "a10"
    num_devices: int = 1             # TP degree (perf scales, memory adds)
    page_size: int = 64              # tokens per logical KV block
    max_batch: int = 32
    chunk_size: int = 512
    prefix_caching: bool = True
    chunked_prefill: bool = True
    scheduler_overhead_s: float = 0.002
    # fused mixed-batch scheduling (the real engine's default mode):
    # False keeps the legacy two-phase iteration the historical
    # cluster benchmarks were tuned on
    mixed_batching: bool = False
    max_prefills: int = 2           # concurrent PREFILLING requests
    token_budget: int = 0           # 0 => max_batch + max_prefills*chunk
    # P/D disaggregation (paper §3.2.5: the pool enables a DistServe-
    # style "prefill/decode disaggregation remote pool"):
    #   mixed   — normal colocated engine
    #   prefill — prefills, publishes KV to the pool, hands the request
    #             off (never decodes)
    #   decode  — pulls prefilled KV from the pool, decodes only
    role: str = "mixed"
    # tiered KV cache: host-DRAM tier capacity (0 disables — no
    # eviction cascade, drop-and-recompute preemption), the pool wire
    # format ("fp16" matches the roofline's kv_dtype_bytes; "int8"
    # halves the wire bytes) and the streaming-handoff chunk size in
    # pages (0 => eager whole-payload transfer)
    host_cache_gb: float = 0.0
    wire_dtype: str = "fp16"
    handoff_chunk_pages: int = 4
    swap_preemption: bool = True
    # SSD third tier below host DRAM (0 disables): host evictions
    # cascade into a write-behind SSD pool whose dirty queue drains at
    # ``ssd_bw``; the page walk and swap resume read back at the same
    # modelled bandwidth.  Idle-session prefixes survive host pressure
    # here instead of falling to recompute.
    ssd_cache_gb: float = 0.0
    ssd_bw: float = 3.0e9
    # 0 => size the device page count from HBM minus params (default);
    # a positive override pins it (small-KV preemption benchmarks)
    num_pages: int = 0
    # SLO-aware scheduling — the SAME policy knobs as the real engine,
    # handled by the shared Scheduler (deadline-aware admission order,
    # priority preemption, per-class attainment accounting)
    slo_aware: bool = False
    slo_classes: Optional[dict] = None      # None => scheduler defaults
    slo_preempt_headroom: float = 0.25
    slo_preempt_cooldown_s: float = 1.0
    # crash-recovery checkpoint policy (the recovery log): publish a
    # running decode's full KV blocks to the pool every this-many new
    # sequence tokens (0 disables), at most ckpt_budget_bytes per pass
    ckpt_interval_tokens: int = 0
    ckpt_budget_bytes: int = 0
    # high-density multi-LoRA serving: HBM adapter slots (slot 0 is the
    # base model, as in the real engine's bank) with LRU eviction into
    # a bounded host tier; cold loads are priced from the adapter's
    # byte size over the artifact/host tier bandwidths and stall the
    # next step.  lora_autoload / lora_queue_timeout_s mirror
    # EngineConfig — the shared Scheduler's adapter_ready gate keeps
    # non-resident adapters loud on both data planes.
    max_adapters: int = 8
    lora_rank: int = 8
    lora_autoload: bool = True
    lora_queue_timeout_s: float = 30.0
    host_adapter_slots: int = 32
    # speculative n-gram decoding: max drafts per decode row (0
    # disables) and the synthetic acceptance rate the sim resolves
    # verification at.  The sim cannot KNOW acceptance (it has no
    # model), so it prices the verified step with
    # ``PerfModel.spec_step_time`` and emits ``accept_rate * drafts``
    # accepted tokens — flowing through the SAME ``on_spec_batch``
    # bookkeeping (EWMA backoff included) as the real engine, which is
    # what keeps sim/real accounting in parity
    spec_tokens: int = 0
    spec_accept_rate: float = 0.7

    def scheduler_config(self) -> SchedulerConfig:
        """The shared Scheduler, two-phase or fused-mixed-batch — the
        exact admission semantics the real engine runs either way."""
        kw = {}
        if self.slo_classes is not None:
            kw["slo_classes"] = dict(self.slo_classes)
        return SchedulerConfig(
            page_size=self.page_size, max_batch=self.max_batch,
            max_pages_per_seq=0,            # sim: no per-seq page cap
            chunk_size=self.chunk_size,
            chunked_prefill=self.chunked_prefill,
            prefix_caching=self.prefix_caching,
            mixed_batching=self.mixed_batching,
            max_prefills=self.max_prefills if self.mixed_batching else 1,
            token_budget=self.token_budget,
            lora_queue_timeout_s=self.lora_queue_timeout_s,
            handoff_chunk_pages=self.handoff_chunk_pages,
            swap_preemption=self.swap_preemption,
            honor_stop_token=False,     # sim decode tokens are
            role=self.role,             # synthetic zeros
            slo_aware=self.slo_aware,
            slo_preempt_headroom=self.slo_preempt_headroom,
            slo_preempt_cooldown_s=self.slo_preempt_cooldown_s,
            ckpt_interval_tokens=self.ckpt_interval_tokens,
            ckpt_budget_bytes=self.ckpt_budget_bytes,
            spec_tokens=self.spec_tokens, **kw)


class SimEngine:
    def __init__(self, cfg: ModelConfig, loop: EventLoop,
                 sim_cfg: SimEngineConfig = None,
                 kv_pool: Optional[DistributedKVPool] = None,
                 engine_id: str = "sim-0", node: str = "node-0",
                 ssd_pool=None):
        self.cfg = cfg
        self.loop = loop
        self.sc = sim_cfg or SimEngineConfig()
        self.kv_pool = kv_pool
        self.engine_id = engine_id
        self.node = node
        if kv_pool is not None:
            kv_pool.attach_engine(engine_id, node)
        dev = DEVICES[self.sc.device_type]
        self.perf = PerfModel(cfg, dev)
        # TP over num_devices: memory adds, compute/bw scale (0.9 eff.)
        nd = self.sc.num_devices
        self._speed = nd * (0.9 if nd > 1 else 1.0)
        kv_budget = max(dev.hbm_bytes * 0.9 * nd
                        - self.perf.param_bytes, dev.hbm_bytes * 0.05)
        num_pages = self.sc.num_pages or int(
            kv_budget / (self.perf.kv_bytes_per_token * self.sc.page_size))
        # raw per-page payload bytes + the wire size a pool handoff
        # actually moves (int8 quantization halves the fp16 roofline)
        self._page_bytes = int(self.perf.kv_bytes_per_token
                               * self.sc.page_size)
        self._wire_bytes = (self._page_bytes // 2
                            if validate_wire_dtype(self.sc.wire_dtype)
                            == "int8" else self._page_bytes)
        self.host_pool = None
        if self.sc.host_cache_gb > 0:
            self.host_pool = HostPagePool(
                capacity_bytes=int(self.sc.host_cache_gb * (1 << 30)))
        self.ssd_pool = None
        if self.host_pool is not None and ssd_pool is not None:
            # host-shared SSD tier: the cluster passes one
            # SharedSSDPool per host group; this engine attaches a
            # per-engine accounting view (same interface as a private
            # pool, plus cross-engine hit classification)
            self.ssd_pool = ssd_pool.view(engine_id) \
                if hasattr(ssd_pool, "view") else ssd_pool
        elif self.sc.ssd_cache_gb > 0 and self.host_pool is not None:
            self.ssd_pool = SSDPagePool(
                capacity_bytes=int(self.sc.ssd_cache_gb * (1 << 30)),
                ssd_bw=self.sc.ssd_bw)
        self.sched = Scheduler(
            self.sc.scheduler_config(),
            PageAllocator(max(num_pages, 16), self.sc.page_size),
            kv_pool=kv_pool, engine_id=engine_id,
            install_page=self._install_page,
            publish_page=self._publish_page,
            host_pool=self.host_pool,
            page_payload=(lambda pid: True),    # sim: cost model only
            page_bytes=self._page_bytes,
            adapter_ready=lambda name: name in self._adapters,
            ssd_pool=self.ssd_pool)
        if self.sched.drafter is not None:
            # sim tokens are synthetic zeros the n-gram matcher cannot
            # usefully continue; swap in the content-free drafter so
            # spec_accept_rate shapes acceptance (see FixedLengthDrafter)
            self.sched.drafter = FixedLengthDrafter(
                **vars(self.sched.drafter))
        self.slowdown_fn: Callable[[], float] = lambda: 1.0
        self._busy = False
        # busy-transition hook: the cluster keeps a busy-engine COUNT
        # from these edges so its per-event done() predicate is O(1)
        # instead of scanning every engine's has_work
        self.on_busy_changed: Optional[Callable[[bool], None]] = None
        # adapter tiering mirrored from the real ModelRunner: a bounded
        # HBM bank (name -> LRU tick; slot 0 is the base model, hence
        # max_adapters - 1 slots) cascading into a bounded host tier.
        # The sim stores no weights — a cold load prices the adapter
        # bytes over the artifact (or host) tier bandwidth and stalls
        # the engine's next step by that time.
        self._adapters: dict = {}
        self._lru_tick = 0
        self._host_adapters: dict = {}
        self._deferred_unloads: set = set()
        self._adapter_penalty_s = 0.0
        self._adapter_bytes = self.perf.lora_adapter_bytes(
            self.sc.lora_rank)
        self._lora = dict(cold_loads=0, cold_load_s=0.0, evictions=0,
                          host_hits=0)
        self._m: dict = {}              # sim-only counters (migrations)
        self.alive = True

    # ---------------------------------------------------------- contract
    def submit(self, req: Request) -> None:
        if (req.lora_adapter and self.sc.lora_autoload
                and req.lora_adapter not in self._adapters):
            try:
                self.register_adapter(req.lora_adapter)
            except RuntimeError:
                pass    # all slots pinned: queue behind adapter_ready
        self.sched.enqueue(req, self.loop.clock.now)
        self._kick()

    def _adapters_in_use(self) -> set:
        return {r.lora_adapter
                for r in self.sched.running + self.sched.prefills
                if r.lora_adapter}

    def _touch_adapter(self, name: str) -> None:
        self._lru_tick += 1
        self._adapters[name] = self._lru_tick

    def register_adapter(self, name: str, weights=None) -> None:
        """Same tier semantics as ``ModelRunner.register_adapter``;
        the weights are a cost, not arrays: host-tier hits pay the
        host->device copy, artifact-store loads additionally pay the
        local-tier fetch.  The stall lands on the next step."""
        self._deferred_unloads.discard(name)
        if name in self._adapters:
            self._touch_adapter(name)
            return
        slots = max(self.sc.max_adapters - 1, 1)
        if len(self._adapters) >= slots:
            in_use = self._adapters_in_use()
            victim = next(
                (n for n in sorted(self._adapters,
                                   key=self._adapters.get)
                 if n not in in_use), None)
            if victim is None:
                raise RuntimeError(
                    "adapter slots exhausted and every resident adapter "
                    "is pinned by an in-flight batch")
            self.unregister_adapter(victim)
            self._lora["evictions"] += 1
        cost = self._adapter_bytes / H2D_BW
        if name in self._host_adapters:
            self._host_adapters.pop(name)
            self._lora["host_hits"] += 1
        else:
            cost += self._adapter_bytes / TIER_BW["local"]
        self._touch_adapter(name)
        self._lora["cold_loads"] += 1
        self._lora["cold_load_s"] += cost
        self._adapter_penalty_s += cost
        self._kick()    # a gated request may now be admissible

    def unregister_adapter(self, name: str) -> None:
        if name not in self._adapters:
            return
        if name in self._adapters_in_use():
            # never disturb an in-flight batch: unload once it drains
            self._deferred_unloads.add(name)
            return
        self._adapters.pop(name)
        if self.sc.host_adapter_slots > 0:
            self._host_adapters[name] = True
            while len(self._host_adapters) > self.sc.host_adapter_slots:
                self._host_adapters.pop(next(iter(self._host_adapters)))

    def _flush_deferred_unloads(self) -> None:
        if not self._deferred_unloads:
            return
        in_use = self._adapters_in_use()
        for name in list(self._deferred_unloads):
            if name not in in_use:
                self._deferred_unloads.discard(name)
                self.unregister_adapter(name)

    @property
    def adapters(self) -> List[str]:
        return sorted(self._adapters)

    def match_prefix_len(self, tokens) -> int:
        return self.sched.match_prefix_len(tokens)

    @property
    def queue_depth(self) -> int:
        """Cheap routing-load accessor (== metrics() num_running +
        num_waiting) — see SchedulerCore.queue_depth."""
        return self.sched.queue_depth

    def healthy(self) -> bool:
        return self.alive and self.slowdown_fn() > 0.0

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    # back-compat views over the shared scheduler's queues
    @property
    def alloc(self) -> PageAllocator:
        return self.sched.alloc

    @property
    def waiting(self) -> List[Request]:
        return self.sched.waiting

    @property
    def running(self) -> List[Request]:
        return self.sched.running

    @property
    def finished(self) -> List[Request]:
        return self.sched.finished

    @property
    def prefilling(self) -> Optional[Request]:
        return self.sched.prefills[0] if self.sched.prefills else None

    @property
    def handoff(self):
        return self.sched.handoff

    @handoff.setter
    def handoff(self, fn) -> None:
        self.sched.handoff = fn

    # ---------------------------------------------------------- scheduling
    def _kick(self) -> None:
        if not self._busy and self.has_work:
            self._set_busy(True)
            self.loop.after(0.0, self._iterate)

    def _set_busy(self, flag: bool) -> None:
        if self._busy != flag:
            self._busy = flag
            if self.on_busy_changed is not None:
                self.on_busy_changed(flag)

    def _install_page(self, pid: int, payload, req: Request,
                      now: float, source: str = "pool",
                      stream: bool = False, nbytes: int = 0) -> None:
        """Payload hook for the shared Scheduler's page walk: the sim
        stores no arrays — each fetched page attributes a transfer-time
        cost to the request.  Host-tier pages move raw bytes at
        ``dram_bw``; SSD-tier pages read back at the modelled
        ``ssd_bw``; pool pages move wire bytes (int8-compressed when
        configured) at ``network_bw``.  Head-group pages charge
        ``_fetch_head_s`` (they gate the tail recompute); streamed
        groups charge ``_fetch_stream_s``, which ``_iterate`` overlaps
        with the step's compute — the chunked-handoff pipeline."""
        nbytes = nbytes or self._page_bytes
        if source == "host":
            cost = nbytes / self.host_pool.dram_bw
        elif source == "ssd":
            cost = nbytes / self.ssd_pool.ssd_bw
        else:
            cost = nbytes / self.kv_pool.network_bw
        attr = "_fetch_stream_s" if stream else "_fetch_head_s"
        setattr(req, attr, getattr(req, attr, 0.0) + cost)

    def _publish_page(self, pid: int, block_hash: str, req: Request,
                      now: float) -> None:
        """Payload hook for the shared prompt-page registration: the
        sim publishes a payload-less record sized by the cost model
        (wire bytes — the int8 format halves them)."""
        self.kv_pool.publish(block_hash, True, self.engine_id, now,
                             size_bytes=self._wire_bytes)

    # ------------------------------------------------ predictive promotion
    def promote_session(self, session_id: str) -> int:
        """Prefetch the session's SSD-resident pages back into host
        DRAM ahead of the predicted turn.  The sim prices the SSD read
        like the real engine pays it: the pages land after a scheduled
        delay of bytes/ssd_bw, OFF the critical path (no engine stall —
        that is the whole point; only the promoter's landing time is
        modelled).  Returns the number of pages scheduled."""
        if self.ssd_pool is None:
            return 0
        keys = self.sched.session_promotable(session_id)
        if not keys:
            return 0
        delay = len(keys) * self._page_bytes / self.ssd_pool.ssd_bw

        def land() -> None:
            now = self.loop.clock.now
            for key in keys:
                payload = self.ssd_pool.get(key, now)
                if payload is not None:
                    self.sched.complete_promotion(
                        key, payload, self._page_bytes, now, session_id)

        self.loop.after(delay, land)
        return len(keys)

    def _iterate(self) -> None:
        now = self.loop.clock.now
        slow = self.slowdown_fn()
        if not self.alive or slow <= 0.0:
            self._set_busy(False)     # dead engine: progress stops
            return
        self._flush_deferred_unloads()
        out = self.sched.schedule(now)
        if not (out.prefills or out.decode):
            if any(r.lora_adapter and r.lora_adapter not in self._adapters
                   for r in self.sched.waiting):
                # requests gated on a non-resident adapter: poll so the
                # control plane's next sync (or the shed timeout) is
                # observed even though no submit will re-kick us
                self.loop.after(0.1, self._iterate)
                return
            self._set_busy(False)
            return
        batch = out.decode
        chunk_total = sum(w.chunk_len for w in out.prefills)
        # transfer charges from the page walk / swap-in: head bytes
        # gate the step (the engine cannot attend over pages that have
        # not landed), streamed chunk groups overlap with the step's
        # compute — effective cost max(compute, stream), the chunked-
        # handoff pipeline (eager mode puts everything in head)
        head = stream = 0.0
        for r in [w.req for w in out.prefills] + list(batch):
            head += getattr(r, "_fetch_head_s", 0.0)
            stream += getattr(r, "_fetch_stream_s", 0.0)
            r._fetch_head_s = 0.0           # type: ignore[attr-defined]
            r._fetch_stream_s = 0.0         # type: ignore[attr-defined]
        if out.spec:
            # speculative verification: draft tokens add FLOPs but no
            # extra weight/KV byte traffic — the roofline term the
            # expected decode speedup (and admission parity with the
            # real engine) rests on
            ctx = sum(r.total_tokens for r in batch) / len(batch)
            comp = self.perf.spec_step_time(
                len(batch), ctx, sum(len(d) for d in out.spec),
                chunk_total) / (self._speed * slow)
        elif batch and out.prefills:
            # fused mixed batch: decode rows + budget-trimmed prefill
            # chunks in ONE pass, one roofline over the token batch
            ctx = sum(r.total_tokens for r in batch) / len(batch)
            comp = self.perf.mixed_step_time(len(batch), ctx,
                                             chunk_total) \
                / (self._speed * slow)
        elif out.prefills:
            comp = self.perf.prefill_time(chunk_total) \
                / (self._speed * slow)
        else:
            ctx = sum(r.total_tokens for r in batch) / len(batch)
            comp = self.perf.decode_step_time(len(batch), ctx) \
                / (self._speed * slow)
        # adapter cold loads stall the step like head-group KV fetches:
        # the batch cannot run until the weights land on device
        head += self._adapter_penalty_s
        self._adapter_penalty_s = 0.0
        dt = self.sc.scheduler_overhead_s + head + max(comp, stream)
        done_t = now + dt
        for w in out.prefills:
            if w.chunk_len == 0:
                continue                    # budget-starved this step
            if self.sched.note_prefill_progress(w.req, w.chunk_len):
                self._finish_prefill(w.req, done_t)
        if batch:
            if out.spec:
                # synthetic acceptance: the accept-rate share of each
                # row's drafts lands, plus the bonus token — routed
                # through the same on_spec_batch bookkeeping (EWMA
                # backoff, acceptance counters) as the real engine
                rate = self.sc.spec_accept_rate
                # accepted tokens ARE the draft prefix by definition;
                # only the bonus/correction sample is synthetic.  The
                # round() keeps short (1-token) drafts acceptable so
                # the EWMA backoff sees the configured rate, not a
                # floor()-induced zero
                emitted = [list(d[:min(round(rate * len(d)), len(d))])
                           + [0] for d in out.spec]
                self.sched.on_spec_batch(batch, out.spec, emitted,
                                         done_t)
            else:
                self.sched.on_decode_batch(batch, [0] * len(batch),
                                           done_t)
        self.loop.after(dt, self._iterate)

    def _finish_prefill(self, req: Request, t: float) -> None:
        self.sched.register_prompt_pages(req, t)
        if self.sched.wants_handoff:
            # disaggregated: KV is in the pool; hand the request to a
            # decode engine and free this engine for the next prefill.
            # Deliver after the pool's metadata lag so the decode side
            # sees the published blocks (the scheduler tracks the
            # in-flight request so drain predicates don't observe a
            # momentarily idle pair).
            self.sched.handoff_prefill(req, t)
            lag = self.kv_pool.metadata_lag if self.kv_pool else 0.0
            # schedule from the (forward-dated) prefill completion time
            self.loop.schedule(t + lag * 1.01,
                               lambda: self.sched.deliver_handoff(req))
            return
        self.sched.finish_prefill(req, 0, t)
        self.sched.note_tokens(t, 1)

    # ------------------------------------------------------- migration
    def migrate_out(self, req: Request, target: "SimEngine") -> bool:
        """Live-migrate a RUNNING request to ``target`` via the pool
        (paper §3.1: the distributed KV cache runtime supports "request
        migration").  All of the sequence's KV blocks — prompt AND
        generated — are published; the target re-admits the request and
        pulls them by hash, so only the block tail is recomputed."""
        if req not in self.sched.running or self.kv_pool is None:
            return False
        now = self.loop.clock.now
        # publish every full block of (prompt + generated) tokens
        seq = list(req.prompt_tokens) + [0] * len(req.output_tokens)
        hashes = chunk_hashes(seq, self.sc.page_size,
                              req.lora_adapter or "")
        try:
            for h in hashes:
                self.kv_pool.publish(h, True, self.engine_id, now,
                                     size_bytes=self._wire_bytes)
        except KVPoolError:
            return False    # pool partitioned: migration refused
        self.sched.drop_running(req, now)
        # target treats the full sequence-so-far as its "prompt": the
        # generated tokens keep their identity via req.output_tokens
        req._migrated_prompt = seq            # type: ignore[attr-defined]
        req.prompt_tokens = seq
        req.prefill_done_tokens = 0
        req.state = RequestState.QUEUED
        self._m["migrations"] = self._m.get("migrations", 0) + 1
        # deliver after metadata visibility so the KV actually transfers
        self.loop.schedule(now + self.kv_pool.metadata_lag * 1.01,
                           lambda: target.submit(req))
        return True

    # ---------------------------------------------------------- metrics
    def metrics(self) -> EngineMetrics:
        m = self.sched.metrics(
            self.loop.clock.now,
            loaded_adapters=tuple(sorted(self._adapters)))
        m.lora_cold_loads = self._lora["cold_loads"]
        m.lora_cold_load_s = self._lora["cold_load_s"]
        m.lora_evictions = self._lora["evictions"]
        m.lora_host_hits = self._lora["host_hits"]
        return m
