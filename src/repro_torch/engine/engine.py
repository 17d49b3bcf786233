"""Continuous-batching inference engine on PyTorch, the counterpart of
``repro/engine/engine.py``.

One ``InferenceEngine`` composes the copied scheduler
(:class:`repro_torch.engine.scheduler.Scheduler`, the same admission,
token-budget, chunking, preemption and P/D logic as the JAX engine) with
a :class:`repro_torch.engine.runner.ModelRunner` that executes each
schedule on a device: ``mixed_step`` for fused decode + prefill passes,
``decode_batch`` and ``prefill_step`` otherwise.

High-density LoRA serving: requests name an adapter; the runner's bank
holds ``max_adapters - 1`` of them (slot 0 is the base model) with an
LRU cascade into a bounded host tier.  An adapter the caller does not
pass in is autoloaded from the port's own name-keyed weights
(``ModelRunner._adapter_seed``), which differ from the JAX package's.

The KV tiers, as in the JAX engine: a host-DRAM tier (``host_cache_gb``:
device evictions cascade into it, preemption swaps to it), an SSD tier
below it (``ssd_cache_gb`` or a host-shared ``ssd_pool``, with
``promote_session`` prefetching a session's pages back on a daemon
thread), and the distributed pool (``kv_pool_client``) with P/D roles
(``role="prefill"`` publishes a prompt's pages and hands the request to
``handoff``; ``role="decode"`` pulls them by block hash) over the raw or
the int8 wire (``wire_dtype``).  Pages cross every tier as the runner's
numpy payloads.

Speculative decoding (``spec_tokens``): the copied scheduler drafts up
to ``spec_tokens`` tokens per decode row (prompt lookup, see
``speculative.py``); the runner verifies every row's drafts in one pass
(``spec_decode_step``, or ``spec_mixed_step`` when prefill chunks ride
along), the verify lanes through the ``paged_prefill`` kernel, and
accepts the longest prefix that matches the model's own samples.
Sampling keys every token by (request seed, absolute position), so the
output is the one step-by-step decoding gives, at any temperature.

The engine runs on the card unless the caller names another device
(``device="cpu"`` for tests); on a CUDA device only ``impl="kernel"``
is accepted, so the plain attention never sits on the card's serving
path.  Not ported yet, and refused when configured: the async loop.
"""
from __future__ import annotations

import queue
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from repro_torch.core.kvcache.tiers import (CompressedPage, HostPagePool,
                                            SSDPagePool, compress_page,
                                            decompress_page, payload_nbytes,
                                            validate_wire_dtype)
from repro_torch.device import resolve_device
from repro_torch.engine import paged_model as PM
from repro_torch.engine.page_table import PageAllocator, chunk_hashes
from repro_torch.engine.request import Request
from repro_torch.engine.runner import ModelRunner
from repro_torch.engine.scheduler import (EngineMetrics, ScheduleOutput,
                                          Scheduler, SchedulerConfig)
from repro_torch.models.config import DENSE, ModelConfig


@dataclass
class EngineConfig:
    """The JAX engine's configuration, field for field (``impl`` takes
    ``"kernel"`` or ``"ref"``).  See ``repro/engine/engine.py`` for what
    each field does; the field of the feature that is not ported yet
    (the async loop) is kept so that configurations carry over, and is
    refused when set."""
    page_size: int = 16
    num_pages: int = 512
    max_batch: int = 8              # decode slots
    max_pages_per_seq: int = 32     # block-table width
    chunk_size: int = 64            # chunked-prefill chunk
    chunked_prefill: bool = True
    prefix_caching: bool = True
    impl: str = "kernel"            # kernel | ref
    dtype: str = "float32"
    lora_rank: int = 8
    max_adapters: int = 8
    lora_autoload: bool = True
    lora_queue_timeout_s: float = 30.0
    host_adapter_slots: int = 32
    mixed_batching: bool = True     # False => legacy two-phase scheduler
    max_prefills: int = 2           # concurrent PREFILLING requests
    token_budget: int = 0           # 0 => max_batch + max_prefills*chunk
    role: str = "mixed"             # mixed | prefill | decode
    host_cache_gb: float = 0.0
    ssd_cache_gb: float = 0.0
    ssd_dir: Optional[str] = None
    wire_dtype: str = "fp"
    handoff_chunk_pages: int = 4
    swap_preemption: bool = True
    slo_aware: bool = False
    slo_classes: Optional[dict] = None
    slo_preempt_headroom: float = 0.25
    slo_preempt_cooldown_s: float = 1.0
    ckpt_interval_tokens: int = 0
    ckpt_budget_bytes: int = 0
    spec_tokens: int = 0
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    spec_probe_interval: int = 50
    async_loop: bool = False

    @property
    def step_token_budget(self) -> int:
        return self.scheduler_config().step_token_budget

    def scheduler_config(self) -> SchedulerConfig:
        kw = {}
        if self.slo_classes is not None:
            kw["slo_classes"] = dict(self.slo_classes)
        return SchedulerConfig(
            page_size=self.page_size, max_batch=self.max_batch,
            max_pages_per_seq=self.max_pages_per_seq,
            chunk_size=self.chunk_size,
            chunked_prefill=self.chunked_prefill,
            prefix_caching=self.prefix_caching,
            mixed_batching=self.mixed_batching,
            max_prefills=self.max_prefills,
            token_budget=self.token_budget, role=self.role,
            lora_queue_timeout_s=self.lora_queue_timeout_s,
            handoff_chunk_pages=self.handoff_chunk_pages,
            swap_preemption=self.swap_preemption,
            slo_aware=self.slo_aware,
            slo_preempt_headroom=self.slo_preempt_headroom,
            slo_preempt_cooldown_s=self.slo_preempt_cooldown_s,
            ckpt_interval_tokens=self.ckpt_interval_tokens,
            ckpt_budget_bytes=self.ckpt_budget_bytes,
            spec_tokens=self.spec_tokens,
            spec_ngram_max=self.spec_ngram_max,
            spec_ngram_min=self.spec_ngram_min,
            spec_probe_interval=self.spec_probe_interval, **kw)


def _refuse_unported(ecfg: EngineConfig) -> None:
    unported = {
        "async loop (async_loop)": ecfg.async_loop,
    }
    named = [name for name, on in unported.items() if on]
    if named:
        raise NotImplementedError(
            "not ported to the PyTorch engine yet: " + ", ".join(named))


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig = None,
                 params=None, clock: Callable[[], float] = time.monotonic,
                 kv_pool_client=None, engine_id: str = "engine-0",
                 seed: int = 0, ssd_pool=None, device=None):
        ecfg = ecfg or EngineConfig()
        if not PM.pageable(cfg):
            raise ValueError(
                f"{cfg.name}: paged engine requires a uniform dense/moe "
                "attention pattern; use the slot engine for hybrid/SSM")
        if cfg.layer_runs[0][0] != DENSE:
            raise NotImplementedError(
                f"{cfg.name}: only DENSE layers are ported so far")
        _refuse_unported(ecfg)
        validate_wire_dtype(ecfg.wire_dtype)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and ecfg.impl != "kernel":
            raise ValueError("on a CUDA device the engine runs the kernels "
                             f"(impl='kernel'), got impl={ecfg.impl!r}")
        self.cfg, self.ecfg = cfg, ecfg
        self.engine_id = engine_id
        self.clock = clock
        self.kv_pool = kv_pool_client
        self.runner = ModelRunner(cfg, ecfg, self.device, params=params,
                                  seed=seed)
        # host-DRAM KV tier: device evictions cascade into it and
        # preemption swaps to it instead of recomputing
        self.host_pool = None
        if ecfg.host_cache_gb > 0:
            self.host_pool = HostPagePool(
                capacity_bytes=int(ecfg.host_cache_gb * (1 << 30)))
        # SSD third tier (write-behind, file-backed) below the host tier
        self.ssd_pool = None
        if ssd_pool is not None and self.host_pool is not None:
            # a host-shared SharedSSDPool: attach this engine's view
            self.ssd_pool = ssd_pool.view(engine_id) \
                if hasattr(ssd_pool, "view") else ssd_pool
        elif ecfg.ssd_cache_gb > 0 and self.host_pool is not None:
            ssd_dir = ecfg.ssd_dir or tempfile.mkdtemp(
                prefix=f"kv-ssd-{engine_id}-")
            self.ssd_pool = SSDPagePool(
                capacity_bytes=int(ecfg.ssd_cache_gb * (1 << 30)),
                directory=ssd_dir)
        self.sched = Scheduler(
            ecfg.scheduler_config(),
            PageAllocator(ecfg.num_pages, ecfg.page_size),
            kv_pool=kv_pool_client, engine_id=engine_id,
            install_page=self._install_page,
            publish_page=self._publish_page,
            host_pool=self.host_pool,
            page_payload=self.runner.page_payload,
            page_bytes=self.runner.page_bytes,
            adapter_ready=lambda name: name in self.runner.adapter_ids,
            ssd_pool=self.ssd_pool)
        # unloads requested while the adapter still serves an in-flight
        # batch are deferred (applied at the next step() once the last
        # user drains): the control plane never disturbs a batch
        self._deferred_unloads: set = set()
        # predictive promotion: a daemon thread reads SSD pages off the
        # critical path; landed payloads queue here and are installed
        # into the host pool at step boundaries by the engine thread
        self._promote_req_q: Optional[queue.Queue] = None
        self._promote_q: Optional[queue.Queue] = None
        self._promoter: Optional[threading.Thread] = None

    # ----------------------------------------------------------- views
    @property
    def params(self):
        return self.runner.params

    @property
    def pool(self):
        return self.runner.pool

    @property
    def alloc(self) -> PageAllocator:
        return self.sched.alloc

    @property
    def waiting(self) -> List[Request]:
        return self.sched.waiting

    @property
    def prefills(self) -> List[Request]:
        return self.sched.prefills

    @property
    def running(self) -> List[Request]:
        return self.sched.running

    @property
    def finished(self) -> List[Request]:
        return self.sched.finished

    @property
    def handoff(self) -> Optional[Callable[[Request], None]]:
        return self.sched.handoff

    @handoff.setter
    def handoff(self, fn) -> None:
        self.sched.handoff = fn

    # ------------------------------------------------------------- LoRA
    def _adapters_in_use(self) -> set:
        """Adapters pinned by admitted (in-flight) requests."""
        return {r.lora_adapter
                for r in self.sched.running + self.sched.prefills
                if r.lora_adapter}

    def register_adapter(self, name: str, weights: dict = None) -> int:
        self._deferred_unloads.discard(name)   # re-wanted before unload
        return self.runner.register_adapter(
            name, weights, pinned=self._adapters_in_use())

    def unregister_adapter(self, name: str) -> None:
        if name in self._adapters_in_use():
            self._deferred_unloads.add(name)
            return
        self.runner.unregister_adapter(name)

    def _flush_deferred_unloads(self) -> None:
        if not self._deferred_unloads:
            return
        in_use = self._adapters_in_use()
        for name in list(self._deferred_unloads):
            if name not in in_use:
                self._deferred_unloads.discard(name)
                self.runner.unregister_adapter(name)

    @property
    def adapters(self) -> List[str]:
        return self.runner.adapters

    # ------------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        if (req.lora_adapter and self.ecfg.lora_autoload
                and req.lora_adapter not in self.runner.adapter_ids):
            try:
                self.register_adapter(req.lora_adapter)
            except RuntimeError:
                pass    # all slots pinned: queue behind adapter_ready
        self.sched.enqueue(req, self.clock())

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    # ------------------------------------------------------------- pool
    def _install_page(self, pid: int, payload, req: Request,
                      now: float, source: str = "pool",
                      stream: bool = False, nbytes: int = 0) -> None:
        """Payload hook for the scheduler's page walk (pool, host or SSD
        tier): write the fetched (k_page, v_page) arrays into a local
        device page, dequantizing compressed wire payloads first.
        ``stream`` only changes the simulator's cost attribution."""
        if isinstance(payload, CompressedPage):
            payload = decompress_page(payload)
        self.runner.write_remote_page(pid, *payload)

    def _publish_page(self, pid: int, block_hash: str, req: Request,
                      now: float) -> None:
        """Payload hook for the scheduler's prompt-page registration:
        copy the page off the device and publish it under its block
        hash, quantized to int8 with per-layer scales when the wire
        format asks for it."""
        payload = self.runner.page_payload(pid)
        size = self.runner.page_bytes
        if self.ecfg.wire_dtype == "int8":
            payload = compress_page(*payload)
            size = payload.nbytes
        self.kv_pool.publish(block_hash, payload, self.engine_id, now,
                             size_bytes=size)

    # -------------------------------------------------------- promotion
    def promote_session(self, session_id: str) -> int:
        """Prefetch a session's SSD-resident pages back into host DRAM
        ahead of its predicted next turn.  The SSD reads happen on a
        background daemon thread; payloads land in the host pool at the
        next step boundary.  Returns the number of pages queued."""
        if self.ssd_pool is None or self.host_pool is None:
            return 0
        keys = self.sched.session_promotable(session_id)
        if not keys:
            return 0
        self._ensure_promoter()
        self._promote_req_q.put((session_id, keys))
        return len(keys)

    def _ensure_promoter(self) -> None:
        if self._promoter is not None:
            return
        self._promote_req_q = queue.Queue()
        self._promote_q = queue.Queue()
        self._promoter = threading.Thread(
            target=self._promote_worker, daemon=True,
            name=f"kv-promote-{self.engine_id}")
        self._promoter.start()

    def _promote_worker(self) -> None:
        while True:
            sid, keys = self._promote_req_q.get()
            try:
                for key in keys:
                    payload = self.ssd_pool.get(key, self.clock())
                    if payload is not None:
                        self._promote_q.put((key, payload, sid))
            finally:
                self._promote_req_q.task_done()

    def _land_promotions(self) -> None:
        """Engine-thread drain: install prefetched pages in host DRAM."""
        if self._promote_q is None:
            return
        while True:
            try:
                key, payload, sid = self._promote_q.get_nowait()
            except queue.Empty:
                return
            self.sched.complete_promotion(
                key, payload,
                payload_nbytes(payload, self.runner.page_bytes),
                self.clock(), sid)

    def drain_promotions(self) -> None:
        """Block until all queued promotions have been read off SSD,
        then land them (deterministic tests / shutdown)."""
        if self._promote_req_q is not None:
            self._promote_req_q.join()
        self._land_promotions()

    # ------------------------------------------------------------- step
    def step(self) -> int:
        """One scheduler iteration.  Returns #tokens produced (one per
        decode row, several per row when a speculative step verified
        drafts, one per *completed* prefill)."""
        self._flush_deferred_unloads()
        self._land_promotions()
        return self._exec(self.sched.schedule(self.clock()))

    def _exec(self, out: ScheduleOutput) -> int:
        """Execute one declarative schedule synchronously."""
        if out.mode == "idle":
            return 0
        if out.mode == "decode":
            if out.spec:
                return self._step_spec(out)
            self._postprocess_decode(out.decode,
                                     self.runner.run_decode(out.decode))
            return len(out.decode)
        if out.mode == "prefill":      # lone prefill or two-phase chunk
            work = out.prefills[0]
            logits = self.runner.run_prefill(work)
            return 1 if self._advance_prefill(work, logits) else 0
        if out.spec:
            return self._step_spec(out)
        # mixed: one fused decode+prefill pass under the token budget
        dec_logits, pre_logits = self.runner.run_mixed(out)
        produced = 0
        # prefill bookkeeping first (their chunks are already in the pool)
        for i, work in enumerate(out.prefills):
            if work.chunk_len == 0:
                continue            # budget-starved this step
            if self._advance_prefill(work, pre_logits[i][None]):
                produced += 1
        if out.decode:
            self._postprocess_decode(out.decode,
                                     dec_logits[:len(out.decode)])
            produced += len(out.decode)
        return produced

    def _step_spec(self, out: ScheduleOutput) -> int:
        """One speculative verification step: every decode row carries its
        drafts as a short multi-query chunk, prefill chunks (when live)
        ride the same fused pass; acceptance appends the model's own
        samples, so the output stream is the one plain decoding gives."""
        spec_logits, pre_logits = self.runner.run_spec(out)
        produced = 0
        if pre_logits is not None:
            for i, work in enumerate(out.prefills):
                if work.chunk_len == 0:
                    continue
                if self._advance_prefill(work, pre_logits[i][None]):
                    produced += 1
        emitted = self.runner.verify_drafts(spec_logits, out.decode,
                                            out.spec)
        produced += self.sched.on_spec_batch(out.decode, out.spec,
                                             emitted, self.clock())
        return produced

    def _advance_prefill(self, work, logits) -> bool:
        """Advance one prefill chunk; True when it produced a token
        (prefill completed and its first token was sampled)."""
        req = work.req
        if not self.sched.note_prefill_progress(req, work.chunk_len):
            return False
        now = self.clock()
        self.sched.register_prompt_pages(req, now)
        if self.sched.wants_handoff:
            # disaggregated: the KV is in the pool; hand the request to a
            # decode engine.  The synchronous data plane flushes exactly
            # the records it just published, so the decode engine's
            # admission walk sees them instead of recomputing the prompt.
            self.sched.handoff_prefill(req, now)
            if self.kv_pool is not None:
                self.kv_pool.flush_hashes(
                    chunk_hashes(req.prompt_tokens, self.ecfg.page_size,
                                 req.lora_adapter or ""),
                    now)
            self.sched.deliver_handoff(req)
            return False
        tok = self.runner.sample(
            logits, [req],
            positions=[req.prompt_len + len(req.output_tokens)])[0]
        self.sched.finish_prefill(req, int(tok), now)
        self.sched.note_tokens(now, req.prompt_len + 1)
        return True

    def _postprocess_decode(self, reqs, logits) -> None:
        # per-position keys: the sample for a given (seed, absolute
        # position) is the same whether this row is decoded alone, in
        # any batch order, or as part of a speculative verification pass
        new = self.runner.sample(
            logits, reqs,
            positions=[r.prompt_len + len(r.output_tokens) for r in reqs])
        self.sched.on_decode_batch(reqs, new, self.clock())

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
        raise RuntimeError("engine did not drain")

    # ------------------------------------------------------------- metrics
    def metrics(self) -> EngineMetrics:
        m = self.sched.metrics(self.clock(),
                               loaded_adapters=tuple(self.adapters))
        m.lora_cold_loads = self.runner.adapter_loads
        m.lora_cold_load_s = self.runner.adapter_load_s
        m.lora_evictions = self.runner.adapter_evictions
        m.lora_host_hits = self.runner.adapter_host_hits
        return m

    def match_prefix_len(self, tokens) -> int:
        """Prefix-cache coverage for router scoring (non-mutating)."""
        return self.sched.match_prefix_len(tokens)

    @property
    def queue_depth(self) -> int:
        return self.sched.queue_depth
