"""Continuous-batching inference engine on PyTorch, the counterpart of
``repro/engine/engine.py``.

One ``InferenceEngine`` composes the copied scheduler
(:class:`repro_torch.engine.scheduler.Scheduler`, the same admission,
token-budget, chunking and preemption logic as the JAX engine) with a
:class:`repro_torch.engine.runner.ModelRunner` that executes each
schedule on a device: ``mixed_step`` for fused decode + prefill passes,
``decode_batch`` and ``prefill_step`` otherwise.

The engine runs on the card unless the caller names another device
(``device="cpu"`` for tests); on a CUDA device only ``impl="kernel"``
is accepted, so the plain attention never sits on the card's serving
path.  Not ported yet, and refused when configured: the host and SSD KV
tiers, the distributed KV pool client and P/D roles, speculative
decoding, the async loop, LoRA adapters and sampling at
temperature > 0.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from repro_torch.device import resolve_device
from repro_torch.engine import paged_model as PM
from repro_torch.engine.page_table import PageAllocator
from repro_torch.engine.request import Request
from repro_torch.engine.runner import ModelRunner
from repro_torch.engine.scheduler import (EngineMetrics, ScheduleOutput,
                                          Scheduler, SchedulerConfig)
from repro_torch.models.config import DENSE, ModelConfig


@dataclass
class EngineConfig:
    """The JAX engine's configuration, field for field (``impl`` takes
    ``"kernel"`` or ``"ref"``).  See ``repro/engine/engine.py`` for what
    each field does; the fields of features that are not ported yet are
    kept so that configurations carry over, and are refused when set."""
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


def _refuse_unported(ecfg: EngineConfig, kv_pool_client, ssd_pool) -> None:
    unported = {
        "host KV tier (host_cache_gb)": ecfg.host_cache_gb > 0,
        "SSD KV tier (ssd_cache_gb, ssd_pool)":
            ecfg.ssd_cache_gb > 0 or ssd_pool is not None,
        "distributed KV pool client": kv_pool_client is not None,
        "P/D roles (role)": ecfg.role != "mixed",
        "speculative decoding (spec_tokens)": ecfg.spec_tokens > 0,
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
        _refuse_unported(ecfg, kv_pool_client, ssd_pool)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and ecfg.impl != "kernel":
            raise ValueError("on a CUDA device the engine runs the kernels "
                             f"(impl='kernel'), got impl={ecfg.impl!r}")
        self.cfg, self.ecfg = cfg, ecfg
        self.engine_id = engine_id
        self.clock = clock
        self.runner = ModelRunner(cfg, ecfg, self.device, params=params,
                                  seed=seed)
        self.sched = Scheduler(
            ecfg.scheduler_config(),
            PageAllocator(ecfg.num_pages, ecfg.page_size),
            engine_id=engine_id, page_bytes=self.runner.page_bytes)

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

    # ------------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        if req.lora_adapter:
            raise NotImplementedError(
                f"request {req.request_id} names LoRA adapter "
                f"{req.lora_adapter!r}: LoRA is not ported yet")
        if req.sampling.temperature > 0:
            raise NotImplementedError(
                f"request {req.request_id}: sampling at temperature > 0 "
                "is not ported yet")
        self.sched.enqueue(req, self.clock())

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    # ------------------------------------------------------------- step
    def step(self) -> int:
        """One scheduler iteration.  Returns #tokens produced (one per
        decode row, one per *completed* prefill)."""
        return self._exec(self.sched.schedule(self.clock()))

    def _exec(self, out: ScheduleOutput) -> int:
        """Execute one declarative schedule synchronously."""
        if out.mode == "idle":
            return 0
        if out.mode == "decode":
            self._postprocess_decode(out.decode,
                                     self.runner.run_decode(out.decode))
            return len(out.decode)
        if out.mode == "prefill":      # lone prefill or two-phase chunk
            work = out.prefills[0]
            logits = self.runner.run_prefill(work)
            return 1 if self._advance_prefill(work, logits) else 0
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

    def _advance_prefill(self, work, logits) -> bool:
        """Advance one prefill chunk; True when it produced a token
        (prefill completed and its first token was sampled)."""
        req = work.req
        if not self.sched.note_prefill_progress(req, work.chunk_len):
            return False
        now = self.clock()
        self.sched.register_prompt_pages(req, now)
        tok = self.runner.sample(logits, [req])[0]
        self.sched.finish_prefill(req, int(tok), now)
        self.sched.note_tokens(now, req.prompt_len + 1)
        return True

    def _postprocess_decode(self, reqs, logits) -> None:
        new = self.runner.sample(logits, reqs)
        self.sched.on_decode_batch(reqs, new, self.clock())

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
        raise RuntimeError("engine did not drain")

    # ------------------------------------------------------------- metrics
    def metrics(self) -> EngineMetrics:
        return self.sched.metrics(self.clock())

    def match_prefix_len(self, tokens) -> int:
        """Prefix-cache coverage for router scoring (non-mutating)."""
        return self.sched.match_prefix_len(tokens)

    @property
    def queue_depth(self) -> int:
        return self.sched.queue_depth
