"""Slot-based engine for the models the paged engine does not take
(sliding-window patterns such as gemma3's 5:1 local:global, codebook
streams such as MusicGen, MLA layers such as deepseek-v2's), the
PyTorch counterpart of ``repro/engine/slot_engine.py``.

Every slot owns one row of contiguous per-slot caches
(``models.model.init_cache``).  A request is prefilled alone into a
fresh one-row cache, which is then copied over its slot's whole row in
place (every field: K/V, ring positions, MLA latents); the active
slots then decode together, one token per step, while empty slots carry
token 0 at position 0 as in the JAX engine.  The queue, admission and
finish bookkeeping is the copied
:class:`repro_torch.engine.scheduler.SchedulerCore`, so the
handle contract (``submit``/``step``/``metrics``/``match_prefix_len``)
is the paged engine's.

Sampling is the JAX slot engine's: one split of the engine's key stream
(``PRNGKey(seed + 1)``) per sampled step, no nucleus filter, and greedy
per codebook for codebook models.  The SSM and hybrid layer types are
not ported yet, so xLSTM and Hymba configs are refused.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine.request import Request, RequestState
from repro_torch.engine.runner import DTYPES
from repro_torch.engine.sampling import prng_key, sample, split
from repro_torch.engine.scheduler import EngineMetrics, SchedulerCore
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclass
class SlotEngineConfig:
    max_slots: int = 4
    max_len: int = 256
    dtype: str = "float32"


class SlotEngine:
    def __init__(self, cfg: ModelConfig, ecfg: SlotEngineConfig = None,
                 params=None, clock: Callable[[], float] = time.monotonic,
                 engine_id: str = "slot-0", seed: int = 0, device=None):
        self.cfg = cfg
        self.ecfg = ecfg or SlotEngineConfig()
        self.clock = clock
        self.engine_id = engine_id
        if self.ecfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                             f"{self.ecfg.dtype!r}")
        self.dtype = DTYPES[self.ecfg.dtype]
        self.device = resolve_device(device)
        # raises for the layer types that are not ported, params given or not
        M.model_specs(cfg)
        self.params = params if params is not None else M.init(
            cfg, seed, self.dtype, self.device)
        self.caches = M.init_cache(cfg, self.ecfg.max_slots,
                                   self.ecfg.max_len, self.dtype, self.device)
        self.slots: List[Optional[Request]] = [None] * self.ecfg.max_slots
        self.core = SchedulerCore()
        self._key = prng_key(seed + 1)

    # ------------------------------------------------------------ contract
    def submit(self, req: Request) -> None:
        self.core.enqueue(req, self.clock())

    @property
    def waiting(self) -> List[Request]:
        return self.core.waiting

    @property
    def finished(self) -> List[Request]:
        return self.core.finished

    @property
    def has_work(self) -> bool:
        return bool(self.core.waiting or any(self.slots))

    def match_prefix_len(self, tokens) -> int:
        return 0                     # no token-addressable KV

    @property
    def queue_depth(self) -> int:
        """Cheap routing-load accessor (== metrics() num_running +
        num_waiting)."""
        return (sum(r is not None for r in self.slots)
                + len(self.core.waiting))

    def register_adapter(self, name, weights=None):   # parity no-op
        pass

    def unregister_adapter(self, name):
        pass

    # ------------------------------------------------------------ internals
    def _prefill_into_slot(self, req: Request, slot: int) -> None:
        toks = torch.tensor([req.prompt_tokens], dtype=torch.int32,
                            device=self.device)
        one_cache = M.init_cache(self.cfg, 1, self.ecfg.max_len, self.dtype,
                                 self.device)
        logits, one_cache = M.prefill(self.params, self.cfg, toks, one_cache)
        # write the single-row cache over this slot's row, in place
        for run, one in zip(self.caches, one_cache):
            for name, c in run.items():
                c[:, slot] = one[name][:, 0]
        tok = self._sample(logits.reshape(1, -1), [req])[0]
        now = self.clock()
        tok = tok.tolist() if self.cfg.num_codebooks else int(tok)
        self._push_token(req, tok, now, first=True)
        req.state = RequestState.RUNNING
        self.core.note_admitted(req, now)
        req.slot = slot
        self.slots[slot] = req

    def _push_token(self, req: Request, tok, now, first=False) -> None:
        req.output_tokens.append(tok)
        if first:
            req.first_token_time = now
        else:
            req.token_times.append(now)
        self.core.note_tokens(now, 1)

    def _sample(self, logits: torch.Tensor, reqs) -> np.ndarray:
        if self.cfg.num_codebooks:
            # greedy per codebook
            lg = logits.reshape(len(reqs), self.cfg.num_codebooks, -1)
            return torch.argmax(lg.float(), -1).to(torch.int32).cpu().numpy()
        temps = [r.sampling.temperature for r in reqs[:logits.shape[0]]]
        self._key, sub = split(self._key)
        return sample(logits, sub, temps).cpu().numpy()

    def step(self) -> int:
        # admit (shared admission scan: FIFO, failing oversized requests)
        while self.core.waiting and None in self.slots:
            req = self.core.waiting[0]
            total = req.prompt_len + req.sampling.max_new_tokens
            if total > self.ecfg.max_len:
                req.state = RequestState.FAILED
                self.core.waiting.pop(0)
                continue
            self.core.waiting.pop(0)
            self._prefill_into_slot(req, self.slots.index(None))
            self._maybe_finish(self.slots[req.slot])
            return 1
        # batched decode over all slots; empty ones carry token 0 at 0
        active = [r for r in self.slots if r is not None]
        if not active:
            return 0
        b = self.ecfg.max_slots
        if self.cfg.num_codebooks:
            toks = np.zeros((b, self.cfg.num_codebooks), np.int32)
        else:
            toks = np.zeros(b, np.int32)
        pos = np.zeros(b, np.int32)
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            toks[i] = r.output_tokens[-1]
            pos[i] = r.prompt_len + len(r.output_tokens) - 1
        logits, self.caches = M.decode_step(
            self.params, self.cfg, self.caches,
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device))
        new = self._sample(logits if self.cfg.num_codebooks
                           else logits.reshape(b, -1),
                           [r or Request(prompt_tokens=[0])
                            for r in self.slots])
        now = self.clock()
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            tok = new[i].tolist() if self.cfg.num_codebooks else int(new[i])
            self._push_token(r, tok, now)
            self._maybe_finish(r)
        return len(active)

    def _maybe_finish(self, req: Request) -> None:
        if req is None or not self.core.request_done(req):
            return
        if req.slot >= 0:
            self.slots[req.slot] = None
            req.slot = -1
        self.core.note_finished(req, self.clock())

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
        raise RuntimeError("slot engine did not drain")

    def metrics(self) -> EngineMetrics:
        now = self.clock()
        used = sum(r is not None for r in self.slots)
        return EngineMetrics(
            num_running=used, num_waiting=len(self.core.waiting),
            kv_utilization=used / max(self.ecfg.max_slots, 1),
            tokens_per_sec=self.core.throughput(now),
            avg_latency=self.core.avg_latency,
            avg_queue_time=self.core.avg_queue_time,
            admitted_requests=self.core.admitted_count,
            finished_requests=self.core.finished_count,
            slo_attainment=self.core.slo_attainment(now),
            slo_by_class=self.core.slo_class_stats(now),
            slo_itl_attainment=self.core.slo_itl_attainment(now))
