"""ModelRunner: executes a ``ScheduleOutput`` on the PyTorch model, the
counterpart of ``repro/engine/runner.py``.

The runner owns everything device-shaped: the params, the paged KV
``PagePool`` (updated in place by every step), the high-density LoRA
bank, the sampling key stream and the persistent host input buffers,
allocated once and refilled per step.  The pool holds ``num_pages + 1``
pages: the last is the scratch page that padding block-table entries
point at.

Sampling keys are the JAX package's: with ``positions`` every row is
keyed by (request seed, absolute position) through ``row_keys``, so a
speculative verification pass samples each position as step-by-step
decoding would; without, one split of the runner's own key stream
(``PRNGKey(seed + 1)``) per call.

The async loop's decode step (``run_decode_async``) queues its inputs,
the forward pass, the sampling and the copy of the sampled tokens to the
host on the device's current stream without waiting for anything: its
inputs travel from a pinned staging buffer (``non_blocking``), tokens
still in flight come from the previous dispatch's device tensor, and the
copy back lands in a pinned tensor behind an event.  ``readback`` is the
one wait, and charges it to ``device_wait_s``, as the sync paths'
readbacks are charged.

It also owns the page *payload* side of the KV tiers: a page leaves the
device as numpy ``(L, page, Hkv, D)`` K and V arrays, the JAX package's
format (``repro_torch.payload``), so the host, SSD and distributed tiers
hold the same payloads for both packages.
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.engine import paged_model as PM
from repro_torch.engine.request import Request
from repro_torch.engine.sampling import prng_key, row_keys, sample, split
from repro_torch.engine.scheduler import PrefillWork, ScheduleOutput
from repro_torch.engine.speculative import accept_length
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.payload import from_payload, to_payload

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class InFlight(NamedTuple):
    """The sampled tokens of an async decode dispatch: ``dev`` (B,) int32
    on the device, which the next dispatch reads without a sync, and
    ``host``, their copy queued behind the step (pinned on a card), done
    when ``done`` is (None on the CPU, where it is done at once)."""
    dev: torch.Tensor
    host: torch.Tensor
    done: Optional["torch.cuda.Event"]


class ModelRunner:
    """Turns declarative schedules into forward passes on ``device``."""

    # process-wide device-wait accumulator (the per-runner one summed
    # over every runner of the process)
    total_device_wait_s = 0.0

    def __init__(self, cfg: ModelConfig, ecfg, device: torch.device,
                 params=None, seed: int = 0):
        self.cfg, self.ecfg, self.device = cfg, ecfg, device
        if ecfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                             f"{ecfg.dtype!r}")
        dtype = DTYPES[ecfg.dtype]
        self.params = params if params is not None else M.init(
            cfg, seed, dtype, device)
        self.pool = PM.init_pool(cfg, ecfg.num_pages + 1, ecfg.page_size,
                                 dtype, device)  # +1: scratch page
        self.lora = PM.init_lora(cfg, ecfg.max_adapters, ecfg.lora_rank,
                                 dtype, device)
        self._adapter_ids: Dict[str, int] = {}
        self._free_adapter_slots = list(range(1, ecfg.max_adapters))
        self._key = prng_key(seed + 1)      # on the CPU: split per call
        # adapter tiering (HBM bank <-> bounded host tier <-> artifact
        # store): weights are a pure function of (engine seed, adapter
        # NAME), never of the bank slot, so eviction is always safe
        # (re-load is byte-identical) and slot reuse cannot leak
        self._seed = seed
        self._adapter_lru: Dict[str, int] = {}
        self._lru_tick = 0
        self._host_adapters: Dict[str, dict] = {}
        self._host_adapter_slots = ecfg.host_adapter_slots
        self.adapter_loads = 0          # non-resident registers paid
        self.adapter_load_s = 0.0       # wall seconds stalled on them
        self.adapter_evictions = 0      # LRU bank evictions
        self.adapter_host_hits = 0      # loads served from the host tier
        # persistent host input buffers (allocated once, refilled per
        # step; block tables are sliced to the bucketed width in use)
        b, kk = ecfg.max_batch, ecfg.max_prefills
        nbmax = ecfg.max_pages_per_seq
        self._dec_toks = np.zeros(b, np.int32)
        self._dec_pos = np.zeros(b, np.int32)
        self._dec_bts = np.full((b, nbmax), ecfg.num_pages, np.int32)
        self._dec_active = np.zeros(b, bool)
        self._dec_aids = np.zeros(b, np.int32)
        # floor of one row: two-phase prefill writes row 0 even when
        # the mixed scheduler is configured with max_prefills=0
        kk1 = max(kk, 1)
        self._pre_toks = np.zeros((kk1, ecfg.chunk_size), np.int32)
        self._pre_ctx = np.zeros(kk1, np.int32)
        self._pre_chunk = np.zeros(kk1, np.int32)
        self._pre_aids = np.zeros(kk1, np.int32)
        self._pre_bts = np.full((kk1, nbmax), ecfg.num_pages, np.int32)
        # speculative verification buffers: every decode row becomes a
        # fixed-width chunk [last_token, draft_1..draft_d], padded to the
        # full width (0 valid rows mark an idle lane)
        sd = 1 + max(ecfg.spec_tokens, 0)
        self._spec_toks = np.zeros((b, sd), np.int32)
        self._spec_ctx = np.zeros(b, np.int32)
        self._spec_len = np.zeros(b, np.int32)
        # seconds spent blocked on the device (readbacks and the staging
        # buffer's guard): with the engine's step wall it gives
        # host_overhead_frac, the share of a step the async loop hides
        self.device_wait_s = 0.0
        # the async decode step's inputs, packed into one int32 buffer
        # (pinned on a card, so its copy is queued, not waited on) and
        # the event recorded after its last copy: the buffer is refilled
        # only once that copy has run (``_sync_inflight``)
        self._stage = torch.zeros(
            6 * b + b * nbmax, dtype=torch.int32,
            pin_memory=device.type == "cuda")
        self._inflight: Optional[torch.cuda.Event] = None

    def _charge(self, dt: float) -> None:
        self.device_wait_s += dt
        ModelRunner.total_device_wait_s += dt

    def _sync_inflight(self) -> None:
        """Wait until the staging buffer's last copy to the device has
        run, so that refilling it cannot change what that copy reads."""
        if self._inflight is not None:
            t0 = time.perf_counter()
            self._inflight.synchronize()
            self._charge(time.perf_counter() - t0)
            self._inflight = None

    def readback(self, x: Union[torch.Tensor, InFlight]) -> np.ndarray:
        """A device tensor (or an async dispatch's tokens) on the host,
        the wait charged to ``device_wait_s``: the async loop's one sync
        point, and the end of every sync step."""
        t0 = time.perf_counter()
        if isinstance(x, InFlight):
            if x.done is not None:
                x.done.synchronize()
            out = x.host.numpy().copy()
        else:
            out = x.cpu().numpy()
        self._charge(time.perf_counter() - t0)
        return out

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Copy a host buffer to the device (a copy on the CPU too: the
        buffer is refilled next step)."""
        return torch.from_numpy(a).to(self.device, copy=True)

    # ------------------------------------------------------------- LoRA
    def _adapter_seed(self, name: str) -> int:
        """The 'artifact store': adapter weights derive from the NAME (and
        the engine seed), so any tier can drop them and re-materialize
        them byte-identically.  The port's own stream: its weights differ
        from the JAX package's for the same name."""
        return ((self._seed + 2) << 32) | (zlib.crc32(name.encode())
                                           & 0x7FFFFFFF)

    def _touch_adapter(self, name: str) -> None:
        self._lru_tick += 1
        self._adapter_lru[name] = self._lru_tick

    def register_adapter(self, name: str, weights: Optional[dict] = None,
                         pinned=()) -> int:
        """Dynamic high-density LoRA registration.

        When the bank is full, the least-recently-used resident adapter
        not in ``pinned`` (adapters of in-flight batches) is evicted into
        the bounded host tier.  Weights (tensors or float32 arrays of the
        shapes ``PM.make_adapter`` gives) come from, in order: the
        caller, the host tier, the artifact store
        (:meth:`_adapter_seed`).  The wall time of a non-resident load
        accumulates in ``adapter_load_s``."""
        if name in self._adapter_ids:
            self._touch_adapter(name)
            return self._adapter_ids[name]
        t0 = time.perf_counter()
        if not self._free_adapter_slots:
            victim = next(
                (n for n in sorted(self._adapter_ids,
                                   key=lambda a: self._adapter_lru.get(a, 0))
                 if n not in pinned), None)
            if victim is None:
                raise RuntimeError(
                    "adapter slots exhausted and every resident adapter "
                    "is pinned by an in-flight batch")
            self.unregister_adapter(victim)
            self.adapter_evictions += 1
        idx = self._free_adapter_slots.pop(0)
        if weights is None:
            host = self._host_adapters.pop(name, None)
            if host is not None:
                weights = host
                self.adapter_host_hits += 1
            else:
                weights = PM.make_adapter(self.cfg, self.ecfg.lora_rank,
                                          self._adapter_seed(name))
        for k in self.lora:
            self.lora[k][idx].copy_(torch.as_tensor(weights[k]))
        if self.device.type == "cuda":      # the stall is the load's
            torch.cuda.synchronize(self.device)
        self._adapter_ids[name] = idx
        self._touch_adapter(name)
        self.adapter_loads += 1
        self.adapter_load_s += time.perf_counter() - t0
        return idx

    def unregister_adapter(self, name: str) -> None:
        idx = self._adapter_ids.pop(name, None)
        if idx is None:
            return
        if self._host_adapter_slots > 0:
            # LRU cascade: bank victims fall into the bounded host tier
            # (copies: the slot is zeroed and reused below); host
            # overflow drops to the artifact store (safe: weights are
            # name-keyed, so re-load is byte-identical)
            self._host_adapters[name] = {
                k: self.lora[k][idx].to("cpu", copy=True) for k in self.lora}
            while len(self._host_adapters) > self._host_adapter_slots:
                self._host_adapters.pop(next(iter(self._host_adapters)))
        self._adapter_lru.pop(name, None)
        for t in self.lora.values():
            t[idx].zero_()
        self._free_adapter_slots.append(idx)

    @property
    def adapters(self) -> List[str]:
        return sorted(self._adapter_ids)

    @property
    def adapter_ids(self) -> Dict[str, int]:
        return self._adapter_ids

    def _aid(self, req: Request) -> int:
        if not req.lora_adapter:
            return 0
        idx = self._adapter_ids.get(req.lora_adapter)
        if idx is None:
            # loud: a non-resident adapter must queue at admission
            # (Scheduler.adapter_ready), never silently serve base
            raise RuntimeError(
                f"request {req.request_id} reached the data plane with "
                f"non-resident adapter {req.lora_adapter!r}")
        self._touch_adapter(req.lora_adapter)
        return idx

    def _bank(self, *aids: np.ndarray) -> Optional[dict]:
        """The bank for a step, or None when every row uses slot 0.  The
        skip is exact: slot 0 is all zeros, so its deltas are exact zeros
        and q + rope(0) = q, v + 0 = v in any dtype.  A step that mixes
        slot 0 with other slots gathers every row, as the JAX package
        does."""
        return self.lora if any(a.any() for a in aids) else None

    # ---------------------------------------------------------- sampling
    def sample(self, logits: torch.Tensor, reqs: List[Request],
               positions: Optional[List[int]] = None) -> np.ndarray:
        """``positions`` (absolute index of the token being produced, per
        row) switches to per-position keys (seed x position through
        ``row_keys``): the sample then depends neither on batch order
        nor on how many positions one pass verifies.  Without it, one
        split of the runner's key stream keys the batch.  A greedy
        batch needs no per-position keys, and gets none (their host cost
        would be paid every step)."""
        b = logits.shape[0]
        temps = np.zeros(b, np.float32)
        tops = np.ones(b, np.float32)
        for i, r in enumerate(reqs[:b]):
            temps[i] = r.sampling.temperature
            tops[i] = r.sampling.top_p
        keys = None
        sub = self._key
        if positions is None:
            self._key, sub = split(self._key)
        elif (temps > 0).any():
            seeds = np.zeros(b, np.int64)
            pos = np.zeros(b, np.int64)     # pad to the logits batch
            for i, r in enumerate(reqs[:b]):
                seeds[i] = r.sampling.seed
                pos[i] = positions[i]
            keys = row_keys(seeds, pos)
        return self.readback(sample(logits, sub, temps, top_k=0,
                                    top_p=tops, keys=keys))

    # ------------------------------------------------------- input prep
    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.ecfg.page_size)

    def _bt_width(self, pages_needed: int) -> int:
        """Bucketed block-table width: bounds the decode kernel's page
        loop by what the batch actually uses (multiples of 4) instead of
        the full ``max_pages_per_seq``."""
        cap = -(-max(pages_needed, 1) // 4) * 4
        return min(cap, self.ecfg.max_pages_per_seq)

    def _decode_inputs(self, reqs: List[Request]):
        ecfg = self.ecfg
        nb = self._bt_width(max((self._pages_for(
            r.prompt_len + len(r.output_tokens)) for r in reqs),
            default=1))
        toks, pos, active = self._dec_toks, self._dec_pos, self._dec_active
        aids = self._dec_aids
        bts = self._dec_bts[:, :nb]
        toks[:] = 0
        pos[:] = 0
        bts[:] = ecfg.num_pages             # scratch page
        active[:] = False
        aids[:] = 0
        for i, r in enumerate(reqs):
            toks[i] = r.output_tokens[-1]
            pos[i] = r.prompt_len + len(r.output_tokens) - 1
            n = min(len(r.page_ids), nb)
            bts[i, :n] = r.page_ids[:n]
            active[i] = True
            aids[i] = self._aid(r)
        return (self._dev(toks), self._dev(pos),
                self._dev(np.ascontiguousarray(bts)), self._dev(active),
                self._dev(aids))

    def _prefill_inputs(self, works: List[PrefillWork], s: int):
        ecfg = self.ecfg
        kk = ecfg.max_prefills
        if s == ecfg.chunk_size:
            pre_toks = self._pre_toks
        else:                               # unchunked: dynamic width
            pre_toks = np.zeros((kk, s), np.int32)
        pre_ctx, pre_chunk = self._pre_ctx, self._pre_chunk
        pre_aids = self._pre_aids
        nb_pre = self._bt_width(max((self._pages_for(w.start + w.chunk_len)
                                     for w in works), default=1))
        pre_bts = self._pre_bts[:, :nb_pre]
        pre_toks[:] = 0
        pre_ctx[:] = 0
        pre_chunk[:] = 0
        pre_aids[:] = 0
        pre_bts[:] = ecfg.num_pages
        for i, w in enumerate(works):
            p, c = w.req, w.chunk_len
            pre_toks[i, :c] = p.prompt_tokens[w.start:w.start + c]
            pre_ctx[i] = w.start
            pre_chunk[i] = c
            n = min(len(p.page_ids), nb_pre)
            pre_bts[i, :n] = p.page_ids[:n]
            pre_aids[i] = self._aid(p)
        return (self._dev(pre_toks), self._dev(pre_ctx),
                self._dev(pre_chunk),
                self._dev(np.ascontiguousarray(pre_bts)),
                self._dev(pre_aids))

    # ---------------------------------------------------------- execute
    def run_mixed(self, out: ScheduleOutput
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One fused decode+prefill pass; returns (dec_logits, pre_logits)."""
        pre_toks, pre_ctx, pre_chunk, pre_bts, pre_aids = \
            self._prefill_inputs(out.prefills, out.pad_len)
        toks, pos, bts, active, aids = self._decode_inputs(out.decode)
        dec_logits, pre_logits, self.pool = PM.mixed_step(
            self.params, self.pool, toks, pos, bts, active, pre_toks,
            pre_bts, pre_ctx, pre_chunk,
            self._bank(self._dec_aids, self._pre_aids), aids, pre_aids,
            cfg=self.cfg,
            page_size=self.ecfg.page_size, impl=self.ecfg.impl)
        return dec_logits, pre_logits

    def run_decode(self, reqs: List[Request]) -> torch.Tensor:
        toks, pos, bts, active, aids = self._decode_inputs(reqs)
        logits, self.pool = PM.decode_batch(
            self.params, self.pool, toks, pos, bts, active,
            self._bank(self._dec_aids), aids, cfg=self.cfg,
            page_size=self.ecfg.page_size, impl=self.ecfg.impl)
        return logits

    # -------------------------------------------------- speculative step
    def _spec_inputs(self, reqs: List[Request], spec: List[List[int]]):
        ecfg = self.ecfg
        nb = self._bt_width(max((self._pages_for(
            r.prompt_len + len(r.output_tokens) + len(d))
            for r, d in zip(reqs, spec)), default=1))
        toks, ctx, slen = self._spec_toks, self._spec_ctx, self._spec_len
        aids = self._dec_aids
        bts = self._dec_bts[:, :nb]
        toks[:] = 0
        ctx[:] = 0
        slen[:] = 0                         # 0 marks an idle lane
        aids[:] = 0
        bts[:] = ecfg.num_pages             # scratch page
        for i, (r, d) in enumerate(zip(reqs, spec)):
            toks[i, 0] = r.output_tokens[-1]
            toks[i, 1:1 + len(d)] = d
            ctx[i] = r.prompt_len + len(r.output_tokens) - 1
            slen[i] = 1 + len(d)
            n = min(len(r.page_ids), nb)
            bts[i, :n] = r.page_ids[:n]
            aids[i] = self._aid(r)
        return (self._dev(toks), self._dev(ctx), self._dev(slen),
                self._dev(np.ascontiguousarray(bts)), self._dev(aids))

    def run_spec(self, out: ScheduleOutput
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One speculative verification pass.  Decode-only schedules take
        ``PM.spec_decode_step``; schedules carrying live prefill chunks
        fuse them through ``PM.spec_mixed_step``.  Returns (spec logits
        (B, SD, V), prefill logits (K, V) or None)."""
        ecfg = self.ecfg
        kw = dict(cfg=self.cfg, page_size=ecfg.page_size, impl=ecfg.impl)
        if any(w.chunk_len > 0 for w in out.prefills):
            pre_toks, pre_ctx, pre_chunk, pre_bts, pre_aids = \
                self._prefill_inputs(out.prefills, out.pad_len)
            toks, ctx, slen, bts, aids = self._spec_inputs(out.decode,
                                                           out.spec)
            spec_logits, pre_logits, self.pool = PM.spec_mixed_step(
                self.params, self.pool, toks, ctx, slen, bts, pre_toks,
                pre_bts, pre_ctx, pre_chunk,
                self._bank(self._dec_aids, self._pre_aids), aids,
                pre_aids, **kw)
            return spec_logits, pre_logits
        toks, ctx, slen, bts, aids = self._spec_inputs(out.decode, out.spec)
        spec_logits, self.pool = PM.spec_decode_step(
            self.params, self.pool, toks, ctx, slen, bts,
            self._bank(self._dec_aids), aids, **kw)
        return spec_logits, None

    def verify_drafts(self, spec_logits: torch.Tensor, reqs: List[Request],
                      spec: List[List[int]]) -> List[List[int]]:
        """Sample EVERY verification row with per-position keys and accept
        each row's longest draft prefix that matches the model's own
        samples.  Returns per-request emitted token lists (accepted
        prefix + the bonus/correction token): what step-by-step decoding
        would have produced."""
        b, sd, v = spec_logits.shape
        temps = np.zeros(b * sd, np.float32)
        tops = np.ones(b * sd, np.float32)
        seeds = np.zeros(b * sd, np.int64)
        pos = np.zeros(b * sd, np.int64)
        for i, r in enumerate(reqs):
            temps[i * sd:(i + 1) * sd] = r.sampling.temperature
            tops[i * sd:(i + 1) * sd] = r.sampling.top_p
            seeds[i * sd:(i + 1) * sd] = r.sampling.seed
            base = r.prompt_len + len(r.output_tokens)
            pos[i * sd:(i + 1) * sd] = base + np.arange(sd)
        keys = row_keys(seeds, pos) if (temps > 0).any() else None
        sampled = self.readback(sample(
            spec_logits.reshape(b * sd, v), self._key, temps, top_k=0,
            top_p=tops, keys=keys)).reshape(b, sd)
        emitted = []
        for i, d in enumerate(spec):
            m = accept_length(d, sampled[i, :len(d) + 1])
            emitted.append([int(t) for t in sampled[i, :m + 1]])
        return emitted

    # ------------------------------------------------ async decode step
    def run_decode_async(self, reqs: List[Request],
                         prev: Optional[dict]) -> InFlight:
        """Dispatch a decode step WITHOUT waiting for the previous one.

        The inputs go through the staging buffer to the device without a
        wait; a row whose last token is still in flight (the host holds
        a PENDING placeholder for it) takes it on the device from
        ``prev["tok_dev"]``, the previous dispatch's tokens, through an
        index made on the host; the step samples on the device with
        per-position keys and queues the copy of its tokens to the host.
        Returns the step's :class:`InFlight` tokens."""
        ecfg = self.ecfg
        b = ecfg.max_batch
        nb = self._bt_width(max((self._pages_for(
            r.prompt_len + len(r.output_tokens)) for r in reqs),
            default=1))
        n_in = 6 * b + b * nb
        self._sync_inflight()
        buf = self._stage.numpy()[:n_in]
        buf[:] = 0
        toks, pos, active, aids, src, from_prev = buf[:6 * b].reshape(6, b)
        bts = buf[6 * b:].reshape(b, nb)
        bts[:] = ecfg.num_pages             # scratch page
        temps = np.zeros(b, np.float32)
        tops = np.ones(b, np.float32)
        seeds = np.zeros(b, np.int64)
        prev_rows = ({id(r): j for j, r in enumerate(prev["reqs"])}
                     if prev else {})
        for i, r in enumerate(reqs):
            if getattr(r, "_pending_toks", 0) and id(r) in prev_rows:
                src[i] = prev_rows[id(r)]   # token still on the device
                from_prev[i] = 1
            else:
                toks[i] = r.output_tokens[-1]
            pos[i] = r.prompt_len + len(r.output_tokens) - 1
            n = min(len(r.page_ids), nb)
            bts[i, :n] = r.page_ids[:n]
            active[i] = 1
            aids[i] = self._aid(r)
            temps[i] = r.sampling.temperature
            tops[i] = r.sampling.top_p
            seeds[i] = r.sampling.seed
        # one copy of the packed inputs, queued behind the device's work
        if self.device.type == "cuda":
            dev = self._stage[:n_in].to(self.device, non_blocking=True)
            self._inflight = torch.cuda.Event()
            self._inflight.record()
        else:
            dev = self._stage[:n_in].clone()
        d_toks, d_pos, d_active, d_aids, d_src, d_from = \
            dev[:6 * b].view(6, b)
        tok_in = d_toks
        if from_prev.any():
            tok_in = torch.where(
                d_from.bool(),
                prev["tok_dev"].dev.index_select(0, d_src.long()), d_toks)
        logits, self.pool = PM.decode_batch(
            self.params, self.pool, tok_in, d_pos, dev[6 * b:].view(b, nb),
            d_active.bool(), self._bank(aids), d_aids, cfg=self.cfg,
            page_size=ecfg.page_size, impl=ecfg.impl,
            rows=torch.arange(len(reqs), device=self.device))
        keys = (row_keys(seeds, pos.astype(np.int64) + 1)
                if (temps > 0).any() else None)
        tok_dev = sample(logits, self._key, temps, top_k=0, top_p=tops,
                         keys=keys)
        if self.device.type != "cuda":
            return InFlight(tok_dev, tok_dev, None)
        host = torch.empty(b, dtype=torch.int32, pin_memory=True)
        host.copy_(tok_dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return InFlight(tok_dev, host, done)

    def run_prefill(self, work: PrefillWork) -> torch.Tensor:
        """One (possibly chunked) prefill for ONE request (two-phase)."""
        ecfg = self.ecfg
        req, s, c = work.req, work.pad_len, work.chunk_len
        if s == ecfg.chunk_size:
            toks = self._pre_toks[:1]
            toks[:] = 0
        else:
            toks = np.zeros((1, s), np.int32)
        toks[0, :c] = req.prompt_tokens[work.start:work.start + c]
        nb = self._bt_width(self._pages_for(work.start + c))
        bt = self._pre_bts[:1, :nb]
        bt[:] = ecfg.num_pages              # scratch page
        n = min(len(req.page_ids), nb)
        bt[0, :n] = req.page_ids[:n]
        aid = np.array([self._aid(req)], np.int32)
        logits, self.pool = PM.prefill_step(
            self.params, self.pool, self._dev(np.ascontiguousarray(toks)),
            self._dev(np.ascontiguousarray(bt)), work.start, c,
            self._bank(aid), self._dev(aid), cfg=self.cfg,
            page_size=ecfg.page_size, impl=ecfg.impl)
        return logits

    # ------------------------------------------------------- pool payloads
    @property
    def page_bytes(self) -> int:
        """Raw (k + v) payload bytes of one page — what the scheduler's
        capacity accounting and transfer counters charge."""
        k = self.pool.k
        return int(2 * k[:, 0].numel() * k.element_size())

    def page_payload(self, pid: int) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize one page's (k, v) as numpy ``(L, page, Hkv, D)``
        arrays for a pool publish or a host-tier offload: the
        device-to-host copy the scheduler's contains() gate avoids for
        blocks the pool already holds."""
        return (to_payload(self.pool.k[:, pid]),
                to_payload(self.pool.v[:, pid]))

    def write_remote_page(self, pid: int, k_page, v_page) -> None:
        """Install a page payload (from the distributed pool or a host or
        SSD tier) into local page ``pid``, in place, cast to the pool's
        dtype."""
        self.pool.k[:, pid].copy_(from_payload(k_page))
        self.pool.v[:, pid].copy_(from_payload(v_page))
