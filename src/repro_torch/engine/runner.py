"""ModelRunner: executes a ``ScheduleOutput`` on the PyTorch model, the
counterpart of ``repro/engine/runner.py`` (no LoRA, speculation, async
loop or page payloads yet).

The runner owns everything device-shaped: the params, the paged KV
``PagePool`` (updated in place by every step) and the persistent host
input buffers, allocated once and refilled per step.  The pool holds
``num_pages + 1`` pages: the last is the scratch page that padding
block-table entries point at.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.engine import paged_model as PM
from repro_torch.engine.request import Request
from repro_torch.engine.sampling import sample
from repro_torch.engine.scheduler import PrefillWork, ScheduleOutput
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ModelRunner:
    """Turns declarative schedules into forward passes on ``device``."""

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
        # persistent host input buffers (allocated once, refilled per
        # step; block tables are sliced to the bucketed width in use)
        b, kk = ecfg.max_batch, ecfg.max_prefills
        nbmax = ecfg.max_pages_per_seq
        self._dec_toks = np.zeros(b, np.int32)
        self._dec_pos = np.zeros(b, np.int32)
        self._dec_bts = np.full((b, nbmax), ecfg.num_pages, np.int32)
        self._dec_active = np.zeros(b, bool)
        # floor of one row: two-phase prefill writes row 0 even when
        # the mixed scheduler is configured with max_prefills=0
        kk1 = max(kk, 1)
        self._pre_toks = np.zeros((kk1, ecfg.chunk_size), np.int32)
        self._pre_ctx = np.zeros(kk1, np.int32)
        self._pre_chunk = np.zeros(kk1, np.int32)
        self._pre_bts = np.full((kk1, nbmax), ecfg.num_pages, np.int32)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Copy a host buffer to the device (a copy on the CPU too: the
        buffer is refilled next step)."""
        return torch.from_numpy(a).to(self.device, copy=True)

    # ---------------------------------------------------------- sampling
    def sample(self, logits: torch.Tensor, reqs: List[Request]
               ) -> np.ndarray:
        temps = [r.sampling.temperature for r in reqs[:logits.shape[0]]]
        return sample(logits, temps).cpu().numpy()

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
        bts = self._dec_bts[:, :nb]
        toks[:] = 0
        pos[:] = 0
        bts[:] = ecfg.num_pages             # scratch page
        active[:] = False
        for i, r in enumerate(reqs):
            toks[i] = r.output_tokens[-1]
            pos[i] = r.prompt_len + len(r.output_tokens) - 1
            n = min(len(r.page_ids), nb)
            bts[i, :n] = r.page_ids[:n]
            active[i] = True
        return (self._dev(toks), self._dev(pos),
                self._dev(np.ascontiguousarray(bts)), self._dev(active))

    def _prefill_inputs(self, works: List[PrefillWork], s: int):
        ecfg = self.ecfg
        kk = ecfg.max_prefills
        if s == ecfg.chunk_size:
            pre_toks = self._pre_toks
        else:                               # unchunked: dynamic width
            pre_toks = np.zeros((kk, s), np.int32)
        pre_ctx, pre_chunk = self._pre_ctx, self._pre_chunk
        nb_pre = self._bt_width(max((self._pages_for(w.start + w.chunk_len)
                                     for w in works), default=1))
        pre_bts = self._pre_bts[:, :nb_pre]
        pre_toks[:] = 0
        pre_ctx[:] = 0
        pre_chunk[:] = 0
        pre_bts[:] = ecfg.num_pages
        for i, w in enumerate(works):
            p, c = w.req, w.chunk_len
            pre_toks[i, :c] = p.prompt_tokens[w.start:w.start + c]
            pre_ctx[i] = w.start
            pre_chunk[i] = c
            n = min(len(p.page_ids), nb_pre)
            pre_bts[i, :n] = p.page_ids[:n]
        return (self._dev(pre_toks), self._dev(pre_ctx),
                self._dev(pre_chunk),
                self._dev(np.ascontiguousarray(pre_bts)))

    # ---------------------------------------------------------- execute
    def run_mixed(self, out: ScheduleOutput
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One fused decode+prefill pass; returns (dec_logits, pre_logits)."""
        pre_toks, pre_ctx, pre_chunk, pre_bts = self._prefill_inputs(
            out.prefills, out.pad_len)
        toks, pos, bts, active = self._decode_inputs(out.decode)
        dec_logits, pre_logits, self.pool = PM.mixed_step(
            self.params, self.pool, toks, pos, bts, active, pre_toks,
            pre_bts, pre_ctx, pre_chunk, cfg=self.cfg,
            page_size=self.ecfg.page_size, impl=self.ecfg.impl)
        return dec_logits, pre_logits

    def run_decode(self, reqs: List[Request]) -> torch.Tensor:
        toks, pos, bts, active = self._decode_inputs(reqs)
        logits, self.pool = PM.decode_batch(
            self.params, self.pool, toks, pos, bts, active, cfg=self.cfg,
            page_size=self.ecfg.page_size, impl=self.ecfg.impl)
        return logits

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
        logits, self.pool = PM.prefill_step(
            self.params, self.pool, self._dev(np.ascontiguousarray(toks)),
            self._dev(np.ascontiguousarray(bt)), work.start, c,
            cfg=self.cfg, page_size=ecfg.page_size, impl=ecfg.impl)
        return logits

    # ------------------------------------------------------- pool payloads
    @property
    def page_bytes(self) -> int:
        """Raw (k + v) payload bytes of one page — what the scheduler's
        capacity accounting and transfer counters charge."""
        k = self.pool.k
        return int(2 * k[:, 0].numel() * k.element_size())
