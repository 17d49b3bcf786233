"""Accelerator catalogue + roofline-driven performance model.

The paper's GPU optimizer needs per-(device, model, workload-bucket)
throughput profiles.  The paper obtains them by offline benchmarking and
*suggests* (limitations section) replacing that with roofline-model
analysis (Imai et al. 2024) — we implement exactly that suggestion:
profiles are derived analytically from device peak FLOPs / HBM bandwidth
/ memory and the model's parameter & KV byte counts.  An offline-table
path (`ProfileTable.from_measurements`) is kept for parity with the
paper's original method.

Catalogue includes the paper's A10 / L20 / V100 plus TPU v5e (our
deployment target) so heterogeneous optimization covers both worlds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops: float          # bf16/fp16 dense, FLOP/s
    hbm_bw: float              # bytes/s
    hbm_bytes: float
    cost_per_hour: float       # $/h (typical cloud on-demand)
    mfu_prefill: float = 0.55  # achievable fraction of peak in prefill
    mbu_decode: float = 0.70   # achievable fraction of HBM bw in decode


DEVICES: Dict[str, DeviceSpec] = {
    "a10":    DeviceSpec("a10",    125e12, 600e9,  24e9, 0.75),
    "l20":    DeviceSpec("l20",    119.5e12, 864e9, 48e9, 1.40),
    "v100":   DeviceSpec("v100",   112e12, 900e9,  32e9, 2.20),
    "a100":   DeviceSpec("a100",   312e12, 2039e9, 80e9, 3.70),
    "tpu-v5e": DeviceSpec("tpu-v5e", 197e12, 819e9, 16e9, 1.20),
}


@dataclass(frozen=True)
class WorkloadBucket:
    """A (input_len, output_len) workload class (Mélange-style)."""
    in_len: int
    out_len: int

    @property
    def key(self) -> Tuple[int, int]:
        return (self.in_len, self.out_len)


class PerfModel:
    """Roofline performance model for one model on one device."""

    def __init__(self, cfg: ModelConfig, dev: DeviceSpec,
                 bytes_per_param: int = 2, kv_dtype_bytes: int = 2):
        self.cfg, self.dev = cfg, dev
        self.n_params = cfg.param_count()
        self.n_active = cfg.active_param_count()
        self.param_bytes = self.n_params * bytes_per_param
        # KV bytes per token (GQA; MLA uses the compressed latent)
        if cfg.mla is not None:
            per_layer = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
        else:
            per_layer = 2 * cfg.n_kv_heads * cfg.head_dim
        self.kv_bytes_per_token = per_layer * cfg.n_layers * kv_dtype_bytes

    def lora_adapter_bytes(self, rank: int,
                           bytes_per_param: int = 2) -> int:
        """Artifact size of one q/v LoRA adapter (the bank
        ``paged_model.init_lora`` holds: A_q/B_q down+up projections on
        the query heads, A_v/B_v on the KV heads) — what a cold load
        moves over the artifact tier and the host->device link."""
        cfg = self.cfg
        hd = cfg.head_dim or cfg.d_model // cfg.n_heads
        return bytes_per_param * (2 * cfg.d_model * rank
                                  + rank * cfg.n_heads * hd
                                  + rank * cfg.n_kv_heads * hd)

    def fits(self) -> bool:
        return self.param_bytes < self.dev.hbm_bytes * 0.9

    def max_batch(self, ctx_len: int) -> int:
        """KV-memory-limited concurrent sequences at context ctx_len."""
        free = self.dev.hbm_bytes * 0.9 - self.param_bytes
        per_seq = self.kv_bytes_per_token * max(ctx_len, 1)
        return max(int(free / per_seq), 0)

    def prefill_time(self, n_tokens: int) -> float:
        """Compute-bound prefill (s)."""
        flops = 2.0 * self.n_active * n_tokens
        return flops / (self.dev.peak_flops * self.dev.mfu_prefill)

    def decode_step_time(self, batch: int, ctx_len: int) -> float:
        """Bandwidth-bound decode iteration (s): weights read once per
        step + per-sequence KV read."""
        bytes_moved = (self.param_bytes
                       + batch * self.kv_bytes_per_token * ctx_len)
        t_mem = bytes_moved / (self.dev.hbm_bw * self.dev.mbu_decode)
        t_flops = (2.0 * self.n_active * batch
                   / (self.dev.peak_flops * self.dev.mfu_prefill))
        return max(t_mem, t_flops)

    def mixed_step_time(self, batch: int, ctx_len: float,
                        prefill_tokens: int) -> float:
        """Fused mixed-batch step (the engine's ``mixed_step``): B
        decode rows + prefill chunks flattened into ONE pass, so the
        weights stream once for the whole token batch while the decode
        rows add their per-sequence KV reads and the prefill tokens
        their FLOPs — one roofline over both.  Degenerates to
        ``decode_step_time`` at ``prefill_tokens=0``; with ``batch=0``
        it is a prefill chunk that also pays the weight stream."""
        flops = 2.0 * self.n_active * (batch + prefill_tokens)
        t_comp = flops / (self.dev.peak_flops * self.dev.mfu_prefill)
        bytes_moved = (self.param_bytes
                       + batch * self.kv_bytes_per_token * ctx_len)
        t_mem = bytes_moved / (self.dev.hbm_bw * self.dev.mbu_decode)
        return max(t_comp, t_mem)

    def spec_step_time(self, batch: int, ctx_len: float,
                       verify_tokens: int,
                       prefill_tokens: int = 0) -> float:
        """Speculative verification step: each decode row feeds its
        last token plus draft tokens through ONE pass.  The
        ``verify_tokens`` (total drafts across the batch) add FLOPs
        like prefill tokens but, crucially, NO extra byte traffic —
        the weights still stream once and the KV read is the same as a
        plain decode step — which is exactly why speculation wins on
        the bandwidth-bound decode roofline: the step emits
        ``1 + accepted`` tokens per row for (almost) the memory time
        of one.  Degenerates to ``mixed_step_time`` at
        ``verify_tokens=0``."""
        flops = 2.0 * self.n_active * (batch + verify_tokens
                                       + prefill_tokens)
        t_comp = flops / (self.dev.peak_flops * self.dev.mfu_prefill)
        bytes_moved = (self.param_bytes
                       + batch * self.kv_bytes_per_token * ctx_len)
        t_mem = bytes_moved / (self.dev.hbm_bw * self.dev.mbu_decode)
        return max(t_comp, t_mem)

    # ---------------------------------------------------- request level
    def request_time(self, bucket: WorkloadBucket, batch: int) -> float:
        """End-to-end time of one request at the given batching level."""
        ctx = bucket.in_len + bucket.out_len // 2
        return (self.prefill_time(bucket.in_len)
                + bucket.out_len * self.decode_step_time(batch, ctx))

    def ttft(self, bucket: WorkloadBucket, queue_depth: int = 0) -> float:
        return self.prefill_time(bucket.in_len) * (1 + queue_depth)

    def capacity_rps(self, bucket: WorkloadBucket,
                     slo_ttft_s: Optional[float] = None,
                     slo_itl_s: Optional[float] = None) -> float:
        """Max sustainable requests/s for this bucket under SLOs.

        Picks the best batch level that still meets ITL SLO; returns 0
        when the model doesn't fit or SLOs are unmeetable.
        """
        if not self.fits():
            return 0.0
        if slo_ttft_s is not None and \
                self.prefill_time(bucket.in_len) > slo_ttft_s:
            return 0.0
        ctx = bucket.in_len + bucket.out_len
        best = 0.0
        b_hi = max(self.max_batch(ctx), 0)
        for batch in (1, 2, 4, 8, 16, 32, 64):
            if batch > b_hi:
                break
            itl = self.decode_step_time(batch, ctx)
            if slo_itl_s is not None and itl > slo_itl_s:
                break
            t_req = self.request_time(WorkloadBucket(*bucket.key), batch)
            rps = batch / max(t_req, 1e-9)
            best = max(best, rps)
        return best


class ProfileTable:
    """(device, bucket) -> capacity rps, either analytic or measured."""

    def __init__(self, cfg: ModelConfig, slo_ttft_s: float = None,
                 slo_itl_s: float = None):
        self.cfg = cfg
        self.slo_ttft_s = slo_ttft_s
        self.slo_itl_s = slo_itl_s
        self._measured: Dict[Tuple[str, Tuple[int, int]], float] = {}

    @classmethod
    def from_measurements(cls, cfg: ModelConfig,
                          rows: Dict[Tuple[str, Tuple[int, int]], float]):
        t = cls(cfg)
        t._measured = dict(rows)
        return t

    def capacity(self, device: str, bucket: WorkloadBucket) -> float:
        key = (device, bucket.key)
        if key in self._measured:
            return self._measured[key]
        pm = PerfModel(self.cfg, DEVICES[device])
        return pm.capacity_rps(bucket, self.slo_ttft_s, self.slo_itl_s)

    def cost_per_request(self, device: str, bucket: WorkloadBucket
                         ) -> float:
        cap = self.capacity(device, bucket)
        if cap <= 0:
            return float("inf")
        return DEVICES[device].cost_per_hour / 3600.0 / cap
