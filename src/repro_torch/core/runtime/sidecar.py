"""Unified AI runtime sidecar + GPU streaming loader (paper §3.2.3).

One ``AIRuntime`` fronts each engine pod: it abstracts vendor-specific
engines behind a single management API (metrics standardization, model
and adapter lifecycle), and models the cold-start path the paper
optimizes — tiered artifact fetch (remote object store / local disk /
host DRAM) with a *streaming* loader that overlaps fetch with
host-to-device transfer instead of serializing them.

The ColdStartManager tracks artifact placement across nodes so the
orchestrator can schedule new pods where the model already sits (the
paper's "loaded on the fastest available node").
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

# artifact tier bandwidths (bytes/s)
TIER_BW = {
    "remote": 1.0e9,        # object store over network
    "local": 4.0e9,         # local NVMe
    "dram": 20.0e9,         # page cache / host memory
}
H2D_BW = 24.0e9             # host -> accelerator interconnect
ENGINE_INIT_S = 8.0         # process start + engine init overhead


@dataclass
class ModelArtifact:
    name: str
    size_bytes: float
    tier_by_node: Dict[str, str] = field(default_factory=dict)

    def tier_on(self, node: str) -> str:
        return self.tier_by_node.get(node, "remote")


def load_time_s(size_bytes: float, tier: str,
                streaming: bool = True) -> float:
    """Cold-start model load time from a given tier.

    Non-streaming (baseline): fetch fully to host, then copy to device.
    Streaming loader: chunks are fetched and copied in a pipeline, so
    wall time ≈ max(fetch, h2d) + one chunk of the slower stage.
    """
    fetch = size_bytes / TIER_BW[tier]
    h2d = size_bytes / H2D_BW
    if not streaming:
        return fetch + h2d
    chunk = size_bytes / 64.0
    pipe_fill = chunk / min(TIER_BW[tier], H2D_BW)
    return max(fetch, h2d) + pipe_fill


class ColdStartManager:
    """Tracks artifact tiers per node; picks the fastest node + predicts
    pod-ready latency (used by orchestration and autoscaler actuation)."""

    def __init__(self, streaming_loader: bool = True):
        self.artifacts: Dict[str, ModelArtifact] = {}
        self.streaming = streaming_loader

    def register_artifact(self, art: ModelArtifact) -> None:
        self.artifacts[art.name] = art

    def note_cached(self, model: str, node: str, tier: str) -> None:
        self.artifacts[model].tier_by_node[node] = tier

    def best_node(self, model: str, candidates: List[str]) -> str:
        art = self.artifacts[model]
        return min(candidates,
                   key=lambda n: TIER_BW[art.tier_on(n)] * -1.0)

    def cold_start_s(self, model: str, node: str) -> float:
        art = self.artifacts[model]
        t = load_time_s(art.size_bytes, art.tier_on(node), self.streaming)
        return ENGINE_INIT_S + t


class AIRuntime:
    """Vendor-agnostic sidecar: wraps any engine exposing the handle
    contract and presents the standardized management surface the
    control plane speaks (the paper's runtime abstracting vLLM /
    SGLang / TensorRT-LLM protocol differences)."""

    def __init__(self, engine, engine_kind: str = "jax",
                 pod_id: str = "pod-0", node: str = "node-0"):
        self.engine = engine
        self.engine_kind = engine_kind
        self.pod_id = pod_id
        self.node = node
        self._policies: Dict[str, float] = {}

    # ------------------------------------------------- standardized metrics
    def scrape(self) -> Dict[str, float]:
        m = self.engine.metrics()
        return {
            "running_requests": float(m.num_running),
            "waiting_requests": float(m.num_waiting),
            "concurrency": float(m.num_running + m.num_waiting),
            "kv_cache_utilization": float(m.kv_utilization),
            "tokens_per_sec": float(m.tokens_per_sec),
            "avg_latency_s": float(m.avg_latency),
            "queue_time_s": float(m.avg_queue_time),
            "preemptions": float(m.preemptions),
            # windowed TTFT/ITL-SLO attainment from the shared scheduler
            # core — the inverted metrics the autoscalers (and the
            # role-pool rebalancer) can target
            "slo_attainment": float(m.slo_attainment),
            "slo_itl_attainment": float(m.slo_itl_attainment),
            # tiered-KV transfer accounting: host-tier pressure signals
            # for the rebalancer and dashboards (device->host offload
            # bytes, host/pool->device fetch bytes, swap traffic)
            "kv_bytes_offloaded": float(m.kv_bytes_offloaded),
            "kv_bytes_fetched": float(m.kv_bytes_fetched),
            "swap_out": float(m.swap_out),
            "swap_in": float(m.swap_in),
            "host_hit_tokens": float(m.host_hit_tokens),
            # SSD tier: tokens resumed from SSD (total and the subset
            # written by ANOTHER engine on the shared host pool), puts
            # dropped by write-behind backpressure, and predictive-
            # promotion effectiveness (prefetched pages hit vs evicted
            # unused)
            "ssd_hit_tokens": float(m.ssd_hit_tokens),
            "ssd_cross_hit_tokens": float(m.ssd_cross_hit_tokens),
            "ssd_dropped_puts": float(m.ssd_dropped_puts),
            "promote_hits": float(m.promote_hits),
            "promote_wasted": float(m.promote_wasted),
            # failure handling: pool fetch/publish attempts lost to a
            # partition, recompute waste from drop-and-recompute
            # resets, recovery-log pages published
            "kv_fetch_failures": float(m.kv_fetch_failures),
            "wasted_tokens": float(m.wasted_tokens),
            "ckpt_pages": float(m.ckpt_pages),
            # speculative decoding: draft/accept counters + acceptance
            # fraction (dashboards watch it to tune spec_tokens)
            "spec_drafted_tokens": float(m.spec_drafted_tokens),
            "spec_accepted_tokens": float(m.spec_accepted_tokens),
            "spec_acceptance": float(m.spec_acceptance),
            # high-density multi-LoRA: requests that queued behind a
            # non-resident adapter (loud miss — never a silent base-
            # model fallback), requests shed after the queue timeout,
            # and the adapter-tier churn (cold loads, stall seconds,
            # HBM-bank evictions, host-tier hits, residency)
            "lora_miss": float(m.lora_miss),
            "lora_shed": float(m.lora_shed),
            "lora_cold_loads": float(m.lora_cold_loads),
            "lora_cold_load_s": float(m.lora_cold_load_s),
            "lora_evictions": float(m.lora_evictions),
            "lora_host_hits": float(m.lora_host_hits),
            "loaded_adapters": float(len(m.loaded_adapters)),
            # host/device overlap: seconds blocked on readback and the
            # non-overlapped host fraction of step wall time — the gap
            # the async engine loop hides
            "device_wait_s": float(m.device_wait_s),
            "host_overhead_frac": float(m.host_overhead_frac),
        }

    # ------------------------------------------------- engine management
    def load_adapter(self, name: str, weights=None) -> None:
        self.engine.register_adapter(name, weights)

    def unload_adapter(self, name: str) -> None:
        self.engine.unregister_adapter(name)

    def list_adapters(self) -> List[str]:
        return list(self.engine.metrics().loaded_adapters)

    def set_policy(self, key: str, value: float) -> None:
        self._policies[key] = value

    def healthy(self) -> bool:
        fn = getattr(self.engine, "healthy", None)
        return bool(fn()) if callable(fn) else True
