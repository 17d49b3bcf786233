"""Request model + per-request serving metrics (TTFT / ITL / queue time).

These metric fields are exactly what the AIBrix control plane consumes:
the gateway's least-latency policy reads ``total_latency``, the
autoscaler aggregates ``queue_time`` and token throughput, and the
benchmark harness reports the paper's Table-1 columns from them.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

_ids = itertools.count()


@dataclass
class SamplingParams:
    temperature: float = 0.0        # 0 => greedy
    top_k: int = 0                  # 0 => disabled
    top_p: float = 1.0
    max_new_tokens: int = 64
    stop_token: Optional[int] = None
    seed: int = 0


class RequestState(Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"
    PREEMPTED = "preempted"
    # preempted with its KV pages parked in the host-DRAM tier: resume
    # swaps them back in and continues decoding from where it stopped
    # instead of recomputing from token 0
    SWAPPED = "swapped"
    FAILED = "failed"


@dataclass
class Request:
    prompt_tokens: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    lora_adapter: Optional[str] = None
    user: str = "default"
    # multi-turn conversation id: the gateway's session routing policy
    # pins every turn of a session to the engine holding its KV prefix
    # (None => single-shot request, routed by the configured policy)
    session_id: Optional[str] = None
    arrival_time: float = 0.0
    # SLO priority class (scheduler.DEFAULT_SLO_CLASSES keys):
    # interactive | standard | batch — picks the TTFT/ITL targets the
    # SLO-aware scheduler and gateway hold for this request
    priority_class: str = "standard"
    request_id: int = field(default_factory=lambda: next(_ids))

    # runtime state
    state: RequestState = RequestState.QUEUED
    output_tokens: List[int] = field(default_factory=list)
    prefill_done_tokens: int = 0          # chunked-prefill progress
    cached_prefix_tokens: int = 0         # tokens served from prefix cache
    page_ids: List[int] = field(default_factory=list)
    slot: int = -1                        # slot-engine binding
    preempt_count: int = 0                # times preempted (swap OR drop)
    # crash-recovery log coverage: sequence tokens (prompt + generated)
    # whose KV blocks the scheduler has checkpointed into the
    # distributed pool — crash_takeover resumes from here
    ckpt_tokens: int = 0

    # timestamps (engine clock)
    schedule_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    token_times: List[float] = field(default_factory=list)

    # ------------------------------------------------------------- metrics
    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def queue_time(self) -> float:
        return max(self.schedule_time - self.arrival_time, 0.0)

    @property
    def ttft(self) -> float:
        return (self.first_token_time - self.arrival_time
                if self.first_token_time else 0.0)

    @property
    def itl(self) -> List[float]:
        ts = [self.first_token_time] + self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    @property
    def total_latency(self) -> float:
        return (self.finish_time - self.arrival_time
                if self.finish_time else 0.0)

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + len(self.output_tokens)
