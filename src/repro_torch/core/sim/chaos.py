"""Chaos harness: declarative failure schedules for the cluster sim.

A :class:`ChaosSchedule` is a list of timed :class:`ChaosEvent`\\ s the
:class:`~repro_torch.core.sim.cluster_sim.ServingCluster` arms on its event
loop at ``run()`` time.  Four scenario kinds cover the failure modes
the paper's diagnostic/mock-up tooling (§3.2.8) is built to exercise:

``engine_crash``
    The pod dies mid-decode: a ``DEVICE_LOST`` fault is injected (the
    heartbeat disappears from telemetry) and the engine stops
    iterating.  Detection flows through the normal scrape -> monitor ->
    remediate path; with crash recovery enabled the dead engine's
    requests are harvested (``Scheduler.crash_takeover``) and resume on
    survivors from their last recovery-log checkpoint.

``straggler``
    A slow node, not a dead one: ``SILENT_DEGRADATION`` or
    ``THERMAL_THROTTLE`` through the engine's ``slowdown_fn`` hook for
    ``duration`` seconds.  The gateway's straggler hedging and the
    monitor's quarantine state machine are the defenses.

``kv_partition``
    The distributed KV pool becomes unreachable for ``duration``
    seconds: fetch/publish raise ``KVPoolError`` and the schedulers
    must degrade to recompute behind their retry/backoff breaker.

``gateway_restart``
    The gateway process bounces mid-stream: for ``duration`` seconds
    new dispatches are deferred (client retries), and the gateway
    comes back with its routing-policy state, rate-limit buckets and
    cordon set wiped — warm state is not durable across restarts.

Events with no ``target`` pick the busiest live engine at fire time,
so a schedule written before the run still hits an engine that
actually holds work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.diagnostics.tools import FaultKind

CHAOS_KINDS = ("engine_crash", "straggler", "kv_partition",
               "gateway_restart")


@dataclass(frozen=True)
class ChaosEvent:
    at: float                           # fire time (sim-clock seconds)
    kind: str                           # one of CHAOS_KINDS
    target: Optional[str] = None        # engine id; None => busiest
    duration: float = 0.0               # straggler/partition/restart window
    severity: float = 1.0               # straggler fault severity
    fault: FaultKind = FaultKind.SILENT_DEGRADATION   # straggler flavor

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; "
                             f"expected one of {CHAOS_KINDS}")
        if self.at < 0:
            raise ValueError(f"chaos event at={self.at} before t=0")


@dataclass
class ChaosSchedule:
    events: List[ChaosEvent] = field(default_factory=list)

    def __iter__(self):
        return iter(sorted(self.events, key=lambda e: e.at))

    def __len__(self):
        return len(self.events)

    def __add__(self, other: "ChaosSchedule") -> "ChaosSchedule":
        """Compose schedules: ``crash(10) + straggler(20, 15)``."""
        return ChaosSchedule(list(self.events) + list(other.events))

    # convenience constructors for the common single-scenario runs
    @classmethod
    def engine_crash(cls, at: float,
                     target: Optional[str] = None) -> "ChaosSchedule":
        return cls([ChaosEvent(at, "engine_crash", target=target)])

    @classmethod
    def straggler(cls, at: float, duration: float, severity: float = 1.0,
                  target: Optional[str] = None,
                  fault: FaultKind = FaultKind.SILENT_DEGRADATION
                  ) -> "ChaosSchedule":
        return cls([ChaosEvent(at, "straggler", target=target,
                               duration=duration, severity=severity,
                               fault=fault)])

    @classmethod
    def kv_partition(cls, at: float, duration: float) -> "ChaosSchedule":
        return cls([ChaosEvent(at, "kv_partition", duration=duration)])

    @classmethod
    def gateway_restart(cls, at: float,
                        duration: float = 1.0) -> "ChaosSchedule":
        return cls([ChaosEvent(at, "gateway_restart", duration=duration)])
