"""LLM-specific autoscaling policies (paper §3.2.4).

Three autoscalers over one MetricStore:

  * HPA — the Kubernetes baseline the paper compares against: periodic
    sync (15s), tolerance dead-band, 5-min scale-down stabilization.
    Slow to react and oscillation-prone on LLM metrics.
  * KPA — Knative-style: stable window + panic window; panic mode scales
    on the 6s window when load bursts >2x capacity and holds the max.
  * APA — AIBrix Pod Autoscaler: tolerance-band scaling on inference
    metrics (KV utilization / concurrency) aggregated directly in the
    autoscaler (zero propagation delay), fluctuation tolerance both ways.

All return a desired replica count; actuation (pod cold start etc.) is
the orchestrator's job, so policy quality and actuation latency can be
measured separately — this mirrors the paper's claim structure
(latency/throughput/oscillation vs native HPA).

Config knobs shared by every policy: ``metric`` (the MetricStore key
to scale on — load metrics such as ``concurrency`` / ``kv_cache_
utilization``, or the *inverted* ``slo_attainment`` signal the shared
scheduler core emits), ``target`` (per-replica target value for load
metrics; desired attainment fraction, e.g. 0.95, for slo_attainment),
``min_replicas``/``max_replicas`` bounds, and ``invert`` (force the
higher-is-better interpretation; auto-detected for metrics in
``INVERTED_METRICS``).  Inverted pressure is the miss-rate ratio
(1-measured)/(1-target), so all three policies scale UP when the
measured value drops below target — e.g. KPA targeting
``slo_attainment`` at 0.95 adds replicas while interactive TTFT
misses pile up — and back DOWN once attainment holds above it (the
SLO path from scheduler to autoscaler).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.autoscaler.metrics import MetricStore

# metrics where HIGHER is better (pressure = target / measured):
# scaling must react to the value falling below target, not above it.
# The pool_* keys are the per-role signals the RolePoolManager
# rebalancer records (fleet TTFT attainment sizes the prefill pool,
# fleet ITL attainment the decode pool).
INVERTED_METRICS = frozenset({"slo_attainment", "slo_itl_attainment",
                              "pool_ttft_attainment",
                              "pool_itl_attainment"})


@dataclass
class ScaleDecision:
    desired: int
    reason: str = ""
    panic: bool = False


class Autoscaler:
    name = "base"

    def __init__(self, metric: str = "concurrency", target: float = 4.0,
                 min_replicas: int = 1, max_replicas: int = 64,
                 invert: Optional[bool] = None):
        self.metric = metric
        self.target = target
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.invert = (metric in INVERTED_METRICS) if invert is None \
            else invert

    def _clamp(self, n: float) -> int:
        return int(min(max(math.ceil(n), self.min_replicas),
                       self.max_replicas))

    def _pressure(self, m: float) -> float:
        """Scaling pressure: > 1 means underprovisioned.  Load metrics:
        measured/target.  Inverted metrics (higher-is-better, e.g.
        slo_attainment): the miss-rate ratio (1-measured)/(1-target) —
        "SLO misses as a multiple of the allowed miss budget".  Unlike
        target/measured (which is floored at ``target`` because
        attainment cannot exceed 1.0, leaving scale-down unreachable
        and replica counts ratcheting up after every dip), the miss
        ratio spans the full range: attainment at target -> 1.0,
        perfect attainment -> 0.0 (scale down toward min_replicas),
        heavy misses -> >> 1."""
        if self.invert:
            return (1.0 - m) / max(1.0 - self.target, 1e-6)
        return m / self.target

    def desired(self, now: float, store: MetricStore, current: int
                ) -> ScaleDecision:
        raise NotImplementedError


class HPA(Autoscaler):
    """Native Kubernetes HPA semantics (the paper's baseline).

    Knobs: ``sync_period_s`` (reconcile interval), ``tolerance``
    (dead-band around pressure 1.0), ``scale_down_stabilization_s``
    (hold the max desired over this window before shrinking).
    """
    name = "hpa"

    def __init__(self, *a, sync_period_s: float = 15.0, tolerance: float = 0.1,
                 scale_down_stabilization_s: float = 300.0, **kw):
        super().__init__(*a, **kw)
        self.sync_period_s = sync_period_s
        self.tolerance = tolerance
        self.down_stab = scale_down_stabilization_s
        self._last_sync = -1e18
        self._last = None
        self._down_candidates: list = []

    def desired(self, now, store, current) -> ScaleDecision:
        if now - self._last_sync < self.sync_period_s and self._last:
            return self._last
        self._last_sync = now
        m = store.stable(now, self.metric)
        if m is None:
            self._last = ScaleDecision(current, "no metric")
            return self._last
        ratio = self._pressure(m)
        if abs(ratio - 1.0) <= self.tolerance:
            desired = current
        else:
            desired = self._clamp(current * ratio)
        # scale-down stabilization: use max desired over the window
        self._down_candidates.append((now, desired))
        self._down_candidates = [(t, d) for t, d in self._down_candidates
                                 if t >= now - self.down_stab]
        if desired < current:
            desired = max(d for _, d in self._down_candidates)
        self._last = ScaleDecision(self._clamp(desired),
                                   f"ratio={ratio:.2f}")
        return self._last


class KPA(Autoscaler):
    """Knative Pod Autoscaler: stable/panic windows (paper: one of the
    'advanced autoscaling algorithms' AIBrix leverages).

    Knobs: ``panic_threshold`` (burst ratio entering panic mode),
    ``max_scale_up_rate``/``max_scale_down_rate`` (per-decision rate
    limits).  Panic mode scales on the 6s window and holds the peak.
    """
    name = "kpa"

    def __init__(self, *a, panic_threshold: float = 2.0,
                 max_scale_up_rate: float = 10.0,
                 max_scale_down_rate: float = 2.0, **kw):
        super().__init__(*a, **kw)
        self.panic_threshold = panic_threshold
        self.up_rate = max_scale_up_rate
        self.down_rate = max_scale_down_rate
        self._panic_until = -1.0
        self._panic_peak = 0

    def _replicas_needed(self, m: float, current: int) -> float:
        """Window aggregate -> replica demand.  Load metrics: aggregate
        load over per-replica target.  Inverted metrics: scale the
        current fleet by the attainment shortfall."""
        if self.invert:
            return max(current, 1) * self._pressure(m)
        return m / self.target

    def desired(self, now, store, current) -> ScaleDecision:
        stable = store.stable(now, self.metric)
        panic = store.panic(now, self.metric)
        if stable is None:
            return ScaleDecision(current, "no metric")
        want_stable = self._replicas_needed(stable, current)
        desired = want_stable
        in_panic = False
        if panic is not None and current > 0:
            need_panic = self._replicas_needed(panic, current)
            if self.invert:
                burst = self._pressure(panic) >= self.panic_threshold
            else:
                capacity = current * self.target
                burst = (panic / max(capacity, 1e-9)
                         >= self.panic_threshold / 2.0)
            if burst and need_panic > current:
                # enter/extend panic mode for 60s; scale on panic window
                self._panic_until = max(self._panic_until, now + 60.0)
            if now <= self._panic_until:
                in_panic = True
                desired = max(want_stable, need_panic,
                              self._panic_peak)
                self._panic_peak = max(self._panic_peak,
                                       math.ceil(desired))
            else:
                self._panic_peak = 0
        # rate limits
        hi = max(current * self.up_rate, current + 1)
        lo = current / self.down_rate
        desired = min(max(desired, lo), hi)
        return ScaleDecision(self._clamp(desired),
                             f"stable={stable:.2f} panic={panic}",
                             panic=in_panic)


class APA(Autoscaler):
    """AIBrix Pod Autoscaler: symmetric fluctuation tolerance on
    real-time (zero-delay) inference metrics.

    Knobs: ``up_fluctuation``/``down_fluctuation`` — the tolerance
    band (as a fraction of capacity, or of pressure 1.0 for inverted
    metrics) that must be exceeded before any scaling move.
    """
    name = "apa"

    def __init__(self, *a, up_fluctuation: float = 0.1,
                 down_fluctuation: float = 0.2, **kw):
        super().__init__(*a, **kw)
        self.up_f = up_fluctuation
        self.down_f = down_fluctuation

    def desired(self, now, store, current) -> ScaleDecision:
        m = store.panic(now, self.metric)       # freshest window
        stable = store.stable(now, self.metric)
        if m is None or stable is None:
            return ScaleDecision(current, "no metric")
        if self.invert:
            # attainment-style metric: pressure >1 = SLO misses piling
            # up on the fresh window -> scale the fleet by the shortfall
            pm, ps = self._pressure(m), self._pressure(stable)
            if pm > 1 + self.up_f:
                desired = math.ceil(max(current, 1) * pm)
            elif ps < 1 - self.down_f:
                desired = math.ceil(max(current, 1) * ps)
            else:
                desired = current
            return ScaleDecision(self._clamp(desired),
                                 f"m={m:.2f} pressure={pm:.2f}")
        capacity = max(current, 1) * self.target
        if m > capacity * (1 + self.up_f):
            desired = math.ceil(m / self.target)
        elif stable < capacity * (1 - self.down_f):
            desired = math.ceil(stable / self.target)
        else:
            desired = current
        return ScaleDecision(self._clamp(desired),
                             f"m={m:.2f} cap={capacity:.1f}")


AUTOSCALERS: Dict[str, type] = {c.name: c for c in (HPA, KPA, APA)}


def make_autoscaler(name: str, **kw) -> Autoscaler:
    return AUTOSCALERS[name](**kw)
