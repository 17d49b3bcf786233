"""High-density LoRA management (paper §3.2.1, Figure 2).

Cluster-level adapter control plane: a registry with lineage (adapters
are versioned artifacts derived from a base model), a density-aware
placement controller that packs many adapters per engine pod while
respecting per-pod slot budgets and spreading replicas for availability,
and the discovery view the gateway's LoRA-affinity routing reads
(the Kubernetes Service/EndpointSlice role in the paper).
"""
from __future__ import annotations

import collections
import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set


@dataclass
class AdapterSpec:
    name: str
    base_model: str
    rank: int = 8
    artifact_uri: str = ""
    parent: Optional[str] = None       # lineage: fine-tuned from another
    requests_per_s: float = 0.0        # observed demand (long-tail aware)


@dataclass
class PodSlots:
    pod_id: str
    capacity: int                      # adapter slots on this pod
    loaded: Set[str] = field(default_factory=set)

    @property
    def free(self) -> int:
        return self.capacity - len(self.loaded)


class LoRAController:
    """Registry + placement.  ``sync`` drives engines to match the plan
    via their register/unregister_adapter hooks."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 demand_window_s: float = 30.0):
        self.adapters: Dict[str, AdapterSpec] = {}
        self.pods: Dict[str, PodSlots] = {}
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.stats = {"loads": 0, "unloads": 0, "placement_runs": 0}
        # demand-driven replanning: the gateway feeds per-adapter
        # arrivals (note_request); refresh_demand turns the windowed
        # rate into each spec's requests_per_s before the next plan
        self.demand_window_s = demand_window_s
        self._arrivals: Dict[str, collections.deque] = {}

    # ------------------------------------------------------------ registry
    def register(self, spec: AdapterSpec) -> None:
        if spec.parent and spec.parent not in self.adapters:
            raise KeyError(f"lineage parent {spec.parent!r} not registered")
        self.adapters[spec.name] = spec

    def deregister(self, name: str) -> None:
        children = [a.name for a in self.adapters.values()
                    if a.parent == name]
        if children:
            raise ValueError(f"{name} has dependent adapters {children}")
        self.adapters.pop(name, None)
        for pod in self.pods.values():
            pod.loaded.discard(name)

    def lineage(self, name: str) -> List[str]:
        out = [name]
        while self.adapters[out[-1]].parent:
            out.append(self.adapters[out[-1]].parent)
        return out

    # ------------------------------------------------------------ pods
    def add_pod(self, pod_id: str, capacity: int = 8) -> None:
        self.pods[pod_id] = PodSlots(pod_id, capacity)

    def remove_pod(self, pod_id: str) -> None:
        self.pods.pop(pod_id, None)

    # ------------------------------------------------------------ demand
    def note_request(self, name: str, now: float) -> None:
        """Gateway hook: record one arrival for ``name`` (called on
        every routed LoRA request — the paper's 'observed demand')."""
        dq = self._arrivals.setdefault(name, collections.deque())
        dq.append(now)
        cutoff = now - self.demand_window_s
        while dq and dq[0] < cutoff:
            dq.popleft()

    def observed_rps(self, name: str, now: float) -> float:
        dq = self._arrivals.get(name)
        if not dq:
            return 0.0
        return len(dq) / max(now - dq[0], 1.0)

    def refresh_demand(self, now: float) -> None:
        """Fold gateway-observed arrival rates into the specs so the
        next plan reflects live demand, not registration-time guesses.
        Adapters with no observations yet keep their prior."""
        for spec in self.adapters.values():
            dq = self._arrivals.get(spec.name)
            if dq is None:
                continue        # never observed: keep the prior
            # prune the window here too — an adapter that went quiet
            # must decay even though note_request no longer fires
            cutoff = now - self.demand_window_s
            while dq and dq[0] < cutoff:
                dq.popleft()
            spec.requests_per_s = self.observed_rps(spec.name, now)

    # ------------------------------------------------------------ placement
    def _replicas(self, spec: AdapterSpec, total_rps: float) -> int:
        share = (spec.requests_per_s / total_rps) if total_rps else 0.0
        return max(self.min_replicas,
                   min(self.max_replicas,
                       round(share * len(self.pods) * 2)))

    def plan_placement(self) -> Dict[str, Set[str]]:
        """Desired pod -> adapters.  Coverage-first, then density: pass
        one gives EVERY adapter a slot (whenever total capacity
        suffices, no adapter is unservable), pass two spends leftover
        slots replicating hot adapters up to max_replicas.  Cold
        (long-tail) adapters therefore pack single-replica onto few
        pods — that's where the cost win is.  Both passes prefer pods
        that already hold the adapter, so re-planning under unchanged
        heat is churn-free (stickiness)."""
        self.stats["placement_runs"] += 1
        plan: Dict[str, Set[str]] = {p: set() for p in self.pods}
        if not self.pods:
            return plan
        by_heat = sorted(self.adapters.values(),
                         key=lambda a: (-a.requests_per_s, a.name))
        budget = {p: self.pods[p].capacity for p in self.pods}
        total_rps = sum(a.requests_per_s for a in self.adapters.values())

        def order(a):   # sticky pods first, then most-free, then id
            return sorted(self.pods,
                          key=lambda p: (a.name not in self.pods[p].loaded,
                                         -budget[p], p))

        for a in by_heat:               # pass 1: cover every adapter
            for p in order(a):
                if budget[p] > 0:
                    plan[p].add(a.name)
                    budget[p] -= 1
                    break
        for a in by_heat:               # pass 2: replicate the hot ones
            placed = sum(1 for p in plan if a.name in plan[p])
            for p in order(a):
                if placed >= self._replicas(a, total_rps):
                    break
                if budget[p] > 0 and a.name not in plan[p]:
                    plan[p].add(a.name)
                    budget[p] -= 1
                    placed += 1
        return plan

    def required_slots(self) -> int:
        """Total adapter slots the current demand wants (coverage +
        hot replication) — the adapter-count-aware autoscaling signal."""
        total_rps = sum(a.requests_per_s for a in self.adapters.values())
        return sum(max(self._replicas(a, total_rps), 1)
                   for a in self.adapters.values())

    def desired_pods(self, slots_per_pod: int) -> int:
        """Minimum pod count whose slot budget covers required_slots().
        The cluster autoscaler takes max(load-based, this) so scale-in
        can never strand registered adapters without a slot."""
        if not self.adapters or slots_per_pod <= 0:
            return 0
        return math.ceil(self.required_slots() / slots_per_pod)

    def sync(self, engines: Dict[str, object]) -> Dict[str, List[str]]:
        """Apply the plan to live engines.  Returns per-pod load/unload
        actions (for observability/tests).

        Before planning, each pod's view is reconciled against the
        engine's actual residency (``adapters`` attribute, when the
        handle exposes one): routed requests may have auto-loaded
        adapters past the plan and the engine's LRU bank may have
        evicted planned ones — sync restores the desired state either
        way instead of drifting.  Unloads go through the engine's
        deferred-unregister path, so an adapter serving an in-flight
        batch is never yanked mid-step."""
        for pod_id, pod in self.pods.items():
            eng = engines.get(pod_id)
            actual = getattr(eng, "adapters", None)
            if actual is not None:
                pod.loaded = set(actual() if callable(actual) else actual)
        plan = self.plan_placement()
        actions: Dict[str, List[str]] = {}
        for pod_id, want in plan.items():
            eng = engines.get(pod_id)
            pod = self.pods[pod_id]
            acts = []
            for name in sorted(pod.loaded - want):
                if eng is not None:
                    eng.unregister_adapter(name)
                pod.loaded.discard(name)
                acts.append(f"unload:{name}")
                self.stats["unloads"] += 1
            for name in sorted(want - pod.loaded):
                if eng is not None:
                    eng.register_adapter(name)
                pod.loaded.add(name)
                acts.append(f"load:{name}")
                self.stats["loads"] += 1
            actions[pod_id] = acts
        return actions

    def replan(self, engines: Dict[str, object],
               now: float) -> Dict[str, List[str]]:
        """Demand-driven replanning: refresh observed rates, then sync."""
        self.refresh_demand(now)
        return self.sync(engines)

    # ------------------------------------------------------------ discovery
    def endpoints(self, adapter: str) -> List[str]:
        """Pods currently serving an adapter (EndpointSlice analogue)."""
        return sorted(p for p, s in self.pods.items() if adapter in s.loaded)
