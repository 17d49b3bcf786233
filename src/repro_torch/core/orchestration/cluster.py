"""Mixed-grain multi-node orchestration (paper §3.2.6, Figure 6).

Coarse grain (the Kubernetes role): ``ClusterManager`` owns pod
lifecycle — scheduling onto nodes, cold-start transitions
(PENDING -> PULLING -> LOADING -> READY), termination, and replica
reconciliation driven by the autoscaler's desired counts.

Fine grain (the Ray role): ``EngineGroup`` (= RayClusterFleet) binds
several pods into one logical multi-node engine (a head + workers, e.g.
TP across hosts for a 236B model), with group-atomic readiness and
rolling upgrades that never take more than ``max_unavailable`` groups
down — the service-oriented behavior the paper says raw engine-native
distribution lacks.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional

from repro_torch.core.runtime.sidecar import ColdStartManager


class PodState(Enum):
    PENDING = "pending"
    PULLING = "pulling"       # artifact fetch
    LOADING = "loading"       # weights -> accelerator
    READY = "ready"
    TERMINATING = "terminating"
    FAILED = "failed"


@dataclass
class Pod:
    pod_id: str
    model: str
    device_type: str
    node: str
    state: PodState = PodState.PENDING
    ready_at: float = 0.0
    created_at: float = 0.0
    version: str = "v1"
    group: Optional[str] = None
    engine: object = None           # attached handle once READY


@dataclass
class Node:
    node_id: str
    device_type: str
    num_devices: int = 8
    used_devices: int = 0

    @property
    def free_devices(self) -> int:
        return self.num_devices - self.used_devices


class ClusterManager:
    """Coarse-grained resource manager (the Kubernetes role)."""

    def __init__(self, cold_start: ColdStartManager,
                 clock: Callable[[], float] = None,
                 devices_per_pod: int = 1,
                 engine_factory: Callable[[Pod], object] = None):
        self.cold = cold_start
        self.clock = clock or (lambda: 0.0)
        self.devices_per_pod = devices_per_pod
        self.engine_factory = engine_factory
        self.nodes: Dict[str, Node] = {}
        self.pods: Dict[str, Pod] = {}
        self._ids = itertools.count()
        self.events: List[tuple] = []      # (t, kind, pod_id)

    # ---------------------------------------------------------- nodes
    def add_node(self, node_id: str, device_type: str,
                 num_devices: int = 8) -> None:
        self.nodes[node_id] = Node(node_id, device_type, num_devices)

    # ---------------------------------------------------------- pods
    def create_pod(self, model: str, device_type: str,
                   version: str = "v1", group: Optional[str] = None
                   ) -> Optional[Pod]:
        """Schedule a pod onto the best node (cold-start aware)."""
        candidates = [n for n in self.nodes.values()
                      if n.device_type == device_type
                      and n.free_devices >= self.devices_per_pod]
        if not candidates:
            return None
        # fastest-artifact node first (ColdStartManager policy)
        best = self.cold.best_node(model, [n.node_id for n in candidates]) \
            if model in self.cold.artifacts else candidates[0].node_id
        node = self.nodes[best]
        node.used_devices += self.devices_per_pod
        now = self.clock()
        pod = Pod(pod_id=f"pod-{next(self._ids)}", model=model,
                  device_type=device_type, node=best, created_at=now,
                  version=version, group=group)
        cold_s = (self.cold.cold_start_s(model, best)
                  if model in self.cold.artifacts else 10.0)
        pod.state = PodState.PULLING
        pod.ready_at = now + cold_s
        self.pods[pod.pod_id] = pod
        self.events.append((now, "create", pod.pod_id))
        return pod

    def delete_pod(self, pod_id: str) -> None:
        pod = self.pods.pop(pod_id, None)
        if pod is None:
            return
        self.nodes[pod.node].used_devices -= self.devices_per_pod
        pod.state = PodState.TERMINATING
        self.events.append((self.clock(), "delete", pod_id))

    def fail_pod(self, pod_id: str) -> None:
        pod = self.pods.get(pod_id)
        if pod is not None:
            pod.state = PodState.FAILED
            self.events.append((self.clock(), "fail", pod_id))

    def tick(self) -> List[Pod]:
        """Advance lifecycle; returns pods that just became READY."""
        now = self.clock()
        became_ready = []
        for pod in self.pods.values():
            if pod.state in (PodState.PULLING, PodState.LOADING):
                # split cold window: first 70% pulling, rest loading
                if now >= pod.ready_at:
                    pod.state = PodState.READY
                    if self.engine_factory is not None:
                        pod.engine = self.engine_factory(pod)
                    became_ready.append(pod)
                    self.events.append((now, "ready", pod.pod_id))
                elif now >= pod.created_at + 0.7 * (pod.ready_at
                                                    - pod.created_at):
                    pod.state = PodState.LOADING
        return became_ready

    # ---------------------------------------------------------- reconcile
    def ready_pods(self, model: str, device_type: Optional[str] = None
                   ) -> List[Pod]:
        return [p for p in self.pods.values()
                if p.model == model and p.state == PodState.READY
                and (device_type is None or p.device_type == device_type)]

    def reconcile(self, model: str, device_type: str, desired: int) -> None:
        """Drive replica count toward ``desired`` (autoscaler actuation)."""
        alive = [p for p in self.pods.values()
                 if p.model == model and p.device_type == device_type
                 and p.state not in (PodState.TERMINATING, PodState.FAILED)]
        for _ in range(desired - len(alive)):
            self.create_pod(model, device_type)
        if desired < len(alive):
            # prefer terminating not-yet-ready pods, then newest
            order = sorted(alive, key=lambda p: (p.state == PodState.READY,
                                                 -p.created_at))
            for pod in order[:len(alive) - desired]:
                self.delete_pod(pod.pod_id)


@dataclass
class GroupSpec:
    name: str
    model: str
    device_type: str
    group_size: int          # pods per logical engine (head + workers)
    replicas: int
    version: str = "v1"


class EngineGroup:
    """Fine-grained orchestration: RayClusterFleet analogue.

    Each replica = ``group_size`` pods forming one logical multi-node
    engine; a replica is READY only when every member is.  Rolling
    upgrade replaces replicas version-by-version, keeping at least
    (replicas - max_unavailable) serving.
    """

    def __init__(self, spec: GroupSpec, cluster: ClusterManager,
                 max_unavailable: int = 1):
        self.spec = spec
        self.cluster = cluster
        self.max_unavailable = max_unavailable
        self.replica_pods: Dict[int, List[str]] = {}
        self._next_replica = 0

    def scale_to(self, replicas: int) -> None:
        while len(self.replica_pods) < replicas:
            rid = self._next_replica
            self._next_replica += 1
            pods = []
            for _ in range(self.spec.group_size):
                pod = self.cluster.create_pod(
                    self.spec.model, self.spec.device_type,
                    version=self.spec.version,
                    group=f"{self.spec.name}-{rid}")
                if pod is None:        # insufficient capacity: rollback
                    for pid in pods:
                        self.cluster.delete_pod(pid)
                    return
                pods.append(pod.pod_id)
            self.replica_pods[rid] = pods
        while len(self.replica_pods) > replicas:
            rid = max(self.replica_pods)
            for pid in self.replica_pods.pop(rid):
                self.cluster.delete_pod(pid)

    def replica_ready(self, rid: int) -> bool:
        return all(self.cluster.pods[p].state == PodState.READY
                   for p in self.replica_pods.get(rid, [])
                   if p in self.cluster.pods)

    def ready_replicas(self) -> List[int]:
        return [r for r in self.replica_pods if self.replica_ready(r)]

    def rolling_upgrade(self, new_version: str, tick_until) -> List[str]:
        """Upgrade every replica to ``new_version``; returns an event log.
        ``tick_until(pred)`` advances sim time until pred() is true."""
        log = []
        self.spec.version = new_version
        for rid in sorted(list(self.replica_pods)):
            old = self.replica_pods[rid]
            # never exceed max_unavailable: wait until enough are ready
            tick_until(lambda: len(self.ready_replicas())
                       >= len(self.replica_pods) - self.max_unavailable)
            pods = []
            ok = True
            for _ in range(self.spec.group_size):
                pod = self.cluster.create_pod(
                    self.spec.model, self.spec.device_type,
                    version=new_version, group=f"{self.spec.name}-{rid}")
                if pod is None:
                    ok = False
                    break
                pods.append(pod.pod_id)
            if not ok:
                for pid in pods:
                    self.cluster.delete_pod(pid)
                log.append(f"replica-{rid}: insufficient capacity, skipped")
                continue
            tick_until(lambda: all(
                self.cluster.pods[p].state == PodState.READY for p in pods))
            for pid in old:
                self.cluster.delete_pod(pid)
            self.replica_pods[rid] = pods
            log.append(f"replica-{rid}: upgraded to {new_version}")
        return log
