"""ServingCluster: the full AIBrix stack wired over the event loop.

Gateway (+routing policy) -> SimEngine fleet -> distributed KV pool,
with the metric pump (AI runtime scrape), autoscaler reconciliation
through the ClusterManager (cold starts included), failure injection,
and the GPU optimizer's desired-count feed.  This is the testbed every
cluster-level benchmark runs on.

Role pools: ``ClusterConfig.roles`` accepts 'mixed' (default),
'<n>P<m>D' (static disaggregation) or 'auto' (even initial split).
Disaggregated fleets are driven through the SAME
:class:`~repro_torch.core.orchestration.pools.RolePoolManager` the real
launcher uses — the gateway routes new requests to the prefill pool,
handoffs load-balance over the decode pool, and with
``ClusterConfig.rebalance`` set an :class:`AttainmentRebalancer`
migrates members between pools live under the discrete-event clock
(``benchmarks/bench_pd_pools.py`` measures it).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.core.autoscaler.metrics import MetricStore
from repro_torch.core.autoscaler.policies import Autoscaler
from repro_torch.core.diagnostics.tools import (DiagnosticMonitor, FailureInjector,
                                          FaultKind, Telemetry)
from repro_torch.core.gateway.gateway import Gateway, RateLimit
from repro_torch.core.kvcache.pool import DistributedKVPool
from repro_torch.core.lora.manager import AdapterSpec, LoRAController
from repro_torch.core.sim.chaos import ChaosSchedule
from repro_torch.core.orchestration.cluster import ClusterManager, PodState
from repro_torch.core.orchestration.pools import (AttainmentRebalancer,
                                            RebalanceConfig,
                                            RolePoolManager,
                                            parse_role_spec)
from repro_torch.core.runtime.sidecar import (AIRuntime, ColdStartManager,
                                        ModelArtifact)
from repro_torch.core.sim.events import EventLoop, SimClock
from repro_torch.core.sim.sim_engine import SimEngine, SimEngineConfig
from repro_torch.core.sim.workloads import (StreamingSummary, TimedRequest,
                                      summarize)
from repro_torch.models.config import ModelConfig


@dataclass
class ClusterConfig:
    routing_policy: str = "least-request"
    routing_kw: dict = field(default_factory=dict)
    # -- sharded gateway core --
    # split the gateway's hot state (session pins, rate-limit buckets,
    # per-shard stats + routable cache) into N independent shards keyed
    # by hash(session_id | user); 1 = the monolithic gateway
    gateway_shards: int = 1
    device_type: str = "a10"
    num_engines: int = 4
    engine: SimEngineConfig = None
    use_kv_pool: bool = False
    kv_pool_gb: float = 64.0
    kv_pool_policy: str = "s3fifo"
    kv_pool_bw: float = 12.5e9       # handoff fabric (bytes/s)
    autoscaler: Optional[Autoscaler] = None
    rate_limit: Optional[RateLimit] = None   # None => gateway defaults
    metric_delay_s: float = 0.0      # legacy metrics-path propagation
    scrape_period_s: float = 1.0
    autoscale_period_s: float = 2.0
    model_bytes: float = 14e9        # ~7B bf16 artifact
    telemetry: bool = False
    # -- role pools (P/D disaggregation at cluster scale) --
    # 'mixed' | '<n>P<m>D' | 'auto' (even split, adapted live when a
    # rebalance config is set).  Disaggregation implies the KV pool.
    roles: str = "mixed"
    rebalance: Optional[RebalanceConfig] = None
    pool_poll_period_s: float = 0.5  # drain-completion polling cadence
    # -- chaos harness + failure handling --
    # a ChaosSchedule arms scripted failures on the event loop
    # (telemetry/diagnostics are force-enabled so detection can run)
    chaos: Optional[ChaosSchedule] = None
    # harvest a dead engine's queued/in-flight requests and re-deliver
    # them to survivors (KV-backed resume when the recovery log covers
    # them); False = the pre-chaos behavior, requests on a dead engine
    # are simply lost
    crash_recovery: bool = True
    # straggler hedging: re-route queued work off engines whose
    # windowed tokens/s < hedge_ratio x fleet median (0 disables)
    hedge_ratio: float = 0.0
    hedge_period_s: float = 1.0
    # client behavior across a gateway restart: deferred dispatches
    # retry this long after the gateway comes back
    gw_retry_delay_s: float = 0.25
    # -- high-density multi-LoRA serving (paper §3.2.1) --
    # register lora-0..lora-{n-1} with a LoRAController wired into the
    # gateway (adapter registry + demand feed + lora-affinity
    # endpoints) and replanned periodically against observed demand.
    # 0 disables the adapter control plane.
    lora_adapters: int = 0
    # controller slot budget per pod; 0 => the engine config's
    # max_adapters - 1 (slot 0 is the base model)
    lora_slots_per_pod: int = 0
    lora_replan_period_s: float = 2.0
    lora_min_replicas: int = 1
    lora_max_replicas: int = 4
    # -- million-session scale --
    # False streams every finished Request into a StreamingSummary
    # (engines' finish_sink) and drops the object, so memory stays flat
    # no matter how many requests a run pushes through; summary() then
    # reads the streaming twin instead of summarize(all_requests)
    retain_requests: bool = True
    # per-priority-class TTFT targets fed to the StreamingSummary so
    # summary() can report ttft_attainment without retaining requests
    ttft_slo_s: Optional[Dict[str, float]] = None
    # -- host-shared SSD pool --
    # True lifts the SSD tier from per-engine to per-host: every
    # ``engines_per_host`` consecutive engines attach to ONE content-
    # addressed SharedSSDPool (capacity = per-engine ssd_cache_gb x
    # group size, one write-behind drain), so a prefix evicted by
    # engine A is an SSD hit for engine B instead of a duplicate copy
    ssd_shared: bool = False
    engines_per_host: int = 2
    # -- predictive KV promotion --
    # promote_lead_s > 0 (with the session routing policy) arms the
    # per-session think-time EWMA predictor: the cluster polls due
    # promotions every promote_poll_period_s and asks the pinned
    # engine to prefetch that session's SSD pages into host DRAM
    # before the predicted turn lands (off the critical path)
    promote_lead_s: float = 0.0
    promote_poll_period_s: float = 0.5


class ServingCluster:
    def __init__(self, cfg: ModelConfig, ccfg: ClusterConfig):
        self.cfg = cfg
        self.ccfg = ccfg
        self.loop = EventLoop()
        self.clock = self.loop.clock
        self.roles = self._resolve_roles(ccfg)
        self.disaggregated = any(r != "mixed" for r in self.roles)
        if self.disaggregated:
            ccfg.num_engines = len(self.roles)
            if ccfg.autoscaler is not None:
                # replica autoscaling actuates through the gateway only
                # and would bypass the role pools (retired members would
                # keep taking handoffs); elastic role pools are a
                # ROADMAP follow-up — refuse the combination for now
                raise ValueError("autoscaler + disaggregated roles is "
                                 "not supported yet: size the pools "
                                 "with ClusterConfig.rebalance instead")
        self.kv_pool = None
        if ccfg.use_kv_pool or self.disaggregated:
            per_tok = 1  # placeholder, real size set by engines' PerfModel
            self.kv_pool = DistributedKVPool(
                capacity_bytes=int(ccfg.kv_pool_gb * (1 << 30)),
                policy=ccfg.kv_pool_policy, clock=self.clock,
                network_bw=ccfg.kv_pool_bw)
        routing_kw = dict(ccfg.routing_kw)
        if ccfg.promote_lead_s > 0 and ccfg.routing_policy == "session":
            routing_kw.setdefault("promote_lead_s", ccfg.promote_lead_s)
        self.gateway = Gateway(policy=ccfg.routing_policy,
                               default_limit=ccfg.rate_limit,
                               clock=self.clock,
                               shards=ccfg.gateway_shards, **routing_kw)
        self.pool_mgr = RolePoolManager(clock=self.clock,
                                        gateway=self.gateway)
        self.rebalancer = (AttainmentRebalancer(ccfg.rebalance)
                           if ccfg.rebalance is not None
                           and self.disaggregated else None)
        self.engines: Dict[str, SimEngine] = {}
        self.runtimes: Dict[str, AIRuntime] = {}
        self.metrics = MetricStore(propagation_delay_s=ccfg.metric_delay_s)
        self.injector = FailureInjector()
        self.monitor = DiagnosticMonitor()
        self.diagnoses: List = []
        self.all_requests: List = []
        self.stream_summary = (None if ccfg.retain_requests else
                               StreamingSummary(ttft_slo_s=ccfg.ttft_slo_s))
        # engines with a pending iteration event, maintained via the
        # on_busy_changed edge callback — run()'s done() predicate
        # checks this counter instead of scanning every engine's
        # has_work after each event (the full scan only runs when the
        # count hits zero, where it still catches dead engines whose
        # queues are non-empty but whose iteration has stopped)
        self._busy_engines = 0
        self.rejected: int = 0
        self.scale_history: List[tuple] = []
        # chaos / failure-handling accounting
        if ccfg.chaos is not None:
            ccfg.telemetry = True    # detection must run to remediate
        self.chaos_log: List[tuple] = []
        self.crashed_requests: List[int] = []   # ids on an engine at crash
        self.crash_recovered: List[int] = []    # ids harvested + redelivered
        self.quarantines = 0
        self.readmits = 0
        self.hedged = 0
        self.gw_restarts = 0
        self.gw_deferred = 0
        self._gateway_down_until = float("-inf")
        # orchestration (pods + cold start) — used when autoscaling
        self.cold = ColdStartManager(streaming_loader=True)
        self.cold.register_artifact(
            ModelArtifact(cfg.name, ccfg.model_bytes,
                          tier_by_node={"node-0": "dram"}))
        self.cluster = ClusterManager(self.cold, clock=self.clock)
        # host-shared SSD pools: host group id -> SharedSSDPool (built
        # lazily as engines spawn; replacements land in their group)
        self._host_ssd: Dict[str, object] = {}
        self.promotions = 0        # promoter prefetch calls issued
        for i in range(max(ccfg.num_engines,
                           (ccfg.autoscaler.max_replicas
                            if ccfg.autoscaler else ccfg.num_engines))):
            self.cluster.add_node(f"node-{i}", ccfg.device_type, 8)
            if i > 0:
                self.cold.note_cached(cfg.name, f"node-{i}", "local")
        for i in range(ccfg.num_engines):
            self._spawn_engine(ready=True, role=self.roles[i])
        # adapter control plane: registry + density placement wired
        # into the gateway (demand feed + lora-affinity endpoints);
        # later-spawned engines join as pods in _spawn_engine
        self.lora_ctrl: Optional[LoRAController] = None
        self._lora_slots = 0
        if ccfg.lora_adapters > 0:
            ecfg = ccfg.engine or SimEngineConfig()
            self._lora_slots = ccfg.lora_slots_per_pod \
                or max(ecfg.max_adapters - 1, 1)
            self.lora_ctrl = LoRAController(
                min_replicas=ccfg.lora_min_replicas,
                max_replicas=ccfg.lora_max_replicas)
            for i in range(ccfg.lora_adapters):
                # zipf-shaped prior; refresh_demand replaces it with
                # gateway-observed rates once traffic flows
                self.lora_ctrl.register(AdapterSpec(
                    f"lora-{i}", cfg.name, requests_per_s=1.0 / (i + 1)))
            for eid in self.engines:
                self.lora_ctrl.add_pod(eid, capacity=self._lora_slots)
            self.gateway.attach_lora_controller(self.lora_ctrl)
            self.lora_ctrl.sync(self.engines)

    @staticmethod
    def _resolve_roles(ccfg: ClusterConfig) -> List[str]:
        if ccfg.roles == "auto":
            if ccfg.num_engines < 2:
                raise ValueError("roles='auto' needs num_engines >= 2 "
                                 "(one prefill AND one decode member)")
            # the live rebalancer corrects the split; absent a demand
            # forecast the even split is the neutral starting point
            # (launch/serve.py seeds from the optimizer's split_roles)
            n_p = max(ccfg.num_engines // 2, 1)
            return (["prefill"] * n_p
                    + ["decode"] * (ccfg.num_engines - n_p))
        return parse_role_spec(ccfg.roles, ccfg.num_engines)

    # ------------------------------------------------------------ engines
    def _spawn_engine(self, ready: bool = False,
                      role: str = "mixed") -> str:
        eid = f"engine-{len(self.runtimes)}"
        node = f"node-{len(self.runtimes) % max(len(self.cluster.nodes), 1)}"
        ecfg = self.ccfg.engine or SimEngineConfig(
            device_type=self.ccfg.device_type)
        if ecfg.role != role:
            ecfg = dataclasses.replace(ecfg, role=role)
        eng = SimEngine(self.cfg, self.loop, ecfg, kv_pool=self.kv_pool,
                        engine_id=eid, node=node,
                        ssd_pool=self._host_ssd_pool(ecfg))
        eng.slowdown_fn = (lambda e=eid: self.injector.slowdown_factor(e))
        eng.on_busy_changed = self._note_busy
        if self.stream_summary is not None:
            eng.sched.finish_sink = self.stream_summary.observe
        self.engines[eid] = eng
        self.runtimes[eid] = AIRuntime(eng, pod_id=eid, node=node)
        ctrl = getattr(self, "lora_ctrl", None)
        if ctrl is not None:
            ctrl.add_pod(eid, capacity=self._lora_slots)
        if ready:
            self.pool_mgr.add_engine(eid, eng, role)
        else:
            # simulate cold start before joining the gateway/pools
            pod = self.cluster.create_pod(self.cfg.name,
                                          self.ccfg.device_type)
            delay = (pod.ready_at - self.clock.now) if pod else 30.0
            self.loop.after(delay,
                            lambda: self.pool_mgr.add_engine(eid, eng,
                                                             role))
        return eid

    def _host_ssd_pool(self, ecfg: SimEngineConfig):
        """The spawning engine's host-group SharedSSDPool (created on
        first use), or None when sharing is off / the engine has no SSD
        tier configured.  Groups are ``engines_per_host`` consecutive
        spawn slots — the sim's stand-in for physical co-location."""
        if (not self.ccfg.ssd_shared or ecfg.ssd_cache_gb <= 0
                or ecfg.host_cache_gb <= 0):
            return None
        from repro_torch.core.kvcache.tiers import SharedSSDPool
        per_host = max(self.ccfg.engines_per_host, 1)
        host = f"host-{len(self.runtimes) // per_host}"
        pool = self._host_ssd.get(host)
        if pool is None:
            pool = self._host_ssd[host] = SharedSSDPool(
                capacity_bytes=int(ecfg.ssd_cache_gb * (1 << 30)
                                   * per_host),
                ssd_bw=ecfg.ssd_bw)
        return pool

    def ssd_pools(self) -> List:
        """The underlying SSD pool objects: one per host group when
        shared, one per engine otherwise (summary + bench accounting)."""
        if self._host_ssd:
            return list(self._host_ssd.values())
        return [e.ssd_pool for e in self.engines.values()
                if getattr(e, "ssd_pool", None) is not None]

    def _note_busy(self, flag: bool) -> None:
        self._busy_engines += 1 if flag else -1

    def _retire_engine(self) -> None:
        live = [e for e in self.engines if e in self.gateway.engines]
        if len(live) <= 1:
            return
        # retire the emptiest engine (graceful: it finishes its work).
        # Through the pool manager, NOT the gateway alone — a stale
        # role-pool member would keep receiving handoffs and keep
        # counting toward pool attainment after retirement
        eid = min(live, key=lambda e: self.engines[e].metrics().num_running)
        self.pool_mgr.remove_engine(eid)
        if self.lora_ctrl is not None:
            self.lora_ctrl.remove_pod(eid)

    @property
    def active_replicas(self) -> int:
        return len(self.gateway.engines)

    # ------------------------------------------------------------ pumps
    def _scrape(self) -> None:
        now = self.clock.now
        # snapshot: remediation may spawn replacement engines mid-scrape
        for eid, rt in list(self.runtimes.items()):
            if eid not in self.gateway.engines:
                continue
            for k, v in rt.scrape().items():
                self.metrics.record(now, k, v)
            if self.ccfg.telemetry:
                m = rt.engine.metrics()
                sample = Telemetry(pod_id=eid, t=now,
                                   tokens_per_sec=m.tokens_per_sec)
                sample = self.injector.perturb(sample)
                for d in self.monitor.observe(sample):
                    self.diagnoses.append(d)
                    self._remediate(d)

    def _remediate(self, d) -> None:
        eid = d.pod_id
        if d.action == "quarantine":
            # soft fault confirmed: cordon out of routing while the
            # monitor's re-admit probe runs; the engine stays alive
            # and keeps draining its in-flight work
            if eid in self.gateway.engines:
                self.gateway.cordon(eid)
                self.quarantines += 1
            return
        if d.action == "readmit":
            self.gateway.uncordon(eid)
            self.readmits += 1
            return
        if d.action in ("restart", "cordon", "drain"):
            if eid not in self.gateway.engines:
                return
            # remove from the role pools too (handoffs and pool
            # attainment must stop seeing the degraded member) and
            # spin up the replacement with a cold start UNDER THE
            # SAME ROLE, so remediation preserves the P/D topology
            role = self.pool_mgr.role_of(eid)
            src_pool = role if role in self.pool_mgr.POOLS else "mixed"
            eng = self.engines.get(eid)
            lost: List = []
            if eng is not None and not eng.healthy():
                # the pod is DEAD: nothing on it can ever finish.
                # Harvest every request it owns — running decodes
                # rewind to their last recovery-log checkpoint — and
                # re-deliver them to survivors
                if self.ccfg.crash_recovery:
                    lost = eng.sched.crash_takeover(self.clock.now)
                    self.gateway.note_failure(eid, "crash")
                    self.crash_recovered += [r.request_id for r in lost]
            elif eng is not None:
                # degraded but alive: graceful drain — in-flight work
                # finishes here, only queued work is re-routed
                lost = eng.sched.takeover_waiting()
            self.pool_mgr.remove_engine(eid)
            if self.lora_ctrl is not None:
                self.lora_ctrl.remove_pod(eid)
            self._spawn_engine(ready=False, role=src_pool)
            self._redeliver_lost(lost, src_pool)

    def _redeliver_lost(self, reqs: List, src_pool: str,
                        exclude=frozenset()) -> None:
        """Re-deliver harvested requests through the role pools,
        request by request; anything undeliverable right now (the
        replacement is still cold-starting and no other member can
        take it) retries on a timer instead of being dropped."""
        pending = []
        for r in reqs:
            try:
                if src_pool == "decode":
                    self.pool_mgr.handoff(r, exclude=exclude)
                else:
                    self.pool_mgr.submit(r, exclude=exclude)
            except RuntimeError:
                pending.append(r)
        if pending:
            self.loop.after(1.0, lambda: self._redeliver_lost(
                pending, src_pool, exclude))

    # ------------------------------------------------------------ chaos
    def _busiest_engine(self) -> Optional[str]:
        live = sorted(e for e in self.engines
                      if e in self.gateway.engines
                      and self.engines[e].healthy())
        if not live:
            return None
        return max(live, key=lambda e: (
            self.engines[e].metrics().num_running
            + self.engines[e].metrics().num_waiting))

    def _chaos_exec(self, ev) -> None:
        now = self.clock.now
        self.chaos_log.append((now, ev.kind, ev.target))
        if ev.kind == "engine_crash":
            eid = ev.target or self._busiest_engine()
            eng = self.engines.get(eid)
            if eng is None:
                return
            # the process is gone mid-decode: heartbeat disappears from
            # telemetry (detection), iteration stops (effect).  Every
            # request aboard is recorded so benches can report the
            # resumed-request latency across recovery modes.
            sched = eng.sched
            self.crashed_requests += [
                r.request_id for r in (sched.waiting + sched.prefills
                                       + sched.running)]
            self.injector.inject(eid, FaultKind.DEVICE_LOST, now)
            eng.alive = False
        elif ev.kind == "straggler":
            eid = ev.target or self._busiest_engine()
            if eid not in self.engines:
                return
            self.injector.inject(eid, ev.fault, now,
                                 severity=ev.severity)
            if ev.duration > 0:
                self.loop.after(ev.duration, lambda: self.injector.clear(
                    eid, ev.fault))
        elif ev.kind == "kv_partition":
            if self.kv_pool is not None:
                self.kv_pool.partition(now, ev.duration or 1.0)
        elif ev.kind == "gateway_restart":
            self._gateway_restart(ev.duration or 1.0)

    def _gateway_restart(self, duration: float) -> None:
        """Bounce the gateway: dispatches arriving inside the window
        are deferred (client retries), and the restarted process comes
        back with its warm state — routing-policy EWMAs/affinity,
        rate-limit buckets, cordon set — wiped."""
        now = self.clock.now
        self.gw_restarts += 1
        self._gateway_down_until = max(self._gateway_down_until,
                                       now + duration)

        def back_up():
            gw = self.gateway
            gw.set_policy(self.ccfg.routing_policy, **self.ccfg.routing_kw)
            gw.clear_user_buckets()
            gw.cordoned.clear()
        self.loop.after(duration, back_up)

    def _hedge(self) -> None:
        """Straggler hedging: pull queued work off engines whose
        windowed tokens/s fell below hedge_ratio x the fleet median
        and re-route it to faster members (the straggler keeps its
        in-flight work — only NOT-yet-started requests move).
        Quarantined engines count too: cordoning stops NEW routing but
        would otherwise strand whatever was already queued on the slow
        node for its whole (slow) drain."""
        suspects = list(self.gateway.straggler_engines(
            self.ccfg.hedge_ratio))
        suspects += [e for e in self.gateway.cordoned
                     if e not in suspects]
        for eid in suspects:
            eng = self.engines.get(eid)
            if eng is None or not eng.sched.waiting:
                continue
            role = self.pool_mgr.role_of(eid)
            src_pool = role if role in self.pool_mgr.POOLS else "mixed"
            # hedging needs somewhere else to put the work
            others = (self.pool_mgr.decoders() if src_pool == "decode"
                      else self.pool_mgr.frontends())
            if len(others) - (eid in others) < 1:
                continue
            reqs = eng.sched.takeover_waiting()
            self.hedged += len(reqs)
            self.gateway.note_failure(eid, "hedged")
            self._redeliver_lost(reqs, src_pool, exclude={eid})

    def _promote_poll(self) -> None:
        """Drain due predictive promotions from the gateway's session
        shards and ask each session's pinned engine to prefetch its SSD
        pages into host DRAM (the promoter runs between turns — off
        every request's critical path)."""
        for sid, eid in self.gateway.due_promotions(self.clock.now):
            eng = self.engines.get(eid)
            if eng is not None and eng.healthy():
                if eng.promote_session(sid):
                    self.promotions += 1

    def _lora_replan(self) -> None:
        """Demand-driven replanning: fold gateway-observed per-adapter
        rates into the registry and drive live register/unregister on
        healthy pods (engines defer unloads of in-flight adapters)."""
        live = {eid: self.engines[eid] for eid in self.engines
                if eid in self.gateway.engines
                and self.engines[eid].healthy()}
        self.lora_ctrl.refresh_demand(self.clock.now)
        self.lora_ctrl.sync(live)

    def _autoscale(self) -> None:
        asc = self.ccfg.autoscaler
        if asc is None:
            return
        now = self.clock.now
        decision = asc.desired(now, self.metrics, self.active_replicas)
        desired = decision.desired
        if self.lora_ctrl is not None:
            # adapter-count-aware floor: scale-in may never strand
            # registered adapters without a slot to be served from
            desired = max(desired, min(
                self.lora_ctrl.desired_pods(self._lora_slots),
                asc.max_replicas))
        self.scale_history.append((now, self.active_replicas, desired))
        delta = desired - self.active_replicas
        for _ in range(max(delta, 0)):
            # reuse a warm spare if one exists, else cold-start a new pod
            spare = [e for e in self.engines
                     if e not in self.gateway.engines
                     and self.engines[e].healthy()]
            if spare:
                # rejoin through the pool manager so pool membership
                # and gateway registration stay consistent (the retire
                # path removes from both)
                self.pool_mgr.add_engine(spare[0], self.engines[spare[0]],
                                         "mixed")
            else:
                self._spawn_engine(ready=False)
        for _ in range(max(-delta, 0)):
            self._retire_engine()

    # ------------------------------------------------------------ run
    def run(self, workload: Iterable[TimedRequest],
            drain_s: float = 600.0) -> dict:
        """Drive a workload to completion and return :meth:`summary`.

        ``workload`` may be a list (every arrival scheduled up front,
        the historical behavior) or any time-ordered iterator such as
        :func:`~repro_torch.core.sim.workloads.multi_round_qa` — iterators
        are consumed lazily, one pending arrival at a time, so a
        million-session trace never materializes in memory."""
        self._last_arrival = 0.0
        self._exhausted = False
        if isinstance(workload, (list, tuple)):
            for tr in workload:
                self._ingest(tr)
                self.loop.schedule(tr.arrival, self._make_dispatch(tr))
            self._last_arrival = (workload[-1].arrival if workload
                                  else 0.0)
            self._exhausted = True
        else:
            self._feed(iter(workload))
        # the scrape pump exists to feed the autoscaler's MetricStore
        # and the telemetry->diagnosis path (chaos forces telemetry
        # on); with neither consumer it's pure O(fleet x sim-seconds)
        # overhead per run, so don't schedule it
        if self.ccfg.autoscaler is not None or self.ccfg.telemetry:
            self.loop.every(self.ccfg.scrape_period_s, self._scrape)
        if self.ccfg.chaos is not None:
            for ev in self.ccfg.chaos:
                self.loop.schedule(ev.at, (lambda e=ev:
                                           self._chaos_exec(e)))
        if self.ccfg.hedge_ratio > 0:
            self.loop.every(self.ccfg.hedge_period_s, self._hedge)
        if (self.ccfg.promote_lead_s > 0
                and self.ccfg.routing_policy == "session"):
            self.loop.every(self.ccfg.promote_poll_period_s,
                            self._promote_poll)
        if self.ccfg.autoscaler is not None:
            self.loop.every(self.ccfg.autoscale_period_s, self._autoscale)
        if self.lora_ctrl is not None:
            self.loop.every(self.ccfg.lora_replan_period_s,
                            self._lora_replan)
        if self.disaggregated:
            self.loop.every(self.ccfg.pool_poll_period_s,
                            lambda: self.pool_mgr.poll(self.clock.now))
        if self.rebalancer is not None:
            self.loop.every(
                self.rebalancer.cfg.period_s,
                lambda: self.rebalancer.step(self.clock.now,
                                             self.pool_mgr))
        def done() -> bool:
            if not self._exhausted:
                return False
            if self.clock.now > self._last_arrival + drain_s:
                return True
            if self.clock.now <= self._last_arrival:
                return False
            if self._busy_engines > 0:
                # some engine has an iteration pending: certainly not
                # done, no need to touch the fleet (the hot path at
                # million-session scale)
                return False
            return not any(e.has_work for e in self.engines.values())

        # iterator workloads have no a-priori end time: the done()
        # predicate (checked after every event) supplies the cap once
        # the source runs dry
        end = (self._last_arrival + drain_s
               if isinstance(workload, (list, tuple)) else float("inf"))
        self.loop.run(until=end, stop_when=done)
        return self.summary()

    def _ingest(self, tr: TimedRequest) -> None:
        if self.ccfg.retain_requests:
            self.all_requests.append(tr.request)

    def _feed(self, it) -> None:
        """Pull ONE workload item and schedule its dispatch; the next
        pull rides on that dispatch event (arrivals are time-ordered,
        so at most one undelivered arrival is ever in the heap)."""
        tr = next(it, None)
        if tr is None:
            self._exhausted = True
            return
        self._ingest(tr)
        self._last_arrival = tr.arrival
        dispatch = self._make_dispatch(tr)

        def fire():
            dispatch()
            self._feed(it)
        self.loop.schedule(tr.arrival, fire)

    def _make_dispatch(self, tr: TimedRequest) -> Callable:
        def dispatch():
            if self.clock.now < self._gateway_down_until:
                # gateway mid-restart: the client retries shortly
                # after the downtime window ends
                self.gw_deferred += 1
                self.loop.after(
                    (self._gateway_down_until - self.clock.now)
                    + self.ccfg.gw_retry_delay_s, dispatch)
                return
            eid = self.gateway.route(
                tr.request.prompt_tokens, user=tr.request.user,
                lora_adapter=tr.request.lora_adapter,
                est_output_tokens=tr.request.sampling.max_new_tokens,
                priority_class=tr.request.priority_class,
                session_id=tr.request.session_id)
            if eid is None:
                self.rejected += 1
                return
            self.engines[eid].submit(tr.request)
        return dispatch

    def summary(self) -> dict:
        s = (self.stream_summary.summary()
             if self.stream_summary is not None
             else summarize(self.all_requests))
        s["rejected"] = self.rejected
        s["sim_events"] = self.loop.events_fired
        # loud load shedding: surface the gateway's rate-limit drops in
        # every cluster summary so benches can't under-report load
        s["shed_requests"] = self.gateway.stats.shed
        s["routing_policy"] = self.ccfg.routing_policy
        if self.gateway.num_shards > 1:
            s["gateway_shards"] = self.gateway.num_shards
        ss = self.gateway.session_stats()
        if ss is not None:
            s["session_hits"] = ss["session_hits"]
            s["session_misses"] = ss["session_misses"]
            s["session_rehomed"] = ss["session_rehomed"]
            if ss["promote_skipped"]:
                s["promote_skipped"] = ss["promote_skipped"]
        if self.kv_pool is not None:
            st = self.kv_pool.stats
            s["pool_hits"] = st.hits_local + st.hits_remote
            s["pool_evictions"] = st.evictions
            s["pool_dup_drops"] = st.dup_puts_dropped
            s["pool_fetch_failures"] = st.fetch_failures
            s["pool_publish_failures"] = st.publish_failures
        agg = [e.metrics() for e in self.engines.values()]
        s["prefix_hit_tokens"] = sum(m.prefix_hit_tokens for m in agg)
        s["remote_hit_tokens"] = sum(m.remote_hit_tokens for m in agg)
        s["preemptions"] = sum(m.preemptions for m in agg)
        # tiered-KV pressure: host/SSD-tier hits, swap traffic, wire bytes
        s["host_hit_tokens"] = sum(m.host_hit_tokens for m in agg)
        s["ssd_hit_tokens"] = sum(m.ssd_hit_tokens for m in agg)
        s["ssd_cross_hit_tokens"] = sum(m.ssd_cross_hit_tokens
                                        for m in agg)
        s["promote_hits"] = sum(m.promote_hits for m in agg)
        s["promote_wasted"] = sum(m.promote_wasted for m in agg)
        if self.promotions:
            s["promotions"] = self.promotions
        # SSD tier accounting (pool-level so shared pools count once):
        # write-behind drops are a first-class signal, and the shared
        # pool's dedupe ratio is the cross-engine sharing payoff
        pools = self.ssd_pools()
        if pools:
            s["ssd_puts"] = sum(p.stats.puts for p in pools)
            s["ssd_bytes_written"] = sum(p.stats.bytes_written
                                         for p in pools)
            s["ssd_dropped_puts"] = sum(p.stats.dropped_puts
                                        for p in pools)
        if self._host_ssd:
            dp = sum(p.dedup_puts for p in self._host_ssd.values())
            tp = sum(p.stats.puts for p in self._host_ssd.values())
            s["ssd_dedup_puts"] = dp
            s["ssd_dedup_bytes"] = sum(p.dedup_bytes
                                       for p in self._host_ssd.values())
            s["ssd_dedupe_ratio"] = dp / max(tp + dp, 1)
        s["swap_out"] = sum(m.swap_out for m in agg)
        s["swap_in"] = sum(m.swap_in for m in agg)
        s["kv_bytes_offloaded"] = sum(m.kv_bytes_offloaded for m in agg)
        s["kv_bytes_fetched"] = sum(m.kv_bytes_fetched for m in agg)
        # failure handling: drop-and-recompute waste, pool-failure
        # fallbacks and the recovery log's footprint
        s["wasted_tokens"] = sum(m.wasted_tokens for m in agg)
        s["kv_fetch_failures"] = sum(m.kv_fetch_failures for m in agg)
        s["ckpt_pages"] = sum(m.ckpt_pages for m in agg)
        # multi-LoRA serving: routing affinity + adapter-tier churn
        if self.lora_ctrl is not None or self.gateway.stats.lora_routed:
            s["lora_routed"] = self.gateway.stats.lora_routed
            s["lora_affinity_hit_rate"] = \
                self.gateway.stats.lora_affinity_hit_rate
            s["lora_miss"] = sum(m.lora_miss for m in agg)
            s["lora_shed"] = sum(m.lora_shed for m in agg)
            s["lora_cold_loads"] = sum(m.lora_cold_loads for m in agg)
            s["lora_cold_load_s"] = sum(m.lora_cold_load_s for m in agg)
            s["lora_evictions"] = sum(m.lora_evictions for m in agg)
        if self.lora_ctrl is not None:
            s["lora_ctrl_loads"] = self.lora_ctrl.stats["loads"]
            s["lora_ctrl_unloads"] = self.lora_ctrl.stats["unloads"]
        if self.ccfg.telemetry or self.ccfg.chaos is not None:
            s["diagnoses"] = len(self.diagnoses)
            s["quarantines"] = self.quarantines
            s["readmits"] = self.readmits
            s["crashed_requests"] = len(self.crashed_requests)
            s["crash_recovered"] = len(self.crash_recovered)
            s["hedged"] = self.hedged
            s["gw_restarts"] = self.gw_restarts
            s["gw_deferred"] = self.gw_deferred
        if self.disaggregated:
            s["pool_counts"] = {p: len(m)
                                for p, m in self.pool_mgr.pools.items()
                                if m}
            s["migrations"] = len(self.pool_mgr.migrations)
            att = self.pool_mgr.attainment()
            s["pool_ttft_attainment"] = att["ttft"]
            s["pool_itl_attainment"] = att["itl"]
        return s
