"""AIBrix API gateway: admission control + fairness + routing dispatch.

The Envoy-extension role from the paper: every request passes token-
based rate limiting (TPM/RPM per user — the thing the paper notes
Knative-style circuit breakers cannot express), then the configured
routing policy picks a serving engine.  The gateway is engine-agnostic:
targets are handles registered by the orchestration layer.

Role-pool awareness: engines may be registered with a ``pool`` tag
(``prefill`` / ``decode`` / ``mixed`` / ``draining``, maintained by
``repro_torch.core.orchestration.pools.RolePoolManager`` as it rebalances).
NEW requests only route to frontend pools (prefill/mixed) — decode
members receive work exclusively through the prefill handoff path, and
a draining member receives nothing at all.  ``deregister_engine`` and
``set_engine_pool`` also purge the engine from per-policy routing
state (attainment EWMAs, prefix-affinity maps) so a drained or
migrated pod can never be picked from stale state.

Sharded core: the gateway's HOT mutable state — session pin tables,
per-user rate-limit buckets, per-shard routing stats and the cached
routable view — lives in N independent ``_GatewayShard`` objects,
picked per request by ``hash(session_id | user)``.  Every structure a
``route()`` call touches is shard-private, so (a) per-call cost is a
function of the shard's table sizes, not the gateway's (cache locality
— a 500k-pin table walks cold cache lines; 500k/16 stays hot), and
(b) shards share zero mutable state, so the layout maps 1:1 onto a
real multi-gateway deployment where each shard is its own process
behind a consistent-hash LB and aggregate capacity is per-shard rate x
N.  Fleet topology (engines, pools, cordons, user limit overrides)
stays global — it is read-mostly and admin-mutated only.  Stats merge
lazily: ``gateway.stats`` returns the single shard's live object when
``shards == 1`` (the historical contract) and a merged snapshot
otherwise.
"""
from __future__ import annotations

import collections
import logging
import statistics
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.gateway.router import RoutingPolicy, make_policy
from repro_torch.engine.scheduler import FRONTEND_ROLES

log = logging.getLogger("repro_torch.gateway")


@dataclass
class RateLimit:
    rpm: float = 600.0            # requests / minute
    tpm: float = 600_000.0        # tokens / minute


class TokenBucket:
    def __init__(self, rate_per_min: float, burst: float = None):
        self.rate = rate_per_min / 60.0
        self.capacity = burst if burst is not None else rate_per_min / 6.0
        self.level = self.capacity
        self.t = 0.0

    def allow(self, amount: float, now: float) -> bool:
        self.level = min(self.capacity, self.level + (now - self.t) * self.rate)
        self.t = now
        if self.level >= amount:
            self.level -= amount
            return True
        return False


@dataclass
class GatewayStats:
    routed: int = 0
    rejected_rpm: int = 0
    rejected_tpm: int = 0
    # multi-LoRA routing: requests naming an adapter, and how many of
    # them landed on an engine that already had it resident (the
    # affinity hit rate is the headline routing metric of §3.2.1)
    lora_routed: int = 0
    lora_hits: int = 0
    per_engine: Dict[str, int] = field(default_factory=dict)
    # per-engine failure accounting: engine_id -> {failure kind -> n}
    # (crashes, quarantines, hedged re-routes) — the control plane's
    # evidence trail for replace-vs-readmit decisions
    engine_failures: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @property
    def shed(self) -> int:
        """Requests the rate limiter dropped (they never reached an
        engine — a bench that ignores this under-reports its load)."""
        return self.rejected_rpm + self.rejected_tpm

    @property
    def lora_affinity_hit_rate(self) -> float:
        """Fraction of LoRA requests routed to an engine already
        holding their adapter (1.0 when none were routed)."""
        return self.lora_hits / self.lora_routed if self.lora_routed \
            else 1.0

    @classmethod
    def merge(cls, parts) -> "GatewayStats":
        """Lazy cross-shard aggregation: counters sum, per-engine and
        failure maps merge key-wise.  Derived properties (``shed``,
        ``lora_affinity_hit_rate``) then read correctly off the sums."""
        out = cls()
        for s in parts:
            out.routed += s.routed
            out.rejected_rpm += s.rejected_rpm
            out.rejected_tpm += s.rejected_tpm
            out.lora_routed += s.lora_routed
            out.lora_hits += s.lora_hits
            for eid, n in s.per_engine.items():
                out.per_engine[eid] = out.per_engine.get(eid, 0) + n
            for eid, rec in s.engine_failures.items():
                dst = out.engine_failures.setdefault(eid, {})
                for kind, n in rec.items():
                    dst[kind] = dst.get(kind, 0) + n
        return out


class _GatewayShard:
    """One slice of the gateway's hot state.  Everything here is
    touched on the per-request path and NOTHING here is shared with a
    sibling shard — the independence is the whole point."""

    __slots__ = ("policy", "stats", "_rpm", "_tpm",
                 "_routable_cache", "_routable_key",
                 "_shed_window", "_shed_t0", "_shed_log_at")

    def __init__(self, policy: RoutingPolicy):
        self.policy = policy
        self.stats = GatewayStats()
        # per-user token buckets, LRU-bounded (see Gateway.max_user_buckets)
        self._rpm: "collections.OrderedDict[str, TokenBucket]" = \
            collections.OrderedDict()
        self._tpm: "collections.OrderedDict[str, TokenBucket]" = \
            collections.OrderedDict()
        # shard-local cached routable view (same content as every other
        # shard's — engines are global — but a private reference means
        # the route() path never touches shared mutable state)
        self._routable_cache: Optional[Dict[str, object]] = None
        self._routable_key = None
        # windowed shed logging state
        self._shed_window = 0
        self._shed_t0 = 0.0
        self._shed_log_at = float("-inf")


class Gateway:
    FRONTEND_POOLS = FRONTEND_ROLES    # shared role taxonomy
    SHED_LOG_WINDOW_S = 10.0           # at most one shed log per window
    # process-wide shed counter across every Gateway instance —
    # benchmarks/run.py prints the per-suite delta so a bench whose
    # offered load the rate limiter silently halved cannot pass as
    # having served it (sim benches >10 rps must raise
    # ClusterConfig.rate_limit or their requests vanish here)
    total_shed: int = 0
    # process-wide LoRA routing counters (same contract): run.py prints
    # each suite's affinity hit rate next to its results
    total_lora_routed: int = 0
    total_lora_hits: int = 0

    def __init__(self, policy: str = "least-request",
                 default_limit: RateLimit = None,
                 clock: Callable[[], float] = None,
                 shards: int = 1, **policy_kw):
        self.num_shards = max(1, int(shards))
        self.default_limit = default_limit or RateLimit()
        self.clock = clock or (lambda: 0.0)
        self.engines: Dict[str, object] = {}
        # cached routable view: ``route()`` runs per request, so the
        # frontend/cordon filter + id-ordering is computed once per
        # fleet change, not per call.  ``cache_routable=False`` restores
        # the rebuild-every-call behavior (bench_routing's baseline).
        self.cache_routable = True
        self._fleet_version = 0
        self.engine_pool: Dict[str, str] = {}     # engine_id -> pool tag
        # quarantined engines: cordoned out of routable_engines() while
        # the DiagnosticMonitor's re-admit probe runs (in-flight work
        # keeps draining; only NEW routing is blocked)
        self.cordoned: set = set()
        self.user_limits: Dict[str, RateLimit] = {}
        # adapter registry (LoRAController): when attached, the gateway
        # feeds it per-adapter arrivals (demand-driven replanning) and
        # wires its endpoint view into the lora-affinity policy
        self.lora_controller = None
        # per-user rate-limit bucket budget, LRU-bounded and split
        # evenly across shards: a million-session trace brings a
        # million distinct users, and an unbounded map would hold two
        # bucket objects per user forever.  Evicting the least-
        # recently-routed user resets their bucket to full on return —
        # indistinguishable from an idle user whose bucket refilled, so
        # only sustained >max_user_buckets populations see any leniency.
        self.max_user_buckets = 1 << 18
        self._policy_name = policy
        self._policy_kw = dict(policy_kw)
        self._shards: List[_GatewayShard] = [
            _GatewayShard(self._make_shard_policy(policy, **policy_kw))
            for _ in range(self.num_shards)]
        # workload histogram for the GPU optimizer's Load Monitor
        self.request_log: collections.deque = collections.deque(maxlen=4096)

    # ------------------------------------------------------------- shards
    def _shard_for(self, key: str) -> _GatewayShard:
        """Shard pick by ``hash(session_id | user)``.  crc32, not
        ``hash()``: Python salts str hashes per process, and the shard
        map must be deterministic so sharded-vs-monolithic equivalence
        holds run to run (and across the real deployment's LB)."""
        if self.num_shards == 1:
            return self._shards[0]
        return self._shards[zlib.crc32(key.encode()) % self.num_shards]

    def _policies(self) -> List[RoutingPolicy]:
        """Unique policy objects across shards (the ``policy`` setter
        aliases one object into every shard, so counters would double-
        count without the dedup)."""
        seen: Dict[int, RoutingPolicy] = {}
        for sh in self._shards:
            seen.setdefault(id(sh.policy), sh.policy)
        return list(seen.values())

    def _make_shard_policy(self, name: str, **kw) -> RoutingPolicy:
        pol = make_policy(name, **kw)
        if hasattr(pol, "attach_clock"):
            pol.attach_clock(self.clock)
        if self.lora_controller is not None \
                and hasattr(pol, "set_endpoints"):
            pol.set_endpoints(self.lora_controller.endpoints)
        return pol

    # --------------------------------------------- back-compat properties
    @property
    def policy(self) -> RoutingPolicy:
        """Shard 0's policy — THE policy when ``shards == 1`` (the
        historical single-shard contract)."""
        return self._shards[0].policy

    @policy.setter
    def policy(self, pol: RoutingPolicy) -> None:
        """Install one externally-built policy object into every shard
        (bench baselines swap hand-rolled policies in this way).  The
        object is aliased, not copied — cross-shard aggregation dedups
        by identity."""
        for sh in self._shards:
            sh.policy = pol
        if hasattr(pol, "attach_clock"):
            pol.attach_clock(self.clock)
        if self.lora_controller is not None \
                and hasattr(pol, "set_endpoints"):
            pol.set_endpoints(self.lora_controller.endpoints)

    @property
    def stats(self) -> GatewayStats:
        """Single-shard: the live stats object (writes through it are
        visible, tests rely on this).  Multi-shard: a merged SNAPSHOT —
        mutating it is meaningless."""
        if self.num_shards == 1:
            return self._shards[0].stats
        return GatewayStats.merge(sh.stats for sh in self._shards)

    @property
    def _rpm(self):
        return self._shards[0]._rpm

    @property
    def _tpm(self):
        return self._shards[0]._tpm

    @property
    def _routable_cache(self):
        return self._shards[0]._routable_cache

    @_routable_cache.setter
    def _routable_cache(self, value) -> None:
        for sh in self._shards:
            sh._routable_cache = value

    def clear_user_buckets(self) -> None:
        """Drop every user's rate-limit bucket (gateway restart: the
        replacement comes up with empty admission state)."""
        for sh in self._shards:
            sh._rpm.clear()
            sh._tpm.clear()

    # -------------------------------------------------------------- admin
    def _fleet_changed(self) -> None:
        """Invalidate every shard's cached routable view (any admin
        mutation).  Bumping the global version is enough — each shard
        revalidates lazily on its next route()."""
        self._fleet_version += 1
        for sh in self._shards:
            sh._routable_cache = None

    def _forget_all(self, engine_id: str) -> None:
        """Purge the engine from EVERY shard's policy state.  A pin
        that survives in any one shard is exactly the stale-routing bug
        sharding must not reintroduce."""
        for pol in self._policies():
            pol.forget(engine_id)

    def register_engine(self, engine_id: str, handle,
                        pool: Optional[str] = None) -> None:
        """Register a target.  ``pool`` tags the serving role; untagged
        engines route like 'mixed' (the pre-pool contract).

        Re-registration with a DIFFERENT pool tag is a retag: policy
        state earned under the old role is purged, same as
        ``set_engine_pool`` — without this, a pod re-registered
        straight into a decode pool keeps its session pins and those
        sessions route into a black hole until TTL expiry."""
        retag = engine_id in self.engines and pool is not None \
            and self.engine_pool.get(engine_id, "mixed") != pool
        self.engines[engine_id] = handle
        if pool is not None:
            self.engine_pool[engine_id] = pool
        if retag:
            self._forget_all(engine_id)
        self._fleet_changed()

    def deregister_engine(self, engine_id: str) -> None:
        """Scale-down/remediation: the engine must become unroutable
        IMMEDIATELY, including from any per-policy state (attainment
        EWMAs, prefix-affinity maps, session pins) that could still
        name it."""
        self.engines.pop(engine_id, None)
        self.engine_pool.pop(engine_id, None)
        self.cordoned.discard(engine_id)
        self._forget_all(engine_id)
        self._fleet_changed()

    def cordon(self, engine_id: str, reason: str = "quarantine") -> None:
        """Quarantine: stop routing NEW work to the engine without
        deregistering it (it stays registered so telemetry and the
        re-admit probe keep flowing).  Policy state is purged — stale
        affinity must not re-earn routing the moment it is readmitted."""
        if engine_id in self.engines and engine_id not in self.cordoned:
            self.cordoned.add(engine_id)
            self._forget_all(engine_id)
            self.note_failure(engine_id, reason)
            self._fleet_changed()

    def uncordon(self, engine_id: str) -> None:
        self.cordoned.discard(engine_id)
        self._fleet_changed()

    def note_failure(self, engine_id: str, kind: str) -> None:
        """Per-engine failure accounting (crash / quarantine / hedged).
        Recorded on the engine's home shard (by engine-id hash) so
        concurrent recorders never contend; the merged view re-unifies
        per engine."""
        rec = self._shard_for(engine_id).stats.engine_failures \
            .setdefault(engine_id, {})
        rec[kind] = rec.get(kind, 0) + 1

    def set_engine_pool(self, engine_id: str, pool: str) -> None:
        """Role migration: retag without a deregister/register cycle.
        Policy state is purged — affinity earned as a prefill member
        must not leak routing onto the same pod as a decode member."""
        self.engine_pool[engine_id] = pool
        self._forget_all(engine_id)
        self._fleet_changed()

    def _build_routable(self) -> Dict[str, object]:
        if not self.engine_pool and not self.cordoned:
            return {eid: self.engines[eid]
                    for eid in sorted(self.engines)}
        if not self.engine_pool:
            return {eid: self.engines[eid]
                    for eid in sorted(self.engines)
                    if eid not in self.cordoned}
        return {eid: self.engines[eid]
                for eid in sorted(self.engines)
                if eid not in self.cordoned
                and self.engine_pool.get(eid, "mixed")
                in self.FRONTEND_POOLS}

    def _shard_routable(self, shard: _GatewayShard) -> Dict[str, object]:
        key = (self._fleet_version, len(self.engines),
               len(self.engine_pool), len(self.cordoned))
        if self.cache_routable and shard._routable_cache is not None \
                and shard._routable_key == key:
            return shard._routable_cache
        view = self._build_routable()
        shard._routable_cache = view
        shard._routable_key = key
        return view

    def routable_engines(self) -> Dict[str, object]:
        """NEW requests go to frontend pools only (prefill/mixed) and
        never to a cordoned engine; untagged engines (no pool manager)
        keep the legacy behavior.

        The returned view is CACHED per shard and id-ordered: it is
        rebuilt only when the fleet changes (register/deregister/retag/
        cordon — and a length check catches direct ``cordoned``
        mutation), so the per-request routing path does no filtering or
        sorting.  Policies rely on the id-ordering for deterministic
        tie-breaks.  This admin-facing accessor reads through shard 0."""
        return self._shard_routable(self._shards[0])

    def straggler_engines(self, ratio: float = 0.5) -> List[str]:
        """Fleet-relative straggler detection: routable engines whose
        windowed tokens/s sits below ``ratio`` x the fleet median while
        they still hold work (queued or running).  A silently degraded
        node looks exactly like this — slow, not dead — and the hedging
        loop re-routes its queued work before the DiagnosticMonitor's
        quarantine confirm window elapses."""
        mets = {eid: h.metrics() for eid, h in
                self.routable_engines().items()}
        rates = [m.tokens_per_sec for m in mets.values()
                 if m.tokens_per_sec > 0]
        if len(rates) < 2:
            return []
        med = statistics.median(rates)
        return [eid for eid, m in mets.items()
                if (m.num_waiting or m.num_running)
                and m.tokens_per_sec < ratio * med]

    def set_user_limit(self, user: str, limit: RateLimit) -> None:
        self.user_limits[user] = limit

    def set_policy(self, name: str, **kw) -> None:
        """Swap the routing policy fleet-wide: every shard gets its own
        fresh instance (independent pin tables — sharing one would
        serialize them again)."""
        self._policy_name, self._policy_kw = name, dict(kw)
        for sh in self._shards:
            sh.policy = self._make_shard_policy(name, **kw)

    def attach_lora_controller(self, ctrl) -> None:
        """Back the gateway with an adapter registry: routed LoRA
        requests feed the controller's demand window, and the
        lora-affinity policy learns the controller's real endpoints."""
        self.lora_controller = ctrl
        for pol in self._policies():
            if hasattr(pol, "set_endpoints"):
                pol.set_endpoints(ctrl.endpoints)

    # ---------------------------------------------------------- sessions
    def session_stats(self) -> Optional[Dict[str, int]]:
        """Merged session-affinity counters across shards, or None when
        the active policy is not session-based."""
        pols = [p for p in self._policies()
                if getattr(p, "name", "") == "session"]
        if not pols:
            return None
        return {
            "session_hits": sum(p.hits for p in pols),
            "session_misses": sum(p.misses for p in pols),
            "session_rehomed": sum(p.rehomed for p in pols),
            "session_pins": sum(len(p._sessions) for p in pols),
            "promote_skipped": sum(p.promote_skipped for p in pols),
        }

    def due_promotions(self, now: Optional[float] = None,
                       limit: int = 256) -> List[Tuple[str, str]]:
        """Drain due predictive promotions across every shard's session
        policy: ``(session_id, engine_id)`` pairs whose predicted turn
        arrival is within the promote lead.  The per-shard ``limit``
        bounds promoter work per poll."""
        if now is None:
            now = self.clock()
        out: List[Tuple[str, str]] = []
        for pol in self._policies():
            if hasattr(pol, "due_promotions"):
                out.extend(pol.due_promotions(now, limit))
        return out

    # -------------------------------------------------------------- route
    def _buckets(self, shard: _GatewayShard,
                 user: str) -> Tuple[TokenBucket, TokenBucket]:
        rpm = shard._rpm
        if user not in rpm:
            lim = self.user_limits.get(user, self.default_limit)
            cap = max(self.max_user_buckets // self.num_shards, 1)
            if len(rpm) >= cap:
                old, _ = rpm.popitem(last=False)
                shard._tpm.pop(old, None)
            rpm[user] = TokenBucket(lim.rpm)
            shard._tpm[user] = TokenBucket(lim.tpm)
        else:
            rpm.move_to_end(user)
        return rpm[user], shard._tpm[user]

    def route(self, tokens: Sequence[int], user: str = "default",
              lora_adapter: Optional[str] = None,
              est_output_tokens: int = 64,
              priority_class: str = "standard",
              session_id: Optional[str] = None) -> Optional[str]:
        """Admission + routing.  Returns engine id, or None if rejected
        (token-based rate limit) / no engine registered.
        ``priority_class`` is the request's SLO class — the slo-aware
        policy routes by its per-class attainment/slack; ``session_id``
        is the multi-turn conversation key — the session policy pins
        it to the engine holding the conversation's KV prefix; other
        policies ignore them.  The whole call runs against ONE shard
        (picked by session, falling back to user), so its cost tracks
        the shard's table sizes, not the gateway's."""
        now = self.clock()
        shard = self._shard_for(
            session_id if session_id is not None else user)
        targets = self._shard_routable(shard)
        if not targets:
            return None
        rpm, tpm = self._buckets(shard, user)
        if not rpm.allow(1.0, now):
            shard.stats.rejected_rpm += 1
            self._note_shed(shard, user, now)
            return None
        if not tpm.allow(len(tokens) + est_output_tokens, now):
            shard.stats.rejected_tpm += 1
            self._note_shed(shard, user, now)
            return None
        eid = shard.policy.select(targets, tokens, lora_adapter,
                                  priority_class=priority_class,
                                  session_id=session_id)
        if lora_adapter:
            # affinity accounting: did the chosen engine already hold
            # the adapter, or does this request pay a cold load?
            shard.stats.lora_routed += 1
            Gateway.total_lora_routed += 1
            try:
                resident = lora_adapter in \
                    targets[eid].metrics().loaded_adapters
            except Exception:
                resident = False
            if resident:
                shard.stats.lora_hits += 1
                Gateway.total_lora_hits += 1
            if self.lora_controller is not None:
                self.lora_controller.note_request(lora_adapter, now)
        shard.stats.routed += 1
        shard.stats.per_engine[eid] = \
            shard.stats.per_engine.get(eid, 0) + 1
        self.request_log.append(
            (now, len(tokens), est_output_tokens, user, eid))
        return eid

    def _note_shed(self, shard: _GatewayShard, user: str,
                   now: float) -> None:
        """Rate-limit drops must be LOUD: count them (instance +
        process-wide) and log once per window with the running totals,
        so a workload the limiter is silently halving shows up in bench
        output instead of just reading as light load.  The window state
        is shard-local (no cross-shard write), so a hot shard logs at
        most once per window regardless of sibling traffic."""
        Gateway.total_shed += 1
        if shard._shed_window == 0:
            shard._shed_t0 = now
        shard._shed_window += 1
        if now >= shard._shed_log_at:
            st = shard.stats
            log.warning(
                "gateway shed %d request(s) over the last %.1fs "
                "(user=%s; shard totals: rpm=%d tpm=%d) — raise "
                "RateLimit if this load is intended",
                shard._shed_window, max(now - shard._shed_t0, 0.0),
                user, st.rejected_rpm, st.rejected_tpm)
            shard._shed_window = 0
            shard._shed_log_at = now + self.SHED_LOG_WINDOW_S

    # -------------------------------------------------------------- stats
    def workload_histogram(self, in_edges=(200, 1000, 4000),
                           out_edges=(100, 500)) -> Dict[tuple, int]:
        """Bucketed (input_len, output_len) histogram — the Load Monitor
        input for the SLO-driven GPU optimizer (paper §3.2.7)."""
        hist: Dict[tuple, int] = {}

        def bucket(v, edges):
            for i, e in enumerate(edges):
                if v < e:
                    return i
            return len(edges)

        for _, ilen, olen, _, _ in self.request_log:
            key = (bucket(ilen, in_edges), bucket(olen, out_edges))
            hist[key] = hist.get(key, 0) + 1
        return hist
