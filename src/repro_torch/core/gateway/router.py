"""LLM-aware routing strategies (paper §3.2.2, Figure 3).

Implements exactly the paper's six policies over live engine metrics:

  random | throughput | least-request | least-kv-cache | least-latency |
  prefix-cache-aware

plus three beyond-paper composites:

  * ``prefix-load`` — prefix affinity scored jointly with load (the
    direction the gateway-api-inference-extension work took); used in
    benchmarks as the "optimized" router.  Knob: ``load_weight``.
  * ``slo-aware`` — routes by per-priority-class SLO slack/attainment
    instead of raw latency: engines report per-class TTFT attainment
    (``EngineMetrics.slo_by_class``, produced by the shared scheduler
    core) and the policy sends a request where its class's SLO has the
    most headroom.  Knobs: ``load_weight`` (queue-depth penalty),
    ``classes`` (TTFT/ITL target table, defaults to the scheduler's
    ``DEFAULT_SLO_CLASSES``).
  * ``session`` — sticky multi-turn routing (production-stack's
    ``routingLogic: "session"``): a bounded, TTL'd ``session_id ->
    engine`` map pins every turn of a conversation to the engine
    already holding its KV prefix; first turns, expired sessions and
    sessions whose engine retired re-home through prefix affinity.
    Knobs: ``max_sessions``, ``ttl_s``, ``load_weight``.

Every ``select`` takes the request's ``priority_class`` and
``session_id`` keywords (the gateway forwards them); policies that
don't differentiate simply ignore them.  Engines are anything exposing
``metrics() -> EngineMetrics`` and ``match_prefix_len(tokens) -> int``
— the real JAX engine, the slot engine and the cluster simulator's
analytic engine all qualify.

Hot-path note: ``select`` runs once per request, for every request, so
no policy may sort the engine view per call.  The gateway hands
policies a *cached, id-ordered* engine dict (rebuilt only when the
fleet changes — see ``Gateway.routable_engines``) and the scoring
loops below are single-pass argmin/argmax with an explicit
``(score, engine_id)`` tie-break, which keeps selection deterministic
for any insertion order of the dict.
"""
from __future__ import annotations

import collections
import heapq
import random as _random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.engine.engine import EngineMetrics  # metric surface contract
from repro_torch.engine.scheduler import DEFAULT_SLO_CLASSES


class RoutingPolicy:
    name = "base"

    def select(self, engines: Dict[str, object], tokens: Sequence[int],
               lora_adapter: Optional[str] = None,
               priority_class: str = "standard",
               session_id: Optional[str] = None) -> str:
        raise NotImplementedError

    def forget(self, engine_id: str) -> None:
        """Purge any per-engine policy state.  The gateway calls this
        on deregistration AND on role migration so a drained/retagged
        pod can never be picked from stale EWMAs or affinity maps.
        Stateless policies inherit the no-op."""


class RandomPolicy(RoutingPolicy):
    name = "random"

    def __init__(self, seed: int = 0):
        self.rng = _random.Random(seed)

    def select(self, engines, tokens, lora_adapter=None,
               priority_class="standard", session_id=None):
        # the gateway's cached routable view is id-ordered, so indexing
        # into the dict directly is both O(n) and deterministic
        keys = list(engines)
        return keys[self.rng.randrange(len(keys))]


class _MetricArgmin(RoutingPolicy):
    metric: Callable = None

    def select(self, engines, tokens, lora_adapter=None,
               priority_class="standard", session_id=None):
        # single pass, deterministic (score, id) tie-break — no sort
        best, best_s = None, None
        metric = self.metric
        for eid, e in engines.items():
            s = metric(e.metrics())
            if best_s is None or s < best_s \
                    or (s == best_s and eid < best):
                best, best_s = eid, s
        return best


class ThroughputPolicy(_MetricArgmin):
    """Lowest current token throughput (tokens/s)."""
    name = "throughput"
    metric = staticmethod(lambda m: m.tokens_per_sec)


def _queue_depth(e) -> int:
    """Engine load for routing scores, off the cheap accessor when the
    engine exposes one (the shared scheduler core does) — a full
    metrics() build per engine per route is the single largest
    per-request cost at large fleet sizes."""
    qd = getattr(e, "queue_depth", None)
    if qd is not None:
        return qd
    m = e.metrics()
    return m.num_running + m.num_waiting


class LeastRequestPolicy(_MetricArgmin):
    """Lowest number of admitted-but-unfinished requests."""
    name = "least-request"
    metric = staticmethod(lambda m: m.num_running + m.num_waiting)

    def select(self, engines, tokens, lora_adapter=None,
               priority_class="standard", session_id=None):
        best, best_s = None, None
        for eid, e in engines.items():
            s = _queue_depth(e)
            if best_s is None or s < best_s \
                    or (s == best_s and eid < best):
                best, best_s = eid, s
        return best


class LeastKVCachePolicy(_MetricArgmin):
    """Lowest KV cache utilization."""
    name = "least-kv-cache"
    metric = staticmethod(lambda m: m.kv_utilization)


class LeastLatencyPolicy(_MetricArgmin):
    """Lowest (queue + serve) latency EWMA."""
    name = "least-latency"
    metric = staticmethod(lambda m: m.avg_queue_time + m.avg_latency)


class PrefixCacheAwarePolicy(RoutingPolicy):
    """Prefer engines whose prefix cache covers > threshold of the
    prompt; fall back to least-request among the rest (paper text)."""
    name = "prefix-cache-aware"

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._fallback = LeastRequestPolicy()

    def select(self, engines, tokens, lora_adapter=None,
               priority_class="standard", session_id=None):
        n = max(len(tokens), 1)
        best_eid, best_cov = None, 0.0
        for eid, e in engines.items():
            cov = e.match_prefix_len(tokens) / n
            if cov > best_cov or (cov == best_cov and cov > 0.0
                                  and eid < best_eid):
                best_eid, best_cov = eid, cov
        if best_eid is not None and best_cov >= self.threshold:
            return best_eid
        return self._fallback.select(engines, tokens, lora_adapter)


class PrefixLoadPolicy(RoutingPolicy):
    """Beyond-paper composite: score = prefix_coverage − load_penalty.

    Captures the failure mode of pure prefix affinity (hot prefix
    hot-spots one engine) by trading coverage against queue depth.
    Keeps a bounded prefix-affinity map (leading block -> last engine
    chosen) as a deterministic TIE-BREAK: when scores are otherwise
    equal (fresh engines, prefix not yet registered anywhere) a
    repeated prefix sticks to the engine already picked for it instead
    of drifting to the lowest id — the epsilon bonus is far below one
    unit of load or coverage, so it can never override either.
    ``forget`` purges an engine from the map on scale-down/migration.
    """
    name = "prefix-load"

    AFFINITY_BLOCK = 16          # leading tokens keying the affinity map
    MAX_AFFINITY = 4096

    def __init__(self, load_weight: float = 0.02,
                 affinity_bonus: float = 1e-6):
        self.load_weight = load_weight
        self.affinity_bonus = affinity_bonus
        self._affinity: Dict[tuple, str] = {}

    def select(self, engines, tokens, lora_adapter=None,
               priority_class="standard", session_id=None):
        n = max(len(tokens), 1)
        key = tuple(tokens[:self.AFFINITY_BLOCK])
        hint = self._affinity.get(key)
        best, best_score = None, -1e18
        for eid, e in engines.items():
            cov = e.match_prefix_len(tokens) / n
            score = cov - self.load_weight * _queue_depth(e)
            if eid == hint:
                score += self.affinity_bonus
            if score > best_score \
                    or (score == best_score and eid < best):
                best, best_score = eid, score
        if (key not in self._affinity
                and len(self._affinity) >= self.MAX_AFFINITY):
            self._affinity.pop(next(iter(self._affinity)))
        self._affinity[key] = best
        return best

    def forget(self, engine_id: str) -> None:
        self._affinity = {k: v for k, v in self._affinity.items()
                          if v != engine_id}


class SLOAwarePolicy(RoutingPolicy):
    """SLO-aware routing: pick the engine with the most SLO headroom
    for the request's priority class, instead of raw latency.

    Score per engine = the class's recent TTFT attainment (how well
    this engine is currently holding that class's SLO — falling back
    to the engine-wide ``slo_attainment`` before the class has any
    finishes there) minus the engine's queue-time pressure normalized
    by the class TTFT target (an engine whose queue already eats most
    of an interactive budget is hopeless for interactive work but fine
    for batch) minus ``load_weight`` × queue depth (tie-break toward
    emptier engines).  Works against any engine whose metrics come
    from the shared scheduler core (real, sim and slot engines).
    """
    name = "slo-aware"

    def __init__(self, load_weight: float = 0.02, classes: dict = None,
                 ewma_alpha: float = 0.3):
        self.load_weight = load_weight
        self.classes = dict(classes or DEFAULT_SLO_CLASSES)
        # per-(engine, class) attainment EWMA: smooths the windowed
        # reading so one noisy scrape can't flip-flop routing; purged
        # by ``forget`` when the engine leaves or changes role
        self.ewma_alpha = ewma_alpha
        self._att_ewma: Dict[tuple, float] = {}

    def select(self, engines, tokens, lora_adapter=None,
               priority_class="standard", session_id=None):
        cls = self.classes.get(priority_class) \
            or self.classes.get("standard") \
            or DEFAULT_SLO_CLASSES["standard"]
        best, best_score = None, -1e18
        for eid, eng in engines.items():
            m = eng.metrics()
            att = m.slo_attainment
            for name, ttft_att, _itl_att, _n in m.slo_by_class:
                if name == priority_class:
                    att = ttft_att
                    break
            key = (eid, priority_class)
            prev = self._att_ewma.get(key)
            if prev is not None:
                att = (1 - self.ewma_alpha) * prev + self.ewma_alpha * att
            self._att_ewma[key] = att
            slack_pressure = m.avg_queue_time / max(cls.ttft_s, 1e-9)
            load = m.num_running + m.num_waiting
            score = att - slack_pressure - self.load_weight * load
            if score > best_score \
                    or (score == best_score and eid < best):
                best, best_score = eid, score
        return best

    def forget(self, engine_id: str) -> None:
        self._att_ewma = {k: v for k, v in self._att_ewma.items()
                          if k[0] != engine_id}


class LoRAAffinityPolicy(RoutingPolicy):
    """LoRA-aware routing (paper §3.2.1): pack requests for co-resident
    adapters onto the same engine; tie-break least-request.

    Two discovery sources, in order: the ``LoRAController``'s endpoint
    view when a registry is attached (``set_endpoints`` — the
    EndpointSlice analogue, wired by ``Gateway.attach_lora_controller``,
    so the policy learns the controller's REAL placements instead of
    static tags), then the engines' live ``loaded_adapters`` metrics
    (which also cover adapters an engine auto-loaded past the plan).
    A request whose adapter is resident nowhere falls back to
    least-request — the chosen engine cold-loads it, and subsequent
    requests find it through the metrics path."""
    name = "lora-affinity"

    def __init__(self):
        self._fallback = LeastRequestPolicy()
        self._endpoints_fn: Optional[Callable[[str], List[str]]] = None

    def set_endpoints(self, fn: Callable[[str], List[str]]) -> None:
        """Attach the adapter-registry discovery view
        (``LoRAController.endpoints``)."""
        self._endpoints_fn = fn

    def select(self, engines, tokens, lora_adapter=None,
               priority_class="standard", session_id=None):
        if lora_adapter:
            having = {}
            if self._endpoints_fn is not None:
                having = {eid: engines[eid]
                          for eid in self._endpoints_fn(lora_adapter)
                          if eid in engines}
            if not having:
                having = {eid: e for eid, e in engines.items()
                          if lora_adapter in e.metrics().loaded_adapters}
            if having:
                return self._fallback.select(having, tokens, lora_adapter)
        return self._fallback.select(engines, tokens, lora_adapter)


class SessionAffinityPolicy(RoutingPolicy):
    """Sticky session routing for multi-turn serving (production-stack's
    ``routingLogic: "session"`` / ``sessionKey: "x-user-id"`` shape).

    A bounded, TTL'd ``session_id -> engine_id`` map pins every turn of
    a conversation to the engine that served its previous turns — where
    the session's KV prefix is already resident in the device cache or
    its host/SSD tiers, so turn N admits with a warm prefix instead of
    recomputing the whole growing history.  The map is only a routing
    *hint*, never correctness state:

    * first turn / expired TTL / map evicted under ``max_sessions`` —
      the request routes through the :class:`PrefixLoadPolicy` fallback
      (prefix affinity traded against load) and the winner is recorded;
    * engine retired or migrated — ``forget`` purges every session
      pinned to it, so the next turn re-homes through prefix affinity
      with zero lost requests (a gateway restart, which loses the whole
      map, degrades the same way: one fallback route per session).

    All map operations are O(1); ``forget`` is O(sessions) but only
    runs on fleet changes.

    Predictive promotion: each pin also carries a think-time EWMA (the
    observed turn-to-turn arrival gap), so the tier promoter can
    prefetch a returning session's SSD pages back into host DRAM
    *before* the predicted turn lands.  When ``promote_lead_s > 0``,
    every turn with a usable EWMA pushes ``(predicted_arrival - lead,
    session, engine)`` onto a bounded schedule heap;
    :meth:`due_promotions` pops the entries whose fire time has passed,
    lazily dropping stale ones (session re-touched, expired or
    re-homed since the push — the recorded ``last_seen`` stamp no
    longer matches the pin).  The heap is capacity-bounded: under
    overload new predictions are skipped (``promote_skipped``), never
    queued without limit.
    """
    name = "session"

    EWMA_ALPHA = 0.4             # think-time smoothing
    MAX_PROMOTE_HEAP = 1 << 16   # bounded promoter schedule

    def __init__(self, max_sessions: int = 1 << 20,
                 ttl_s: float = 1800.0, load_weight: float = 0.02,
                 promote_lead_s: float = 0.0):
        self.max_sessions = max_sessions
        self.ttl_s = ttl_s
        self.promote_lead_s = promote_lead_s
        self._fallback = PrefixLoadPolicy(load_weight=load_weight)
        # session_id -> (engine_id, last_seen, think_ewma_or_None);
        # dict order == LRU order
        self._sessions: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        # promotion schedule: (fire_at, session_id, last_seen_stamp)
        self._promote_heap: list = []
        self._clock = None
        self.hits = 0          # routed by the sticky map
        self.misses = 0        # first turn of a session
        self.rehomed = 0       # mapping stale/retired -> prefix fallback
        self.promote_skipped = 0   # heap full => prediction dropped

    def attach_clock(self, clock) -> None:
        """The gateway wires its clock in so TTL expiry shares the
        cluster's notion of time (sim or wall)."""
        self._clock = clock

    def think_ewma(self, session_id: str) -> Optional[float]:
        """The session's smoothed turn-to-turn gap (None before the
        second turn) — the promoter's arrival predictor."""
        ent = self._sessions.get(session_id)
        return ent[2] if ent is not None else None

    def _schedule_promotion(self, session_id: str, now: float,
                            ewma: float) -> None:
        if len(self._promote_heap) >= self.MAX_PROMOTE_HEAP:
            self.promote_skipped += 1
            return
        fire_at = max(now, now + ewma - self.promote_lead_s)
        heapq.heappush(self._promote_heap, (fire_at, session_id, now))

    def due_promotions(self, now: float,
                       limit: int = 256) -> List[Tuple[str, str]]:
        """Pop up to ``limit`` due ``(session_id, engine_id)`` pairs.
        An entry is live only while its recorded ``last_seen`` stamp
        still matches the pin — a session that was touched again,
        evicted or re-homed since the push is silently dropped."""
        out: List[Tuple[str, str]] = []
        heap = self._promote_heap
        while heap and heap[0][0] <= now and len(out) < limit:
            _, sid, stamp = heapq.heappop(heap)
            ent = self._sessions.get(sid)
            if ent is not None and ent[1] == stamp:
                out.append((sid, ent[0]))
        return out

    def select(self, engines, tokens, lora_adapter=None,
               priority_class="standard", session_id=None):
        if session_id is None:
            return self._fallback.select(engines, tokens, lora_adapter,
                                         priority_class)
        now = self._clock() if self._clock is not None else 0.0
        ent = self._sessions.get(session_id)
        if ent is not None:
            eid, last, ewma = ent
            if eid in engines and (self.ttl_s <= 0
                                   or now - last <= self.ttl_s):
                gap = now - last
                ewma = gap if ewma is None else \
                    ((1 - self.EWMA_ALPHA) * ewma
                     + self.EWMA_ALPHA * gap)
                self._sessions[session_id] = (eid, now, ewma)
                self._sessions.move_to_end(session_id)
                self.hits += 1
                if self.promote_lead_s > 0:
                    self._schedule_promotion(session_id, now, ewma)
                return eid
            del self._sessions[session_id]
            self.rehomed += 1
        else:
            self.misses += 1
        eid = self._fallback.select(engines, tokens, lora_adapter,
                                    priority_class)
        while len(self._sessions) >= self.max_sessions:
            self._sessions.popitem(last=False)
        self._sessions[session_id] = (eid, now, None)
        return eid

    def forget(self, engine_id: str) -> None:
        stale = [sid for sid, ent in self._sessions.items()
                 if ent[0] == engine_id]
        for sid in stale:
            del self._sessions[sid]
        self._fallback.forget(engine_id)


POLICIES = {p.name: p for p in (
    RandomPolicy, ThroughputPolicy, LeastRequestPolicy, LeastKVCachePolicy,
    LeastLatencyPolicy, PrefixCacheAwarePolicy, PrefixLoadPolicy,
    SLOAwarePolicy, LoRAAffinityPolicy, SessionAffinityPolicy)}


def make_policy(name: str, **kw) -> RoutingPolicy:
    if name not in POLICIES:
        raise KeyError(f"unknown routing policy {name!r}: {sorted(POLICIES)}")
    return POLICIES[name](**kw)
