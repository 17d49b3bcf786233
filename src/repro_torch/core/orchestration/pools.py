"""Role-aware control plane: dynamic P/D pools with live migration.

Serving roles are a first-class control-plane concept here instead of a
launch-time constant: :class:`RolePoolManager` owns named pools
(``prefill`` / ``decode`` / ``mixed``) of engines, exposes per-pool
depth and fleet SLO attainment, load-balances the prefill->decode
handoff, and supports **live role migration** — draining a member
(stop admitting, finish in-flight chunks, hand its queued work to the
other pool members) and re-registering it under the other role, so the
P:D ratio changes without restarts.  The same manager drives the real
JAX engines (``launch/serve.py --roles auto``) and the discrete-event
cluster simulator (``ServingCluster``), because both engine shapes
expose the shared ``Scheduler`` the drain protocol talks to.

:class:`AttainmentRebalancer` closes the loop the paper's SLO-driven
GPU optimizer opens: one inverted-metric autoscaler instance per pool
(the PR-3 machinery — pressure = miss-rate over the allowed miss
budget), with **TTFT attainment sizing the prefill pool** and **ITL
attainment sizing the decode pool**.  TTFT misses mean prompts queue
for prefill capacity; ITL misses mean decode batches are over-packed —
so at fixed fleet size a deficit in one pool is served by migrating a
member from the other (``repro_torch.core.optimizer.split_roles`` proposes
the *initial* ratio from the roofline profile; this adapts it live).

Engines are anything exposing ``sched`` (the shared Scheduler),
``submit(req)``, ``metrics()`` and ``has_work`` — the real
``InferenceEngine`` and the simulator's ``SimEngine`` both qualify.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.autoscaler.metrics import MetricStore
from repro_torch.core.autoscaler.policies import make_autoscaler
from repro_torch.engine.request import Request
from repro_torch.engine.scheduler import DECODER_ROLES, FRONTEND_ROLES


def parse_role_spec(spec: str, default_engines: int) -> List[str]:
    """'mixed' -> N mixed engines; '2P2D'/'1p3d' -> disaggregated.

    ``'auto'`` is a control-plane decision, not a parse: resolve it
    first (``repro_torch.core.optimizer.split_roles`` or an even split) and
    pass the concrete spec here.
    """
    if not spec or spec == "mixed":
        return ["mixed"] * default_engines
    m = re.fullmatch(r"(\d+)[pP](\d+)[dD]", spec)
    if m is None:
        raise ValueError(
            f"role spec {spec!r}: expected 'mixed' or '<n>P<m>D'")
    n_p, n_d = int(m.group(1)), int(m.group(2))
    if n_p == 0 or n_d == 0:
        raise ValueError(
            f"role spec {spec!r}: a disaggregated group needs at least "
            "one prefill AND one decode engine")
    return ["prefill"] * n_p + ["decode"] * n_d


@dataclass
class Migration:
    """One live role change, from drain request to completion."""
    engine_id: str
    src: str
    dst: str
    started: float
    completed: float = -1.0          # -1 while still draining

    @property
    def done(self) -> bool:
        return self.completed >= 0.0


class RolePoolManager:
    """Named engine pools + the live role-migration protocol.

    Migration protocol (P->D; D->P is symmetric):

    1. ``request_migration`` marks the member ``draining``: the shared
       Scheduler stops admitting, the gateway stops routing to it, and
       its not-yet-admitted queue is re-delivered to the remaining pool
       members (prefill-pool waiters need prefilling -> frontends;
       decode-pool waiters already have KV in the distributed pool ->
       other decoders).
    2. In-flight work finishes normally: a draining prefill member
       completes its chunks and hands each request off through the
       existing ``DistributedKVPool`` path; a draining decode member
       finishes its running decodes.
    3. ``poll`` observes the drain completing, flips the scheduler role
       (``Scheduler.set_role``) and re-registers the member under its
       new pool — no restart, no engine state rebuilt.
    """

    POOLS = ("prefill", "decode", "mixed")
    FRONTEND_POOLS = FRONTEND_ROLES          # admit NEW requests
    DECODER_POOLS = DECODER_ROLES            # accept handoffs

    def __init__(self, clock: Callable[[], float] = None, gateway=None):
        self.clock = clock or (lambda: 0.0)
        self.gateway = gateway
        self.pools: Dict[str, Dict[str, object]] = {
            p: {} for p in self.POOLS}
        self._engines: Dict[str, object] = {}
        self._draining: Dict[str, Migration] = {}
        self.migrations: List[Migration] = []    # completed, in order

    # ------------------------------------------------------------ members
    def add_engine(self, engine_id: str, engine, role: str = "mixed"
                   ) -> None:
        if role not in self.POOLS:
            raise ValueError(f"unknown pool {role!r}: {self.POOLS}")
        sched = getattr(engine, "sched", None)
        if sched is not None:
            if sched.scfg.role != role:
                sched.set_role(role)
            # every member gets the load-balancing handoff shim; it
            # only fires while the member's role is 'prefill'
            sched.handoff = self.handoff
        self.pools[role][engine_id] = engine
        self._engines[engine_id] = engine
        if self.gateway is not None:
            self.gateway.register_engine(engine_id, engine, pool=role)

    def remove_engine(self, engine_id: str) -> None:
        self._engines.pop(engine_id, None)
        self._draining.pop(engine_id, None)
        for members in self.pools.values():
            members.pop(engine_id, None)
        if self.gateway is not None:
            self.gateway.deregister_engine(engine_id)

    def role_of(self, engine_id: str) -> Optional[str]:
        for pool, members in self.pools.items():
            if engine_id in members:
                return pool
        if engine_id in self._draining:
            return "draining"
        return None

    def members(self, pool: str) -> Dict[str, object]:
        return dict(self.pools[pool])

    def counts(self) -> Dict[str, int]:
        c = {p: len(m) for p, m in self.pools.items()}
        c["draining"] = len(self._draining)
        return c

    @property
    def engines(self) -> Dict[str, object]:
        return dict(self._engines)

    @property
    def draining(self) -> bool:
        return bool(self._draining)

    def _healthy(self, eng) -> bool:
        fn = getattr(eng, "healthy", None)
        return fn() if callable(fn) else True

    def frontends(self) -> Dict[str, object]:
        """Members that admit NEW requests (draining members excluded)."""
        return {eid: e for pool in self.FRONTEND_POOLS
                for eid, e in self.pools[pool].items()
                if self._healthy(e)}

    def decoders(self) -> Dict[str, object]:
        """Members that accept prefill handoffs."""
        return {eid: e for pool in self.DECODER_POOLS
                for eid, e in self.pools[pool].items()
                if self._healthy(e)}

    # ------------------------------------------------------------ signals
    @staticmethod
    def _queue_depth(engine) -> int:
        """O(1) queue-depth probe for the per-request submit/handoff
        hot path: read the shared scheduler's queues directly instead
        of building a full EngineMetrics snapshot (which scans the
        SLO attainment windows)."""
        sched = getattr(engine, "sched", None)
        if sched is not None:
            return (len(sched.waiting) + len(sched.running)
                    + len(sched.prefills))
        m = engine.metrics()
        return m.num_running + m.num_waiting

    @staticmethod
    def _waiting(engine) -> int:
        sched = getattr(engine, "sched", None)
        if sched is not None:
            return len(sched.waiting)
        return engine.metrics().num_waiting

    def depth(self, pool: str) -> int:
        """Total queue depth (running + waiting) across a pool."""
        return sum(self._queue_depth(e) for e in self.pools[pool].values())

    def waiting_depth(self, pool: str) -> int:
        """Waiting-only depth: work QUEUED (not being served) in a
        pool.  Prefill-side waiters mean prefill capacity is the
        bottleneck; decode-side waiters mean handed-off requests are
        blocked on decode slots — the disambiguator for TTFT misses,
        which span both pools."""
        return sum(self._waiting(e) for e in self.pools[pool].values())

    def attainment(self, focus_class: Optional[str] = None
                   ) -> Dict[str, float]:
        """Fleet-aggregated windowed SLO attainment.  Finishes happen on
        decode/mixed members, but the attribution is causal across
        pools: TTFT covers the prefill queue + handoff, ITL the decode
        step time — so ``ttft`` sizes the prefill pool and ``itl`` the
        decode pool.  ``focus_class`` narrows the TTFT signal to one
        priority class's windowed attainment (e.g. 'interactive' — the
        class whose SLO the rebalance is protecting); ITL stays the
        fleet-wide windowed figure, which the focus class dominates
        whenever it is the decode-latency-sensitive one."""
        ttft, itl = [], []
        for eng in self._engines.values():
            m = eng.metrics()
            if not m.finished_requests:
                continue
            t_att = m.slo_attainment
            if focus_class is not None:
                for name, ttft_att, _itl_att, _n in m.slo_by_class:
                    if name == focus_class:
                        t_att = ttft_att
                        break
            ttft.append(t_att)
            itl.append(m.slo_itl_attainment)
        return {"ttft": sum(ttft) / len(ttft) if ttft else 1.0,
                "itl": sum(itl) / len(itl) if itl else 1.0}

    # ------------------------------------------------------------ data path
    def handoff(self, req: Request, exclude=()) -> None:
        """Prefill->decode handoff: least-loaded decoder by queue depth.
        ``exclude`` removes members from consideration (hedging away
        from a straggler, re-delivery off a crashed engine)."""
        targets = {eid: e for eid, e in self.decoders().items()
                   if eid not in exclude}
        if not targets:
            raise RuntimeError("role pools: handoff with no decode-"
                               "capable member (refused to drain last?)")
        eid = min(sorted(targets), key=lambda e: self._queue_depth(
            targets[e]))
        targets[eid].submit(req)

    def submit(self, req: Request, exclude=()) -> None:
        """Admit a NEW request: least-loaded frontend by queue depth
        (what the gateway's least-request policy computes; this is the
        manager-local path used for drain re-delivery and tests).
        ``exclude`` as in :meth:`handoff`."""
        targets = {eid: e for eid, e in self.frontends().items()
                   if eid not in exclude}
        if not targets:
            raise RuntimeError("role pools: no frontend member")
        eid = min(sorted(targets), key=lambda e: self._queue_depth(
            targets[e]))
        targets[eid].submit(req)

    def _redeliver(self, reqs: List[Request], src_pool: str,
                   exclude=()) -> None:
        for r in reqs:
            if src_pool == "decode":
                # KV already in the distributed pool
                self.handoff(r, exclude=exclude)
            else:
                self.submit(r, exclude=exclude)

    # ------------------------------------------------------------ migration
    def request_migration(self, src: str, dst: str, now: float,
                          engine_id: Optional[str] = None
                          ) -> Optional[Migration]:
        """Begin draining one ``src``-pool member toward ``dst``.

        Picks the least-loaded member unless ``engine_id`` pins one.
        Refuses moves that would leave a disaggregated topology without
        a frontend or without a decoder.  Returns the in-flight
        :class:`Migration` (or None if refused)."""
        if src not in self.POOLS or dst not in self.POOLS or src == dst:
            raise ValueError(f"bad migration {src!r}->{dst!r}")
        candidates = self.pools[src]
        if engine_id is not None:
            if engine_id not in candidates:
                return None
        elif candidates:
            engine_id = min(sorted(candidates), key=lambda e:
                            self._queue_depth(candidates[e]))
        if engine_id is None:
            return None
        # liveness: never drain the last frontend or the last decoder
        if src in self.FRONTEND_POOLS and \
                len(self.frontends()) - (engine_id in self.frontends()) < 1:
            return None
        if src in self.DECODER_POOLS and \
                len(self.decoders()) - (engine_id in self.decoders()) < 1:
            return None
        engine = candidates.pop(engine_id)
        mig = Migration(engine_id, src, dst, started=now)
        self._draining[engine_id] = mig
        sched = getattr(engine, "sched", None)
        if sched is not None:
            sched.draining = True
            self._redeliver(sched.takeover_waiting(), src)
        if self.gateway is not None:
            self.gateway.set_engine_pool(engine_id, "draining")
        return mig

    def poll(self, now: float) -> List[Migration]:
        """Advance in-flight migrations; returns those that completed.
        Call this from the serving loop (real engines) or a periodic
        event (the simulator) — draining is asynchronous by design."""
        done: List[Migration] = []
        for eid, mig in list(self._draining.items()):
            engine = self._engines[eid]
            sched = engine.sched
            if sched.waiting:        # raced submit: re-deliver and wait
                self._redeliver(sched.takeover_waiting(), mig.src)
            if not sched.drained:
                continue
            sched.set_role(mig.dst)
            sched.draining = False
            del self._draining[eid]
            self.pools[mig.dst][eid] = engine
            mig.completed = now
            self.migrations.append(mig)
            done.append(mig)
            if self.gateway is not None:
                self.gateway.set_engine_pool(eid, mig.dst)
        return done


@dataclass
class RebalanceConfig:
    """Knobs for the attainment-driven pool-sizing loop."""
    ttft_target: float = 0.90        # prefill-pool attainment target
    itl_target: float = 0.90         # decode-pool attainment target
    period_s: float = 5.0            # decision cadence
    # min spacing between migrations: at least the scheduler-core SLO
    # window, so each move's effect is measured on fresh finishes
    # before the next move can act on the same (stale) misses
    cooldown_s: float = 60.0
    warmup_s: float = 30.0           # no moves before the attainment
    #                                  window has real finishes in it
    min_prefill: int = 1
    min_decode: int = 1
    scaler: str = "apa"              # per-pool autoscaler policy
    scaler_kw: dict = field(default_factory=dict)
    # priority class whose windowed attainment drives the loop (None =
    # fleet-wide across classes); 'interactive' protects the tight SLO
    signal_class: Optional[str] = None


class AttainmentRebalancer:
    """One autoscaler instance per pool, attainment as the signal.

    Reuses the inverted-metric machinery verbatim: the prefill pool's
    instance targets windowed fleet TTFT attainment, the decode pool's
    targets windowed ITL attainment; each computes a desired member
    count for ITS pool independently.  At fixed fleet size the pool
    with the larger deficit pulls a member from the other via
    ``RolePoolManager.request_migration`` (one drain in flight at a
    time, rate-limited by ``cooldown_s``)."""

    METRICS = {"prefill": "pool_ttft_attainment",
               "decode": "pool_itl_attainment"}

    def __init__(self, cfg: Optional[RebalanceConfig] = None):
        self.cfg = cfg or RebalanceConfig()
        self.store = MetricStore()
        targets = {"prefill": self.cfg.ttft_target,
                   "decode": self.cfg.itl_target}
        self.scalers = {
            pool: make_autoscaler(self.cfg.scaler, metric=metric,
                                  target=targets[pool], min_replicas=1,
                                  **self.cfg.scaler_kw)
            for pool, metric in self.METRICS.items()}
        self._last_move = -1e18
        self._last_dir: Optional[str] = None
        self.history: List[tuple] = []   # (t, ttft, itl, n_p, n_d, want_p, want_d)

    def desired(self, now: float, manager: RolePoolManager
                ) -> Dict[str, int]:
        """Per-pool desired member counts — independent decisions."""
        return {pool: self.scalers[pool].desired(
            now, self.store, max(len(manager.pools[pool]), 1)).desired
            for pool in self.METRICS}

    def step(self, now: float, manager: RolePoolManager
             ) -> Optional[Migration]:
        """One reconcile tick: record signals, advance drains, maybe
        start one migration.  Returns the migration started (if any)."""
        att = manager.attainment(focus_class=self.cfg.signal_class)
        self.store.record(now, "pool_ttft_attainment", att["ttft"])
        self.store.record(now, "pool_itl_attainment", att["itl"])
        manager.poll(now)
        cur_p = len(manager.pools["prefill"])
        cur_d = len(manager.pools["decode"])
        if cur_p == 0 and cur_d == 0:
            return None              # colocated fleet: nothing to size
        want = self.desired(now, manager)
        self.history.append((now, att["ttft"], att["itl"], cur_p, cur_d,
                             want["prefill"], want["decode"]))
        if manager.draining or now < self.cfg.warmup_s:
            return None              # one drain at a time
        deficit_p = want["prefill"] - cur_p
        deficit_d = want["decode"] - cur_d
        # TTFT spans both pools (prefill queue + pool handoff + decode
        # admission + tail recompute), so a TTFT-attainment deficit is
        # only a PREFILL deficit when the backlog actually sits on the
        # prefill side — when the waiting queue has clearly piled up
        # behind the decode slots instead, reassign the deficit to the
        # decode pool (ITL misses need no such correction: they are
        # decode's alone).
        if deficit_p > 0 and cur_p and cur_d:
            wq_p = manager.waiting_depth("prefill") / cur_p
            wq_d = manager.waiting_depth("decode") / cur_d
            if wq_d > max(2.0 * wq_p, 2.0):
                deficit_d = max(deficit_d, deficit_p)
                deficit_p = 0
        direction = None
        if deficit_p > max(deficit_d, 0) and cur_d > self.cfg.min_decode:
            direction = "toward_prefill"
        elif deficit_d > max(deficit_p, 0) and cur_p > self.cfg.min_prefill:
            direction = "toward_decode"
        if direction is None:
            return None
        # direction-aware cooldown: REVERSING a move must wait out the
        # full attainment window (the misses that drove the last move
        # are still in it), but repeating the same direction on a
        # persistent deficit only needs half — the signal is fresh
        wait = (self.cfg.cooldown_s if direction != self._last_dir
                else self.cfg.cooldown_s / 2)
        if now - self._last_move < wait:
            return None
        if direction == "toward_prefill":
            mig = manager.request_migration("decode", "prefill", now)
        else:
            mig = manager.request_migration("prefill", "decode", now)
        if mig is not None:
            self._last_move = now
            self._last_dir = direction
        return mig
