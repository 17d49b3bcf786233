"""Serving launcher on the PyTorch engines: one AIBrix pod group on this
host, the counterpart of ``repro/launch/serve.py`` with the same flags,
defaults, prints and request loop.

``python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 16``
spins up N port engines on the card behind the AIBrix gateway (routing
policy selectable), serves a synthetic batch of requests end to end, and
prints the per-request latency metrics the paper's evaluations report.
``--torch-device cpu`` runs the engines on the CPU instead (the kernels'
plain versions), as the tests do; without a card and without
``--torch-device`` the launcher raises.  ``--device`` keeps its
reference meaning: the roofline profile the ``--roles auto`` planner
sizes the P:D split against.

Everything the reference launcher drives runs here on the port:
``--roles 2P2D`` (prefill engines publish prompt pages into a shared
:class:`DistributedKVPool` and hand requests to decode engines),
``--roles auto`` (the GPU optimizer's ``split_roles`` proposes the P:D
split and an :class:`AttainmentRebalancer` adapts it live), the KV tiers
(``--host-cache-gb``, ``--ssd-cache-gb``, ``--ssd-shared``,
``--wire-dtype``), ``--slo``, ``--chaos`` with ``--ckpt-interval``,
``--spec-tokens``, ``--adapters`` under a :class:`LoRAController` and
``--async-loop``.

The CLI serves ``get_reduced_config(args.arch)``, as the reference does;
:func:`serve` serves any ``ModelConfig`` with the parsed arguments on a
given device (``chip_smoke.py`` drives it at full width).
"""
from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np

from repro_torch.configs import get_reduced_config
from repro_torch.core.gateway import Gateway
from repro_torch.core.kvcache.pool import DistributedKVPool
from repro_torch.core.lora.manager import AdapterSpec, LoRAController
from repro_torch.core.optimizer.gpu_optimizer import (DemandBucket,
                                                      split_roles)
from repro_torch.core.optimizer.profiles import ProfileTable, WorkloadBucket
from repro_torch.core.orchestration.pools import (AttainmentRebalancer,
                                            RebalanceConfig,
                                            RolePoolManager,
                                            parse_role_spec)
from repro_torch.core.sim.workloads import summarize
from repro_torch.device import resolve_device
from repro_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from repro_torch.engine.scheduler import DEFAULT_SLO_CLASSES


def parse_roles(spec: str, default_engines: int):
    """Back-compat alias for the shared role-spec parser."""
    return parse_role_spec(spec, default_engines)


def auto_roles(cfg, n_engines: int, prompt_len: int, max_new: int,
               rate_rps: float = 1.0, device: str = "a10"):
    """``--roles auto``: seed the P:D split from the GPU optimizer's
    roofline planner over the offered request shape (the live
    rebalancer adapts it from attainment once serving starts —
    ``device`` names the planner's roofline profile, which need not
    match the host exactly for the seed to be useful)."""
    interactive = DEFAULT_SLO_CLASSES["interactive"]
    rs = split_roles(ProfileTable(cfg),
                     [DemandBucket(WorkloadBucket(prompt_len, max_new),
                                   rate_rps)],
                     device=device, total_engines=n_engines,
                     slo_ttft_s=interactive.ttft_s,
                     slo_itl_s=interactive.itl_s)
    return ["prefill"] * rs.n_prefill + ["decode"] * rs.n_decode, rs


def build_engines(cfg, roles, clock, ecfg_kw=None, gateway=None,
                  force_pool=False, ssd_pool=None, device=None):
    """A pod group under a RolePoolManager.

    Returns ``(engines dict, manager, pool)``.  The manager owns the
    role pools, wires the prefill->decode handoff and (when a gateway
    is passed) registers each engine under its pool so routing only
    sees frontends.  Disaggregated groups get a DistributedKVPool;
    ``force_pool`` builds one for all-mixed groups too (the chaos
    drill's crash recovery and partition scenarios need it).
    ``ssd_pool`` is a host-level :class:`SharedSSDPool` every engine
    attaches to (per-engine accounting views) instead of creating a
    private SSD tier.  ``device`` is where the engines run (the card
    unless one is named).
    """
    kw = dict(page_size=8, num_pages=256, max_batch=4,
              max_pages_per_seq=32, chunk_size=32)
    kw.update(ecfg_kw or {})
    disagg = any(r != "mixed" for r in roles)
    pool = None
    if disagg or force_pool:
        pool = DistributedKVPool(capacity_bytes=1 << 30,
                                 metadata_lag=0.0, clock=clock)
    manager = RolePoolManager(clock=clock, gateway=gateway)
    engines = {}
    for i, role in enumerate(roles):
        eid = f"engine-{i}"
        engines[eid] = InferenceEngine(
            cfg, EngineConfig(role=role, **kw), clock=clock,
            kv_pool_client=pool, engine_id=eid, seed=0 if disagg else i,
            ssd_pool=ssd_pool, device=device)
        manager.add_engine(eid, engines[eid], role)
    return engines, manager, pool


def parse_args(argv=None) -> argparse.Namespace:
    """The reference launcher's flags, plus ``--torch-device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--engines", type=int, default=None,
                    help="pod count for --roles mixed (default 2) or "
                         "--roles auto (default 4)")
    ap.add_argument("--roles", default="mixed",
                    help="'mixed' (default, --engines colocated pods), "
                         "'2P2D'-style static disaggregation, or "
                         "'auto' (optimizer-proposed split, adapted "
                         "live by the attainment rebalancer)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--policy", default="prefix-cache-aware")
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slo", action="store_true",
                    help="SLO-aware scheduling (priority classes, "
                         "earliest-slack admission, preemption); pair "
                         "with --policy slo-aware for SLO routing")
    ap.add_argument("--interactive-frac", type=float, default=0.5,
                    help="fraction of requests tagged priority class "
                         "'interactive' (the rest are 'batch')")
    ap.add_argument("--device", default="a10",
                    help="roofline profile the --roles auto planner "
                         "sizes the initial P:D split against")
    ap.add_argument("--host-cache-gb", type=float, default=0.5,
                    help="host-DRAM KV tier per engine (GB): device "
                         "evictions cascade into it and preemption "
                         "swaps instead of recomputing; 0 disables")
    ap.add_argument("--ssd-cache-gb", type=float, default=0.0,
                    help="file-backed SSD KV tier per engine (GB) below "
                         "the host tier: host evictions write behind to "
                         "SSD and prefix walks fall device -> host -> "
                         "SSD before recompute; 0 disables")
    ap.add_argument("--ssd-shared", action="store_true",
                    help="share ONE host-level SSD pool across all "
                         "engines (content-addressed dedupe, one "
                         "write-behind drain): a prefix evicted by "
                         "engine A is an SSD hit for engine B; total "
                         "capacity = --ssd-cache-gb x engines")
    ap.add_argument("--gateway-shards", type=int, default=1,
                    help="shard the gateway's hot mutable state "
                         "(session pins, rate buckets, failure "
                         "accounting) N ways so route() cost stays "
                         "flat as the pin table grows")
    ap.add_argument("--promote-lead-s", type=float, default=0.0,
                    help="predictive KV promotion: with --policy "
                         "session, prefetch a session's SSD pages back "
                         "into host DRAM this many seconds before its "
                         "think-time EWMA predicts the next turn "
                         "(0 disables)")
    ap.add_argument("--wire-dtype", default="int8",
                    choices=("fp", "int8"),
                    help="pool-handoff wire format: 'int8' quantizes "
                         "page payloads with per-layer scales (~4x "
                         "fewer handoff bytes), 'fp' is byte-exact")
    ap.add_argument("--chaos", default="none",
                    choices=("none", "engine_crash", "kv_partition"),
                    help="mid-run chaos drill on the REAL engines: "
                         "'engine_crash' kills the busiest engine after "
                         "half the requests (harvested work re-delivers "
                         "to survivors; pair with --ckpt-interval so "
                         "running decodes resume from the recovery log "
                         "instead of recomputing), 'kv_partition' "
                         "partitions the KV pool for 2s (engines "
                         "degrade to recompute behind the breaker)")
    ap.add_argument("--ckpt-interval", type=int, default=0,
                    help="recovery-log checkpoint interval in tokens "
                         "(0 disables): running decodes periodically "
                         "publish their KV pages so a crash rewinds to "
                         "the last checkpoint, not to token 0")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="speculative n-gram decoding: max prompt-"
                         "lookup draft tokens verified per decode row "
                         "in one fused pass (0 disables); outputs stay "
                         "byte-identical under greedy decoding")
    ap.add_argument("--adapters", type=int, default=0,
                    help="register N LoRA adapters (zipf demand prior) "
                         "with a LoRAController, density-place them "
                         "over the engines and tag every request with "
                         "a zipf-drawn adapter (0 disables)")
    ap.add_argument("--lora-policy", default="lora-affinity",
                    help="gateway routing policy when --adapters is "
                         "set (default lora-affinity: route to pods "
                         "where the adapter is already resident)")
    ap.add_argument("--async-loop", action="store_true",
                    help="overlap host scheduling/input prep for step "
                         "N+1 with step N's device compute (decode "
                         "steps dispatch before the previous readback)")
    ap.add_argument("--torch-device", default=None,
                    help="torch device the engines run on (default: the "
                         "card; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.engines is not None and args.roles not in ("mixed", "auto"):
        ap.error("--engines only applies to --roles mixed/auto; a "
                 "'<n>P<m>D' spec fixes the pod count itself")
    if args.roles == "auto" and args.engines is not None \
            and args.engines < 2:
        ap.error("--roles auto needs --engines >= 2 (one prefill AND "
                 "one decode pod)")
    if args.adapters and args.roles != "mixed":
        ap.error("--adapters needs --roles mixed (the P->D handoff "
                 "path does not carry adapter state yet)")
    return args


def serve(cfg, args: argparse.Namespace, device=None, engine_kw=None
          ) -> SimpleNamespace:
    """Serve ``args.requests`` synthetic requests of ``cfg`` on a pod group
    of port engines on ``device`` (the card unless one is named), and
    print what the reference launcher prints.  ``engine_kw`` overrides
    the launcher's engine sizes (page size, pool, batch, chunk, dtype).
    Returns the requests as ``(engine id, Request)`` pairs in arrival
    order, the gateway, the engines still up, their manager and the
    distributed pool (or None)."""
    device = resolve_device(device)
    t0 = time.monotonic()
    clock = lambda: time.monotonic() - t0      # noqa: E731
    rebalancer = None
    if args.roles == "auto":
        roles, rs = auto_roles(cfg, args.engines or 4,
                               args.prompt_len, args.max_new,
                               device=args.device)
        rebalancer = AttainmentRebalancer(
            RebalanceConfig(period_s=0.5, cooldown_s=5.0, warmup_s=2.0))
        print(f"auto roles: optimizer proposes {rs.spec} "
              f"(prefill_load={rs.prefill_load:.3f}, "
              f"decode_load={rs.decode_load:.3f})")
    else:
        roles = parse_role_spec(args.roles, args.engines or 2)
    disagg = any(r != "mixed" for r in roles)
    if disagg:
        # int8 is the launcher's default deployment posture — say so
        # loudly: the wire is lossy (parity within the pinned
        # tolerance), pass --wire-dtype fp for byte-exact handoffs
        print(f"kv tiers: host_cache={args.host_cache_gb}GB/engine, "
              f"ssd_cache={args.ssd_cache_gb}GB/engine, "
              f"pool wire={args.wire_dtype}"
              + (" (quantized; --wire-dtype fp for byte-exact)"
                 if args.wire_dtype == "int8" else ""))
    policy = args.lora_policy if args.adapters else args.policy
    policy_kw = {}
    if args.promote_lead_s > 0 and policy == "session":
        policy_kw["promote_lead_s"] = args.promote_lead_s
    gw = Gateway(policy=policy, clock=clock,
                 shards=args.gateway_shards, **policy_kw)
    shared_ssd = None
    if args.ssd_shared and args.ssd_cache_gb > 0 \
            and args.host_cache_gb > 0:
        from repro_torch.core.kvcache.tiers import SharedSSDPool
        import tempfile
        shared_ssd = SharedSSDPool(
            capacity_bytes=int(args.ssd_cache_gb * (1 << 30)
                               * len(roles)),
            directory=tempfile.mkdtemp(prefix="kv-ssd-host-"))
        print(f"kv tiers: ONE host-shared SSD pool "
              f"({args.ssd_cache_gb * len(roles):.1f}GB) across "
              f"{len(roles)} engine(s)")
    engines, manager, pool = build_engines(
        cfg, roles, clock,
        ecfg_kw=dict(engine_kw or {}, slo_aware=args.slo,
                     host_cache_gb=args.host_cache_gb,
                     ssd_cache_gb=args.ssd_cache_gb,
                     wire_dtype=args.wire_dtype,
                     ckpt_interval_tokens=args.ckpt_interval,
                     spec_tokens=args.spec_tokens,
                     async_loop=args.async_loop),
        gateway=gw, force_pool=args.chaos != "none",
        ssd_pool=shared_ssd, device=device)
    lora_ctrl = None
    lora_heat = None
    if args.adapters:
        lora_ctrl = LoRAController(min_replicas=1, max_replicas=2)
        for i in range(args.adapters):
            lora_ctrl.register(AdapterSpec(
                f"lora-{i}", cfg.name, requests_per_s=1.0 / (i + 1)))
        slots = max(EngineConfig().max_adapters - 1, 1)
        for eid in engines:
            lora_ctrl.add_pod(eid, capacity=slots)
        gw.attach_lora_controller(lora_ctrl)
        lora_ctrl.sync(engines)
        lora_heat = 1.0 / (np.arange(1, args.adapters + 1) ** 1.1)
        lora_heat /= lora_heat.sum()
        print(f"lora: {args.adapters} adapter(s) density-placed over "
              f"{len(engines)} engine(s) ({slots} slots each), "
              f"policy={policy}, controller loads="
              f"{lora_ctrl.stats['loads']}")
    if args.chaos == "engine_crash" and not args.ckpt_interval:
        print("chaos: --ckpt-interval 0 — crashed decodes recompute "
              "from token 0 (set e.g. --ckpt-interval 16 to resume "
              "from the recovery log)")

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 24).tolist()
    reqs = []

    def pump():
        for eng in list(engines.values()):
            if eng.has_work:
                eng.step()
        manager.poll(clock())
        if rebalancer is not None:
            rebalancer.step(clock(), manager)
        if args.promote_lead_s > 0:
            for sid, eid in gw.due_promotions(clock()):
                if eid in engines:
                    engines[eid].promote_session(sid)

    def chaos_drill():
        """Mid-run failure injection against the live engine group."""
        now = clock()
        if args.chaos == "kv_partition":
            pool.partition(now=now, duration=2.0)
            print(f"[chaos] t={now:.2f}s kv pool partitioned for 2.0s "
                  "(fetch/publish fail; the breaker degrades admission "
                  "to recompute until it heals)")
            return
        # let in-flight work decode past a checkpoint boundary first:
        # the drill demonstrates the resume path, and a kill during
        # prefill leaves the recovery log nothing to cover
        for _ in range(40):
            pump()
        now = clock()
        # crash the engine carrying the most work: harvest everything
        # it owns (running decodes rewind to their recovery-log
        # checkpoint when --ckpt-interval fed one) and re-deliver
        victim = max(engines, key=lambda e: len(engines[e].running)
                     + len(engines[e].prefills) + len(engines[e].waiting))
        eng = engines.pop(victim)
        lost = eng.sched.crash_takeover(now)
        manager.remove_engine(victim)
        gw.note_failure(victim, "crash")
        for r in lost:
            eid = gw.route(r.prompt_tokens,
                           est_output_tokens=args.max_new,
                           priority_class=r.priority_class)
            engines[eid].submit(r)
        resumed = sum(1 for r in lost
                      if getattr(r, "_resume_decode", False)
                      or r.output_tokens)
        print(f"[chaos] t={now:.2f}s engine {victim} crashed: "
              f"{len(lost)} request(s) harvested, {resumed} resuming "
              "from the recovery log, rest recompute")

    drill_after = args.requests // 2 if args.chaos != "none" else -1
    for i in range(args.requests):
        prompt = shared + rng.integers(
            0, cfg.vocab_size, max(args.prompt_len - 24, 4)).tolist()
        pclass = ("interactive" if rng.random() < args.interactive_frac
                  else "batch")
        adapter = None
        if args.adapters:
            adapter = f"lora-{int(rng.choice(args.adapters, p=lora_heat))}"
        r = Request(prompt_tokens=prompt,
                    sampling=SamplingParams(max_new_tokens=args.max_new),
                    arrival_time=clock(), priority_class=pclass,
                    lora_adapter=adapter)
        eid = gw.route(prompt, est_output_tokens=args.max_new,
                       lora_adapter=adapter, priority_class=pclass)
        engines[eid].submit(r)
        reqs.append((eid, r))
        # interleave a bit of serving with arrivals
        pump()
        if i + 1 == drill_after:
            chaos_drill()
    while any(e.has_work for e in engines.values()) or manager.draining:
        pump()
    for eng in engines.values():
        eng.drain_async()       # resolve any in-flight async dispatch

    print(f"\nrouting ({policy}):", dict(gw.stats.per_engine))
    s = summarize([r for _, r in reqs])
    for k, v in s.items():
        print(f"  {k:22s} {v:.2f}" if isinstance(v, float) else
              f"  {k:22s} {v}")
    for eid, eng in engines.items():
        m = eng.metrics()
        print(f"  {eid} [{manager.role_of(eid)}]: "
              f"finished={m.finished_requests} "
              f"prefix_hit_tokens={m.prefix_hit_tokens} "
              f"remote_hit_tokens={m.remote_hit_tokens} "
              f"host_hit_tokens={m.host_hit_tokens} "
              f"ssd_hit_tokens={m.ssd_hit_tokens} "
              f"kv_util={m.kv_utilization:.2f}")
        if m.swap_out or m.kv_bytes_offloaded:
            print(f"    tiers: swap_out={m.swap_out} swap_in={m.swap_in}"
                  f" offloaded={m.kv_bytes_offloaded >> 10}KiB"
                  f" fetched={m.kv_bytes_fetched >> 10}KiB")
        if m.spec_drafted_tokens:
            print(f"    spec: drafted={m.spec_drafted_tokens} "
                  f"accepted={m.spec_accepted_tokens} "
                  f"acceptance={m.spec_acceptance:.2f}")
        if args.async_loop or m.device_wait_s:
            print(f"    overlap: device_wait={m.device_wait_s:.2f}s "
                  f"host_overhead_frac={m.host_overhead_frac:.2f}")
        if m.slo_by_class:
            rows = " ".join(
                f"{c}: ttft={ta:.2f} itl={ia:.2f} n={n}"
                for c, ta, ia, n in m.slo_by_class)
            print(f"    slo_attainment={m.slo_attainment:.2f} [{rows}]")
    if any(r != "mixed" for r in roles):
        print(f"  pools: {manager.counts()} "
              f"migrations={len(manager.migrations)}")
    if pool is not None:
        st = pool.stats
        print(f"  pool: puts={st.puts} hits={st.hits_local + st.hits_remote}"
              f" dup_drops={st.dup_puts_dropped}"
              f" bytes_stored={st.bytes_stored}")
    if shared_ssd is not None:
        cross = sum(e.metrics().ssd_cross_hit_tokens
                    for e in engines.values())
        print(f"  ssd(shared): puts={shared_ssd.stats.puts} "
              f"dedup_puts={shared_ssd.dedup_puts} "
              f"dedupe_ratio={shared_ssd.dedupe_ratio:.2f} "
              f"bytes_written={shared_ssd.stats.bytes_written} "
              f"dropped_puts={shared_ssd.stats.dropped_puts} "
              f"cross_hit_tokens={cross}")
    if args.adapters:
        cold = sum(e.runner.adapter_loads for e in engines.values())
        stall = sum(e.runner.adapter_load_s for e in engines.values())
        miss = sum(e.metrics().lora_miss for e in engines.values())
        print(f"  lora: affinity_hits={gw.stats.lora_hits}"
              f"/{gw.stats.lora_routed} "
              f"(rate={gw.stats.lora_affinity_hit_rate:.2f}) "
              f"cold_loads={cold} cold_load_s={stall:.2f} miss={miss}")
    if args.chaos != "none":
        wasted = sum(e.metrics().wasted_tokens for e in engines.values())
        ckpt = sum(e.metrics().ckpt_pages for e in engines.values())
        fails = sum(e.metrics().kv_fetch_failures
                    for e in engines.values())
        unfinished = sum(1 for _, r in reqs
                         if len(r.output_tokens) < args.max_new)
        print(f"  chaos({args.chaos}): unfinished={unfinished} "
              f"wasted_tokens={wasted} ckpt_pages={ckpt} "
              f"kv_fetch_failures={fails}")
    return SimpleNamespace(reqs=reqs, gateway=gw, engines=engines,
                           manager=manager, pool=pool)


def main(argv=None) -> SimpleNamespace:
    """The CLI: serve the reduced config of ``--arch`` on
    ``--torch-device``."""
    args = parse_args(argv)
    return serve(get_reduced_config(args.arch), args,
                 device=args.torch_device)


if __name__ == "__main__":
    main()
