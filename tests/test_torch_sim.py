"""The port's discrete-event cluster simulator, accelerator diagnostics
and analytic roofline against the JAX package's.

Every case runs once on ``repro`` and once on ``repro_torch`` (modules
imported by name from each package, the same seeds and configs) and
compares what comes out: event orders, per-request times, metrics,
diagnoses and ``ServingCluster`` summary dicts, which must be equal.
Each case also keeps the checks of the reference test it replays
(``tests/test_sim_and_analysis.py``, ``tests/test_chaos.py``,
``tests/test_system.py``).

Before a cluster summary is compared across the packages, the
reference's own is run twice and must repeat: every key of every
summary here does (``NOT_REPEATABLE`` would name a key that did not,
with the reason, and such a key would still be compared across the
packages within one run).  The analytic model's ``estimate`` must be
equal; ``roofline_terms`` divides by the card's constants, which differ
on purpose (the port's are an H100's), so its terms must scale by the
ratio of the constants.
"""
import dataclasses
import importlib
import math
import types

import pytest

pytest.importorskip("torch")

MODULES = dict(
    events="core.sim.events", sim_engine="core.sim.sim_engine",
    cluster_sim="core.sim.cluster_sim", chaos="core.sim.chaos",
    workloads="core.sim.workloads", tools="core.diagnostics.tools",
    pool="core.kvcache.pool", gateway="core.gateway.gateway",
    request="engine.request", configs="configs",
    analytic="launch.analytic")
ARCH = "deepseek-coder-7b"
# summary keys that do not repeat from run to run in the reference
# itself, with the reason; none has been found
NOT_REPEATABLE = {}


def _package(root):
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}") for k, v in MODULES.items()})


J, T = _package("repro"), _package("repro_torch")
PACKAGES = (J, T)


def _plain(x):
    """``x`` with dataclasses as dicts, enums as their values and NaN as
    a string, so that results of the two packages compare with ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "value") and type(x).__module__.endswith(
            "diagnostics.tools"):
        return x.value
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _both(case):
    """``case(P)`` for the reference and for the port; their plain
    results must be equal.  Returns the reference's."""
    ref, port = (_plain(case(P)) for P in PACKAGES)
    assert port == ref
    return ref


def _repeats(case):
    """The reference's ``case`` twice: its summary must repeat, keys in
    ``NOT_REPEATABLE`` aside."""
    a, b = _plain(case(J)), _plain(case(J))
    skip = set(NOT_REPEATABLE)
    assert {k: v for k, v in a.items() if k not in skip} == \
        {k: v for k, v in b.items() if k not in skip}


def _diag(diags):
    return [(d.pod_id, d.t, d.fault.value, d.evidence, d.action)
            for d in diags]


# ---------------------------------------------------------------- events
def test_event_loop_ordering_and_every():
    def case(P):
        loop = P.events.EventLoop()
        seen = []
        loop.schedule(2.0, lambda: seen.append("b"))
        loop.schedule(1.0, lambda: seen.append("a"))
        loop.every(1.0, lambda: seen.append("t"), until=3.5)
        loop.run(until=10.0)
        assert seen.count("t") == 3
        assert loop.clock.now <= 10.0
        return seen, loop.clock.now, loop.events_fired
    _both(case)


# ------------------------------------------------------------- workloads
def _requests(wl):
    return [(tr.arrival, tr.request.prompt_tokens,
             tr.request.sampling.max_new_tokens, tr.request.user,
             tr.request.priority_class) for tr in wl]


def test_workload_generators_shapes():
    def case(P):
        W = P.workloads
        w1 = W.sharegpt_like(5.0, 10.0, seed=0)
        assert all(tr.request.prompt_len >= 8 for tr in w1)
        w2 = W.birdsql_like(50, 5.0, seed=0)
        assert len({tuple(tr.request.prompt_tokens[:16])
                    for tr in w2}) <= 12
        w3 = W.multiturn_chat(4, 3, 5.0, seed=0)
        assert len(w3) == 12
        w4 = W.burst(1.0, 10.0, 30.0, 10.0, 10.0, seed=0)
        return [_requests(w) for w in (w1, w2, w3, w4)]
    _both(case)


def test_summarize_percentiles():
    def case(P):
        reqs = []
        for i in range(10):
            r = P.request.Request(prompt_tokens=[0] * 10,
                                  arrival_time=float(i))
            r.first_token_time = i + 0.1 * (i + 1)
            r.token_times = [r.first_token_time + 0.05]
            r.output_tokens = [1, 2]
            r.finish_time = r.token_times[-1]
            reqs.append(r)
        s = P.workloads.summarize(reqs)
        assert s["finished"] == 10
        assert s["ttft_p99_ms"] >= s["ttft_avg_ms"]
        return s
    _both(case)


# ------------------------------------------------------------ sim engine
def _timings(reqs):
    return [(r.first_token_time, r.finish_time, list(r.output_tokens))
            for r in reqs]


def _req(P, prompt, n):
    return P.request.Request(prompt_tokens=list(prompt),
                             sampling=P.request.SamplingParams(
                                 max_new_tokens=n), arrival_time=0.0)


def test_sim_engine_progress_and_metrics():
    def case(P):
        loop = P.events.EventLoop()
        eng = P.sim_engine.SimEngine(
            P.configs.get_config(ARCH), loop,
            P.sim_engine.SimEngineConfig(device_type="a10"))
        for _ in range(5):
            eng.submit(_req(P, range(500), 20))
        loop.run(until=1e6, stop_when=lambda: not eng.has_work)
        m = eng.metrics()
        assert m.finished_requests == 5
        assert all(r.ttft > 0 and r.total_latency >= r.ttft
                   for r in eng.finished)
        assert 0.01 < eng.finished[0].ttft < 5.0
        return m, _timings(eng.finished), loop.clock.now
    _both(case)


def test_sim_engine_dead_device_stops():
    def case(P):
        loop = P.events.EventLoop()
        eng = P.sim_engine.SimEngine(
            P.configs.get_config(ARCH), loop,
            P.sim_engine.SimEngineConfig(device_type="a10"))
        eng.slowdown_fn = lambda: 0.0
        eng.submit(_req(P, [1] * 100, 5))
        loop.run(until=100.0)
        assert eng.metrics().finished_requests == 0
        return eng.metrics(), loop.clock.now
    _both(case)


def _two_engines(P, kw_a, kw_b, ids=("a", "b"), nodes=(None, None),
                 capacity=8 << 30, lag=0.001):
    loop = P.events.EventLoop()
    cfg = P.configs.get_config(ARCH)
    pool = P.pool.DistributedKVPool(capacity_bytes=capacity,
                                    metadata_lag=lag, clock=loop.clock)
    engines = [P.sim_engine.SimEngine(
        cfg, loop, P.sim_engine.SimEngineConfig(**kw), kv_pool=pool,
        engine_id=eid, **({"node": node} if node else {}))
        for kw, eid, node in zip((kw_a, kw_b), ids, nodes)]
    return loop, pool, engines


def test_pd_disaggregation_handoff():
    def case(P):
        loop, pool, (pre, dec) = _two_engines(
            P, dict(role="prefill"), dict(role="decode"), ("p0", "d0"),
            ("n0", "n1"))
        pre.handoff = dec.submit
        req = _req(P, range(300), 10)
        pre.submit(req)
        loop.run(until=1e5, stop_when=lambda: not (pre.has_work
                                                   or dec.has_work))
        assert len(req.output_tokens) == 10
        assert req in dec.finished and req not in pre.finished
        assert dec.metrics().remote_hit_tokens > 0
        return (pre.metrics(), dec.metrics(), _timings([req]),
                dataclasses.asdict(pool.stats))
    _both(case)


def test_request_migration_via_pool():
    def case(P):
        loop, pool, (src, dst) = _two_engines(P, {}, {}, ("src", "dst"),
                                              ("n0", "n1"))
        req = _req(P, range(256), 40)
        src.submit(req)
        loop.run(until=1e5, stop_when=lambda: len(req.output_tokens) >= 10)
        assert req in src.running
        assert src.migrate_out(req, dst)
        loop.run(until=1e6, stop_when=lambda: not (src.has_work
                                                   or dst.has_work))
        assert len(req.output_tokens) == 40 and req in dst.finished
        assert dst.metrics().remote_hit_tokens > 0
        assert src._m.get("migrations") == 1
        return src.metrics(), dst.metrics(), _timings([req])
    _both(case)


# ---------------------------------------------------------- analytic
@pytest.mark.parametrize("arch", ("qwen3-0.6b", "deepseek-v2-236b",
                                  "xlstm-1.3b"))
def test_analytic_estimates_equal_and_terms_scale(arch):
    ests = []
    for P in PACKAGES:
        cfg = P.configs.get_config(arch)
        tr = P.analytic.estimate(cfg, "train", 256, 4096)
        pf = P.analytic.estimate(cfg, "prefill", 32, 32768)
        dc = P.analytic.estimate(cfg, "decode", 128, 32768)
        assert tr.flops > pf.flops > dc.flops > 0
        assert tr.model_flops <= tr.flops
        ests.append((tr, pf, dc))
    assert _plain(ests[1]) == _plain(ests[0])
    flop_ratio = J.analytic.PEAK_FLOPS / T.analytic.PEAK_FLOPS
    bw_ratio = J.analytic.HBM_BW / T.analytic.HBM_BW
    link_ratio = J.analytic.ICI_BW / T.analytic.ICI_BW
    for est in ests[0]:
        ref = J.analytic.roofline_terms(est, 1e8, 256)
        port = T.analytic.roofline_terms(est, 1e8, 256)
        assert port["dominant"] in ("compute", "memory", "collective")
        assert 0 < port["useful_flops_ratio"] <= 1.0
        assert port["useful_flops_ratio"] == ref["useful_flops_ratio"]
        for key, ratio in (("compute_s", flop_ratio),
                           ("memory_s", bw_ratio),
                           ("collective_s", link_ratio)):
            assert math.isclose(port[key], ref[key] * ratio,
                                rel_tol=4e-16), key


def test_moe_active_flops_below_dense_equivalent():
    def case(P):
        ds = P.configs.get_config("deepseek-v2-236b")
        est = P.analytic.estimate(ds, "decode", 128, 32768)
        assert est.model_flops < 2.0 * ds.param_count() * 128 * 0.25
        return est
    _both(case)


# ------------------------------------------------------------- chaos
def test_chaos_schedule_validates_and_composes():
    def case(P):
        C = P.chaos
        with pytest.raises(ValueError):
            C.ChaosEvent(1.0, "meteor_strike")
        with pytest.raises(ValueError):
            C.ChaosEvent(-1.0, "engine_crash")
        sched = (C.ChaosSchedule.straggler(at=20.0, duration=5.0)
                 + C.ChaosSchedule.engine_crash(at=10.0))
        assert len(sched) == 2
        return [dataclasses.asdict(e) for e in sched]
    assert [e["at"] for e in _both(case)] == [10.0, 20.0]


def test_injector_clear_leaves_no_empty_entries():
    def case(P):
        K = P.tools.FaultKind
        inj = P.tools.FailureInjector()
        inj.inject("p0", K.THERMAL_THROTTLE, now=0.0)
        inj.inject("p0", K.LINK_FLAP, now=0.0)
        inj.clear("p0", K.LINK_FLAP)
        left = [f.kind.value for f in inj.active["p0"]]
        inj.clear("p0", K.THERMAL_THROTTLE)
        assert "p0" not in inj.active
        inj.clear("p0", K.DEVICE_LOST)
        assert "p0" not in inj.active
        return left
    assert _both(case) == ["thermal_throttle"]


def _sample(P, pid, t, **kw):
    return P.tools.Telemetry(pod_id=pid, t=float(t), tokens_per_sec=100.0,
                             **kw)


def _monitor_device_lost(P):
    return P.tools.DiagnosticMonitor().observe(
        _sample(P, "p0", 1.0, heartbeat_ok=False))


def _monitor_fatal_ecc(P):
    return P.tools.DiagnosticMonitor().observe(_sample(P, "p0", 1.0,
                                                       ecc_dbe=1))


def _monitor_thermal(P):
    inj = P.tools.FailureInjector()
    mon = P.tools.DiagnosticMonitor(confirm_n=3)
    inj.inject("p0", P.tools.FaultKind.THERMAL_THROTTLE, now=0.0,
               severity=1.0)
    diags = []
    for t in range(1, 4):
        diags += mon.observe(inj.perturb(_sample(P, "p0", t)))
    assert "p0" in mon.quarantined
    return diags


def _monitor_link_flap(P):
    mon = P.tools.DiagnosticMonitor(confirm_n=3)
    diags = []
    for t in range(1, 8):
        diags += mon.observe(_sample(P, "p0", t, link_up=False))
    return diags


def _monitor_silent_degradation(P):
    inj = P.tools.FailureInjector()
    mon = P.tools.DiagnosticMonitor(confirm_n=3)
    for t in range(10):
        mon.observe(_sample(P, "p1", t))
    inj.inject("p1", P.tools.FaultKind.SILENT_DEGRADATION, 10.0,
               severity=0.9)
    diags = []
    for t in range(10, 25):
        diags += mon.observe(inj.perturb(_sample(P, "p1", t)))
    return diags


def _monitor_flapping(P):
    mon = P.tools.DiagnosticMonitor(confirm_n=3, quarantine_s=5.0,
                                    readmit_n=5)
    diags, t, marks = [], 0.0, []
    for bad_every, n in ((2, 20), (1, 3), (2, 20), (0, 6)):
        for i in range(n):
            t += 1.0
            bad = bad_every and i % bad_every == 0
            diags += mon.observe(_sample(P, "pf", t,
                                         ecc_sbe=60 if bad else 0))
        marks.append([d.action for d in diags])
    assert marks == [[], ["quarantine"], ["quarantine"],
                     ["quarantine", "readmit"]]
    assert "pf" not in mon.quarantined
    return diags


def _monitor_escalates(P):
    mon = P.tools.DiagnosticMonitor(confirm_n=2, escalate_s=10.0)
    diags = []
    for t in range(1, 14):
        diags += mon.observe(_sample(P, "pe", t, ecc_sbe=60))
        if any(d.action == "restart" for d in diags):
            break
    assert "pe" not in mon.quarantined
    return diags


@pytest.mark.parametrize("case, want", [
    (_monitor_device_lost, [("device_lost", "restart")]),
    (_monitor_fatal_ecc, [("ecc_error", "cordon")]),
    (_monitor_thermal, [("thermal_throttle", "quarantine")]),
    (_monitor_link_flap, [("link_flap", "quarantine")]),
    (_monitor_silent_degradation, [("silent_degradation", "quarantine")]),
    (_monitor_flapping, [("ecc_error", "quarantine"),
                         ("ecc_error", "readmit")]),
    (_monitor_escalates, [("ecc_error", "quarantine"),
                          ("ecc_error", "restart")]),
], ids=["device_lost", "fatal_ecc", "thermal", "link_flap",
        "silent_degradation", "flapping", "escalates"])
def test_monitor_diagnoses(case, want):
    """The monitor's per-fault rules and its hysteresis
    (tests/test_chaos.py:60-174), diagnosis for diagnosis."""
    got = _both(lambda P: _diag(case(P)))
    assert [(fault, action) for _, _, fault, _, action in got] == want


def test_kv_pool_partition_raises_counts_and_heals():
    def case(P):
        t = [0.0]
        pool = P.pool.DistributedKVPool(capacity_bytes=1 << 20,
                                        metadata_lag=0.0,
                                        clock=lambda: t[0])
        pool.partition(now=0.0, duration=5.0)
        with pytest.raises(P.pool.KVPoolError):
            pool.publish("h0", b"x", "e0", 0.0, size_bytes=8)
        with pytest.raises(P.pool.KVPoolError):
            pool.fetch("h0", "e0", 1.0)
        t[0] = 6.0
        assert not pool.partitioned(6.0)
        pool.partition(now=6.0, duration=60.0)
        pool.heal()
        pool.publish("h0", b"x", "e0", 6.0, size_bytes=8)
        assert pool.fetch("h0", "e1", 6.1) == b"x"
        return pool.stats
    s = _both(case)
    assert s["publish_failures"] == 1 and s["fetch_failures"] == 1


def test_scheduler_survives_partition_with_recompute_fallback():
    def case(P):
        kw = dict(device_type="a10", page_size=16, max_batch=4,
                  chunk_size=512, prefix_caching=False)
        loop, pool, (a, b) = _two_engines(P, kw, kw, capacity=4 << 30,
                                          lag=0.0)
        prompt = [7] * 256
        r0 = _req(P, prompt, 4)
        loop.schedule(0.0, lambda: a.submit(r0))
        loop.run(until=20.0, stop_when=lambda: not a.has_work)
        assert pool.stats.puts > 0
        pool.tick(loop.clock.now)
        pool.partition(now=loop.clock.now, duration=30.0)
        r1 = _req(P, prompt, 4)
        t1 = loop.clock.now
        loop.schedule(t1 + 0.1, lambda: b.submit(r1))
        loop.run(until=t1 + 30.0, stop_when=lambda: loop.clock.now > t1
                 + 0.1 and not b.has_work)
        assert r1.state.name == "FINISHED"
        partitioned = b.metrics()
        assert partitioned.remote_hit_tokens == 0
        assert partitioned.kv_fetch_failures > 0
        pool.heal()
        r2 = _req(P, prompt, 4)
        t2 = loop.clock.now + 10.0
        loop.schedule(t2, lambda: b.submit(r2))
        loop.run(until=t2 + 30.0, stop_when=lambda: loop.clock.now > t2
                 and not b.has_work)
        assert r2.state.name == "FINISHED"
        assert b.metrics().remote_hit_tokens > 0
        return partitioned, b.metrics(), _timings([r0, r1, r2])
    _both(case)


def test_gateway_cordon_and_straggler_detection():
    class FakeMetrics:
        def __init__(self, tps, waiting):
            self.tokens_per_sec = tps
            self.num_waiting = waiting
            self.num_running = 0
            self.num_active_tokens = 0
            self.kv_utilization = 0.0

    class FakeEngine:
        def __init__(self, tps, waiting=1):
            self._m = FakeMetrics(tps, waiting)

        def metrics(self):
            return self._m

    def case(P):
        gw = P.gateway.Gateway(policy="least-request")
        for eid, tps in (("fast0", 100.0), ("fast1", 100.0),
                         ("slow", 10.0)):
            gw.register_engine(eid, FakeEngine(tps))
        out = [gw.straggler_engines(ratio=0.5)]
        gw.engines["slow"]._m.num_waiting = 0
        out.append(gw.straggler_engines(ratio=0.5))
        gw.cordon("fast1", reason="quarantine")
        out.append(sorted(gw.routable_engines()))
        out.append(dict(gw.stats.engine_failures["fast1"]))
        gw.uncordon("fast1")
        out.append(sorted(gw.routable_engines()))
        return out
    assert _both(case) == [["slow"], [], ["fast0", "slow"],
                           {"quarantine": 1}, ["fast0", "fast1", "slow"]]


# ------------------------------------------------- cluster-level chaos
def _chaos_cluster(P, chaos, n=3, ckpt=64, seed=3, rate=3.0,
                   dur=15.0, mb=8, **ccfg_kw):
    wl = P.workloads.slo_mixed(rate_rps=rate, duration_s=dur, seed=seed)
    ecfg = P.sim_engine.SimEngineConfig(
        device_type="a10", max_batch=mb, chunk_size=512,
        mixed_batching=True, ckpt_interval_tokens=ckpt)
    ccfg = P.cluster_sim.ClusterConfig(
        num_engines=n, engine=ecfg, use_kv_pool=True,
        chaos=chaos(P.chaos.ChaosSchedule, P.tools.FaultKind), **ccfg_kw)
    c = P.cluster_sim.ServingCluster(P.configs.get_config(ARCH), ccfg)
    s = c.run(wl, drain_s=300.0)
    return c, s, len(wl)


def _crash(S, K):
    return S.engine_crash(at=5.0)


def _straggler(S, K):
    return S.straggler(at=12.0, duration=25.0, severity=0.95,
                       fault=K.SILENT_DEGRADATION)


def _partition(S, K):
    return S.kv_partition(at=3.0, duration=8.0)


def _gw_restart(S, K):
    return S.gateway_restart(at=4.0, duration=2.0)


CHAOS_CASES = {
    "crash_recovers": (_crash, {}),
    "crash_without_recovery": (_crash, dict(crash_recovery=False)),
    "straggler_hedging": (_straggler, dict(n=4, rate=6.0, dur=30.0, mb=2,
                                           hedge_ratio=0.6)),
    "kv_partition": (_partition, {}),
    "gateway_restart": (_gw_restart, {}),
}


@pytest.mark.parametrize("name", sorted(CHAOS_CASES))
def test_cluster_chaos_summary_equal(name):
    """tests/test_chaos.py:235-333: each chaos schedule's cluster run,
    summary for summary, with the reference's checks."""
    chaos, kw = CHAOS_CASES[name]

    def case(P):
        c, s, n = _chaos_cluster(P, chaos, **kw)
        dead = sorted(eid for eid, e in c.engines.items() if not e.alive)
        return dict(s, n_requests=n, dead=dead,
                    dead_in_pool=[c.pool_mgr.role_of(e) for e in dead],
                    dead_routed=[e in c.gateway.engines for e in dead],
                    cordoned=sorted(c.gateway.cordoned),
                    diagnosis_log=_diag(c.diagnoses))
    _repeats(case)
    s = _both(case)
    if name == "crash_recovers":
        assert s["crashed_requests"] > 0
        assert s["crash_recovered"] == s["crashed_requests"]
        assert s["finished"] == s["n_requests"] and s["ckpt_pages"] > 0
        assert len(s["dead"]) == 1
        assert s["dead_in_pool"] == [None] and s["dead_routed"] == [False]
    elif name == "crash_without_recovery":
        assert s["crashed_requests"] > 0 and s["crash_recovered"] == 0
        assert s["finished"] < s["n_requests"]
    elif name == "straggler_hedging":
        assert s["finished"] == s["n_requests"]
        assert s["quarantines"] >= 1 and s["hedged"] >= 1
    elif name == "kv_partition":
        assert s["finished"] == s["n_requests"]
        assert s["pool_publish_failures"] + s["pool_fetch_failures"] > 0
        assert s["kv_fetch_failures"] > 0
    else:
        assert s["gw_restarts"] == 1 and s["gw_deferred"] > 0
        assert s["finished"] == s["n_requests"] and s["cordoned"] == []


def test_retire_engine_removes_pool_membership():
    def case(P):
        c = P.cluster_sim.ServingCluster(
            P.configs.get_config(ARCH), P.cluster_sim.ClusterConfig(
                num_engines=2, engine=P.sim_engine.SimEngineConfig(
                    device_type="a10")))
        eids = list(c.engines)
        assert all(c.pool_mgr.role_of(e) is not None for e in eids)
        c._retire_engine()
        return ([e for e in eids if c.pool_mgr.role_of(e) is None],
                sorted(c.gateway.engines))
    gone, left = _both(case)
    assert len(gone) == 1 and len(left) == 1


# ------------------------------------------------- cluster: the system
def _system_cluster(P, wl, **kw):
    ecfg = dict(kw.pop("engine", {}), device_type="a10")
    c = P.cluster_sim.ServingCluster(
        P.configs.get_config(ARCH), P.cluster_sim.ClusterConfig(
            engine=P.sim_engine.SimEngineConfig(**ecfg), **kw))
    return c.run(wl(P.workloads))


def test_cluster_sim_conserves_requests():
    def case(P):
        return _system_cluster(P, lambda W: W.birdsql_like(
            120, rate_rps=6.0, seed=0), num_engines=3)
    _repeats(case)
    s = _both(case)
    assert s["finished"] + s["rejected"] == 120
    assert s["ttft_avg_ms"] > 0 and s["itl_avg_ms"] > 0


def test_distributed_pool_improves_ttft_on_shared_prefixes():
    def case(P, pool):
        return _system_cluster(P, lambda W: W.birdsql_like(
            200, rate_rps=12.0, seed=1), num_engines=4, use_kv_pool=pool,
            engine=dict(prefix_caching=False))
    for pool in (False, True):
        _repeats(lambda P: case(P, pool))
    without = _both(lambda P: case(P, False))
    with_pool = _both(lambda P: case(P, True))
    assert with_pool["ttft_avg_ms"] < without["ttft_avg_ms"] * 0.8
    assert with_pool["remote_hit_tokens"] > 0


def test_prefix_routing_beats_random_on_multiturn():
    def case(P, policy):
        return _system_cluster(P, lambda W: W.multiturn_chat(
            24, turns=5, rate_rps=8.0, seed=2), routing_policy=policy,
            num_engines=4)
    for policy in ("random", "prefix-load"):
        _repeats(lambda P: case(P, policy))
    rnd = _both(lambda P: case(P, "random"))
    aff = _both(lambda P: case(P, "prefix-load"))
    assert aff["prefix_hit_tokens"] > rnd["prefix_hit_tokens"]
    assert aff["ttft_avg_ms"] <= rnd["ttft_avg_ms"] * 1.05


# ------------------------------------------------- the port's h100 entry
def test_h100_registers_and_serves_a_cluster(monkeypatch):
    """``core/optimizer/h100.register`` puts the card into the copied
    catalogue only when called; a small cluster then runs on it (the
    telemetry loop on, a thermal throttle injected, an engine crash with
    recovery) and, at the catalogue's default fractions, answers sooner
    than the same cluster on the A100, whose peaks are all lower."""
    from repro_torch.core.optimizer import h100, profiles
    # undone at teardown: the catalogue is left as it was found
    monkeypatch.setitem(profiles.DEVICES, "h100", None)
    del profiles.DEVICES["h100"]
    importlib.reload(h100)
    assert "h100" not in profiles.DEVICES            # nothing at import
    spec = h100.register(h100.h100_spec(mfu_prefill=0.55, mbu_decode=0.70))
    assert profiles.DEVICES["h100"] is spec
    assert (spec.peak_flops, spec.hbm_bw, spec.hbm_bytes) == (
        T.analytic.PEAK_FLOPS, T.analytic.HBM_BW, 80e9)

    def run(device):
        S = T.chaos.ChaosSchedule
        c = T.cluster_sim.ServingCluster(
            T.configs.get_config("qwen3-0.6b"), T.cluster_sim.ClusterConfig(
                device_type=device, num_engines=3, use_kv_pool=True,
                telemetry=True, chaos=S.engine_crash(at=5.0),
                engine=T.sim_engine.SimEngineConfig(
                    device_type=device, max_batch=8,
                    ckpt_interval_tokens=64)))
        c.loop.after(2.0, lambda: c.injector.inject(
            "engine-1", T.tools.FaultKind.THERMAL_THROTTLE, 2.0,
            severity=0.8))
        return c, c.run(T.workloads.birdsql_like(60, rate_rps=6.0, seed=4),
                        drain_s=300.0)

    c, s = run("h100")
    assert s["finished"] + s["rejected"] == 60
    assert s["crash_recovered"] == s["crashed_requests"]
    assert any(d.pod_id == "engine-1" and d.fault.value == "thermal_throttle"
               for d in c.diagnoses)
    _, a100 = run("a100")
    assert s["ttft_avg_ms"] < a100["ttft_avg_ms"]
