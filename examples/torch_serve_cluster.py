"""Full AIBrix control-plane demo on the PyTorch port's cluster simulator,
the twin of ``examples/serve_cluster.py``:

gateway routing + distributed KV cache pool + APA autoscaling + a
failure injection handled by the diagnostics -> orchestration loop,
over a Bird-SQL-like workload at production scale (simulated 4-40x A10
fleet serving deepseek-coder-7b).

    PYTHONPATH=src python examples/torch_serve_cluster.py

It touches no tensor, so it runs on the CPU as well.
"""
from repro_torch.configs import get_config
from repro_torch.core.autoscaler.policies import make_autoscaler
from repro_torch.core.diagnostics.tools import FaultKind
from repro_torch.core.sim import (ClusterConfig, ServingCluster,
                                  SimEngineConfig)
from repro_torch.core.sim.workloads import birdsql_like

SUMMARY_KEYS = ("finished", "total_tput_tok_s", "ttft_avg_ms",
                "ttft_p99_ms", "itl_avg_ms", "latency_p99_s",
                "prefix_hit_tokens", "remote_hit_tokens", "pool_evictions",
                "rejected")


def main():
    cfg = get_config("deepseek-coder-7b")
    ccfg = ClusterConfig(
        routing_policy="prefix-load",
        device_type="a10",
        num_engines=4,
        engine=SimEngineConfig(device_type="a10", max_batch=24,
                               chunk_size=512),
        use_kv_pool=True, kv_pool_gb=64.0, kv_pool_policy="s3fifo",
        autoscaler=make_autoscaler("apa", metric="concurrency",
                                   target=12.0, min_replicas=2,
                                   max_replicas=10),
        telemetry=True)
    cluster = ServingCluster(cfg, ccfg)

    # inject a thermal throttle mid-run; the monitor should catch it
    cluster.loop.after(30.0, lambda: cluster.injector.inject(
        "engine-1", FaultKind.THERMAL_THROTTLE, 30.0, severity=0.8))

    wl = birdsql_like(800, rate_rps=18.0, seed=7)
    summary = cluster.run(wl)

    print("== cluster summary ==")
    for k in SUMMARY_KEYS:
        v = summary.get(k, 0)
        print(f"  {k:22s} {v:.1f}" if isinstance(v, float)
              else f"  {k:22s} {v}")
    print(f"  replicas over time: "
          f"{[d for _, _, d in cluster.scale_history[::20]]}")
    print(f"  diagnoses: "
          f"{[(d.pod_id, d.fault.value, d.action) for d in cluster.diagnoses[:4]]}")
    print(f"  pool stats: {cluster.kv_pool.stats}")
    assert summary["finished"] >= 780        # a few may be re-queued
    print("torch_serve_cluster OK")


if __name__ == "__main__":
    main()
