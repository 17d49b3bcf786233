"""GPU-optimizer walkthrough on the PyTorch port (paper §3.2.7), the twin
of ``examples/hetero_optimizer.py``: from live gateway logs to an ILP
allocation to autoscaler desired-replica feeds, with the H100 the port
runs on in the device set (``core/optimizer/h100.py``, its achievable
fractions fitted from the port's own serves on the card).

    PYTHONPATH=src python examples/torch_hetero_optimizer.py

It touches no tensor, so it runs on the CPU as well.
"""
import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.gateway import Gateway
from repro_torch.core.optimizer import (GPUOptimizer, LoadMonitor,
                                        ProfileTable, homogeneous_cost)
from repro_torch.core.optimizer import h100

DEVICES = ("a10", "l20", "v100", "h100")


class _NullEngine:
    def metrics(self):
        from repro_torch.engine.engine import EngineMetrics
        return EngineMetrics()

    def match_prefix_len(self, tokens):
        return 0


def demand():
    """The demand buckets of an hour of mixed chat and text2sql traffic
    routed through a gateway (``examples/hetero_optimizer.py``'s)."""
    gw = Gateway(policy="random")
    gw.register_engine("e0", _NullEngine())
    rng = np.random.default_rng(0)
    t = 0.0
    for _ in range(3000):
        t += rng.exponential(1 / 25.0)
        if rng.random() < 0.7:      # chat
            ilen = int(np.clip(rng.lognormal(5.3, 0.8), 16, 4000))
            olen = int(np.clip(rng.lognormal(4.6, 0.7), 8, 800))
        else:                       # text2sql
            ilen = int(np.clip(rng.normal(1800, 300), 800, 6000))
            olen = int(np.clip(rng.normal(30, 10), 5, 90))
        gw.clock = lambda t=t: t
        gw.route([0] * ilen, est_output_tokens=olen)
    return LoadMonitor().demand(gw.request_log, window_s=t)


def main():
    h100.register()
    cfg = get_config("deepseek-coder-7b")
    wanted = demand()
    print("demand buckets (in,out -> rps):")
    for d in wanted:
        print(f"  {d.bucket.key}: {d.rps:.2f} rps")

    table = ProfileTable(cfg, slo_ttft_s=5.0, slo_itl_s=0.25)
    opt = GPUOptimizer(table, DEVICES, availability={"v100": 2})
    alloc = opt.optimize(wanted)
    print(f"\nILP allocation: {alloc.counts}  "
          f"${alloc.cost_per_hour:.2f}/h  {alloc.note or '(milp)'}")
    for (bucket, dev), rps in sorted(alloc.assignment.items()):
        print(f"  bucket {bucket} -> {dev}: {rps:.2f} rps")
    for dev in ("l20", "h100"):
        n, c = homogeneous_cost(table, wanted, dev)
        print(f"homogeneous {dev} baseline: {n} pods  ${c:.2f}/h")
    n, c = homogeneous_cost(table, wanted, "l20")
    print(f"cost reduction against l20: "
          f"{100 * (1 - alloc.cost_per_hour / c):.1f}%")
    print("\nautoscaler metric source:", opt.metric_source(wanted))
    print("torch_hetero_optimizer OK")


if __name__ == "__main__":
    main()
