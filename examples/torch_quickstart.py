"""Quickstart on the PyTorch port: serve a model with batched requests
through two port engines behind the AIBrix gateway, the twin of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py                 # the card
    PYTHONPATH=src python examples/torch_quickstart.py --torch-device cpu

What happens:
  1. a reduced qwen3-family model is instantiated (random weights),
  2. two port InferenceEngine pods register with the Gateway,
  3. a batch of requests (sharing a system-prompt prefix) is routed
     with the prefix-cache-aware policy and served with continuous
     batching + paged KV cache,
  4. per-request TTFT and the engines' prefix-hit stats print.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_reduced_config
from repro_torch.core.gateway import Gateway
from repro_torch.core.sim.workloads import summarize
from repro_torch.engine import (EngineConfig, InferenceEngine, Request,
                                SamplingParams)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--torch-device", default=None,
                    help="torch device of the engines (default: the card)")
    args = ap.parse_args(argv)
    cfg = get_reduced_config("qwen3-0.6b")
    t0 = time.monotonic()
    clock = lambda: time.monotonic() - t0        # noqa: E731

    gateway = Gateway(policy="prefix-cache-aware", clock=clock)
    engines = {}
    for i in range(2):
        eng = InferenceEngine(
            cfg,
            EngineConfig(page_size=8, num_pages=256, max_batch=4,
                         max_pages_per_seq=32, chunk_size=32),
            clock=clock, engine_id=f"engine-{i}", seed=i,
            device=args.torch_device)
        engines[f"engine-{i}"] = eng
        gateway.register_engine(f"engine-{i}", eng)

    rng = np.random.default_rng(0)
    system_prompt = rng.integers(0, cfg.vocab_size, 32).tolist()
    requests = []
    for i in range(10):
        prompt = system_prompt + rng.integers(
            0, cfg.vocab_size, 8 + (i % 5)).tolist()
        req = Request(prompt_tokens=prompt,
                      sampling=SamplingParams(max_new_tokens=12,
                                              temperature=0.0),
                      arrival_time=clock())
        target = gateway.route(prompt, est_output_tokens=12)
        engines[target].submit(req)
        requests.append((target, req))
        for eng in engines.values():             # interleave serving
            if eng.has_work:
                eng.step()
    while any(e.has_work for e in engines.values()):
        for eng in engines.values():
            if eng.has_work:
                eng.step()

    print("routing decisions:", dict(gateway.stats.per_engine))
    for eid, req in requests[:4]:
        print(f"  req {req.request_id} -> {eid}: "
              f"out={req.output_tokens}  ttft={req.ttft*1e3:.0f}ms")
    stats = summarize([r for _, r in requests])
    print("summary:", {k: round(v, 2) if isinstance(v, float) else v
                       for k, v in stats.items()})
    for eid, eng in engines.items():
        m = eng.metrics()
        print(f"  {eid}: finished={m.finished_requests} "
              f"prefix_hit_tokens={m.prefix_hit_tokens} "
              f"kv_util={m.kv_utilization:.2f}")
    assert stats["finished"] == len(requests)
    print("quickstart OK")
    return requests


if __name__ == "__main__":
    main()
