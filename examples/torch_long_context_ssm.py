"""Long-context decoding with a constant-size state on the PyTorch port,
the twin of ``examples/long_context_ssm.py``: a reduced xLSTM-family
model prefills a 700-token context and decodes 24 tokens through the
port's SlotEngine, while its recurrent state stays the same size
whatever the context's length.

    PYTHONPATH=src python examples/torch_long_context_ssm.py          # the card
    PYTHONPATH=src python examples/torch_long_context_ssm.py --torch-device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import get_reduced_config
from repro_torch.engine import (Request, SamplingParams, SlotEngine,
                                SlotEngineConfig)
from repro_torch.models import model as M

CONTEXT, NEW_TOKENS = 700, 24


def state_bytes(cfg, cache_len: int, device) -> int:
    """Bytes of one sequence's caches at ``cache_len``."""
    caches = M.init_cache(cfg, 1, cache_len, device=device)
    return sum(t.numel() * t.element_size() for run in caches
               for t in run.values())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--torch-device", default=None,
                    help="torch device of the engine (default: the card)")
    args = ap.parse_args(argv)
    cfg = get_reduced_config("xlstm-1.3b")
    print(f"model: {cfg.name}  (mLSTM/sLSTM pattern "
          f"{cfg.layer_runs}, no KV cache)")

    # the state's size is constant in the sequence's length: measure it
    sizes = {n: state_bytes(cfg, n, args.torch_device) for n in (8, 1024)}
    assert len(set(sizes.values())) == 1, sizes
    print(f"recurrent state: {sizes[8] / 1e3:.1f} KB per sequence at 8 "
          f"and at 1024 tokens of context")

    eng = SlotEngine(cfg, SlotEngineConfig(max_slots=2, max_len=1024),
                     device=args.torch_device)
    rng = np.random.default_rng(0)
    long_prompt = rng.integers(0, cfg.vocab_size, CONTEXT).tolist()
    req = Request(prompt_tokens=long_prompt,
                  sampling=SamplingParams(max_new_tokens=NEW_TOKENS))
    eng.submit(req)
    eng.run_until_idle()
    print(f"context {len(long_prompt)} tokens -> generated "
          f"{len(req.output_tokens)} tokens: {req.output_tokens[:12]}...")
    assert len(req.output_tokens) == NEW_TOKENS
    print("torch_long_context_ssm OK")
    return req


if __name__ == "__main__":
    main()
