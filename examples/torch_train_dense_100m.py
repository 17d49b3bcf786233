"""End-to-end training example on the PyTorch port, the twin of
``examples/train_dense_100m.py``: a ~100M-param qwen3-family model on
the synthetic Markov corpus for a few hundred steps, on the card unless
``--torch-device`` names another device.  Shows a decreasing loss curve,
checkpointing, and a restore that equals the saved state.

    PYTHONPATH=src python examples/torch_train_dense_100m.py --steps 300
    PYTHONPATH=src python examples/torch_train_dense_100m.py --steps 30 \\
        --torch-device cpu
"""
import argparse
import pathlib

import torch

from repro_torch.configs import get_config
from repro_torch.data import synthetic_lm_batches
from repro_torch.models.config import ModelConfig
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train_loop
from repro_torch.tree import tree_leaves

CKPT_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / \
    "torch_ckpt_100m"


def model_100m() -> ModelConfig:
    # qwen3 family scaled to ~100M params (8 layers, d=512, vocab 16k)
    return get_config("qwen3-0.6b").replace(
        name="qwen3-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=1536, vocab_size=16_384, head_dim=64,
        layer_pattern=("dense",) * 8, max_seq_len=2048)


def main(argv=None):
    """Train, check the loss fell by more than 0.3 and that the latest
    checkpoint restores (to the final state when it is the last step's);
    returns (state, history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--torch-device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = model_100m()
    n = cfg.param_count()
    print(f"model: {cfg.name}  params={n/1e6:.1f}M")
    data = synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq,
                                corpus_tokens=400_000,
                                device=args.torch_device)
    opt = AdamWConfig(lr=6e-4, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps, weight_decay=0.05)
    state, history = train_loop(
        cfg, opt, data, args.steps, seed=0,
        log_every=max(args.steps // 15, 1),
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=max(args.steps // 2, 10),
        device=args.torch_device)
    for h in history:
        print(f"  step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"lr {h['lr']:.2e}  gnorm {h['grad_norm']:.2f}  "
              f"({h['elapsed_s']:.0f}s)")
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f}")
    if not last < first - 0.3:
        raise AssertionError("loss should drop on the Markov corpus")
    # checkpoint roundtrip; a checkpoint of the last step must restore
    # the final state exactly
    step = ckpt.latest_step(args.ckpt_dir)
    restored = ckpt.restore(args.ckpt_dir, state, step)
    if step == args.steps and not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                              tree_leaves(state))):
        raise AssertionError(f"checkpoint of step {step} does not restore "
                             "the final state")
    leaf0 = tree_leaves(restored.params)[0]
    print(f"checkpoint restore OK (step {step}, leaf {tuple(leaf0.shape)})")
    print("torch_train_dense_100m OK")
    return state, history


if __name__ == "__main__":
    main()
