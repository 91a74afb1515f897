"""End-to-end training example of the PyTorch/CUDA port (the counterpart
of ``examples/train_100m.py``): train that example's qwen3-family model
(6 layers, d 512, vocab 32,768: 40.4M parameters) on the synthetic
pipeline, with checkpointing and restart.

    PYTHONPATH=src python examples/torch/train_100m.py [--steps 300]
    PYTHONPATH=src python examples/torch/train_100m.py --device cpu \\
        --steps 2 --batch 2 --seq 16

The loss should fall from ~10.4 toward the Markov source's entropy. The
checkpoints go to ``--ckpt-dir`` (default: a temporary directory, removed
at the end); a second run on the same directory resumes from its newest
checkpoint.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import build_train_step, init_train_state
from repro_torch.train import loop as loop_lib
from repro_torch.tree import leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # the reference example's qwen3-family model: 6 layers, d=512, 8 heads,
    # tied embeddings
    cfg = get_config("qwen3-0.6b", n_layers=6, d_model=512, n_heads=8,
                     n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
                     max_seq_len=256)
    opt = adamw(lr=cosine_schedule(1e-3, 30, args.steps), weight_decay=0.01)
    step = build_train_step(cfg, opt)
    state = init_train_state(
        cfg, opt, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    n = sum(p.numel() for p in leaves(state["params"]))
    print(f"params: {n / 1e6:.1f}M")

    data = SyntheticLMData(cfg.vocab_size, batch=args.batch, seq=args.seq,
                           seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        state, hist = loop_lib.run(step, state, data, steps=args.steps,
                                   ckpt_dir=args.ckpt_dir or tmp,
                                   ckpt_every=100, log_every=20)
    print(f"loss: {np.mean(hist['loss'][:5]):.3f} → "
          f"{np.mean(hist['loss'][-5:]):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
