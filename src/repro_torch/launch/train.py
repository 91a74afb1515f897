"""Training entry point. Port of ``repro/launch/train.py``.

On the card (the default):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 50 --batch 8 --seq 512

On the CPU, a reduced same-family config:
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 8 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

Without ``--device`` and without a CUDA card it raises: it never falls
back to the CPU.
"""
from __future__ import annotations

import argparse

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
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", default=None, choices=[None, "int8"])
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    opt = adamw(lr=cosine_schedule(args.lr, args.steps // 10, args.steps),
                weight_decay=0.01, quantize_moments=args.int8_moments)
    step_fn = build_train_step(cfg, opt, grad_accum=args.grad_accum,
                               compress_grads=args.compress_grads)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, opt, generator=gen, device=device)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    data = SyntheticLMData(
        cfg.vocab_size, args.batch, args.seq, seed=args.seed,
        embedding_dim=cfg.d_model if cfg.embedding_inputs else None)
    state, hist = loop_lib.run(step_fn, state, data, steps=args.steps,
                               ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every)
    first = np.mean(hist["loss"][:5]) if hist["loss"] else float("nan")
    last = np.mean(hist["loss"][-5:]) if hist["loss"] else float("nan")
    print(f"[train] loss {first:.3f} → {last:.3f} over {len(hist['loss'])} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
