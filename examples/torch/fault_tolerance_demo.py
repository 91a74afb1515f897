"""Fault-tolerance demo of the PyTorch/CUDA port (the counterpart of
``examples/fault_tolerance_demo.py``): stop the training mid-run, restart
from the newest checkpoint, and check that the resumed trajectory matches
an uninterrupted one.

    PYTHONPATH=src python examples/torch/fault_tolerance_demo.py [--device cpu]

Checkpoints go to ``--ckpt-dir`` (default: a temporary directory, removed
at the end); the demo needs one that holds no checkpoint yet.
"""
import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.train import build_train_step, init_train_state
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import loop as loop_lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("qwen3-0.6b", reduced=True)
    opt = adamw(lr=3e-3)
    step = build_train_step(cfg, opt)
    data = SyntheticLMData(cfg.vocab_size, 8, 32, seed=0)

    def fresh():
        return init_train_state(
            cfg, opt, generator=torch.Generator(device=device).manual_seed(0),
            device=device)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = args.ckpt_dir or tmp
        if ckpt_lib.find_latest(ckpt) is not None:
            raise SystemExit(f"{ckpt} already holds checkpoints")
        # 1) an uninterrupted run to step 30
        full, hist_full = loop_lib.run(step, fresh(), data, steps=30,
                                       log_every=0)
        # 2) to step 20 with checkpoints every 10, a "crash", a restart → 30
        loop_lib.run(step, fresh(), data, steps=20, ckpt_dir=ckpt,
                     ckpt_every=10, log_every=0)
        print("-- simulated crash; restarting from latest checkpoint --")
        resumed, hist2 = loop_lib.run(step, fresh(), data, steps=30,
                                      ckpt_dir=ckpt, ckpt_every=10,
                                      log_every=0)
    a = full["params"]["final_norm"].float()
    b = resumed["params"]["final_norm"].float()
    print(f"resumed == uninterrupted: "
          f"{torch.allclose(a, b, rtol=1e-5, atol=1e-8)}")
    print(f"final losses: full={hist_full['loss'][-1]:.4f} "
          f"resumed={hist2['loss'][-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
