"""Quickstart: the CAMP quantized GEMM as a drop-in op, in the PyTorch/CUDA
port (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

On the card (the default) ``camp_matmul`` runs the fused CUDA kernels, and
the unfused int8 GEMM's CUDA kernel is compared with its plain PyTorch
version; with ``--device cpu`` every op takes its plain version.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import camp
from repro_torch.core.hybrid import hybrid_matmul_i8
from repro_torch.core.quant import quantize_rowwise
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import dot_i32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.from_numpy(a).to(device)
    x = tensor(rng.standard_normal((256, 1024)).astype(np.float32))
    w = tensor(rng.standard_normal((1024, 512)).astype(np.float32))

    print("== CAMP quickstart ==")
    exact = x @ w
    for qmode in ("w8a8", "w4a8", "w4a4"):
        wq = camp.prepare_weight(w, qmode)             # PTQ: pack + scales
        y = camp.camp_matmul(x, wq, qmode=qmode)       # dynamic act-quant GEMM
        rel = float((y - exact).abs().max() / exact.abs().max())
        print(f"{qmode}: weight bytes {wq.memory_bytes():>8} "
              f"(fp32 {w.numel() * 4}), max rel err {rel:.4f}")

    # The unfused int8 GEMM's CUDA kernel against its plain version:
    a_q, a_s = quantize_rowwise(x)
    wq8 = camp.prepare_weight(w, "w8a8")
    y_plain = ops.gemm_i8(a_q, wq8.q, a_s, wq8.scale, impl="torch")
    if device.type == "cuda":
        y_cuda = ops.gemm_i8(a_q, wq8.q, a_s, wq8.scale, impl="cuda")
        print("CUDA kernel == plain version:",
              bool(torch.equal(y_cuda, y_plain)))
    else:
        print("CUDA kernel == plain version: not run on the CPU")

    # The paper's §3 hybrid multiplier identity (int8 GEMM from 4-bit blocks):
    a8 = tensor(rng.integers(-128, 128, (64, 64)).astype(np.int8))
    b8 = tensor(rng.integers(-128, 128, (64, 64)).astype(np.int8))
    print("hybrid(4-bit blocks) == int8 dot:",
          bool(torch.equal(hybrid_matmul_i8(a8, b8), dot_i32(a8, b8))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
