"""Dispatch for the CAMP GEMM kernels.

Every op takes ``impl``:

* ``'auto'``  — the device of the tensor decides: the CUDA kernel for a CUDA
  tensor, the plain PyTorch version for a CPU tensor;
* ``'cuda'``  — the CUDA kernel (raises for a CPU tensor);
* ``'torch'`` — the plain PyTorch version, on any device. Tests and
  ``chip_smoke.py`` use it to hold the kernels against their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.camp_gemm_fused import (camp_gemm_fused_w8a8,
                                                 camp_gemm_fused_w8a8_ref)

VALID_IMPLS = ("auto", "cuda", "torch")


def check_impl(impl: str, x: torch.Tensor) -> str:
    """Validate ``impl`` against the tensor's device; 'auto' → the device's."""
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl={impl!r} not in {VALID_IMPLS}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got {x.device}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def gemm_i8_fused(x, b_q, b_scale, *, out_dtype=torch.float32,
                  impl: str = "auto", epilogue: str = "none", bias=None,
                  operand=None):
    """w8a8 with in-kernel activation quantization: (M,K) float × (K,N) int8."""
    fn = (camp_gemm_fused_w8a8_ref if check_impl(impl, x) == "torch"
          else camp_gemm_fused_w8a8)
    return fn(x, b_q, b_scale, out_dtype=out_dtype, epilogue=epilogue,
              bias=bias, operand=operand)
