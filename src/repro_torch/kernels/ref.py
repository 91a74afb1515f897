"""Plain PyTorch oracles for the integer GEMM path.

``quantize_rowwise_ref`` follows the reference GEMM's f32 chain **as XLA
compiles it**: the reference's fused GEMM fallback is always jitted, and
under ``jit`` XLA rewrites the division by the constant ``qmax`` into a
multiplication by its f32 reciprocal (``1/127`` rounded to f32). The
quotient ``x / scale`` stays a true division. The CUDA kernel
(``csrc/camp_gemm_fused.cu``) computes the same chain, so its int8
activations are bit-identical to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import _qmax


def recip_f32(qmax: int) -> float:
    """``1/qmax`` rounded to f32 (exactly representable as a Python float)."""
    return float(np.float32(1.0) / np.float32(qmax))


def dot_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) × (K, N) → int32.

    On the CPU an int32 matmul. CUDA has no int32 matmul, so there the
    product runs in float64, which is exact: |sum| ≤ 127² · K < 2⁵³.
    """
    if a.is_cuda:
        return (a.double() @ b.double()).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32)


def quantize_rowwise_ref(x: torch.Tensor, bits: int = 8):
    """Per-row absmax quantize → (int8 q (M, K), f32 scale (M, 1))."""
    qmax = _qmax(bits)
    absmax = x.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        absmax * recip_f32(qmax))
    q = torch.clamp(torch.round(x.float() / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def gemm_i8_ref(a_q, b_q, a_scale, b_scale, out_dtype=torch.float32):
    """int8 GEMM oracle: exact int32 accumulate + Cartesian scale."""
    acc = dot_i32(a_q, b_q)
    return (acc.float() * (a_scale * b_scale)).to(out_dtype)
