"""Plain PyTorch oracles for the integer GEMM path and for attention.

``quantize_rowwise_ref`` follows the reference GEMM's f32 chain **as XLA
compiles it**: the reference's fused GEMM fallback is always jitted, and
under ``jit`` (and in the interpret-mode Pallas kernels) XLA rewrites the
division by the constant ``qmax`` into a multiplication by its f32
reciprocal (``1/127`` or ``1/7`` rounded to f32). The quotient
``x / scale`` stays a true division. The CUDA kernels (``csrc/quantize.cu``
and the fused GEMMs' prologue) compute the same chain, so their int8/int4
activations are bit-identical to the reference's.

:func:`flush_ref` is the GEMMs' flush as XLA compiles the reference: the
Cartesian scale ``acc · (s_a · s_b)``, contracted with a first bias or
residual add into one fused multiply-add, then the other epilogue stages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import _qmax, unpack_int4
from repro_torch.kernels.epilogue import apply_epilogue, validate_epilogue


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


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding to f32, as a fused multiply-add.

    The product of two f32 values is exact in float64, so only the sum
    rounds twice (to float64, then to f32); the two agree with a true FMA
    except at rare double-rounding ties.
    """
    return (a.double() * b.double() + c.double()).float()


def quantize_rowwise_ref(x: torch.Tensor, bits: int = 8):
    """Per-row absmax quantize → (int8 q (M, K), f32 scale (M, 1))."""
    qmax = _qmax(bits)
    absmax = x.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        absmax * recip_f32(qmax))
    q = torch.clamp(torch.round(x.float() / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def flush_ref(acc: torch.Tensor, a_scale, b_scale, *, out_dtype=torch.float32,
              epilogue: str = "none", bias=None, operand=None):
    """int32 accumulator (M, N) → ``acc · (s_a · s_b)`` → stages → out_dtype."""
    stages = validate_epilogue(epilogue, bias, operand)
    bias = None if bias is None else bias.reshape(1, -1)
    y = acc.float()
    scale = a_scale * b_scale.reshape(1, -1)
    if stages and stages[0] in ("bias", "residual"):
        y = fma_f32(y, scale, bias if stages[0] == "bias" else operand)
        stages = stages[1:]
    else:
        y = y * scale
    return apply_epilogue(y, stages, bias=bias, operand=operand).to(out_dtype)


def gemm_i8_ref(a_q, b_q, a_scale, b_scale, out_dtype=torch.float32):
    """int8 GEMM oracle: exact int32 accumulate + Cartesian scale."""
    acc = dot_i32(a_q, b_q)
    return (acc.float() * (a_scale * b_scale)).to(out_dtype)


def gemm_w4_ref(a_q, b_packed, a_scale, b_scale, out_dtype=torch.float32):
    """int8 A × packed-int4 B oracle: unpack B, then the int8 oracle."""
    b_q = unpack_int4(b_packed, a_q.shape[-1])
    return gemm_i8_ref(a_q, b_q, a_scale, b_scale, out_dtype)


def gemm_a4w4_ref(a_packed, b_packed, k, a_scale, b_scale,
                  out_dtype=torch.float32):
    """Packed-int4 A (M, K//2) × packed-int4 B (K//2, N) oracle."""
    a_q = unpack_int4(a_packed.T, k).T
    b_q = unpack_int4(b_packed, k)
    return gemm_i8_ref(a_q, b_q, a_scale, b_scale, out_dtype)


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """Oracle for the flash-attention kernel, naive (small shapes only):
    q, k, v (B, H, S, D) → softmax(q kᵀ · scale) v in f32, in q.dtype. The
    causal mask keeps column c for row r when c <= r + (Sk - Sq)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
