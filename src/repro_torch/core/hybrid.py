"""Hybrid (divide-and-conquer) multiplier: the paper's §3, in matmul algebra.

Port of ``repro/core/hybrid.py``. CAMP builds every 8-bit multiplier out of
four 4-bit ones (eq. (1)-(2) of the paper):

    A = a1·2^4 + a0,  B = b1·2^4 + b0
    A·B = (a1·b1)·2^8 + (a1·b0 + a0·b1)·2^4 + a0·b0

with ``a1`` the *signed* high nibble (arithmetic shift) and ``a0`` the
*unsigned* low nibble. Matrix multiplication is linear, so the identity
lifts to whole GEMMs: an int8×int8→int32 GEMM is a shifted sum of four
int4-operand GEMMs, and w4a8 needs two. These are plain integer torch ops
(``impl='hybrid'`` in :mod:`repro_torch.kernels.ops`), the bit-exact witness
that the algebra holds; no kernel runs them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import dot_i32


def split_nibbles(x: torch.Tensor):
    """int8 → (signed high, unsigned low) nibbles as int8:
    ``x == hi * 16 + lo``, ``hi`` in [-8, 7], ``lo`` in [0, 15]."""
    x = x.to(torch.int8)
    return x >> 4, x & 0x0F


def hybrid_matmul_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) × int8 (K, N) → int32 from four int4-range GEMMs."""
    ah, al = split_nibbles(a)
    bh, bl = split_nibbles(b)
    hh, hl = dot_i32(ah, bh), dot_i32(ah, bl)
    lh, ll = dot_i32(al, bh), dot_i32(al, bl)
    return (hh << 8) + ((hl + lh) << 4) + ll


def hybrid_matmul_w4a8(a: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    """int8 activations (M, K) × int4-valued int8 weights (K, N) → int32,
    from two int4-range GEMMs (the paper's 2× throughput point)."""
    ah, al = split_nibbles(a)
    return (dot_i32(ah, b4) << 4) + dot_i32(al, b4)
