"""Fused GEMM epilogues: elementwise tails applied to the f32 accumulator.

An epilogue is a ``+``-separated stage string applied left to right, as in
the reference (``repro/kernels/epilogue.py``):

  ==========  ======================================  =================
  stage       effect on the f32 accumulator ``y``     extra tensor
  ==========  ======================================  =================
  ``bias``      ``y + bias``  (broadcast over rows)   ``bias`` (N,)
  ``silu``      ``y * sigmoid(y)``                    —
  ``gelu``      ``gelu(y)`` (tanh approximation)      —
  ``residual``  ``y + operand``                       ``operand`` (M, N)
  ``mul``       ``y * operand``                       ``operand`` (M, N)
  ==========  ======================================  =================

``apply_epilogue`` is the plain version of the flush that the CUDA GEMM
kernel (``csrc/camp_gemm_fused.cu``) runs in registers before its one store.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

EPILOGUE_STAGES = ("bias", "silu", "gelu", "residual", "mul")


def parse_epilogue(epilogue: Optional[str]) -> Tuple[str, ...]:
    """'bias+silu' → ('bias', 'silu'); None/'none'/'' → ()."""
    if not epilogue or epilogue == "none":
        return ()
    stages = tuple(s.strip() for s in epilogue.split("+") if s.strip())
    for s in stages:
        if s not in EPILOGUE_STAGES:
            raise ValueError(f"unknown epilogue stage {s!r}; valid: {EPILOGUE_STAGES}")
    if stages.count("bias") > 1:
        raise ValueError(f"epilogue {epilogue!r}: 'bias' may appear at most once")
    if stages.count("residual") + stages.count("mul") > 1:
        raise ValueError(
            f"epilogue {epilogue!r}: at most one operand stage (residual|mul)")
    return stages


def epilogue_needs(stages: Sequence[str]) -> Tuple[bool, bool]:
    """→ (needs_bias, needs_operand)."""
    return "bias" in stages, ("residual" in stages or "mul" in stages)


def validate_epilogue(epilogue: Optional[str], bias, operand) -> Tuple[str, ...]:
    """Parse ``epilogue`` and require bias/operand presence to match it."""
    stages = parse_epilogue(epilogue)
    needs_bias, needs_opd = epilogue_needs(stages)
    if needs_bias != (bias is not None):
        raise ValueError(
            f"epilogue {epilogue!r} {'requires' if needs_bias else 'takes no'}"
            f" bias= (got bias={'set' if bias is not None else 'None'})")
    if needs_opd != (operand is not None):
        raise ValueError(
            f"epilogue {epilogue!r} {'requires' if needs_opd else 'takes no'}"
            f" operand= (got operand={'set' if operand is not None else 'None'})")
    return stages


def apply_epilogue(y: torch.Tensor, stages: Sequence[str], *, bias=None,
                   operand=None) -> torch.Tensor:
    """Apply ``stages`` to the f32 accumulator ``y`` (M, N).

    ``bias``: broadcastable to (1, N); ``operand``: (M, N). Both are upcast
    to f32 here, as the kernel does with its loads.
    """
    for s in stages:
        if s == "bias":
            y = y + bias.float()
        elif s == "silu":
            y = y * torch.sigmoid(y)
        elif s == "gelu":
            y = F.gelu(y, approximate="tanh")
        elif s == "residual":
            y = y + operand.float()
        else:  # mul
            y = y * operand.float()
    return y
