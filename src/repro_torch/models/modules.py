"""Shared building blocks: norms, rope, linear-with-CAMP, gated MLP.

Port of ``repro/models/modules.py`` (the single-device paths; the
row-parallel tensor-parallel linear comes with tensor parallelism).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.camp import camp_matmul, weight_bits
from repro_torch.core.quant import QuantizedTensor, div_exact
from repro_torch.kernels.epilogue import apply_epilogue, parse_epilogue


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """Variance in f32; the normalised product is rounded in x's dtype, as
    the reference does (``x * inv * scale`` with ``inv`` cast to x.dtype)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def refuse_tf32(x: torch.Tensor, what: str) -> None:
    """Raise on a CUDA tensor while TF32 matmuls are on: ``what`` computes
    f32 products that must stay f32, as in the reference."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{what} is f32; TF32 matmuls "
                           "(torch.backends.cuda.matmul.allow_tf32) would "
                           "change its results")


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm over the last dim, in f32. x: (..., H, hd). The
    variance is the population variance (``jnp.var``), not torch's
    unbiased default."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
           qmode: str = "none", impl: str = "auto",
           epilogue: Optional[str] = None,
           operand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W (+ b)``, through the CAMP pipeline when W is quantized.

    ``epilogue`` appends fused tail stages after the bias (e.g. ``'silu'``,
    ``'mul'`` with ``operand``); on the quantized path they run inside the
    kernel's flush on the f32 accumulator.
    """
    stages = []
    if bias is not None:
        stages.append("bias")
    if epilogue and epilogue != "none":
        stages.append(epilogue)
    epi = "+".join(stages) if stages else "none"
    if isinstance(w, QuantizedTensor):
        # The weight's payload decides the kernel family: a caller-side qmode
        # of 'none' (or one whose weight bits disagree with the payload) is
        # remapped to the mode matching the weight, keeping the requested
        # activation treatment (weight-only stays weight-only).
        if qmode == "none" or weight_bits(qmode) != w.bits:
            if qmode.endswith("a16"):
                qmode = "w8a16" if w.bits == 8 else "w4a16"
            else:
                qmode = "w8a8" if w.bits == 8 else "w4a8"
        return camp_matmul(x, w, qmode=qmode, impl=impl, epilogue=epi,
                           bias=bias, operand=operand)
    y = torch.matmul(x, w.to(x.dtype))
    if epi != "none":
        y = apply_epilogue(
            y.float(), parse_epilogue(epi),
            bias=None if bias is None else bias.reshape(1, -1),
            operand=operand).to(x.dtype)
    return y


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int → (cos, sin) of shape (..., head_dim // 2), f32.

    The inverse frequencies are computed on the CPU (correctly rounded
    division, as the reference) and moved to the positions' device.
    """
    half = head_dim // 2
    expo = div_exact(torch.arange(half, dtype=torch.float32), half)
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), expo)
    ang = positions.float()[..., None] * inv.to(positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd // 2) → rotated x (half-split)."""
    x32 = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def gated_mlp(x: torch.Tensor, p: dict, *, qmode: str = "none",
              impl: str = "auto") -> torch.Tensor:
    """SiLU-gated FFN: down(silu(gate(x)) * up(x)), as three fused GEMMs.

    The gate applies SiLU in its flush, the up projection multiplies by the
    activated gate in its flush, and the down projection is plain.
    """
    g = linear(x, p["w_gate"], qmode=qmode, impl=impl, epilogue="silu")
    h = linear(x, p["w_up"], qmode=qmode, impl=impl, epilogue="mul", operand=g)
    return linear(h, p["w_down"], qmode=qmode, impl=impl)
