"""Quantization primitives (int8) for the CAMP technique.

Conventions, as in the reference (``repro/core/quant.py``):

* Weights ``(K, N)`` are quantized **per output channel** (one scale per
  column, absmax over K).
* Activations ``(M, K)`` are quantized **per row** (per token).
* int8 values live in [-127, 127] (symmetric; -128 excluded).

The f32 chain is the reference's: ``scale = absmax / qmax`` (1 where absmax
is 0), then a true division ``x / scale``, round half to even
(``torch.round``), clip. The division by ``qmax`` is computed by dividing
by a tensor, never by a Python scalar: PyTorch's CUDA division by a CPU
scalar multiplies by the reciprocal, which is not correctly rounded.

Packed int4 storage (``pack_int4``/``unpack_int4``) comes with the int4
GEMM kernels in a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

INT8_QMAX = 127
INT4_QMAX = 7


def _qmax(bits: int) -> int:
    if bits == 8:
        return INT8_QMAX
    if bits == 4:
        return INT4_QMAX
    raise ValueError(f"unsupported bits={bits}; CAMP supports 8 and 4")


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` correctly rounded on every device (see module docstring)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


@dataclasses.dataclass
class QuantizedTensor:
    """A quantized weight: int8 payload + f32 per-column scales.

    ``q``: (K, N) int8; ``scale``: (1, N) f32; ``shape``: logical (K, N).
    """

    q: torch.Tensor
    scale: torch.Tensor
    bits: int
    shape: tuple

    def dequantize(self) -> torch.Tensor:
        if self.bits != 8:
            raise NotImplementedError(
                "int4 payloads come with the int4 GEMM kernels (ROADMAP "
                "queue 2, K4)")
        return self.q.to(self.scale.dtype) * self.scale


def quantize_rowwise(x: torch.Tensor, bits: int = 8):
    """Symmetric per-row quantization → ``(int8 q, f32 scale (..., 1))``."""
    qmax = _qmax(bits)
    absmax = x.abs().amax(dim=-1, keepdim=True).float()
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        div_exact(absmax, qmax))
    q = torch.clamp(torch.round(x.float() / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def quantize_colwise(w: torch.Tensor, bits: int = 8):
    """Symmetric per-column quantization of (K, N) → scale (1, N) f32."""
    qmax = _qmax(bits)
    w32 = w.float()
    absmax = w32.abs().amax(dim=0, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        div_exact(absmax, qmax))
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def quantize_weight(w: torch.Tensor, bits: int = 8) -> QuantizedTensor:
    """Quantize a (K, N) weight to an int8 :class:`QuantizedTensor`."""
    if w.ndim != 2:
        raise ValueError(f"quantize_weight expects 2-D (K, N); got {tuple(w.shape)}")
    if bits != 8:
        raise NotImplementedError(
            "int4 weights come with the int4 GEMM kernels (ROADMAP queue 2, K4)")
    q, scale = quantize_colwise(w, bits)
    return QuantizedTensor(q=q, scale=scale, bits=bits, shape=tuple(w.shape))
