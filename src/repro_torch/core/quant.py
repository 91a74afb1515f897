"""Quantization primitives (int8 and packed int4) for the CAMP technique.

Conventions, as in the reference (``repro/core/quant.py``):

* Weights ``(K, N)`` are quantized **per output channel** (one scale per
  column, absmax over K).
* Activations ``(M, K)`` are quantized **per row** (per token).
* int8 values live in [-127, 127] (symmetric; -128 excluded), int4 values
  in [-7, 7].
* int4 payloads are packed two per byte along axis 0 (K for a weight):
  row ``2i`` goes to the low nibble of byte row ``i``, row ``2i+1`` to the
  high nibble; both nibbles are sign-extended when unpacked.

The f32 chain is the reference's: ``scale = absmax / qmax`` (1 where absmax
is 0), then a true division ``x / scale``, round half to even
(``torch.round``), clip. The division by ``qmax`` is computed by dividing
by a tensor, never by a Python scalar: PyTorch's CUDA division by a CPU
scalar multiplies by the reciprocal, which is not correctly rounded.
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
    """A quantized weight: int8 or packed-int4 payload + f32 column scales.

    ``q``: (K, N) int8, or (K//2, N) packed int4 when ``bits`` is 4;
    ``scale``: (1, N) f32; ``shape``: the logical (K, N). A stack of MoE
    expert weights carries a leading expert axis on all three: q (E, K, N)
    or (E, K//2, N), scale (E, 1, N), shape (E, K, N), each expert packed
    along its own K.
    """

    q: torch.Tensor
    scale: torch.Tensor
    bits: int
    shape: tuple

    def __post_init__(self):
        _qmax(self.bits)
        if len(self.shape) not in (2, 3):
            raise ValueError(f"a quantized weight is (K, N) or (E, K, N); "
                             f"got {self.shape}")
        *lead, k, n = self.shape
        rows = k // 2 if self.bits == 4 else k
        if tuple(self.q.shape) != (*lead, rows, n):
            raise ValueError(f"{self.bits}-bit payload of a {self.shape} "
                             f"weight must be {(*lead, rows, n)}; got "
                             f"{tuple(self.q.shape)}")

    def dequantize(self) -> torch.Tensor:
        w = self.q
        if self.bits == 4:
            k = self.shape[-2]
            w = (unpack_int4(w, k) if w.ndim == 2
                 else torch.stack([unpack_int4(m, k) for m in w]))
        return w.to(self.scale.dtype) * self.scale

    def memory_bytes(self) -> int:
        """Bytes of the payload and its f32 scales (the reference's
        count)."""
        return self.q.numel() + 4 * self.scale.numel()


def quantize_rowwise(x: torch.Tensor, bits: int = 8):
    """Symmetric per-row quantization → ``(int8 q, f32 scale (..., 1))``."""
    qmax = _qmax(bits)
    absmax = x.abs().amax(dim=-1, keepdim=True).float()
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        div_exact(absmax, qmax))
    q = torch.clamp(torch.round(x.float() / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize_rowwise(q: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def quantize_colwise(w: torch.Tensor, bits: int = 8):
    """Symmetric per-column quantization of (..., K, N) → scale (..., 1,
    N) f32 (each leading index a matrix of its own). On meta (a dry
    run's weights) the shapes alone."""
    qmax = _qmax(bits)
    if w.is_meta:
        return (torch.empty(w.shape, dtype=torch.int8, device="meta"),
                torch.empty((*w.shape[:-2], 1, w.shape[-1]),
                            dtype=torch.float32, device="meta"))
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        div_exact(absmax, qmax))
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4-valued int8 (first dim even) two per byte along axis 0."""
    if q.shape[0] % 2 != 0:
        raise ValueError(f"K={q.shape[0]} must be even to pack int4")
    lo, hi = q[0::2].to(torch.int8), q[1::2].to(torch.int8)
    return (hi << 4) | (lo & 0x0F)


def unpack_int4(packed: torch.Tensor, k=None) -> torch.Tensor:
    """Inverse of :func:`pack_int4`, sign-extending both nibbles; the first
    ``k`` rows of the result when ``k`` is given."""
    p = packed.to(torch.int8)
    lo, hi = (p << 4) >> 4, p >> 4          # arithmetic shifts on int8
    out = torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], *p.shape[1:])
    return out if k is None else out[:k]


def quantize_weight(w: torch.Tensor, bits: int = 8) -> QuantizedTensor:
    """Quantize a (K, N) weight; 4-bit payloads are packed along K."""
    if w.ndim != 2:
        raise ValueError(f"quantize_weight expects 2-D (K, N); got {tuple(w.shape)}")
    q, scale = quantize_colwise(w, bits)
    if bits == 4:
        q = pack_int4(q)
    return QuantizedTensor(q=q, scale=scale, bits=bits, shape=tuple(w.shape))


# --------------------------------------------------------------------------
# QAT fake quantization with a straight-through gradient
# --------------------------------------------------------------------------
class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        # K7's rowwise chain (the reference's under jit); kernels import
        # this module, so the kernel's wrapper is imported here
        from repro_torch.kernels.quantize import quantize_lastdim
        q, scale = quantize_lastdim(x, bits=bits)
        return (q.float() * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None                      # straight through


def fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Quantize → dequantize x per row of its last axis (absmax, ``bits``),
    with the identity as its gradient."""
    _qmax(bits)
    return _FakeQuant.apply(x, bits)
