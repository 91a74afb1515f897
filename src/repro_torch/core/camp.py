"""CAMP public API: ``camp_matmul``, the quantized drop-in for ``x @ W``.

Port of ``repro/core/camp.py``. Quantization modes:

  =========  =========================  ==========================================
  qmode      storage                    compute
  =========  =========================  ==========================================
   none      bf16/f32 weights            float matmul
  w8a8       int8 W (1 B/param)          fused quantize→int8×int8→int32 (K1)
  w4a8       packed int4 W (0.5 B)       fused quantize→int8×int4→int32 (K4)
  w4a4       packed int4 W + int4 A      fused quantize→int4×int4→int32 (K4)
  w8a16      int8 W                      dequantize → float matmul (weight-only)
  w4a16      packed int4 W               dequantize → float matmul (weight-only)
  =========  =========================  ==========================================

For the integer modes the default is the fused path: the activation
quantization happens inside the GEMM kernel, and the elementwise tails
(``epilogue=`` with ``bias=``/``operand=``, see
:mod:`repro_torch.kernels.epilogue`) run on the f32 accumulator in its
flush. ``fused=False`` takes the two-kernel composition instead: rowwise
quantize (K7), then the unfused GEMM (K5 for w8a8, K6a for w4a8, and for
w4a4 the int4 activations packed along K and K6b). It equals the fused
path bit for bit; no model path selects it.

:func:`qat_matmul` is the training side: both operands fake-quantized
(K7's rowwise chain, straight-through gradients), then a float matmul.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import (QuantizedTensor, fake_quant, pack_int4,
                                    quantize_weight)
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import apply_epilogue, validate_epilogue

QMODES = ("none", "w8a8", "w4a8", "w4a4", "w8a16", "w4a16")
INT_QMODES = ("w8a8", "w4a8", "w4a4")


def weight_bits(qmode: str) -> Optional[int]:
    if qmode == "none":
        return None
    return 4 if qmode.startswith("w4") else 8


def prepare_weight(w: torch.Tensor, qmode: str):
    """Quantize a (K, N) weight for ``qmode`` (identity for 'none')."""
    if qmode not in QMODES:
        raise ValueError(f"qmode={qmode!r} not in {QMODES}")
    if qmode == "none":
        return w
    return quantize_weight(w, bits=weight_bits(qmode))


def camp_matmul(x: torch.Tensor, w, *, qmode: str = "w8a8",
                impl: str = "auto", out_dtype=None,
                fused: Optional[bool] = None, epilogue: str = "none",
                bias: Optional[torch.Tensor] = None,
                operand: Optional[torch.Tensor] = None,
                plan=None) -> torch.Tensor:
    """Quantized matmul ``x @ W`` via the CAMP pipeline.

    ``x``: (..., K) float; ``w``: :class:`QuantizedTensor` (K, N), or a
    float tensor when qmode='none'. Returns (..., N) in ``out_dtype``
    (default x.dtype). ``impl`` as in :mod:`repro_torch.kernels.ops`.
    ``fused=None`` means fused for the integer modes (ignored by 'none' and
    the weight-only modes, which quantize no activations). ``plan=None``
    takes the integer GEMM's launch plan from the autotune (see
    :mod:`repro_torch.kernels.ops`); a CPU tensor ignores it.
    """
    if qmode not in QMODES:
        raise ValueError(f"qmode={qmode!r} not in {QMODES}")
    out_dtype = out_dtype or x.dtype
    stages = validate_epilogue(epilogue, bias, operand)

    def finish_float(y):
        if stages:
            y = apply_epilogue(
                y.float(), stages,
                bias=None if bias is None else bias.reshape(1, -1),
                operand=None if operand is None else operand.reshape(y.shape))
        return y.to(out_dtype)

    if qmode == "none":
        w_arr = w.dequantize() if isinstance(w, QuantizedTensor) else w
        return finish_float(torch.matmul(x, w_arr.to(x.dtype)))

    if not isinstance(w, QuantizedTensor):
        raise TypeError(f"qmode={qmode!r} needs a QuantizedTensor, got {type(w)}")
    lead, k = x.shape[:-1], x.shape[-1]
    n = w.shape[1]
    if w.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)} @ W {w.shape}: K mismatch")
    x2 = x.reshape(-1, k)

    if qmode in ("w8a16", "w4a16"):
        y = finish_float(torch.matmul(x2, w.dequantize().to(x.dtype)))
        return y.reshape(*lead, n)

    x2 = x2.contiguous()
    opd2 = None if operand is None else operand.reshape(-1, n).contiguous()
    kw = dict(out_dtype=out_dtype, impl=impl, epilogue=epilogue, bias=bias,
              operand=opd2, plan=plan)
    if fused is None or fused:
        fn = {"w8a8": ops.gemm_i8_fused, "w4a8": ops.gemm_w4_fused,
              "w4a4": ops.gemm_a4w4_fused}[qmode]
        y = fn(x2, w.q, w.scale, **kw)
    elif qmode == "w8a8":
        a_q, a_s = ops.quantize_rowwise(x2, bits=8, impl=impl)
        y = ops.gemm_i8(a_q, w.q, a_s, w.scale, **kw)
    elif qmode == "w4a8":
        a_q, a_s = ops.quantize_rowwise(x2, bits=8, impl=impl)
        y = ops.gemm_w4(a_q, w.q, a_s, w.scale, **kw)
    else:
        a_q, a_s = ops.quantize_rowwise(x2, bits=4, impl=impl)
        a_packed = pack_int4(a_q.T).T.contiguous()   # packed along K
        y = ops.gemm_a4w4(a_packed, w.q, k, a_s, w.scale, **kw)
    return y.reshape(*lead, n)


def qat_matmul(x: torch.Tensor, w: torch.Tensor, *, bits: int = 8
               ) -> torch.Tensor:
    """Training-side fake-quantized ``x @ w`` with straight-through
    gradients: x per row, w per output channel (over K), as PTQ
    quantizes them."""
    xq = fake_quant(x, bits)
    wq = fake_quant(w.T, bits).T
    return torch.matmul(xq, wq)
