"""CAMP public API: ``camp_matmul``, the quantized drop-in for ``x @ W``.

Port of ``repro/core/camp.py``. Quantization modes:

  =========  =========================  ==========================================
  qmode      storage                    compute
  =========  =========================  ==========================================
   none      bf16/f32 weights            float matmul
  w8a8       int8 W (1 B/param)          fused quantize→int8×int8→int32 kernel (K1)
  w8a16      int8 W                      dequantize → float matmul (weight-only)
  w4a8       packed int4 W               not yet ported (ROADMAP queue 2, K4)
  w4a4       packed int4 W + int4 A      not yet ported (ROADMAP queue 2, K4)
  w4a16      packed int4 W               not yet ported (ROADMAP queue 2, K4)
  =========  =========================  ==========================================

For w8a8 the activation quantization happens inside the GEMM kernel, and the
elementwise tails (``epilogue=`` with ``bias=``/``operand=``, see
:mod:`repro_torch.kernels.epilogue`) run on the f32 accumulator in its flush.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import QuantizedTensor, quantize_weight
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import apply_epilogue, validate_epilogue

QMODES = ("none", "w8a8", "w4a8", "w4a4", "w8a16", "w4a16")
INT4_QMODES = ("w4a8", "w4a4", "w4a16")


def _int4_not_ported(qmode: str):
    return NotImplementedError(
        f"qmode={qmode!r} needs the int4 GEMM kernels, not yet ported "
        "(ROADMAP queue 2, K4)")


def weight_bits(qmode: str) -> Optional[int]:
    if qmode == "none":
        return None
    return 4 if qmode.startswith("w4") else 8


def prepare_weight(w: torch.Tensor, qmode: str):
    """Quantize a (K, N) weight for ``qmode`` (identity for 'none')."""
    if qmode not in QMODES:
        raise ValueError(f"qmode={qmode!r} not in {QMODES}")
    if qmode in INT4_QMODES:
        raise _int4_not_ported(qmode)
    if qmode == "none":
        return w
    return quantize_weight(w, bits=8)


def camp_matmul(x: torch.Tensor, w, *, qmode: str = "w8a8",
                impl: str = "auto", out_dtype=None, epilogue: str = "none",
                bias: Optional[torch.Tensor] = None,
                operand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized matmul ``x @ W`` via the CAMP pipeline.

    ``x``: (..., K) float; ``w``: :class:`QuantizedTensor` (K, N), or a
    float tensor when qmode='none'. Returns (..., N) in ``out_dtype``
    (default x.dtype). ``impl`` as in :mod:`repro_torch.kernels.ops`.
    """
    if qmode not in QMODES:
        raise ValueError(f"qmode={qmode!r} not in {QMODES}")
    if qmode in INT4_QMODES:
        raise _int4_not_ported(qmode)
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

    if qmode == "w8a16":
        y = finish_float(torch.matmul(x2, w.dequantize().to(x.dtype)))
        return y.reshape(*lead, n)

    opd2 = None if operand is None else operand.reshape(-1, n).contiguous()
    y = ops.gemm_i8_fused(x2.contiguous(), w.q, w.scale, out_dtype=out_dtype,
                          impl=impl, epilogue=epilogue, bias=bias,
                          operand=opd2)
    return y.reshape(*lead, n)
