"""K1 and K4: fused activation-quantize + integer GEMM + epilogue.

Port of the reference's ``camp_gemm_fused_w8a8`` / ``_w4a8`` / ``_w4a4``
(``repro/kernels/camp_gemm_fused.py``): bf16/f32 activations are quantized
per row inside the kernel (to [-127, 127], or [-7, 7] for w4a4), multiplied
by the int8 weight (K1) or the packed-int4 weight (K4, (K//2, N), unpacked
on chip) into an int32 accumulator, and flushed as ``acc · (s_a · s_b)``
followed by the epilogue stages, with one store of the output (a first
bias/residual stage fuses with the scale into one multiply-add, as XLA
compiles the reference). The activations' integer payload never exists
in device memory; only their M row scales do, in the call's workspace,
for the flush.

* ``camp_gemm_fused_*_ref`` are the plain PyTorch versions. The CPU tests
  use them, and ``chip_smoke.py`` holds the kernels against them.
* ``camp_gemm_fused_*`` are the wrappers: a CPU tensor goes to the plain
  version; a meta tensor runs the meta rule (:mod:`repro_torch.kernels.
  meta`); a CUDA tensor launches ``csrc/camp_gemm_fused.cu`` (or raises):
  the tensor-core template of K5/K6a with x quantized on chip, under the
  autotune's plan (:func:`repro_torch.core.autotune.get_plan`, fused) or
  ``plan=``, one to three device kernels a call
  (``camp_gemm.device_kernels``). ``launches`` (w8a8), ``launches_w4a8``
  and ``launches_w4a4`` count calls that launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autotune
from repro_torch.core.blocking import PlanConfig
from repro_torch.core.quant import unpack_int4
from repro_torch.kernels.camp_gemm import (FLOATS, check_tensor, launch_gemm,
                                           require_cuda)
from repro_torch.kernels.ref import dot_i32, flush_ref, quantize_rowwise_ref

launches = 0          # kernel launches through camp_gemm_fused_w8a8 (K1)
launches_w4a8 = 0     # through camp_gemm_fused_w4a8 (K4)
launches_w4a4 = 0     # through camp_gemm_fused_w4a4 (K4)

# qmode → (activation bits, weight bits)
_BITS = {"w8a8": (8, 8), "w4a8": (8, 4), "w4a4": (4, 4)}
# qmode → the autotune's kernel kind
KIND = {"w8a8": "i8", "w4a8": "w4", "w4a4": "a4w4"}


def _check_k(qmode, x, b):
    k = x.shape[-1]
    rows = k if _BITS[qmode][1] == 8 else k // 2
    if _BITS[qmode][1] == 4 and k % 2:
        raise ValueError(f"camp_gemm_fused_{qmode}: K={k} must be even")
    if b.shape[0] != rows:
        raise ValueError(f"camp_gemm_fused_{qmode}: x {tuple(x.shape)} needs "
                         f"W with {rows} rows, got {tuple(b.shape)}")


def _fused_ref(qmode, x, b, b_scale, *, out_dtype, epilogue, bias, operand,
               dot):
    _check_k(qmode, x, b)
    a_bits, w_bits = _BITS[qmode]
    b_q = unpack_int4(b, x.shape[-1]) if w_bits == 4 else b
    a_q, a_s = quantize_rowwise_ref(x, a_bits)
    return flush_ref(dot(a_q, b_q), a_s, b_scale, out_dtype=out_dtype,
                     epilogue=epilogue, bias=bias, operand=operand)


def camp_gemm_fused_w8a8_ref(x, b_q, b_scale, *, out_dtype=torch.float32,
                             epilogue: str = "none", bias=None, operand=None,
                             dot=dot_i32):
    """Plain version: quantize rowwise (qmax 127) → exact int32 dot (or
    ``dot``, e.g. the hybrid decomposition) → flush → stages."""
    return _fused_ref("w8a8", x, b_q, b_scale, out_dtype=out_dtype,
                      epilogue=epilogue, bias=bias, operand=operand, dot=dot)


def camp_gemm_fused_w4a8_ref(x, b_packed, b_scale, *, out_dtype=torch.float32,
                             epilogue: str = "none", bias=None, operand=None,
                             dot=dot_i32):
    """Plain version: unpack W, quantize rowwise (qmax 127), dot, flush."""
    return _fused_ref("w4a8", x, b_packed, b_scale, out_dtype=out_dtype,
                      epilogue=epilogue, bias=bias, operand=operand, dot=dot)


def camp_gemm_fused_w4a4_ref(x, b_packed, b_scale, *, out_dtype=torch.float32,
                             epilogue: str = "none", bias=None, operand=None):
    """Plain version: unpack W, quantize rowwise (qmax 7), dot, flush."""
    return _fused_ref("w4a4", x, b_packed, b_scale, out_dtype=out_dtype,
                      epilogue=epilogue, bias=bias, operand=operand,
                      dot=dot_i32)


def _fused_cuda(qmode, x, b, b_scale, kw, plan):
    require_cuda(x, f"camp_gemm_fused_{qmode}")
    if x.ndim != 2 or b.ndim != 2:
        raise ValueError(f"camp_gemm_fused_{qmode} takes 2-D x and W")
    _check_k(qmode, x, b)
    (m, k), n, dev = x.shape, b.shape[1], x.device
    check_tensor("x", x, (m, k), FLOATS, dev)
    check_tensor("W", b, (b.shape[0], n), (torch.int8,), dev)
    plan = plan or autotune.get_plan(KIND[qmode], m, n, k, fused=True,
                                     a_in_bytes=x.element_size())
    return launch_gemm("camp_gemm_fused", f"camp_gemm_fused_{qmode}", x, None,
                       b, b_scale, k, plan=plan[:3], flags=plan.flags, **kw)


def camp_gemm_fused_w8a8(x: torch.Tensor, b_q: torch.Tensor,
                         b_scale: torch.Tensor, *, out_dtype=torch.float32,
                         epilogue: str = "none",
                         bias: Optional[torch.Tensor] = None,
                         operand: Optional[torch.Tensor] = None,
                         plan: Optional[PlanConfig] = None) -> torch.Tensor:
    """w8a8 GEMM of x (M, K) bf16/f32 by b_q (K, N) int8, scales (1, N) f32.

    ``bias`` (N,) and ``operand`` (M, N) are bf16/f32, as the epilogue
    needs them. Returns (M, N) in ``out_dtype`` (bf16 or f32). ``plan``
    (a CUDA tensor only; the plain versions have none) overrides the
    autotune's.
    """
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    if x.device.type == "cpu":
        return camp_gemm_fused_w8a8_ref(x, b_q, b_scale, **kw)
    out = _fused_cuda("w8a8", x, b_q, b_scale, kw, plan)
    if out.numel() and out.is_cuda:
        global launches
        launches += 1
    return out


def camp_gemm_fused_w4a8(x: torch.Tensor, b_packed: torch.Tensor,
                         b_scale: torch.Tensor, *, out_dtype=torch.float32,
                         epilogue: str = "none",
                         bias: Optional[torch.Tensor] = None,
                         operand: Optional[torch.Tensor] = None,
                         plan: Optional[PlanConfig] = None) -> torch.Tensor:
    """w4a8: x (M, K) bf16/f32 (K even) by packed-int4 W (K//2, N)."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    if x.device.type == "cpu":
        return camp_gemm_fused_w4a8_ref(x, b_packed, b_scale, **kw)
    out = _fused_cuda("w4a8", x, b_packed, b_scale, kw, plan)
    if out.numel() and out.is_cuda:
        global launches_w4a8
        launches_w4a8 += 1
    return out


def camp_gemm_fused_w4a4(x: torch.Tensor, b_packed: torch.Tensor,
                         b_scale: torch.Tensor, *, out_dtype=torch.float32,
                         epilogue: str = "none",
                         bias: Optional[torch.Tensor] = None,
                         operand: Optional[torch.Tensor] = None,
                         plan: Optional[PlanConfig] = None) -> torch.Tensor:
    """w4a4: x quantized to [-7, 7] in the kernel, by packed W (K//2, N)."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    if x.device.type == "cpu":
        return camp_gemm_fused_w4a4_ref(x, b_packed, b_scale, **kw)
    out = _fused_cuda("w4a4", x, b_packed, b_scale, kw, plan)
    if out.numel() and out.is_cuda:
        global launches_w4a4
        launches_w4a4 += 1
    return out
