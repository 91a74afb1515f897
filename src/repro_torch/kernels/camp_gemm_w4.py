"""K6a and K6b: packed-int4 GEMMs of pre-quantized activations.

Port of the reference's ``camp_gemm_w4`` and ``camp_gemm_a4w4``
(``repro/kernels/camp_gemm_w4.py``). Packed int4 holds two values per byte
along K, low nibble = even k, both sign-extended
(:func:`repro_torch.core.quant.pack_int4`):

* ``camp_gemm_w4`` (K6a): int8 A (M, K) × packed B (K//2, N);
* ``camp_gemm_a4w4`` (K6b): packed A (M, K//2) × packed B (K//2, N).

Both flush like K5 (``acc · (s_a · s_b)`` then the epilogue stages), or
return the int32 sums unflushed for ``out_dtype=torch.int32``, as K5. Both
CUDA kernels (``csrc/camp_gemm.cu``) are instances of K5's tensor-core
template (``csrc/camp_gemm_tc.cuh``) under the autotune's plan (kinds
``w4`` and ``a4w4`` of :func:`repro_torch.core.autotune.get_plan`, or
``plan=``): K is even, so
a K step never splits a packed byte, and the nibbles are unpacked into
int8 in shared memory (B from its TMA-loaded stage; K6b's packed A from
registers, one K step ahead).

Each wrapper takes its plain version (``*_ref``) for a CPU tensor,
launches the kernel for a CUDA tensor (or raises) and runs the kernel's
meta rule for a meta tensor (:mod:`repro_torch.kernels.meta`); ``launches_w4`` and
``launches_a4w4`` count kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import unpack_int4
from repro_torch.core import autotune
from repro_torch.core.blocking import PlanConfig
from repro_torch.kernels.camp_gemm import (camp_gemm_i8_ref, check_tensor,
                                           launch_gemm, require_cuda)
from repro_torch.kernels.ref import dot_i32

launches_w4 = 0       # kernel launches through camp_gemm_w4
launches_a4w4 = 0     # kernel launches through camp_gemm_a4w4


def camp_gemm_w4_ref(a_q, b_packed, a_scale, b_scale, *,
                     out_dtype=torch.float32, epilogue: str = "none",
                     bias=None, operand=None, dot=dot_i32):
    """Plain version: unpack B, exact int32 dot (or ``dot``) → flush (K5's
    plain version; int32 out: the dot unflushed)."""
    b_q = unpack_int4(b_packed, a_q.shape[1])
    return camp_gemm_i8_ref(a_q, b_q, a_scale, b_scale, out_dtype=out_dtype,
                            epilogue=epilogue, bias=bias, operand=operand,
                            dot=dot)


def camp_gemm_a4w4_ref(a_packed, b_packed, a_scale, b_scale, *,
                       out_dtype=torch.float32, epilogue: str = "none",
                       bias=None, operand=None):
    """Plain version: unpack A along K and B along K → int32 dot → flush
    (K5's plain version; int32 out: the dot unflushed)."""
    k = 2 * a_packed.shape[1]
    a_q = unpack_int4(a_packed.T, k).T
    b_q = unpack_int4(b_packed, k)
    return camp_gemm_i8_ref(a_q, b_q, a_scale, b_scale, out_dtype=out_dtype,
                            epilogue=epilogue, bias=bias, operand=operand)


def _packed_shapes(a, b_packed, k, what):
    if a.ndim != 2 or b_packed.ndim != 2:
        raise ValueError(f"{what} takes 2-D operands")
    if k % 2 or b_packed.shape[0] != k // 2:
        raise ValueError(f"{what}: K={k} must be even and B packed to "
                         f"({k // 2}, N); got {tuple(b_packed.shape)}")


def camp_gemm_w4(a_q: torch.Tensor, b_packed: torch.Tensor,
                 a_scale: torch.Tensor, b_scale: torch.Tensor, *,
                 out_dtype=torch.float32, epilogue: str = "none",
                 bias: Optional[torch.Tensor] = None,
                 operand: Optional[torch.Tensor] = None,
                 plan: Optional[PlanConfig] = None) -> torch.Tensor:
    """int8 A (M, K), scales (M, 1) × packed-int4 B (K//2, N), scales (1, N)
    → (M, N) in ``out_dtype``. ``plan`` (a CUDA tensor only) overrides the
    autotune's."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    _packed_shapes(a_q, b_packed, a_q.shape[-1], "camp_gemm_w4")
    if a_q.device.type == "cpu":
        return camp_gemm_w4_ref(a_q, b_packed, a_scale, b_scale, **kw)
    require_cuda(a_q, "camp_gemm_w4")
    (m, k), n, dev = a_q.shape, b_packed.shape[1], a_q.device
    check_tensor("a_q", a_q, (m, k), (torch.int8,), dev)
    check_tensor("b_packed", b_packed, (k // 2, n), (torch.int8,), dev)
    plan = plan or autotune.get_plan("w4", m, n, k)
    out = launch_gemm("camp_gemm", "camp_gemm_w4", a_q, a_scale, b_packed,
                      b_scale, k, plan=plan[:3], flags=plan.flags, **kw)
    if out.numel() and out.is_cuda:
        global launches_w4
        launches_w4 += 1
    return out


def camp_gemm_a4w4(a_packed: torch.Tensor, b_packed: torch.Tensor,
                   a_scale: torch.Tensor, b_scale: torch.Tensor, *,
                   out_dtype=torch.float32, epilogue: str = "none",
                   bias: Optional[torch.Tensor] = None,
                   operand: Optional[torch.Tensor] = None,
                   plan: Optional[PlanConfig] = None) -> torch.Tensor:
    """Packed-int4 A (M, K//2), scales (M, 1) × packed-int4 B (K//2, N),
    scales (1, N) → (M, N) in ``out_dtype``; the logical K is 2 · K//2.
    ``plan`` (a CUDA tensor only) overrides the autotune's."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    _packed_shapes(a_packed, b_packed, 2 * a_packed.shape[-1],
                   "camp_gemm_a4w4")
    if a_packed.device.type == "cpu":
        return camp_gemm_a4w4_ref(a_packed, b_packed, a_scale, b_scale, **kw)
    require_cuda(a_packed, "camp_gemm_a4w4")
    (m, k2), n, dev = a_packed.shape, b_packed.shape[1], a_packed.device
    check_tensor("a_packed", a_packed, (m, k2), (torch.int8,), dev)
    check_tensor("b_packed", b_packed, (k2, n), (torch.int8,), dev)
    plan = plan or autotune.get_plan("a4w4", m, n, 2 * k2)
    out = launch_gemm("camp_gemm", "camp_gemm_a4w4", a_packed, a_scale,
                      b_packed, b_scale, 2 * k2, plan=plan[:3],
                      flags=plan.flags, **kw)
    if out.numel() and out.is_cuda:
        global launches_a4w4
        launches_a4w4 += 1
    return out
