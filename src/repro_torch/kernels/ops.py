"""Dispatch for the CAMP GEMM and quantize kernels.

Port of ``repro/kernels/ops.py``. Every op takes ``impl``:

* ``'auto'``   — the device of the tensor decides: the CUDA kernel for a
  CUDA tensor, the plain PyTorch version for a CPU tensor;
* ``'cuda'``   — the CUDA kernel (raises for a CPU tensor);
* ``'torch'``  — the plain PyTorch version, on any device. Tests and
  ``chip_smoke.py`` use it to hold the kernels against their plain versions;
* ``'hybrid'`` — the plain version with the integer product built from the
  paper's §3 hybrid-multiplier decomposition (:mod:`repro_torch.core.
  hybrid`), on any device but meta; bit-exact with 'torch'. As in the
  reference, a4w4 has no decomposition and quantize has none to make, so
  those take the plain version.

A meta tensor takes the kernel's route ('auto' and 'cuda' alike), where
the wrapper runs the kernel's meta rule (:mod:`repro_torch.kernels.meta`)
in place of a launch: the dry run models the card's kernel path. It never
takes a plain version ('torch' or 'hybrid' on one raises).

A CUDA tensor reaches a plain version only when 'torch' or 'hybrid' is
asked for: a kernel that fails to build or launch raises.

The GEMM ops take ``plan=`` (a :class:`~repro_torch.core.blocking.
PlanConfig`), the counterpart of the reference's ``block=``: the kernel's
launch plan, where the default (None) takes the autotune's
(:func:`repro_torch.core.autotune.get_plan`). The plain versions have no
plan and ignore it.

The ``gemm_*_fused`` family quantizes the activations inside the GEMM (K1,
K4); ``quantize_rowwise`` (K7) followed by ``gemm_i8`` (K5), ``gemm_w4``
(K6a) or ``gemm_a4w4`` (K6b) is the unfused composition, equal to the
fused path bit for bit. With ``out_dtype=torch.int32`` those three return
their int32 sums unflushed; ``flush`` (elementwise, the kernels' flush)
scales them once the ranks of a row-parallel product have added them.
"""
from __future__ import annotations

import torch

from repro_torch.core import hybrid
from repro_torch.kernels.camp_gemm import (camp_gemm_i8,  # noqa: F401
                                           camp_gemm_i8_ref, flush)
from repro_torch.kernels.camp_gemm_fused import (camp_gemm_fused_w4a4,
                                                 camp_gemm_fused_w4a4_ref,
                                                 camp_gemm_fused_w4a8,
                                                 camp_gemm_fused_w4a8_ref,
                                                 camp_gemm_fused_w8a8,
                                                 camp_gemm_fused_w8a8_ref)
from repro_torch.kernels.camp_gemm_w4 import (camp_gemm_a4w4,
                                              camp_gemm_a4w4_ref,
                                              camp_gemm_w4, camp_gemm_w4_ref)
from repro_torch.kernels.quantize import quantize_rowwise_kernel
from repro_torch.kernels.ref import dot_i32, quantize_rowwise_ref

VALID_IMPLS = ("auto", "cuda", "torch", "hybrid")


def check_impl(impl: str, x: torch.Tensor) -> str:
    """Validate ``impl`` against the tensor's device; 'auto' → the device's
    ('cuda' for a meta tensor: the kernel's meta rule)."""
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl={impl!r} not in {VALID_IMPLS}")
    if x.is_meta:
        if impl in ("torch", "hybrid"):
            raise ValueError(f"impl={impl!r} on a meta tensor: the dry run "
                             "models the card's kernels, not a plain version")
        return "cuda"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got {x.device}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def _dot(impl: str, hybrid_dot):
    return hybrid_dot if impl == "hybrid" else dot_i32


def gemm_i8_fused(x, b_q, b_scale, *, out_dtype=torch.float32,
                  impl: str = "auto", epilogue: str = "none", bias=None,
                  operand=None, plan=None):
    """w8a8 with in-kernel activation quantization: (M,K) float × (K,N) int8."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    impl = check_impl(impl, x)
    if impl == "cuda":
        return camp_gemm_fused_w8a8(x, b_q, b_scale, **kw, plan=plan)
    return camp_gemm_fused_w8a8_ref(
        x, b_q, b_scale, dot=_dot(impl, hybrid.hybrid_matmul_i8), **kw)


def gemm_w4_fused(x, b_packed, b_scale, *, out_dtype=torch.float32,
                  impl: str = "auto", epilogue: str = "none", bias=None,
                  operand=None, plan=None):
    """w4a8 with in-kernel activation quantization: (M,K) float ×
    (K//2,N) packed int4."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    impl = check_impl(impl, x)
    if impl == "cuda":
        return camp_gemm_fused_w4a8(x, b_packed, b_scale, **kw,
                                    plan=plan)
    return camp_gemm_fused_w4a8_ref(
        x, b_packed, b_scale, dot=_dot(impl, hybrid.hybrid_matmul_w4a8), **kw)


def gemm_a4w4_fused(x, b_packed, b_scale, *, out_dtype=torch.float32,
                    impl: str = "auto", epilogue: str = "none", bias=None,
                    operand=None, plan=None):
    """w4a4 with in-kernel int4 activation quantization: the packed int4
    activations of the unfused path never exist at all."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    if check_impl(impl, x) == "cuda":
        return camp_gemm_fused_w4a4(x, b_packed, b_scale, **kw,
                                    plan=plan)
    return camp_gemm_fused_w4a4_ref(x, b_packed, b_scale, **kw)


def gemm_i8(a_q, b_q, a_scale, b_scale, *, out_dtype=torch.float32,
            impl: str = "auto", epilogue: str = "none", bias=None,
            operand=None, plan=None):
    """int8 GEMM: (M,K) int8 × (K,N) int8 → (M,N) with the scale flush
    (``out_dtype=torch.int32``: the int32 sums, unflushed)."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    impl = check_impl(impl, a_q)
    if impl == "cuda":
        return camp_gemm_i8(a_q, b_q, a_scale, b_scale, **kw, plan=plan)
    return camp_gemm_i8_ref(a_q, b_q, a_scale, b_scale,
                            dot=_dot(impl, hybrid.hybrid_matmul_i8), **kw)


def gemm_w4(a_q, b_packed, a_scale, b_scale, *, out_dtype=torch.float32,
            impl: str = "auto", epilogue: str = "none", bias=None,
            operand=None, plan=None):
    """a8w4 GEMM: int8 activations × packed-int4 weights."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    impl = check_impl(impl, a_q)
    if impl == "cuda":
        return camp_gemm_w4(a_q, b_packed, a_scale, b_scale, **kw,
                            plan=plan)
    return camp_gemm_w4_ref(a_q, b_packed, a_scale, b_scale,
                            dot=_dot(impl, hybrid.hybrid_matmul_w4a8), **kw)


def gemm_a4w4(a_packed, b_packed, k, a_scale, b_scale, *,
              out_dtype=torch.float32, impl: str = "auto",
              epilogue: str = "none", bias=None, operand=None,
              plan=None):
    """int4 GEMM: both operands packed two per byte along K (logical K=k)."""
    if k != 2 * a_packed.shape[-1]:
        raise ValueError(f"gemm_a4w4: K={k} but A is packed to "
                         f"{tuple(a_packed.shape)}")
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    if check_impl(impl, a_packed) == "cuda":
        return camp_gemm_a4w4(a_packed, b_packed, a_scale, b_scale, **kw,
                              plan=plan)
    return camp_gemm_a4w4_ref(a_packed, b_packed, a_scale, b_scale, **kw)


def quantize_rowwise(x, *, bits: int = 8, impl: str = "auto"):
    """Dynamic rowwise quantization: x (M, K) → (int8 q, f32 scale (M, 1))."""
    if check_impl(impl, x) == "cuda":
        return quantize_rowwise_kernel(x, bits=bits)
    return quantize_rowwise_ref(x, bits)
