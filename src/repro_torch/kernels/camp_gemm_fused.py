"""K1: fused activation-quantize + int8 GEMM + epilogue (w8a8).

Port of the reference's ``camp_gemm_fused_w8a8`` (``repro/kernels/
camp_gemm_fused.py``): bf16/f32 activations are quantized per row inside
the kernel, multiplied by the int8 weight into an int32 accumulator, and
flushed as ``acc · (s_a · s_b)`` followed by the epilogue stages, with one
store of the output (a first bias/residual stage fuses with the scale into
one multiply-add, as XLA compiles the reference). The activations' int8 payload and scales never exist
in device memory.

* :func:`camp_gemm_fused_w8a8_ref` is the plain PyTorch version. The CPU
  tests use it, and ``chip_smoke.py`` holds the kernel against it.
* :func:`camp_gemm_fused_w8a8` is the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches ``csrc/camp_gemm_fused.cu`` (or raises).
  ``launches`` counts kernel launches.

int4 weights (the reference's ``camp_gemm_fused_w4a8``/``_w4a4``) come with
K4 in a later slice.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.epilogue import (EPILOGUE_STAGES, apply_epilogue,
                                          validate_epilogue)
from repro_torch.kernels.ref import dot_i32, quantize_rowwise_ref

launches = 0          # kernel launches through the wrapper

_FLOATS = (torch.float32, torch.bfloat16)
_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding to f32, as a fused multiply-add.

    The product of two f32 values is exact in float64, so only the sum
    rounds twice (to float64, then to f32); the two agree with a true FMA
    except at rare double-rounding ties.
    """
    return (a.double() * b.double() + c.double()).float()


def camp_gemm_fused_w8a8_ref(x, b_q, b_scale, *, out_dtype=torch.float32,
                             epilogue: str = "none", bias=None, operand=None):
    """Plain version: quantize rowwise → exact int32 dot → flush → stages.

    The flush is the reference's as XLA compiles it: ``acc · (s_a · s_b)``,
    and where the first stage adds (bias, residual) XLA contracts the scale
    multiply and that add into one fused multiply-add.
    """
    stages = validate_epilogue(epilogue, bias, operand)
    bias = None if bias is None else bias.reshape(1, -1)
    a_q, a_s = quantize_rowwise_ref(x, 8)
    y = dot_i32(a_q, b_q).float()
    scale = a_s * b_scale.reshape(1, -1)
    if stages and stages[0] in ("bias", "residual"):
        y = fma_f32(y, scale, bias if stages[0] == "bias" else operand)
        stages = stages[1:]
    else:
        y = y * scale
    return apply_epilogue(y, stages, bias=bias, operand=operand).to(out_dtype)


def _lib():
    lib = build.load("camp_gemm_fused")
    fn = lib.camp_gemm_fused_w8a8
    fn.argtypes = [_VOID, _INT, _VOID, _VOID, _VOID, _INT, _VOID, _INT,
                   _VOID, _INT, _INT, _INT, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def camp_gemm_fused_w8a8(x: torch.Tensor, b_q: torch.Tensor,
                         b_scale: torch.Tensor, *, out_dtype=torch.float32,
                         epilogue: str = "none",
                         bias: Optional[torch.Tensor] = None,
                         operand: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """w8a8 GEMM of x (M, K) bf16/f32 by b_q (K, N) int8, scales (1, N) f32.

    ``bias`` (N,) and ``operand`` (M, N) are bf16/f32, as the epilogue
    needs them. Returns (M, N) in ``out_dtype`` (bf16 or f32).
    """
    if x.device.type == "cpu":
        return camp_gemm_fused_w8a8_ref(x, b_q, b_scale, out_dtype=out_dtype,
                                        epilogue=epilogue, bias=bias,
                                        operand=operand)
    if x.device.type != "cuda":
        raise ValueError(f"camp_gemm_fused_w8a8: no kernel for {x.device}")
    stages = validate_epilogue(epilogue, bias, operand)
    if x.ndim != 2 or b_q.ndim != 2:
        raise ValueError("camp_gemm_fused_w8a8 takes 2-D x and b_q")
    (m, k), n = x.shape, b_q.shape[1]
    dev = x.device
    _check("x", x, (m, k), _FLOATS, dev)
    _check("b_q", b_q, (k, n), (torch.int8,), dev)
    _check("b_scale", b_scale.reshape(1, -1), (1, n), (torch.float32,), dev)
    if not b_scale.is_contiguous():
        raise ValueError("b_scale must be contiguous")
    if bias is not None:
        _check("bias", bias.reshape(-1), (n,), _FLOATS, dev)
    if operand is not None:
        _check("operand", operand, (m, n), _FLOATS, dev)
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype {out_dtype} not in {_FLOATS}")
    code = 0
    for i, s in enumerate(stages):
        code |= (EPILOGUE_STAGES.index(s) + 1) << (4 * i)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out

    def bf16(t):
        return int(t is not None and t.dtype == torch.bfloat16)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _lib()(x.data_ptr(), bf16(x), b_q.data_ptr(), b_scale.data_ptr(),
                ptr(bias), bf16(bias), ptr(operand), bf16(operand),
                out.data_ptr(), bf16(out), m, n, k, code, len(stages),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"camp_gemm_fused_w8a8 launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out
