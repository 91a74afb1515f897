"""K7: rowwise absmax quantization (bits 8 or 4).

Port of the reference's ``quantize_rowwise_kernel``
(``repro/kernels/quantize.py``): x (M, K) bf16/f32 → int8 q (M, K) in
[-qmax, qmax] and f32 scales (M, 1), qmax 127 for bits 8 and 7 for bits 4.
A zero row comes out as (0, 1). The f32 chain is the fused GEMMs'
(:func:`repro_torch.kernels.ref.quantize_rowwise_ref`, its plain version),
so the unfused quantize → GEMM path equals the fused kernels bit for bit.

:func:`quantize_rowwise_kernel` takes the plain version for a CPU tensor
and launches ``csrc/quantize.cu`` for a CUDA tensor (or raises);
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import _qmax
from repro_torch.kernels import build
from repro_torch.kernels.camp_gemm import FLOATS, check_tensor, require_cuda
from repro_torch.kernels.ref import quantize_rowwise_ref

launches = 0          # kernel launches through the wrapper

_VOID, _INT = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.load("quantize").quantize_rowwise
    fn.argtypes = [_VOID, _INT, _VOID, _VOID, _INT, _INT, _INT, _VOID]
    fn.restype = _INT
    return fn


def quantize_rowwise_kernel(x: torch.Tensor, *, bits: int = 8):
    """x (M, K) bf16/f32 → (int8 q (M, K), f32 scale (M, 1))."""
    _qmax(bits)
    if x.device.type == "cpu":
        return quantize_rowwise_ref(x, bits)
    require_cuda(x, "quantize_rowwise_kernel")
    if x.ndim != 2:
        raise ValueError("quantize_rowwise_kernel takes a 2-D x")
    (m, k), dev = x.shape, x.device
    check_tensor("x", x, (m, k), FLOATS, dev)
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    s = torch.empty((m, 1), dtype=torch.float32, device=dev)
    if m == 0:
        return q, s
    rc = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
                s.data_ptr(), m, k, bits,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_rowwise launch failed: cudaError {rc}")
    global launches
    launches += 1
    return q, s
