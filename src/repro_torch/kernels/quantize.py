"""K7: rowwise absmax quantization (bits 8 or 4).

Port of the reference's ``quantize_rowwise_kernel``
(``repro/kernels/quantize.py``): x (M, K) bf16/f32 → int8 q (M, K) in
[-qmax, qmax] and f32 scales (M, 1), qmax 127 for bits 8 and 7 for bits 4.
A zero row comes out as (0, 1). The f32 chain is the fused GEMMs'
(:func:`repro_torch.kernels.ref.quantize_rowwise_ref`, its plain version),
so the unfused quantize → GEMM path equals the fused kernels bit for bit.

:func:`quantize_rowwise_kernel` takes the plain version for a CPU tensor,
launches ``csrc/quantize.cu`` for a CUDA tensor (or raises) and runs the
meta rule for a meta tensor (:mod:`repro_torch.kernels.meta`: q and the
scales allocated, 3·M·K operations recorded);
``launches`` counts kernel launches. :func:`team_size` picks how many of
the kernel's threads take one row. :func:`quantize_lastdim` runs it over
the rows of any tensor's last axis: the training path's int8 moments,
int8 gradient compression and fake quantization.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.quant import _qmax
from repro_torch.kernels import build, meta
from repro_torch.kernels.camp_gemm import (FLOATS, check_tensor,
                                           require_cuda, sms_of)
from repro_torch.kernels.ref import quantize_rowwise_ref

launches = 0          # kernel launches through the wrapper

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
BLOCK = 256           # threads a block of csrc/quantize.cu
MAX_TEAM = 8 * BLOCK  # a row's threads at most: a cluster of 8 blocks
REG_GROUPS = 4        # 16-byte groups of x a thread holds in registers
GROUPS_A_THREAD = 8   # ... and at most that many, the rest read from L2


def team_size(m: int, k: int, x_bytes: int, sms: int) -> int:
    """Threads of ``csrc/quantize.cu`` that take one row of an (M, K) x of
    ``x_bytes`` a value on a card of ``sms`` SMs: a power of two from 32
    (a warp; 8 rows a block) to ``MAX_TEAM`` (a cluster of 8 blocks). The
    smallest that leaves each thread at most ``GROUPS_A_THREAD`` 16-byte
    groups of the row; doubled while the grid has fewer blocks than SMs
    and a thread has a group to spare, inside a block, or into a cluster
    while a thread's groups exceed its registers (the fastest choices on
    the card at the shapes of ``chip_smoke.py``'s K7, ``PERF.md``)."""
    groups = -(-k * x_bytes // 16)
    team = 32
    while team < MAX_TEAM and (
            team * GROUPS_A_THREAD < groups
            or (-(-m * team // BLOCK) < sms and team < groups
                and (team < BLOCK or team * REG_GROUPS < groups))):
        team *= 2
    return team


def _lib():
    fn = build.load("quantize").quantize_rowwise
    fn.argtypes = [_VOID, _INT, _VOID, _VOID, _INT, _INT, _INT, _INT, _VOID]
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
    if dev.type == "meta":
        meta.record("quantize_rowwise", 3.0 * m * k, meta.nbytes(x, q, s))
        return q, s
    team = team_size(m, k, x.element_size(), sms_of(x))
    rc = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
                s.data_ptr(), m, k, bits, team,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_rowwise launch failed: cudaError {rc}")
    global launches
    launches += 1
    return q, s


def quantize_lastdim(x: torch.Tensor, *, bits: int = 8,
                     row_absmax: Optional[torch.Tensor] = None):
    """x (..., K) → (int8 q (..., K), f32 scale (..., 1)): K7 (or its
    plain version, for a CPU tensor) over x viewed as (M, K) rows.

    ``row_absmax`` (..., 1): where x holds a block of longer rows (a shard
    of the last dim), each whole row's absmax (≥ the block's, one of the
    rows' values, so exact in x's dtype). K7 then quantizes x's rows with
    one more column holding it: their absmax, hence their scale and every
    value, is the whole row's, bit for bit.
    """
    if x.ndim == 0:
        raise ValueError("quantize_lastdim needs a last axis")
    if row_absmax is not None:
        q, s = quantize_lastdim(torch.cat([x, row_absmax.to(x.dtype)], -1),
                                bits=bits)
        return q[..., :-1].contiguous(), s
    q, s = quantize_rowwise_kernel(x.reshape(-1, x.shape[-1]).contiguous(),
                                   bits=bits)
    return q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)
